// Kernel X for Hopper (sm_90a): per-cell splat extraction from a bucket
// state, the render path's reduction of each cell to its nearest particle.
//
// Replaces: mpm_tpu/render/extract_kernel.py:_extract_kernel (launched
// by extract_cell_splats). The plain PyTorch version is
// mpm_tpu_torch/render/extract_kernel.extract_cell_splats_plain.
//
// What bounds it on this card: device-memory reads. Each slot's mass is
// read (4 B), the position of each slot with mass (12 B), and the velocity
// of each cell's winner (6 B in bf16, 12 B in f32); each cell writes 20 B.
// At the settled 1M pool window ((64, 48, 64), K=8, bf16, 62% of the slots
// occupied) that is about 23 MB, some 7 us at 3.35 TB/s. The projection is
// a few dozen FLOPs per occupied slot.
//
// The design: one thread per cell (extract_cells.cuh). It loads its K masses
// first, all in flight at once, into a bit a slot; then it walks the slots in
// slot order, loading the position of the next occupied slot while it
// projects the current one, and the winner's velocity once at the end. An
// empty slot costs its mass alone. Loading the positions of 8 slots at once
// instead ran slower (PERF.md). Threads of a warp hold neighbouring cells,
// so every read of a slot row is coalesced over C. No shared memory, no
// atomics; the result does not depend on the launch shape.

#include "extract_cells.cuh"

extern "C" {

int extract_cells_scals() { return 16; }

// pos [3, K, C] f32, vel [3, K, C] (bf16 when vel_bf16, else f32), mass [K, C],
// scals: 16 host floats (mpm::RenderScals), out [5, C] f32.
int extract_cells(const float* pos, const void* vel, const float* mass, const float* scals,
                  int K, int C, int vel_bf16, float* out, void* stream) {
  mpm::RenderScals rs;
  for (int i = 0; i < 16; ++i) rs.s[i] = scals[i];
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      vel_bf16 ? mpm::launch_extract(pos, (const __nv_bfloat16*)vel, mass, K, C, rs, out, s)
               : mpm::launch_extract(pos, (const float*)vel, mass, K, C, rs, out, s);
  return (int)err;
}

}  // extern "C"
