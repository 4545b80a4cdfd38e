// Kernel P for Hopper (sm_90a): P2G mass and APIC momentum, the density
// gather, the EOS / viscous force and the grid update, on the bucket layout.
//
// Replaces: mpm_tpu/ops/pallas/p2g_fused.py:_p2g_update_kernel (called
// from p2g_update_pallas), the TPU's kernel P. What it computes is
// mpm_tpu/ops/bucketed.p2g_bucketed followed by ops/grid.update_grid; the
// plain PyTorch version is mpm_tpu_torch/ops/cuda/p2g_update.p2g_update_plain.
//
// What bounds it on this card: every slot's state (pos 12 B, mass 4 B, vel
// 12 B or 6 B in bf16, C 36 B or 18 B) is read by the 27 cells around it,
// once in pass 1 and once more (without vel) in pass 2, and the density pass
// reads 27 grid masses per slot. From device memory that is about 150 B per
// slot per substep (f32 storage), but the 27-fold re-reads go through L1/L2:
// some 4 KB of cache traffic per slot per substep. Load throughput from the
// caches, and the latency of the dependent gathers, bound it; the FLOPs
// (about 2,000 per slot) do not.
//
// The design: the bucket layout makes every pass a gather, so each grid
// node is owned by one thread that sums its 27 neighbour buckets' slots in
// the plain version's order and, built with --fmad=false, rounds as it
// does: the two agree bit for bit. Three launches, bucket_kernels.cuh's
// p2g_mass_mom and p2g_coef (one thread per cell or slot; consecutive
// threads own consecutive z cells, so every slot read is coalesced, and
// empty slots are skipped after one 4-byte mass read) and p2g_force_tile:
// pass 2 and the grid update by one block per 2 x 8 x 16 nodes, which
// stages the occupied slots of the tile's 4 x 10 x 18 buckets in shared
// memory once (pos, a_p, b_mu and C as f32, two slot indices at a time)
// and keeps each node's 27 tap partials in registers, so that each slot is
// loaded and converted once a block rather than once for each of the 27
// nodes it reaches. The TPU kernel's plane sweeps and VMEM rings do not
// carry over. Output: grid velocity [3, C] and grid
// mass [C], float32 or int32. In fixed-point mode (the S4 scene) the grid is
// int32: each slot's contribution is encoded and summed as integers, the
// density and the grid update decode, and the grid velocity is encoded
// again (p2g_fused.py:91-100, 286-290, 368-405).

#include "p2g_params.cuh"

namespace {

// Kernel P for grid element type GT (float, or int for fixed point).
template <typename GT>
cudaError_t launch(const mpm::P2GParams& p, const float* pos, const void* vel, const void* Cm,
                   const float* mass, void* gmass, void* gmom, float* a_p, float* b_mu,
                   void* gvel, int vc_bf16, cudaStream_t s) {
  using BF = __nv_bfloat16;
  GT *gm = (GT*)gmass, *gp = (GT*)gmom, *gv = (GT*)gvel;
  if (vc_bf16)
    return mpm::launch_p2g<3>(p, pos, (const BF*)vel, (const BF*)Cm, mass, gm, gp, a_p, b_mu, gv,
                              s);
  return mpm::launch_p2g<3>(p, pos, (const float*)vel, (const float*)Cm, mass, gm, gp, a_p, b_mu,
                            gv, s);
}

template <typename VC>
int tile_blocks_per_sm() {
  auto kern = mpm::p2g_force_tile<3, VC, float, true, mpm::P2GParams>;
  const size_t smem = mpm::force_tile_smem<3>();
  int n = -1;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, mpm::tile_nodes<3>(), smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Parameter block size, checked by the Python wrapper against its ctypes
// mirror of P2GParams.
int p2g_update_params_size() { return (int)sizeof(mpm::P2GParams); }

// Blocks of pass 2's tile kernel (D = 3, float32 grid, bf16 or float32
// C) that fit on one SM, or -1 on an error; for utils/kernel_resources.py.
int p2g_force_tile_blocks_per_sm(int vc_bf16) {
  return vc_bf16 ? tile_blocks_per_sm<__nv_bfloat16>() : tile_blocks_per_sm<float>();
}

// vc_bf16: vel and C are stored as bfloat16 (else float32). fixed: the grid
// is int32 fixed point (gmass, gmom and gvel int32; else float32). Scratch:
// gmom [3, C], a_p [K, C], b_mu [K, C]. Outputs: gmass [C], gvel [3, C].
int p2g_update(const void* params, const float* pos, const void* vel, const void* Cm,
               const float* mass, void* gmass, void* gmom, float* a_p, float* b_mu, void* gvel,
               int vc_bf16, int fixed, void* stream) {
  const mpm::P2GParams& p = *(const mpm::P2GParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      fixed ? launch<int>(p, pos, vel, Cm, mass, gmass, gmom, a_p, b_mu, gvel, vc_bf16, s)
            : launch<float>(p, pos, vel, Cm, mass, gmass, gmom, a_p, b_mu, gvel, vc_bf16, s);
  return (int)err;
}

}  // extern "C"
