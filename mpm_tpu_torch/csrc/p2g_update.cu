// Kernel P for Hopper (sm_90a): P2G mass and APIC momentum, the density
// gather, the EOS / viscous force and the grid update, on the bucket layout.
//
// Replaces: mpm_tpu/ops/pallas/p2g_fused.py:_p2g_update_kernel (called
// from p2g_update_pallas), the TPU's kernel P. What it computes is
// mpm_tpu/ops/bucketed.p2g_bucketed followed by ops/grid.update_grid; the
// plain PyTorch version is mpm_tpu_torch/ops/cuda/p2g_update.p2g_update_plain.
//
// What bounds it on this card: every slot's state (pos 12 B, mass 4 B, vel
// 12 B or 6 B in bf16, C 36 B or 18 B) reaches the 27 nodes around it, once
// in pass 1 and once more (without vel) in pass 2, and the density pass
// reads 27 grid masses per slot. From device memory that is about 150 B per
// slot per substep (f32 storage); what bounds the kernel is the issue rate
// of the per-tap arithmetic (about 2,000 FLOPs per slot, unfused) and the
// latency of loading each tile's slots from L2, once for each tile whose
// halo holds them.
//
// The design: the bucket layout makes every pass a gather, each grid node's
// sums taking its 27 neighbour buckets' slots in the plain version's order,
// so, built with --fmad=false, it rounds as the plain version does: the two
// agree bit for bit. Three launches of bucket_kernels.cuh, the two passes
// by one block per 2 x 8 x 16 nodes, each loading the occupied slots of the
// tile's 4 x 10 x 18 buckets once: p2g_mass_tile (pass 1: each thread owns
// halo buckets and adds its slots' contributions in slot order to the
// nodes' 27 tap partials in shared memory, 110.6 KB a block; then each node
// sums its partials in tap order), p2g_coef (one thread per slot) and
// p2g_force_tile (pass 2 and the grid update: the slots staged in shared
// memory as f32 records, two slot indices at a time, and each node's 27 tap
// partials in registers). So each slot is loaded and converted once a block
// rather than once for each of the 27 nodes it reaches. The TPU kernel's
// plane sweeps and VMEM rings do not carry over. Output: grid velocity [3,
// C] and grid mass [C], float32 or int32. In fixed-point mode (the S4
// scene) the grid is int32: each slot's contribution is encoded and summed
// as integers, the density and the grid update decode, and the grid
// velocity is encoded again (p2g_fused.py:91-100, 286-290, 368-405).

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

// Blocks of `kern` (D = 3, a tile a block) with `smem` bytes of dynamic
// shared memory that fit on one SM, or -1 on an error.
template <class K>
int blocks_per_sm(K kern, size_t smem) {
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

// Blocks of pass 2's and pass 1's tile kernels (D = 3, float32 grid, bf16
// or float32 vel and C) that fit on one SM, or -1 on an error; for
// utils/kernel_resources.py.
int p2g_force_tile_blocks_per_sm(int vc_bf16) {
  using BF = __nv_bfloat16;
  const size_t smem = mpm::force_tile_smem<3>();
  return vc_bf16 ? blocks_per_sm(mpm::p2g_force_tile<3, BF, float, true, mpm::P2GParams>, smem)
                 : blocks_per_sm(mpm::p2g_force_tile<3, float, float, true, mpm::P2GParams>, smem);
}
int p2g_mass_tile_blocks_per_sm(int vc_bf16) {
  using BF = __nv_bfloat16;
  const size_t smem = mpm::mass_tile_smem<3>();
  return vc_bf16 ? blocks_per_sm(mpm::p2g_mass_tile<3, BF, float, mpm::P2GParams>, smem)
                 : blocks_per_sm(mpm::p2g_mass_tile<3, float, float, mpm::P2GParams>, smem);
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
