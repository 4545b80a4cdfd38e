// The two sharded stages of kernel P for Hopper (sm_90a), on one slab of an
// x-slab decomposition (parallel/domain.py).
//
// Replaces: mpm_tpu/ops/pallas/p2g_fused.py:_p2g1_shard_kernel (called from
// p2g1_shard_pallas) and _p2g2u_shard_kernel (called from
// p2g2u_shard_pallas), the TPU's kernel P split at the grid-mass exchange.
// The plain PyTorch versions are mpm_tpu_torch/ops/cuda/p2g_shard.
// p2g1_shard_plain and p2g2u_shard_plain.
//
// A slab's state is padded with its neighbours' two nearest planes on each
// side (L planes, global plane x0 first); its grid has one plane more on
// each side, L + 2 planes from global plane x0 - 1. A particle's force needs
// its density, which gathers grid mass one plane away, so the chain breaks
// at the mass: stage 1 sums the pass-1 grid mass and momentum, exact on grid
// planes [2, L-1]; the caller replaces the other four mass planes with the
// neighbours' exact ones; stage 2 then computes the force coefficients of
// every slot from exact density, adds pass 2 to the pass-1 momentum and
// updates the grid, exact on planes [2, L-1] again (the caller exchanges
// the grid velocity the same way).
//
// What bounds them on this card: what bounds kernel P (p2g_update.cu), of
// which they are the three launches cut in two: the issue rate of the two
// passes' per-tap arithmetic over each tile's slots and the latency of
// loading those slots from L2, not device memory. The slab adds 4 state
// planes and 2 grid planes to every L - 4 own ones.
//
// The design: bucket_kernels.cuh's p2g_mass_tile (stage 1: each occupied
// slot of a tile and its halo loaded once, its contributions added to tap
// partials in shared memory), p2g_coef and p2g_force_tile (stage 2: staged
// tiles of slots in shared memory, kernel P's pass 2) with the slab's
// geometry (mpm::Slab: offset x0, go = 1), the same device code as kernel
// P. Stage 1 keeps the pass-1
// momentum for stage 2 rather than emitting it again with the force, as the
// TPU's stage 2 does: each grid node's value is then computed by the same
// operations in the same order from copies of the same slots as in
// unsharded kernel P, so a sharded substep equals the unsharded one bit for
// bit. Float32 grids, or int32 fixed point (GridCoding<int>).

#include "p2g_params.cuh"

namespace {

using mpm::P2GParams;

mpm::Slab slab_at(int x0) { return {x0, 1, 0, 0x7fffffff}; }

template <typename GT>
cudaError_t stage1(const P2GParams& p, int x0, const float* pos, const void* vel, const void* Cm,
                   const float* mass, void* gmass, void* gmom, int vc_bf16, cudaStream_t s) {
  using BF = __nv_bfloat16;
  if (vc_bf16)
    return mpm::launch_p2g_pass1<3>(p, pos, (const BF*)vel, (const BF*)Cm, mass, (GT*)gmass,
                                    (GT*)gmom, s, slab_at(x0));
  return mpm::launch_p2g_pass1<3>(p, pos, (const float*)vel, (const float*)Cm, mass, (GT*)gmass,
                                  (GT*)gmom, s, slab_at(x0));
}

template <typename GT>
cudaError_t stage2(const P2GParams& p, int x0, const float* pos, const void* Cm,
                   const float* mass, const void* gmass, const void* gmom, float* a_p,
                   float* b_mu, void* gvel, int vc_bf16, cudaStream_t s) {
  using BF = __nv_bfloat16;
  if (vc_bf16)
    return mpm::launch_p2g_pass2<3>(p, pos, (const BF*)Cm, mass, (const GT*)gmass,
                                    (const GT*)gmom, a_p, b_mu, (GT*)gvel, s, slab_at(x0));
  return mpm::launch_p2g_pass2<3>(p, pos, (const float*)Cm, mass, (const GT*)gmass,
                                  (const GT*)gmom, a_p, b_mu, (GT*)gvel, s, slab_at(x0));
}

}  // namespace

extern "C" {

int p2g_shard_params_size() { return (int)sizeof(P2GParams); }

// Stage 1. params: the slab's (nx = L planes, dres the true domain); x0:
// the global plane of the slab's plane 0. Outputs gmass [(L+2) * ny * nz]
// and gmom [3, (L+2) * ny * nz], float32 or int32 (`fixed`).
int p2g1_shard(const void* params, int x0, const float* pos, const void* vel, const void* Cm,
               const float* mass, void* gmass, void* gmom, int vc_bf16, int fixed,
               void* stream) {
  const P2GParams& p = *(const P2GParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(fixed ? stage1<int>(p, x0, pos, vel, Cm, mass, gmass, gmom, vc_bf16, s)
                     : stage1<float>(p, x0, pos, vel, Cm, mass, gmass, gmom, vc_bf16, s));
}

// Stage 2: gmass (exchanged) and stage 1's gmom in; gvel [3, (L+2) * ny *
// nz] out; a_p and b_mu [K, L * ny * nz] are scratch.
int p2g2u_shard(const void* params, int x0, const float* pos, const void* Cm, const float* mass,
                const void* gmass, const void* gmom, float* a_p, float* b_mu, void* gvel,
                int vc_bf16, int fixed, void* stream) {
  const P2GParams& p = *(const P2GParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(fixed ? stage2<int>(p, x0, pos, Cm, mass, gmass, gmom, a_p, b_mu, gvel, vc_bf16, s)
                     : stage2<float>(p, x0, pos, Cm, mass, gmass, gmom, a_p, b_mu, gvel, vc_bf16,
                                     s));
}

}  // extern "C"
