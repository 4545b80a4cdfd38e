// The per-pass kernels for Hopper (sm_90a): A, B, D and the migration
// kernel E, on the 3D bucket layout, float32 storage and grids.
//
// Replaces: mpm_tpu/ops/pallas/bucket_kernels.py:_p2g1_kernel (A),
// _p2g2_kernel (B) and _g2p_kernel (D), called from p2g_pallas and
// g2p_pallas, and mpm_tpu/ops/pallas/migrate_kernels.py:_intra_core_kernel,
// _intra_c_kernel, _x_kernel and _x_c_kernel (E, called from
// migrate_intra_pallas and migrate_x_pallas): the TPU's per-pass substep,
// bucket_kernels.substep (MPM_PALLAS_OLD=1, and float configs outside the
// fused kernels' VMEM envelope). The plain PyTorch versions are
// mpm_tpu_torch/ops/cuda/planes.p2g1_plain, p2g2_plain and g2p_plain and
// ops/cuda/migrate_planes.migrate_planes_plain.
//
// What bounds them on this card: they are kernel P and F cut at the TPU's
// pass boundaries, so what bounds P and F bounds them. A reads the state of
// every occupied slot (pos, vel, C: 60 B in float32), once for each tile
// whose halo holds it, and writes the grid mass and momentum (16 B a cell);
// B reads pos
// and C again with the grid mass and writes a second momentum; D reads pos
// and the grid velocity and writes vel and C (48 B a slot, every slot); E
// reads the whole state and writes it once, choosing by the positions and
// masses in three phases. The issue rate and the latency of loading the
// tiles' slots bound A and B, device memory D and E.
//
// The design: bucket_kernels.cuh's kernels for D = 3, the device code of
// P and F, so the rounding is one source's. A is p2g_mass_tile, kernel P's
// first launch (launch_p2g_pass1); B is
// p2g_coef then p2g_force_tile without the update, pass 2 from zero (the
// sum with A's momentum is the caller's, as the TPU left it to XLA); D is
// g2p_vc; E is the migration's older chain (launch_migrate; kernel F's
// moves slot codes instead, launch_migrate_codes): the migrate_reject /
// migrate_select pair per axis z, y, x, each select moving positions, mass
// and source indices only, then one migrate_gather of vel, C and ids. E
// takes a state, not G2P's tail, so it has no slot codes. The TPU split E
// into core and C kernels and blocked the C rows to fit VMEM. Plane sweeps,
// K blocks and halo padding do not carry over.

#include "p2g_params.cuh"

namespace {

using mpm::P2GParams;
using mpm::THREADS;
using mpm::blocks_for;

}  // namespace

extern "C" {

int planes_params_size() { return (int)sizeof(P2GParams); }

// A: pos, vel, C and mass in; gmass [C] and gmom [3, C] out.
int p2g1_planes(const void* params, const float* pos, const float* vel, const float* Cm,
                const float* mass, float* gmass, float* gmom, void* stream) {
  const P2GParams& p = *(const P2GParams*)params;
  return (int)mpm::launch_p2g_pass1<3>(p, pos, vel, Cm, mass, gmass, gmom,
                                       (cudaStream_t)stream);
}

// B: pos, C, mass and A's gmass in; gmom2 [3, C] (pass 2 from zero) out;
// a_p and b_mu [K, C] are scratch.
int p2g2_planes(const void* params, const float* pos, const float* Cm, const float* mass,
                const float* gmass, float* a_p, float* b_mu, float* gmom2, void* stream) {
  const P2GParams& p = *(const P2GParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t KC = (size_t)p.g.K * p.g.C;
  mpm::p2g_coef<3, float><<<blocks_for(KC, THREADS), THREADS, 0, s>>>(pos, mass, gmass, a_p,
                                                                      b_mu, p, mpm::whole_grid());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)mpm::launch_p2g_force<3, float, float, false>(p, pos, Cm, mass, a_p, b_mu, gmass,
                                                            nullptr, gmom2, s, mpm::whole_grid());
}

// D: pos, mass and the grid velocity gvel [3, C] in; vel [3, K, C] and C
// [9, K, C] out.
int g2p_planes(const void* params, const float* pos, const float* mass, const float* gvel,
               float* vel_out, float* C_out, void* stream) {
  const P2GParams& p = *(const P2GParams*)params;
  const size_t KC = (size_t)p.g.K * p.g.C;
  mpm::g2p_vc<3, float, float><<<blocks_for(KC, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      pos, mass, gvel, vel_out, C_out, p);
  return (int)cudaGetLastError();
}

// E: the three axis phases z, y, x of bucketed.migrate on an nx x ny x nz
// grid with K slots a cell: the input state -> A -> B -> A (the result).
// R is a [K, C] scratch row; cnt [2] int32 = lost, deferred, added to.
int migrate_planes(int nx, int ny, int nz, int K, const float* pos, const float* vel,
                   const float* Cm, const float* mass, const int* ids, float* a_pos,
                   float* a_vel, float* a_C, float* a_mass, int* a_ids, float* b_pos,
                   float* b_vel, float* b_C, float* b_mass, int* b_ids, float* R, int* cnt,
                   void* stream) {
  const mpm::Geom g = {{nx, ny, nz}, K, nx * ny * nz};
  mpm::StateBuf<float> in = {(float*)pos, (float*)vel, (float*)Cm, (float*)mass, (int*)ids};
  mpm::StateBuf<float> A = {a_pos, a_vel, a_C, a_mass, a_ids};
  mpm::StateBuf<float> B = {b_pos, b_vel, b_C, b_mass, b_ids};
  return (int)mpm::launch_migrate<3>(g, in, A, B, R, cnt, cnt + 1, nullptr, -1,
                                     (cudaStream_t)stream);
}

}  // extern "C"
