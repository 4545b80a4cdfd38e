// The 2D substep for Hopper (sm_90a): kernel chains sim2d and migrate2d on
// the 2D bucket layout.
//
// Replaces: mpm_tpu/ops/pallas/kernels2d.py:_sim2d_kernel and
// _migrate2d_kernel (called from _substep2d, entry substep2d), the TPU's whole 2D
// substep. What sim2d computes is mpm_tpu/ops/bucketed p2g_bucketed, the
// grid update and g2p_bucketed (everything but migration); migrate2d is
// bucketed.migrate (axis 1, then axis 0). The plain PyTorch versions are
// mpm_tpu_torch/ops/cuda/substep2d.sim2d_plain and migrate2d_plain.
//
// Layout (the JAX package's): pos [2, K, C], vel [2, K, C], C [4, K, C]
// (row-major 2x2), mass [K, C], ids [K, C], C = nx * ny cells with y
// fastest; float32 only.
//
// What bounds it on this card: at the 2D benchmark (100k particles in
// 262,144 slots: 256^2, K=4) the functions need the mass of every slot, the
// state of the occupied ones and every output: 12.6 MB for sim2d (3.8 us at
// 3.35 TB/s) and 15.1 MB for migrate2d (4.5 us; utils/roofline.py). The
// 9-tap gathers re-read from L1/L2. Both are below the cost of their
// launches, so the 2D substep is bound by launches and host time, not by
// the card. The simple design is kernels P's and F's, instantiated for
// D = 2 from bucket_kernels.cuh: the TPU kernel held the whole grid in VMEM
// with halo padding (_halo2); here every pass is a gather by one thread per
// cell or slot over its 9 neighbours. The sums run in the plain version's
// order, and with --fmad=false every multiply and add rounds apart as the
// plain version's do, so the two agree bit for bit.
//   sim2d, four launches: p2g_mass_tile, p2g_coef, p2g_force_tile (both tile
//     kernels on tiles of 8 x 32 nodes; legacy strain optional; slip /
//     stick / friction bands),
//     g2p_tail (the 2D mouse interactions pack 6 values: cx, cy, radius,
//     strength, inv_falloff, active).
//   migrate2d, for axis 1 then axis 0, two launches each: migrate_reject
//     (deferred counted) and migrate_select (lost counted; positions, mass
//     and source indices only); then migrate_gather (vel, C, ids); no
//     ceiling.

#include "bucket_kernels.cuh"

namespace {

struct Sim2DParams {
  mpm::Geom2 g;
  int dres[2];        // true domain
  int bc;             // 0 slip, 1 stick, 2 friction
  int band_lo, band_hi;
  int eos_pow_n;      // > 0: integer exponent unrolled (stress.pow_static)
  int legacy_strain;
  int n_inter;
  float eos_pow_f;    // exponent for powf when eos_pow_n == 0
  float dt;
  float gravity[2];
  float rest_density;
  float mu;           // dynamic viscosity
  float eos_k;
  float pressure_floor;
  float friction;
  float clamp_lo, clamp_hi_offset;
  float wall_min, wall_max_offset, wall_stiffness;
  float inter[mpm::MAX_INTER * mpm::INTER_VALS<2>];
};

}  // namespace

extern "C" {

// Parameter block size and interaction capacity, checked by the Python
// wrapper against its ctypes mirror of Sim2DParams.
int substep2d_params_size() { return (int)sizeof(Sim2DParams); }
int substep2d_max_interactions() { return mpm::MAX_INTER; }

// Everything of the 2D substep but migration. Scratch: gmass [C], gmom
// [2, C], a_p [K, C], b_mu [K, C], gvel [2, C]. Outputs: pos_out, vel_out
// [2, K, C], C_out [4, K, C]; cfl [1] int32 is added to.
int sim2d(const void* params, const float* pos, const float* vel, const float* Cm,
          const float* mass, float* gmass, float* gmom, float* a_p, float* b_mu, float* gvel,
          float* pos_out, float* vel_out, float* C_out, int* cfl, void* stream) {
  const Sim2DParams& p = *(const Sim2DParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      mpm::launch_p2g<2>(p, pos, vel, Cm, mass, gmass, gmom, a_p, b_mu, gvel, s);
  if (err != cudaSuccess) return (int)err;
  return (int)mpm::launch_g2p_tail<2>(p, pos, mass, gvel, pos_out, vel_out, C_out, cfl, s);
}

// Both migration phases on an nx x ny grid with K slots a cell, axis 1 then
// axis 0: the input state -> A -> B (the result). R is a [K, C] scratch row;
// cnt [2] int32 = lost, deferred, added to.
int migrate2d(int nx, int ny, int K, const float* pos, const float* vel, const float* Cm,
              const float* mass, const int* ids, float* a_pos, float* a_vel, float* a_C,
              float* a_mass, int* a_ids, float* b_pos, float* b_vel, float* b_C, float* b_mass,
              int* b_ids, float* R, int* cnt, void* stream) {
  const mpm::Geom2 g = {{nx, ny}, K, nx * ny};
  mpm::StateBuf<float> in = {(float*)pos, (float*)vel, (float*)Cm, (float*)mass, (int*)ids};
  mpm::StateBuf<float> A = {a_pos, a_vel, a_C, a_mass, a_ids};
  mpm::StateBuf<float> B = {b_pos, b_vel, b_C, b_mass, b_ids};
  return (int)mpm::launch_migrate<2>(g, in, A, B, R, cnt, cnt + 1, nullptr, -1,
                                     (cudaStream_t)stream);
}

}  // extern "C"
