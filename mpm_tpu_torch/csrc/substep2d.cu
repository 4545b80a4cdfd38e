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
// fastest. vel and C are stored as float32 or bf16 (`vc_bf16`, as
// _sim2d_kernel loads them, kernels2d.py:76-77): sim2d converts them to
// float32 as it loads them and rounds once as it stores (the 3D bf16
// pool's template instantiated for D = 2); migrate2d moves their bits.
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
//     ceiling. This is the migration's older chain (launch_migrate); the 3D
//     kernel F's moves one-byte slot codes (launch_migrate_codes).

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
  const float* inter;  // device [n_inter, INTER_VALS<2>]; null when n_inter is 0
};

// Both migration phases on an nx x ny grid with K slots a cell, axis 1 then
// axis 0: the input state -> A -> B (the result). R is a [K, C] scratch row;
// cnt [2] int32 = lost, deferred, added to. vel and C move as raw bits: 16
// a value when vc_bf16, else 32.
template <typename T>
int migrate2d_as(int nx, int ny, int K, const float* pos, const void* vel,
                 const void* Cm, const float* mass, const int* ids, float* a_pos,
                 void* a_vel, void* a_C, float* a_mass, int* a_ids, float* b_pos,
                 void* b_vel, void* b_C, float* b_mass, int* b_ids, float* R, int* cnt,
                 cudaStream_t stream) {
  const mpm::Geom2 g = {{nx, ny}, K, nx * ny};
  mpm::StateBuf<T> in = {(float*)pos, (T*)vel, (T*)Cm, (float*)mass, (int*)ids};
  mpm::StateBuf<T> A = {a_pos, (T*)a_vel, (T*)a_C, a_mass, a_ids};
  mpm::StateBuf<T> B = {b_pos, (T*)b_vel, (T*)b_C, b_mass, b_ids};
  return (int)mpm::launch_migrate<2>(g, in, A, B, R, cnt, cnt + 1, nullptr, -1, stream);
}

}  // namespace

extern "C" {

// Parameter block size, checked by the Python wrapper against its ctypes
// mirror of Sim2DParams.
int substep2d_params_size() { return (int)sizeof(Sim2DParams); }

// Everything of the 2D substep but migration. Scratch: gmass [C], gmom
// [2, C], a_p [K, C], b_mu [K, C], gvel [2, C]. Outputs: pos_out, vel_out
// [2, K, C], C_out [4, K, C] (vel and C bf16 when vc_bf16); cfl [1] int32 is
// added to.
int sim2d(const void* params, const float* pos, const void* vel, const void* Cm,
          const float* mass, float* gmass, float* gmom, float* a_p, float* b_mu, float* gvel,
          float* pos_out, void* vel_out, void* C_out, int* cfl, int vc_bf16, void* stream) {
  const Sim2DParams& p = *(const Sim2DParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (vc_bf16) {
    using B16 = __nv_bfloat16;
    err = mpm::launch_p2g<2>(p, pos, (const B16*)vel, (const B16*)Cm, mass, gmass, gmom, a_p,
                             b_mu, gvel, s);
    if (err != cudaSuccess) return (int)err;
    return (int)mpm::launch_g2p_tail<2>(p, pos, mass, gvel, pos_out, (B16*)vel_out,
                                        (B16*)C_out, cfl, s);
  }
  err = mpm::launch_p2g<2>(p, pos, (const float*)vel, (const float*)Cm, mass, gmass, gmom, a_p,
                           b_mu, gvel, s);
  if (err != cudaSuccess) return (int)err;
  return (int)mpm::launch_g2p_tail<2>(p, pos, mass, gvel, pos_out, (float*)vel_out,
                                      (float*)C_out, cfl, s);
}

// Both migration phases of a state (migrate2d_as).
int migrate2d(int nx, int ny, int K, const float* pos, const void* vel, const void* Cm,
              const float* mass, const int* ids, float* a_pos, void* a_vel, void* a_C,
              float* a_mass, int* a_ids, float* b_pos, void* b_vel, void* b_C, float* b_mass,
              int* b_ids, float* R, int* cnt, int vc_bf16, void* stream) {
  auto run = vc_bf16 ? migrate2d_as<uint16_t> : migrate2d_as<uint32_t>;
  return run(nx, ny, K, pos, vel, Cm, mass, ids, a_pos, a_vel, a_C, a_mass, a_ids, b_pos, b_vel,
             b_C, b_mass, b_ids, R, cnt, (cudaStream_t)stream);
}

}  // extern "C"
