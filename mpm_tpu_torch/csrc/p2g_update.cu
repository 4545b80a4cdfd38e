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
// The simple design: the bucket layout makes every pass a gather, so each
// grid node is owned by one thread that sums its 27 neighbour buckets' slots
// in a fixed order (taps in (x, y, z) order, slots in slot order). There are
// no float atomics and the result is the same run to run; it sums in the
// plain version's order, so the two differ only where nvcc fuses a
// multiply-add. Consecutive threads own consecutive z
// cells, so every slot read is coalesced. Empty slots are skipped after one
// 4-byte mass read. The TPU kernel's plane sweeps and VMEM rings do not carry
// over. Three launches:
//   1. p2g_mass_mom   one thread per cell: pass-1 mass and momentum.
//   2. p2g_coef       one thread per slot: density gather from 27 nodes,
//                     then the a_p and b_mu force coefficients.
//   3. p2g_force_grid one thread per cell: pass-2 force gather added to the
//                     momentum, then the grid update (momentum -> velocity,
//                     gravity, BC bands against the true domain dres).
// Output: grid velocity [3, C] and grid mass [C], float32.

#include "mpm_common.cuh"

namespace {

using mpm::Geom;

struct P2GParams {
  Geom g;
  int dres[3];          // true domain (domain_res, or grid_res)
  int bc;               // 0 slip, 1 stick, 2 friction
  int band_lo, band_hi;
  int eos_pow_n;        // > 0: integer exponent unrolled (stress.pow_static)
  int legacy_strain;
  float eos_pow_f;      // exponent for powf when eos_pow_n == 0
  float dt;
  float gravity[3];
  float rest_density;
  float mu;             // dynamic viscosity
  float eos_k;
  float pressure_floor;
  float friction;
};

// stress.pow_static: binary exponentiation in the JAX package's order.
__device__ __forceinline__ float pow_static(float x, int n) {
  float result = 0.f;
  bool have = false;
  float base = x;
  while (n) {
    if (n & 1) {
      result = have ? result * base : base;
      have = true;
    }
    n >>= 1;
    if (n) base = base * base;
  }
  return result;
}

template <typename VC>
__global__ void p2g_mass_mom(const float* __restrict__ pos, const VC* __restrict__ vel,
                             const VC* __restrict__ Cm, const float* __restrict__ mass,
                             float* __restrict__ gmass, float* __restrict__ gmom,
                             P2GParams p) {
  const Geom g = p.g;
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  int x, y, z;
  mpm::cell_xyz(g, c, x, y, z);
  const size_t KC = (size_t)g.K * g.C;
  float gm = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
  for (int tx = 0; tx < 3; ++tx)
    for (int ty = 0; ty < 3; ++ty)
      for (int tz = 0; tz < 3; ++tz) {
        // bucket b = c + (t - 1); its particles reach node c with tap 2 - t
        int bx = x + tx - 1, by = y + ty - 1, bz = z + tz - 1;
        if (!mpm::in_grid(g, bx, by, bz)) continue;
        int b = mpm::flat(g, bx, by, bz);
        const int r0 = 2 - tx, r1 = 2 - ty, r2 = 2 - tz;
        const float cb[3] = {((float)x + 0.5f) + (float)(tx - 1),
                             ((float)y + 0.5f) + (float)(ty - 1),
                             ((float)z + 0.5f) + (float)(tz - 1)};
        float pm = 0.f, p0 = 0.f, p1 = 0.f, p2 = 0.f;
        for (int k = 0; k < g.K; ++k) {
          size_t i = (size_t)k * g.C + b;
          float m = mass[i];
          if (!(m > 0.f)) continue;
          float d[3], dist[3], Cl[9], v[3];
          for (int a = 0; a < 3; ++a) d[a] = pos[a * KC + i] - cb[a];
          float w = mpm::tap_weight(r0, r1, r2, d);
          dist[0] = (float)(r0 - 1) - d[0];
          dist[1] = (float)(r1 - 1) - d[1];
          dist[2] = (float)(r2 - 1) - d[2];
          for (int a = 0; a < 9; ++a) Cl[a] = mpm::load_vc(Cm, a * KC + i);
          for (int a = 0; a < 3; ++a) v[a] = mpm::load_vc(vel, a * KC + i);
          float mass_c = w * m;
          pm = pm + mass_c;
          p0 = p0 + mass_c * (v[0] + mpm::matvec_row(Cl, 0, dist));
          p1 = p1 + mass_c * (v[1] + mpm::matvec_row(Cl, 1, dist));
          p2 = p2 + mass_c * (v[2] + mpm::matvec_row(Cl, 2, dist));
        }
        gm = gm + pm;
        g0 = g0 + p0;
        g1 = g1 + p1;
        g2 = g2 + p2;
      }
  gmass[c] = gm;
  gmom[0 * (size_t)g.C + c] = g0;
  gmom[1 * (size_t)g.C + c] = g1;
  gmom[2 * (size_t)g.C + c] = g2;
}

__global__ void p2g_coef(const float* __restrict__ pos, const float* __restrict__ mass,
                         const float* __restrict__ gmass, float* __restrict__ a_p,
                         float* __restrict__ b_mu, P2GParams p) {
  const Geom g = p.g;
  const size_t KC = (size_t)g.K * g.C;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= KC) return;
  float m = mass[i];
  if (!(m > 0.f)) {
    a_p[i] = 0.f;
    b_mu[i] = 0.f;
    return;
  }
  int c = (int)(i % g.C);
  int x, y, z;
  mpm::cell_xyz(g, c, x, y, z);
  const int xyz[3] = {x, y, z};
  float d[3];
  for (int a = 0; a < 3; ++a) d[a] = pos[a * KC + i] - ((float)xyz[a] + 0.5f);
  float density = 0.f;
  for (int tx = 0; tx < 3; ++tx)
    for (int ty = 0; ty < 3; ++ty)
      for (int tz = 0; tz < 3; ++tz) {
        int nx_ = x + tx - 1, ny_ = y + ty - 1, nz_ = z + tz - 1;
        if (!mpm::in_grid(g, nx_, ny_, nz_)) continue;
        float gm = gmass[mpm::flat(g, nx_, ny_, nz_)];
        density = density + mpm::tap_weight(tx, ty, tz, d) * gm;
      }
  float volume = m / density;
  float ratio = density / p.rest_density;
  float rp = p.eos_pow_n > 0 ? pow_static(ratio, p.eos_pow_n) : powf(ratio, p.eos_pow_f);
  float pressure = fmaxf(p.pressure_floor, p.eos_k * (rp - 1.0f));
  float coef = (-4.0f * p.dt) * volume;
  a_p[i] = coef * (-pressure);
  b_mu[i] = coef * p.mu;
}

template <typename VC>
__global__ void p2g_force_grid(const float* __restrict__ pos, const VC* __restrict__ Cm,
                               const float* __restrict__ mass, const float* __restrict__ a_p,
                               const float* __restrict__ b_mu, const float* __restrict__ gmass,
                               const float* __restrict__ gmom, float* __restrict__ gvel,
                               P2GParams p) {
  const Geom g = p.g;
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  int x, y, z;
  mpm::cell_xyz(g, c, x, y, z);
  const size_t KC = (size_t)g.K * g.C;
  float acc[3] = {gmom[c], gmom[(size_t)g.C + c], gmom[2 * (size_t)g.C + c]};
  for (int tx = 0; tx < 3; ++tx)
    for (int ty = 0; ty < 3; ++ty)
      for (int tz = 0; tz < 3; ++tz) {
        int bx = x + tx - 1, by = y + ty - 1, bz = z + tz - 1;
        if (!mpm::in_grid(g, bx, by, bz)) continue;
        int b = mpm::flat(g, bx, by, bz);
        const int r0 = 2 - tx, r1 = 2 - ty, r2 = 2 - tz;
        const float cb[3] = {((float)x + 0.5f) + (float)(tx - 1),
                             ((float)y + 0.5f) + (float)(ty - 1),
                             ((float)z + 0.5f) + (float)(tz - 1)};
        float part[3] = {0.f, 0.f, 0.f};
        for (int k = 0; k < g.K; ++k) {
          size_t i = (size_t)k * g.C + b;
          if (!(mass[i] > 0.f)) continue;
          float d[3], dist[3], Cl[9];
          for (int a = 0; a < 3; ++a) d[a] = pos[a * KC + i] - cb[a];
          float w = mpm::tap_weight(r0, r1, r2, d);
          dist[0] = (float)(r0 - 1) - d[0];
          dist[1] = (float)(r1 - 1) - d[1];
          dist[2] = (float)(r2 - 1) - d[2];
          for (int a = 0; a < 9; ++a) Cl[a] = mpm::load_vc(Cm, a * KC + i);
          if (p.legacy_strain) {
            // S = C + C^T - I * C^T: off-diagonals symmetrised, diagonal C_ii
            float S[9];
            for (int r = 0; r < 3; ++r)
              for (int s = 0; s < 3; ++s) {
                float sum = Cl[r * 3 + s] + Cl[s * 3 + r];
                S[r * 3 + s] = r == s ? sum - Cl[s * 3 + r] : sum;
              }
            const float ap = a_p[i], bm = b_mu[i];
            for (int r = 0; r < 3; ++r) {
              float sd = mpm::matvec_row(S, r, dist);
              part[r] = part[r] + w * (ap * dist[r] + bm * sd);
            }
          } else {
            const float ap = a_p[i], bm = b_mu[i];
            for (int r = 0; r < 3; ++r) {
              float sd = mpm::matvec_row(Cl, r, dist) + mpm::matvec_t_row(Cl, r, dist);
              part[r] = part[r] + w * (ap * dist[r] + bm * sd);
            }
          }
        }
        acc[0] = acc[0] + part[0];
        acc[1] = acc[1] + part[1];
        acc[2] = acc[2] + part[2];
      }

  // grid update (ops/grid.update_grid)
  float m = gmass[c];
  bool has_mass = m > 0.f;
  float safe = has_mass ? m : 1.0f;
  float v[3];
  for (int a = 0; a < 3; ++a) v[a] = acc[a] / safe + p.dt * p.gravity[a];
  const int idx[3] = {x, y, z};
  bool band[3];
  for (int a = 0; a < 3; ++a)
    band[a] = idx[a] < p.band_lo || idx[a] > p.dres[a] - 1 - p.band_hi;
  if (p.bc == 0) {
    for (int a = 0; a < 3; ++a)
      if (band[a]) v[a] = 0.f;
  } else if (p.bc == 1) {
    if (band[0] || band[1] || band[2]) v[0] = v[1] = v[2] = 0.f;
  } else {
    for (int a = 0; a < 3; ++a) {
      if (!band[a]) continue;
      for (int r = 0; r < 3; ++r) v[r] = (r == a) ? 0.f : v[r] * p.friction;
    }
  }
  for (int a = 0; a < 3; ++a) gvel[a * (size_t)g.C + c] = has_mass ? v[a] : 0.f;
}

inline unsigned blocks_for(size_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <typename VC>
cudaError_t launch(const float* pos, const void* vel, const void* Cm, const float* mass,
                   float* gmass, float* gmom, float* a_p, float* b_mu, float* gvel,
                   const P2GParams& p, cudaStream_t stream) {
  const int T = 256;
  const size_t KC = (size_t)p.g.K * p.g.C;
  p2g_mass_mom<VC><<<blocks_for(p.g.C, T), T, 0, stream>>>(
      pos, (const VC*)vel, (const VC*)Cm, mass, gmass, gmom, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p2g_coef<<<blocks_for(KC, T), T, 0, stream>>>(pos, mass, gmass, a_p, b_mu, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p2g_force_grid<VC><<<blocks_for(p.g.C, T), T, 0, stream>>>(
      pos, (const VC*)Cm, mass, a_p, b_mu, gmass, gmom, gvel, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Parameter block size, checked by the Python wrapper against its ctypes
// mirror of P2GParams.
int p2g_update_params_size() { return (int)sizeof(P2GParams); }

// vc_bf16: vel and C are stored as bfloat16 (else float32). Scratch: gmom
// [3, C], a_p [K, C], b_mu [K, C]. Outputs: gmass [C], gvel [3, C].
int p2g_update(const void* params, const float* pos, const void* vel, const void* Cm,
               const float* mass, float* gmass, float* gmom, float* a_p, float* b_mu,
               float* gvel, int vc_bf16, void* stream) {
  const P2GParams& p = *(const P2GParams*)params;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = vc_bf16
      ? launch<__nv_bfloat16>(pos, vel, Cm, mass, gmass, gmom, a_p, b_mu, gvel, p, s)
      : launch<float>(pos, vel, Cm, mass, gmass, gmom, a_p, b_mu, gvel, p, s);
  return (int)err;
}

}  // extern "C"
