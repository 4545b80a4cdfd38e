// The bucket-state kernels for D = 2 or 3 axes, shared by kernel P
// (p2g_update.cu), kernel F (g2p_migrate.cu), the 2D substep
// (substep2d.cu) and the per-pass kernels A, B, D and E (planes.cu), each
// of which instantiates them for its D, storage type and grid type (float,
// or int32 fixed point: GridCoding) and launches them with its own
// parameter block.
//
// What they compute is mpm_tpu/ops/bucketed.py: p2g_bucketed, the grid
// update (ops/grid.update_grid), g2p_bucketed and migrate. The bucket layout
// makes every pass a gather: a grid node is owned by one thread that sums
// its 3^D neighbour buckets' slots in the plain version's order (taps in
// (x, y[, z]) order, slots in slot order), and a slot by one thread that
// reads its 3^D nodes. There are no float atomics, so the results are the
// same run to run; counters are int32 atomicAdds, exact in any order.
// Neighbours come from D-dimensional coordinates with bounds checks; the
// plain version's flat offsets wrap rows instead, and the two agree because
// the position clamps keep every axis's edge planes empty (the wrappers
// refuse looser clamps).
//
// Every kernel also runs on one slab of an x-slab decomposition (a Slab,
// mpm_common.cuh: the global offset x0 of physical coordinates, a grid go
// planes wider than the state on each side, and the planes whose counter
// events count); whole_grid() is the whole grid, and with it each kernel
// computes what it computed before slabs existed, operation for operation.
//
//   p2g_mass_mom    one thread per cell: pass-1 mass and APIC momentum.
//   p2g_coef        one thread per slot: density gather, EOS, the a_p and
//                   b_mu force coefficients.
//   p2g_force_grid  one thread per cell: pass-2 force (legacy strain
//                   optional) added to the momentum, then the grid update:
//                   momentum over mass, gravity, slip / stick / friction
//                   bands against the true domain dres.
//   p2g_force       the same pass 2 from zero, without the update (B).
//   g2p_tail        one thread per slot: G2P gather, C = 4B, then the tail
//                   of bucketed.g2p_bucketed: advect, clamp against dres,
//                   interactions, wall springs, the CFL clamp and its count;
//                   empty slots parked at the cell centre. vel and C round
//                   to the storage type only at the store.
//   g2p_vc          the same gather, vel and C = 4B only, zero at empty
//                   slots (D).
// The two gathers are device functions (p2g_force_gather, g2p_gather)
// shared by their two users, so one source keeps the rounding. A
// fixed-point grid encodes each slot's contribution (bucketed._encode) and
// decodes where the plain version decodes.
//   migrate_reject  one thread per source cell, per axis phase: the
//                   conservative rule occ0(dest) + i < K, where a
//                   left-mover's i also counts the right-movers of cell - 2,
//                   plus the optional ceiling band on y. It writes the axis
//                   position of every slot to a scratch row, clamped back
//                   into the cell for rejected movers.
//   migrate_select  one thread per destination cell: its 3K candidates in
//                   [stay, from-left, from-right] slot order, the first K
//                   written out of place, the rest zeroed (ids -1), any
//                   excess counted in `lost`.
#pragma once

#include <type_traits>

#include "mpm_common.cuh"

namespace mpm {

constexpr int MAX_INTER = 8;  // interactions a call takes
template <int D>
constexpr int INTER_VALS = D + 4;  // centre [D], radius, strength, inv_falloff, active

// The coordinate and extent of cell c along `axis` (a runtime value).
template <int D>
__device__ __forceinline__ int axis_extent(const GridGeom<D>& g, int axis) {
  int e = g.n[0];
  for (int a = 1; a < D; ++a)
    if (axis == a) e = g.n[a];
  return e;
}

template <int D>
__device__ __forceinline__ int axis_coord(const GridGeom<D>& g, int c, int axis) {
  return (c / axis_stride(g, axis)) % axis_extent(g, axis);
}

__device__ __forceinline__ float axis_delta(float pa, int coord) {
  return fminf(fmaxf(floorf(pa) - (float)coord, -1.0f), 1.0f);
}

// The fixed-point multiplier of a parameter block; float grids have none.
template <typename GT, class Params>
__device__ __forceinline__ float grid_mult(const Params& p) {
  if constexpr (std::is_same<GT, int>::value)
    return p.fixed_mult;
  else
    return 1.0f;
}

// Params: the source's parameter block, with the fields named below. GT:
// the grid's element type, float or int (fixed point, GridCoding).
// One thread per grid node c of grid_geom(p.g, s); x is the node's state
// coordinate (go planes below its grid plane), so a halo node gathers the
// state planes within its reach.
template <int D, typename VC, typename GT, class Params>
__global__ void p2g_mass_mom(const float* __restrict__ pos, const VC* __restrict__ vel,
                             const VC* __restrict__ Cm, const float* __restrict__ mass,
                             GT* __restrict__ gmass, GT* __restrict__ gmom, Params p, Slab s) {
  using G = GridCoding<GT>;
  const GridGeom<D> g = p.g;
  const GridGeom<D> gg = grid_geom(g, s);
  const float mult = grid_mult<GT>(p);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= gg.C) return;
  int x[D];
  cell_coords(gg, c, x);
  x[0] -= s.go;
  const size_t KC = (size_t)g.K * g.C;
  GT gm = 0, gp[D];
  for (int a = 0; a < D; ++a) gp[a] = 0;
#pragma unroll
  for (int t = 0; t < NTAPS<D>; ++t) {
    // bucket b = c + (t - 1); its particles reach node c with tap 2 - t
    int tt[D], bx[D], r[D];
    float cb[D];
    tap_digits(t, tt);
    for (int a = 0; a < D; ++a) {
      bx[a] = x[a] + tt[a] - 1;
      r[a] = 2 - tt[a];
      cb[a] = (global_coord(s, a, x[a]) + 0.5f) + (float)(tt[a] - 1);
    }
    if (!in_grid(g, bx)) continue;
    const int b = flat(g, bx);
    GT pm = 0, pp[D];
    for (int a = 0; a < D; ++a) pp[a] = 0;
    for (int k = 0; k < g.K; ++k) {
      const size_t i = (size_t)k * g.C + b;
      const float m = mass[i];
      if (!(m > 0.f)) continue;
      float d[D], dist[D], Cl[D * D], v[D];
      for (int a = 0; a < D; ++a) d[a] = pos[a * KC + i] - cb[a];
      const float w = tap_weight(r, d);
      for (int a = 0; a < D; ++a) dist[a] = (float)(r[a] - 1) - d[a];
      for (int a = 0; a < D * D; ++a) Cl[a] = load_vc(Cm, a * KC + i);
      for (int a = 0; a < D; ++a) v[a] = load_vc(vel, a * KC + i);
      const float mass_c = w * m;
      pm = G::add(pm, G::enc(mass_c, mult));
      for (int a = 0; a < D; ++a)
        pp[a] = G::add(pp[a], G::enc(mass_c * (v[a] + matvec_row<D>(Cl, a, dist)), mult));
    }
    gm = G::add(gm, pm);
    for (int a = 0; a < D; ++a) gp[a] = G::add(gp[a], pp[a]);
  }
  gmass[c] = gm;
  for (int a = 0; a < D; ++a) gmom[a * (size_t)gg.C + c] = gp[a];
}

// gmass on grid_geom(p.g, s).
template <int D, typename GT, class Params>
__global__ void p2g_coef(const float* __restrict__ pos, const float* __restrict__ mass,
                         const GT* __restrict__ gmass, float* __restrict__ a_p,
                         float* __restrict__ b_mu, Params p, Slab s) {
  using G = GridCoding<GT>;
  const GridGeom<D> g = p.g;
  const GridGeom<D> gg = grid_geom(g, s);
  const float mult = grid_mult<GT>(p);
  const size_t KC = (size_t)g.K * g.C;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= KC) return;
  const float m = mass[i];
  if (!(m > 0.f)) {
    a_p[i] = 0.f;
    b_mu[i] = 0.f;
    return;
  }
  int x[D];
  cell_coords(g, (int)(i % g.C), x);
  float d[D];
  for (int a = 0; a < D; ++a) d[a] = pos[a * KC + i] - (global_coord(s, a, x[a]) + 0.5f);
  float density = 0.f;
#pragma unroll
  for (int t = 0; t < NTAPS<D>; ++t) {
    int tt[D], nb[D];  // nb: the node on the grid's planes
    tap_digits(t, tt);
    for (int a = 0; a < D; ++a) nb[a] = x[a] + tt[a] - 1;
    nb[0] += s.go;
    if (!in_grid(gg, nb)) continue;
    density = density + tap_weight(tt, d) * G::dec(gmass[flat(gg, nb)], mult);
  }
  const float volume = m / density;
  const float ratio = density / p.rest_density;
  const float rp =
      p.eos_pow_n > 0 ? pow_static(ratio, p.eos_pow_n) : powf(ratio, p.eos_pow_f);
  const float pressure = fmaxf(p.pressure_floor, p.eos_k * (rp - 1.0f));
  const float coef = (-4.0f * p.dt) * volume;
  a_p[i] = coef * (-pressure);
  b_mu[i] = coef * p.mu;
}

// Pass 2 at node x (state coordinates): the force contributions (legacy
// strain optional) of the 3^D buckets around it, each bucket's slots
// summed in slot order, added to acc tap by tap. Shared by kernel P, its
// sharded stage 2 and the per-pass kernel B.
template <int D, typename VC, typename GT, class Params>
__device__ __forceinline__ void p2g_force_gather(const int (&x)[D], const float* __restrict__ pos,
                                                 const VC* __restrict__ Cm,
                                                 const float* __restrict__ mass,
                                                 const float* __restrict__ a_p,
                                                 const float* __restrict__ b_mu, GT (&acc)[D],
                                                 const Params& p, const Slab& s) {
  using G = GridCoding<GT>;
  const GridGeom<D>& g = p.g;
  const float mult = grid_mult<GT>(p);
  const size_t KC = (size_t)g.K * g.C;
#pragma unroll
  for (int t = 0; t < NTAPS<D>; ++t) {
    int tt[D], bx[D], r[D];
    float cb[D];
    tap_digits(t, tt);
    for (int a = 0; a < D; ++a) {
      bx[a] = x[a] + tt[a] - 1;
      r[a] = 2 - tt[a];
      cb[a] = (global_coord(s, a, x[a]) + 0.5f) + (float)(tt[a] - 1);
    }
    if (!in_grid(g, bx)) continue;
    const int b = flat(g, bx);
    GT part[D];
    for (int a = 0; a < D; ++a) part[a] = 0;
    for (int k = 0; k < g.K; ++k) {
      const size_t i = (size_t)k * g.C + b;
      if (!(mass[i] > 0.f)) continue;
      float d[D], dist[D], Cl[D * D], S[D * D];
      for (int a = 0; a < D; ++a) d[a] = pos[a * KC + i] - cb[a];
      const float w = tap_weight(r, d);
      for (int a = 0; a < D; ++a) dist[a] = (float)(r[a] - 1) - d[a];
      for (int a = 0; a < D * D; ++a) Cl[a] = load_vc(Cm, a * KC + i);
      if (p.legacy_strain) {
        // S = C + C^T - I * C^T (MLSMPM2DFluid.cs:276-281): off-diagonal
        // entries symmetrised, the diagonal C_ii left unscaled
        for (int u = 0; u < D; ++u)
          for (int v = 0; v < D; ++v) {
            const float sum = Cl[u * D + v] + Cl[v * D + u];
            S[u * D + v] = u == v ? sum - Cl[v * D + u] : sum;
          }
      }
      const float ap = a_p[i], bm = b_mu[i];
      for (int a = 0; a < D; ++a) {
        const float sd = p.legacy_strain
                             ? matvec_row<D>(S, a, dist)
                             : matvec_row<D>(Cl, a, dist) + matvec_t_row<D>(Cl, a, dist);
        part[a] = G::add(part[a], G::enc(w * (ap * dist[a] + bm * sd), mult));
      }
    }
    for (int a = 0; a < D; ++a) acc[a] = G::add(acc[a], part[a]);
  }
}

// Kernel P's last launch: pass 2 added to the pass-1 momentum, then the
// grid update. A fixed-point grid is decoded for the update and its
// velocity encoded again. One thread per node of grid_geom(p.g, s).
template <int D, typename VC, typename GT, class Params>
__global__ void p2g_force_grid(const float* __restrict__ pos, const VC* __restrict__ Cm,
                               const float* __restrict__ mass, const float* __restrict__ a_p,
                               const float* __restrict__ b_mu, const GT* __restrict__ gmass,
                               const GT* __restrict__ gmom, GT* __restrict__ gvel, Params p,
                               Slab s) {
  using G = GridCoding<GT>;
  const GridGeom<D> gg = grid_geom(p.g, s);
  const float mult = grid_mult<GT>(p);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= gg.C) return;
  int x[D];
  cell_coords(gg, c, x);
  x[0] -= s.go;
  GT acc[D];
  for (int a = 0; a < D; ++a) acc[a] = gmom[a * (size_t)gg.C + c];
  p2g_force_gather<D, VC, GT>(x, pos, Cm, mass, a_p, b_mu, acc, p, s);

  // grid update (ops/grid.update_grid)
  const float m = G::dec(gmass[c], mult);
  const bool has_mass = m > 0.f;
  const float safe = has_mass ? m : 1.0f;
  float v[D];
  bool band[D], any_band = false;
  for (int a = 0; a < D; ++a) {
    v[a] = G::dec(acc[a], mult) / safe + p.dt * p.gravity[a];
    const int xa = a == 0 ? x[a] + s.x0 : x[a];  // the global index
    band[a] = xa < p.band_lo || xa > p.dres[a] - 1 - p.band_hi;
    any_band = any_band || band[a];
  }
  if (p.bc == 0) {  // slip
    for (int a = 0; a < D; ++a)
      if (band[a]) v[a] = 0.f;
  } else if (p.bc == 1) {  // stick
    if (any_band)
      for (int a = 0; a < D; ++a) v[a] = 0.f;
  } else {  // friction
    for (int a = 0; a < D; ++a) {
      if (!band[a]) continue;
      for (int r = 0; r < D; ++r) v[r] = (r == a) ? 0.f : v[r] * p.friction;
    }
  }
  for (int a = 0; a < D; ++a)
    gvel[a * (size_t)gg.C + c] = has_mass ? G::enc(v[a], mult) : (GT)0;
}

// The per-pass kernel B's last launch: pass 2 from zero, no grid update.
template <int D, typename VC, typename GT, class Params>
__global__ void p2g_force(const float* __restrict__ pos, const VC* __restrict__ Cm,
                          const float* __restrict__ mass, const float* __restrict__ a_p,
                          const float* __restrict__ b_mu, GT* __restrict__ gmom2, Params p) {
  const GridGeom<D> g = p.g;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  int x[D];
  cell_coords(g, c, x);
  GT acc[D];
  for (int a = 0; a < D; ++a) acc[a] = 0;
  p2g_force_gather<D, VC, GT>(x, pos, Cm, mass, a_p, b_mu, acc, p, whole_grid());
  for (int a = 0; a < D; ++a) gmom2[a * (size_t)g.C + c] = acc[a];
}

// G2P at a slot of cell x, at offset d from the cell centre: the grid
// velocities of the 3^D nodes around it summed in tap order into vel and
// B. gvel on grid_geom(g, s). Shared by kernel F's tail and the per-pass
// kernel D.
template <int D, typename GT>
__device__ __forceinline__ void g2p_gather(const GridGeom<D>& g, const int (&x)[D],
                                           const float (&d)[D], const GT* __restrict__ gvel,
                                           float mult, float (&vel)[D], float (&B)[D * D],
                                           const Slab& s) {
  using G = GridCoding<GT>;
  const GridGeom<D> gg = grid_geom(g, s);
  for (int a = 0; a < D; ++a) vel[a] = 0.f;
  for (int a = 0; a < D * D; ++a) B[a] = 0.f;
#pragma unroll
  for (int t = 0; t < NTAPS<D>; ++t) {
    int tt[D], nb[D];
    float dist[D];
    tap_digits(t, tt);
    for (int a = 0; a < D; ++a) {
      nb[a] = x[a] + tt[a] - 1;
      dist[a] = (float)(tt[a] - 1) - d[a];
    }
    nb[0] += s.go;
    if (!in_grid(gg, nb)) continue;
    const int n = flat(gg, nb);
    const float w = tap_weight(tt, d);
    for (int a = 0; a < D; ++a) {
      const float wv = w * G::dec(gvel[a * (size_t)gg.C + n], mult);
      vel[a] = vel[a] + wv;
      for (int b = 0; b < D; ++b) B[a * D + b] = B[a * D + b] + wv * dist[b];
    }
  }
}

// cfl: the cfl_clamped counter, added to (on the planes s counts).
template <int D, typename VC, typename GT, class Params>
__global__ void g2p_tail(const float* __restrict__ pos, const float* __restrict__ mass,
                         const GT* __restrict__ gvel, float* __restrict__ pos_out,
                         VC* __restrict__ vel_out, VC* __restrict__ C_out,
                         int* __restrict__ cfl, Params p, Slab s) {
  const GridGeom<D> g = p.g;
  const size_t KC = (size_t)g.K * g.C;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= KC) return;
  int x[D];
  cell_coords(g, (int)(i % g.C), x);
  float center[D];
  for (int a = 0; a < D; ++a) center[a] = global_coord(s, a, x[a]) + 0.5f;
  if (!(mass[i] > 0.f)) {  // park empty slots at the cell centre
    for (int a = 0; a < D; ++a) {
      pos_out[a * KC + i] = center[a];
      store_vc(vel_out, a * KC + i, 0.f);
    }
    for (int a = 0; a < D * D; ++a) store_vc(C_out, a * KC + i, 0.f);
    return;
  }
  float d[D], vel[D], B[D * D];
  for (int a = 0; a < D; ++a) d[a] = pos[a * KC + i] - center[a];
  g2p_gather<D, GT>(g, x, d, gvel, grid_mult<GT>(p), vel, B, s);

  float ps[D];
  for (int a = 0; a < D; ++a) {
    const float q = pos[a * KC + i] + vel[a] * p.dt;
    ps[a] = fminf(fmaxf(q, p.clamp_lo), (float)p.dres[a] - p.clamp_hi_offset);
  }

  for (int j = 0; j < p.n_inter; ++j) {  // ops/interact.apply_interactions
    const float* it = p.inter + j * INTER_VALS<D>;
    const float radius = it[D], strength = it[D + 1], inv_falloff = it[D + 2];
    float dd[D];
    for (int a = 0; a < D; ++a) dd[a] = ps[a] - it[a];
    float r2 = dd[0] * dd[0];
    for (int a = 1; a < D; ++a) r2 = r2 + dd[a] * dd[a];
    const bool inside = (r2 < radius * radius) && (it[D + 3] > 0.f);
    const float norm = sqrtf(r2);
    const float safe = norm > 0.f ? norm : 1.0f;
    const float falloff = 1.0f + inv_falloff * (radius / safe - 1.0f);
    const float sf = strength * falloff;
    float force[D];
    bool finite = true;
    for (int a = 0; a < D; ++a) {
      force[a] = (dd[a] / safe) * sf;
      finite = finite && isfinite(force[a]);
    }
    if (inside && norm > 0.f && finite)
      for (int a = 0; a < D; ++a) vel[a] = vel[a] + force[a];
  }

  bool moved = false;
  for (int a = 0; a < D; ++a) {
    // predictive wall spring (g2p.glsl:131-140)
    const float x_n = ps[a] + vel[a];
    const float hi = (float)p.dres[a] - p.wall_max_offset;
    vel[a] = vel[a] + p.wall_stiffness * (fmaxf(p.wall_min - x_n, 0.f) + fminf(hi - x_n, 0.f));
    // CFL bucket clamp: stay within the +-1-cell migration range
    const float cell = center[a] - 0.5f;
    const float q = fminf(fmaxf(ps[a], cell - 1.0f), (cell + 2.0f) - CFL_EPS);
    moved = moved || (q != ps[a]);
    pos_out[a * KC + i] = q;
    store_vc(vel_out, a * KC + i, vel[a]);
  }
  for (int a = 0; a < D * D; ++a) store_vc(C_out, a * KC + i, 4.0f * B[a]);
  if (moved && counted(s, x[0])) atomicAdd(cfl, 1);
}

// The per-pass kernel D: G2P velocity and C = 4B, zero at empty slots, no
// tail.
template <int D, typename VC, typename GT, class Params>
__global__ void g2p_vc(const float* __restrict__ pos, const float* __restrict__ mass,
                       const GT* __restrict__ gvel, VC* __restrict__ vel_out,
                       VC* __restrict__ C_out, Params p) {
  const GridGeom<D> g = p.g;
  const size_t KC = (size_t)g.K * g.C;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= KC) return;
  if (!(mass[i] > 0.f)) {
    for (int a = 0; a < D; ++a) store_vc(vel_out, a * KC + i, 0.f);
    for (int a = 0; a < D * D; ++a) store_vc(C_out, a * KC + i, 0.f);
    return;
  }
  int x[D];
  cell_coords(g, (int)(i % g.C), x);
  float d[D], vel[D], B[D * D];
  for (int a = 0; a < D; ++a) d[a] = pos[a * KC + i] - ((float)x[a] + 0.5f);
  g2p_gather<D, GT>(g, x, d, gvel, grid_mult<GT>(p), vel, B, whole_grid());
  for (int a = 0; a < D; ++a) store_vc(vel_out, a * KC + i, vel[a]);
  for (int a = 0; a < D * D; ++a) store_vc(C_out, a * KC + i, 4.0f * B[a]);
}

// bucketed.reject_overflow for the cells of one axis phase. ceil_band_y >=
// 0: upward y-moves out of cells with y >= ceil_band_y are rejected too and
// counted in `ceiling` (the air window's ceiling; -1 for none). Both
// counters count on the planes s counts.
template <int D>
__global__ void migrate_reject(const float* __restrict__ pos, const float* __restrict__ mass,
                               float* __restrict__ R, int* __restrict__ deferred,
                               int* __restrict__ ceiling, int axis, int ceil_band_y,
                               GridGeom<D> g, Slab s) {
  const size_t KC = (size_t)g.K * g.C;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  const int co = axis_coord(g, c, axis);
  const int cg = axis == 0 ? co + s.x0 : co;  // the global coordinate
  const int st = axis_stride(g, axis);
  const int n_a = axis_extent(g, axis);
  const float* pa = pos + axis * KC;

  int occ0_r = 0, occ0_l = 0, nmovr_l2 = 0;
  for (int k = 0; k < g.K; ++k) {
    const size_t row = (size_t)k * g.C;
    if (co + 1 < n_a && mass[row + c + st] > 0.f) ++occ0_r;
    if (co - 1 >= 0 && mass[row + c - st] > 0.f) ++occ0_l;
    if (co - 2 >= 0 && mass[row + c - 2 * st] > 0.f &&
        axis_delta(pa[row + c - 2 * st], cg - 2) == 1.0f)
      ++nmovr_l2;
  }
  const bool ceil_band = axis == 1 && ceil_band_y >= 0 && co >= ceil_band_y;
  int rank_r = 0, rank_l = 0, n_rej = 0, n_ceil = 0;
  for (int k = 0; k < g.K; ++k) {
    const size_t i = (size_t)k * g.C + c;
    float xa = pa[i];
    if (mass[i] > 0.f) {
      const float delta = axis_delta(xa, cg);
      bool rej = false;
      if (delta == 1.0f) {
        rej = occ0_r + rank_r >= g.K;
        ++rank_r;
        if (!rej && ceil_band) {
          rej = true;
          ++n_ceil;
        }
      } else if (delta == -1.0f) {
        rej = occ0_l + nmovr_l2 + rank_l >= g.K;
        ++rank_l;
      }
      if (rej) {
        xa = fminf(fmaxf(xa, (float)cg), ((float)cg + 1.0f) - CFL_EPS);
        ++n_rej;
      }
    }
    R[i] = xa;
  }
  if (!counted(s, axis_coord(g, c, 0))) return;
  if (n_rej) atomicAdd(deferred, n_rej);
  if (n_ceil) atomicAdd(ceiling, n_ceil);
}

// bucketed._migrate_axis after rejection: vel and C move as raw bits (T is
// uint16_t for bf16 storage, uint32_t for float32).
template <int D, typename T>
__global__ void migrate_select(const float* __restrict__ pos, const float* __restrict__ R,
                               const T* __restrict__ vel, const T* __restrict__ Cm,
                               const float* __restrict__ mass, const int* __restrict__ ids,
                               float* __restrict__ pos_o, T* __restrict__ vel_o,
                               T* __restrict__ C_o, float* __restrict__ mass_o,
                               int* __restrict__ ids_o, int* __restrict__ lost, int axis,
                               GridGeom<D> g, Slab s) {
  const size_t KC = (size_t)g.K * g.C;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  const int co = axis_coord(g, c, axis);
  const int st = axis_stride(g, axis);
  const int n_a = axis_extent(g, axis);
  const int xg = axis == 0 ? s.x0 : 0;  // local to global coordinate

  int n = 0;
  // candidates: own slots staying (shift 0), the left neighbour's slots
  // moving +1, the right neighbour's moving -1
  for (int src_i = 0; src_i < 3; ++src_i) {
    const int shift = src_i == 0 ? 0 : (src_i == 1 ? 1 : -1);
    const int src_co = co - shift;
    if (src_co < 0 || src_co >= n_a) continue;
    const int src = c - shift * st;
    for (int k = 0; k < g.K; ++k) {
      const size_t i = (size_t)k * g.C + src;
      if (!(mass[i] > 0.f) || axis_delta(R[i], src_co + xg) != (float)shift) continue;
      if (n < g.K) {
        const size_t o = (size_t)n * g.C + c;
        for (int a = 0; a < D; ++a) {
          pos_o[a * KC + o] = a == axis ? R[i] : pos[a * KC + i];
          vel_o[a * KC + o] = vel[a * KC + i];
        }
        for (int a = 0; a < D * D; ++a) C_o[a * KC + o] = Cm[a * KC + i];
        mass_o[o] = mass[i];
        ids_o[o] = ids[i];
      }
      ++n;
    }
  }
  for (int j = n; j < g.K; ++j) {
    const size_t o = (size_t)j * g.C + c;
    for (int a = 0; a < D; ++a) {
      pos_o[a * KC + o] = 0.f;
      vel_o[a * KC + o] = 0;
    }
    for (int a = 0; a < D * D; ++a) C_o[a * KC + o] = 0;
    mass_o[o] = 0.f;
    ids_o[o] = -1;
  }
  if (n > g.K && counted(s, axis_coord(g, c, 0))) atomicAdd(lost, n - g.K);
}

constexpr int THREADS = 256;

// Kernel P's first launch: pass-1 mass and momentum on the nodes of
// grid_geom(p.g, s). The sharded stage 1 (p2g_shard.cu) is this launch alone.
template <int D, typename VC, typename GT, class Params>
cudaError_t launch_p2g_pass1(const Params& p, const float* pos, const VC* vel, const VC* Cm,
                             const float* mass, GT* gmass, GT* gmom, cudaStream_t stream,
                             const Slab& s = whole_grid()) {
  p2g_mass_mom<D, VC, GT><<<blocks_for(grid_geom(p.g, s).C, THREADS), THREADS, 0, stream>>>(
      pos, vel, Cm, mass, gmass, gmom, p, s);
  return cudaGetLastError();
}

// Kernel P's last two launches: the force coefficients from gmass, then
// pass 2 on gmom and the grid update into gvel. The sharded stage 2
// (p2g_shard.cu) is these two launches.
template <int D, typename VC, typename GT, class Params>
cudaError_t launch_p2g_pass2(const Params& p, const float* pos, const VC* Cm, const float* mass,
                             const GT* gmass, const GT* gmom, float* a_p, float* b_mu, GT* gvel,
                             cudaStream_t stream, const Slab& s = whole_grid()) {
  const size_t KC = (size_t)p.g.K * p.g.C;
  p2g_coef<D, GT><<<blocks_for(KC, THREADS), THREADS, 0, stream>>>(pos, mass, gmass, a_p, b_mu,
                                                                   p, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p2g_force_grid<D, VC, GT><<<blocks_for(grid_geom(p.g, s).C, THREADS), THREADS, 0, stream>>>(
      pos, Cm, mass, a_p, b_mu, gmass, gmom, gvel, p, s);
  return cudaGetLastError();
}

// Kernel P's chain on `stream`: pos, vel, C and mass in; gmass [C] and gvel
// [D, C] out (GT float, or int for a fixed-point grid); gmom [D, C], a_p and
// b_mu [K, C] are scratch.
template <int D, typename VC, typename GT, class Params>
cudaError_t launch_p2g(const Params& p, const float* pos, const VC* vel, const VC* Cm,
                       const float* mass, GT* gmass, GT* gmom, float* a_p, float* b_mu,
                       GT* gvel, cudaStream_t stream) {
  cudaError_t err = launch_p2g_pass1<D>(p, pos, vel, Cm, mass, gmass, gmom, stream);
  if (err != cudaSuccess) return err;
  return launch_p2g_pass2<D>(p, pos, Cm, mass, gmass, gmom, a_p, b_mu, gvel, stream);
}

template <int D, typename VC, typename GT, class Params>
cudaError_t launch_g2p_tail(const Params& p, const float* pos, const float* mass,
                            const GT* gvel, float* pos_out, VC* vel_out, VC* C_out, int* cfl,
                            cudaStream_t stream, const Slab& s = whole_grid()) {
  const size_t KC = (size_t)p.g.K * p.g.C;
  g2p_tail<D, VC, GT><<<blocks_for(KC, THREADS), THREADS, 0, stream>>>(
      pos, mass, gvel, pos_out, vel_out, C_out, cfl, p, s);
  return cudaGetLastError();
}

// One bucket state's arrays; vel and C as T (raw bits in migration).
template <typename T>
struct StateBuf {
  float* pos;
  T* vel;
  T* C;
  float* mass;
  int* ids;
};

// bucketed.migrate on `stream`: one reject/select phase per axis, the last
// axis first, each out of place. The first phase reads `src` and writes
// out0, the next reads that and writes out1, and so on in turns; R is a
// [K, C] scratch row.
template <int D, typename T>
cudaError_t launch_migrate(const GridGeom<D>& g, StateBuf<T> src, StateBuf<T> out0,
                           StateBuf<T> out1, float* R, int* lost, int* deferred,
                           int* ceiling, int ceil_band_y, cudaStream_t stream,
                           const Slab& s = whole_grid()) {
  StateBuf<T> dst = out0;
  for (int ph = 0; ph < D; ++ph) {
    const int axis = D - 1 - ph;
    migrate_reject<D><<<blocks_for(g.C, THREADS), THREADS, 0, stream>>>(
        src.pos, src.mass, R, deferred, ceiling, axis, ceil_band_y, g, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    migrate_select<D, T><<<blocks_for(g.C, THREADS), THREADS, 0, stream>>>(
        src.pos, R, src.vel, src.C, src.mass, src.ids, dst.pos, dst.vel, dst.C, dst.mass,
        dst.ids, lost, axis, g, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
    dst = ph % 2 == 0 ? out1 : out0;
  }
  return cudaSuccess;
}

}  // namespace mpm
