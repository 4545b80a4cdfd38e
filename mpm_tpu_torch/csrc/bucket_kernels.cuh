// The bucket-state kernels for D = 2 or 3 axes, shared by kernel P
// (p2g_update.cu), kernel F (g2p_migrate.cu), the 2D substep
// (substep2d.cu) and the per-pass kernels A, B, D and E (planes.cu), each
// of which instantiates them for its D, storage type and grid type (float,
// or int32 fixed point: GridCoding) and launches them with its own
// parameter block.
//
// What they compute is mpm_tpu/ops/bucketed.py: p2g_bucketed, the grid
// update (ops/grid.update_grid), g2p_bucketed and migrate. The bucket layout
// makes every pass a gather: a grid node's sums take its 3^D neighbour
// buckets' slots in the plain version's order (taps in (x, y[, z]) order,
// slots in slot order; the two P2G passes stage a tile's slots first, see
// them), and a slot is owned by one thread that reads its 3^D nodes. There
// are no float atomics, so the results are the same run to run; counters
// are int32 atomicAdds, exact in any order.
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
//   p2g_mass_tile   one block per tile of nodes: each occupied slot of the
//                   tile and its halo loaded once, its contributions added
//                   to the nodes' tap partials in shared memory in slot
//                   order, then each node's partials summed in tap order:
//                   pass-1 mass and APIC momentum.
//   p2g_coef        one thread per slot: density gather, EOS, the a_p and
//                   b_mu force coefficients.
//   p2g_force_tile  one block per tile of nodes, one thread per node: the
//                   tile's and its halo's occupied slots staged in shared
//                   memory once, then the pass-2 force (legacy strain
//                   optional) summed tap by tap in registers and added to
//                   the momentum, then the grid update: momentum over mass,
//                   gravity, slip / stick / friction bands against the true
//                   domain dres (kernel P); or pass 2 from zero without the
//                   update (B).
//   g2p_tail        one thread per slot: G2P gather, C = 4B, then the tail
//                   of bucketed.g2p_bucketed: advect, clamp against dres,
//                   interactions, wall springs, the CFL clamp and its count;
//                   empty slots parked at the cell centre. vel and C round
//                   to the storage type only at the store.
//   g2p_vc          the same gather, vel and C = 4B only, zero at empty
//                   slots (D).
// The G2P gather is a device function (g2p_gather) shared by its two users,
// so one source keeps the rounding. A fixed-point grid encodes each slot's
// contribution (bucketed._encode) and decodes where the plain version
// decodes.
// The migration has two chains. Kernel F's (launch_migrate_codes) moves a
// one-byte code a slot through its axis phases, one launch a phase:
//   g2p_tail        writes each slot's code beside pos, vel and C: occupied,
//                   and on each axis the cell delta of its clamped position
//                   (SlotCode). Phase a moves a slot along axis a only, so
//                   its delta on every later axis is fixed here.
//   migrate_select_codes  one thread per destination cell, per axis phase,
//                   reading the codes of cells c-2 .. c+1 on the phase's
//                   axis: the conservative rule occ0(dest) + i < K for its
//                   own movers and for the movers of its two neighbours into
//                   it (a left-mover's i also counts the right-movers of its
//                   cell - 2), plus the optional ceiling band on y; then its
//                   3K candidates in [stay, from-left, from-right] slot
//                   order, the first K written out of place as a code (the
//                   phase's field now "moved or stayed" or "rejected") and
//                   an index into the migration's input, the rest code 0 and
//                   index -1, any excess counted in `lost`. A thread counts
//                   `deferred` and `ceiling` for its own cell's movers only.
//   migrate_gather_codes  one thread per output slot, after the last phase:
//                   pos, mass, vel, C and ids moved once, through the
//                   composed index; on each axis whose field reads
//                   "rejected" the position clamped into the output cell.
// The per-pass kernel E (planes.cu) and migrate2d (substep2d.cu) keep the
// older chain (launch_migrate), two launches a phase that carry positions
// and masses:
//   migrate_reject  one thread per source cell, per axis phase: the same
//                   rule, writing the axis position of every slot to a
//                   scratch row, clamped back into the cell for rejected
//                   movers.
//   migrate_select  one thread per destination cell: the candidates as
//                   above, moving positions, mass and each slot's index.
//   migrate_gather  one thread per output slot, after the last phase: vel,
//                   C and ids moved once, through the composed index.
// WIDE (K > 64): both selects take the candidates' bits a chunk of 64
// slots at a time.
#pragma once

#include <type_traits>

#include "mpm_common.cuh"

namespace mpm {

// The interactions reach the tail as a device array of INTER_VALS<D>
// floats each, any number of them (the parameter blocks' `inter`, `n_inter`).
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

// Kernel F's slot code: bit 6 set for an occupied slot (an empty one is 0),
// and on axis a the two bits at 2a: before the axis's phase the slot's cell
// delta on it, CODE_UP or CODE_DOWN (0: it stays), after the phase 0, or
// CODE_REJ where the phase kept a mover back in its cell.
struct SlotCode {
  static constexpr unsigned OCC = 0x40, UP = 1, DOWN = 2, REJ = 3;
  __device__ static unsigned field(unsigned code, int axis) { return (code >> (2 * axis)) & 3u; }
  // the field of a delta in {-1, 0, 1}
  __device__ static unsigned of_delta(float delta) {
    return delta == 1.0f ? UP : delta == -1.0f ? DOWN : 0u;
  }
};

// The fixed-point multiplier of a parameter block; float grids have none.
template <typename GT, class Params>
__device__ __forceinline__ float grid_mult(const Params& p) {
  if constexpr (std::is_same<GT, int>::value)
    return p.fixed_mult;
  else
    return 1.0f;
}

// Pass 1 (p2g_mass_tile): one block per tile of grid nodes. A gather by one
// thread a node loses its time reloading each slot's pos, vel, C (converted
// from bf16 each time) and mass once for each of the 3^D nodes it reaches,
// and reading the mass of every slot, empty or not, 3^D times a node. A
// slot's contribution to a node depends only on the slot and the tap digits
// r (node = bucket + r - 1): its offset d from its own bucket's centre is
// the same for every node that reads it. So here each thread owns buckets
// of the tile's halo ((tile + 2)^D buckets): it reads a bucket's masses once
// into an occupancy mask, loads each occupied slot once (the next while it
// adds the current one), computes its axis weights and C * dist products
// once, and what the taps of one leading digit pair share once for each
// pair whose nodes the tile holds, and adds the slot's contribution to each
// node of the tile it reaches into that node's partial for the tap, kept in
// shared memory ([3^D taps][tile nodes] of (mass, momentum)). A partial is fed by one bucket, so by one thread, which adds
// the bucket's slots in slot order from +0; after a barrier each thread, one
// per node, adds its partials in tap order, skipping taps outside the state.
// Those are the operations of the per-node gather in its order, so the
// result is the same bit for bit, and no partial lives in registers.
template <int D>
struct MassTile;
template <>
struct MassTile<3> {
  static constexpr int MIN_BLOCKS = 2;  // per SM: 110.6 KB of partials each
};
template <>
struct MassTile<2> {
  static constexpr int MIN_BLOCKS = 4;
};

// The tile of nodes of both passes' kernels: 2 x 8 x 16 nodes (D=3), 8 x 32
// (D=2), the last axis fastest, so that a warp's lanes hold neighbouring
// nodes or buckets.
template <int D>
__host__ __device__ constexpr int tile_dim(int a) {
  return D == 3 ? (a == 0 ? 2 : a == 1 ? 8 : 16) : (a == 0 ? 8 : 32);
}
template <int D>
__host__ __device__ constexpr int tile_nodes() {
  return D == 3 ? tile_dim<3>(0) * tile_dim<3>(1) * tile_dim<3>(2)
                : tile_dim<2>(0) * tile_dim<2>(1);
}
template <int D>
__host__ __device__ constexpr int tile_buckets() {  // the tile's buckets and their halo
  return D == 3 ? (tile_dim<3>(0) + 2) * (tile_dim<3>(1) + 2) * (tile_dim<3>(2) + 2)
                : (tile_dim<2>(0) + 2) * (tile_dim<2>(1) + 2);
}
// A cell's occupied slots, bit k for slot k: a 32-bit word M when K <= 32,
// a 64-bit one when K <= 64. Above 64 slots the WIDE variants walk a cell's
// slots a chunk of 64 at a time, chunk after chunk, so a bucket's slots are
// still taken in slot order. The launchers pick M and WIDE by K through
// by_slots, so the kernels at K <= 32 are those of one word and at K <= 64
// those of one 64-bit word.
constexpr int CHUNK = 64;  // slots a WIDE chunk
using Bits64 = unsigned long long;
template <typename MT, bool W>
struct SlotMasks {
  using M = MT;
  static constexpr bool WIDE = W;
};
// f(SlotMasks<M, WIDE>{}) for the masks of K slots.
template <class F>
auto by_slots(int K, F f) {
  return K > CHUNK ? f(SlotMasks<Bits64, true>{})
         : K > 32  ? f(SlotMasks<Bits64, false>{})
                   : f(SlotMasks<unsigned, false>{});
}
__device__ __forceinline__ int slot_first(unsigned m) { return __ffs(m) - 1; }
__device__ __forceinline__ int slot_first(Bits64 m) { return __ffsll((long long)m) - 1; }
__device__ __forceinline__ int slot_count(unsigned m) { return __popc(m); }
__device__ __forceinline__ int slot_count(Bits64 m) { return __popcll(m); }
__device__ __forceinline__ int slot_end(unsigned m) { return 32 - __clz(m); }
__device__ __forceinline__ int slot_end(Bits64 m) { return 64 - __clzll((long long)m); }

template <int D>
__host__ __device__ constexpr size_t mass_tile_smem() {  // a 4-vector partial a tap and node
  return (size_t)NTAPS<D> * tile_nodes<D>() * sizeof(float4);
}

// A partial (mass, momentum[D]) as a 4-vector of the grid's element type.
template <typename GT>
struct Vec4;
template <>
struct Vec4<float> {
  using T = float4;
};
template <>
struct Vec4<int> {
  using T = int4;
};
template <typename V>
__device__ __forceinline__ auto& vec_at(V& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

// One slot's values as stored (vel and C as VC), for loading one slot ahead.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <int D, typename VC>
struct SlotVals {
  float m, p[D];
  VC v[D], c[D * D];
  __device__ __forceinline__ void load(const float* __restrict__ pos, const VC* __restrict__ vel,
                                       const VC* __restrict__ Cm, const float* __restrict__ mass,
                                       size_t i, size_t KC) {
    m = mass[i];
    for (int a = 0; a < D; ++a) {
      p[a] = pos[a * KC + i];
      v[a] = vel[a * KC + i];
    }
    for (int e = 0; e < D * D; ++e) c[e] = Cm[e * KC + i];
  }
};

// Params: the source's parameter block (g; fixed_mult for an int grid). GT:
// the grid's element type, float or int (fixed point, GridCoding). Pass-1
// mass and APIC momentum on the nodes of grid_geom(p.g, s), one block a
// tile, one thread a node; x below is a node's state coordinate (go planes
// below its grid plane), so a halo node gathers the state planes within its
// reach. WIDE (K > 64): the masks hold a chunk of CHUNK slots, and the
// walk below runs once a chunk, in slot order.
template <int D, typename VC, typename GT, class Params, typename M = unsigned,
          bool WIDE = false>
__global__ void __launch_bounds__(tile_nodes<D>(), MassTile<D>::MIN_BLOCKS)
    p2g_mass_tile(const float* __restrict__ pos, const VC* __restrict__ vel,
                  const VC* __restrict__ Cm, const float* __restrict__ mass,
                  GT* __restrict__ gmass, GT* __restrict__ gmom, Params p, Slab s) {
  using G = GridCoding<GT>;
  using V4 = typename Vec4<GT>::T;
  constexpr int NN = tile_nodes<D>(), HB = tile_buckets<D>();
  constexpr int NB = (HB + NN - 1) / NN;  // halo buckets a thread
  extern __shared__ float4 smem[];
  V4* part = reinterpret_cast<V4*>(smem);  // [NTAPS][NN] tap partials
  const GridGeom<D>& g = p.g;
  const GridGeom<D> gg = grid_geom(g, s);
  const float mult = grid_mult<GT>(p);
  const size_t KC = (size_t)g.K * g.C;

  // the tile's first node in state coordinates and the nodes it holds
  // (fewer than its extent at the grid's far ends)
  int t0[D], lim[D];
  {
    int b = blockIdx.x;
    for (int a = D - 1; a >= 0; --a) {
      const int nt = (gg.n[a] + tile_dim<D>(a) - 1) / tile_dim<D>(a);
      const int first = (b % nt) * tile_dim<D>(a);  // on the grid's planes
      lim[a] = min(tile_dim<D>(a), gg.n[a] - first);
      t0[a] = a == 0 ? first - s.go : first;
      b /= nt;
    }
  }
  // halo bucket h (last axis fastest) has halo coordinates hc and is state
  // cell t0 + hc - 1
  auto halo_coords = [&](int h, int (&hc)[D], int (&bx)[D]) {
    for (int a = D - 1; a >= 0; --a) {
      hc[a] = h % (tile_dim<D>(a) + 2);
      h /= tile_dim<D>(a) + 2;
      bx[a] = t0[a] + hc[a] - 1;
    }
  };

  // the occupancy masks of this thread's buckets h = threadIdx.x + j * NN,
  // slots k0 on (bit k - k0): all K, or WIDE, the chunk [k0, k0 + CHUNK)
  M bits[NB];
  auto occupancy = [&](int k0) {
    const int kend = WIDE ? min(g.K, k0 + CHUNK) : g.K;
    bool any = false;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int h = threadIdx.x + j * NN;
      bits[j] = 0;
      if (h >= HB) continue;
      int hc[D], bx[D];
      halo_coords(h, hc, bx);
      if (!in_grid(g, bx)) continue;
      const int b = flat(g, bx);
      for (int k = k0; k < kend; ++k)
        if (mass[(size_t)k * g.C + b] > 0.f) bits[j] |= M(1) << (k - k0);
      any = any || bits[j] != 0;
    }
    return any;
  };
  int held = 0;  // the chunk `bits` holds
  bool any = occupancy(0);
  if constexpr (WIDE)  // a later chunk only while the first ones hold no slot
    for (int k0 = CHUNK; k0 < g.K && !any; k0 += CHUNK) any = occupancy(held = k0);

  // this thread's node
  int lx[D], x[D];
  {
    int r = threadIdx.x;
    for (int a = D - 1; a >= 0; --a) {
      lx[a] = r % tile_dim<D>(a);
      r /= tile_dim<D>(a);
    }
  }
  bool valid = true;
  for (int a = 0; a < D; ++a) {
    x[a] = t0[a] + lx[a];
    valid = valid && lx[a] < lim[a];
  }
  int gx[D];  // the node on the grid's planes
  for (int a = 0; a < D; ++a) gx[a] = a == 0 ? x[a] + s.go : x[a];
  const int c = flat(gg, gx);

  if (!__syncthreads_or(any)) {  // no slot reaches the tile: every sum is +0
    if (!valid) return;
    gmass[c] = 0;
    for (int a = 0; a < D; ++a) gmom[a * (size_t)gg.C + c] = 0;
    return;
  }
  for (int e = threadIdx.x; e < NTAPS<D> * NN; e += NN) part[e] = V4{};
  __syncthreads();

#pragma unroll 1
  for (int k0 = 0; k0 < (WIDE ? g.K : 1); k0 += CHUNK) {  // one pass unless WIDE
    if constexpr (WIDE)
      if (k0 != held) occupancy(held = k0);
#pragma unroll 1
    for (int j = 0; j < NB; ++j) {
      M occ = 0;  // bits[j], selected without indexing the array by j
#pragma unroll
      for (int q = 0; q < NB; ++q)
        if (q == j) occ = bits[q];
      if (!occ) continue;
      int hc[D], bx[D];
      halo_coords(threadIdx.x + j * NN, hc, bx);
      const int b = flat(g, bx);
      // reach[a] bit r: the node bucket + r - 1 (tile coordinate hc + r - 2)
      // on axis a is one the tile holds
      unsigned reach[D];
      float cb[D];  // the bucket's centre
      for (int a = 0; a < D; ++a) {
        reach[a] = 0;
        for (int r = 0; r < 3; ++r) {
          const int l = hc[a] + r - 2;
          if (l >= 0 && l < lim[a]) reach[a] |= 1u << r;
        }
        cb[a] = global_coord(s, a, bx[a]) + 0.5f;
      }
      // the bucket's occupied slots in slot order, each loaded while the one
      // before it is added
      SlotVals<D, VC> nx;
      nx.load(pos, vel, Cm, mass, (size_t)(k0 + slot_first(occ)) * g.C + b, KC);
      while (occ) {
        const SlotVals<D, VC> sv = nx;
        occ &= occ - 1;
        if (occ) nx.load(pos, vel, Cm, mass, (size_t)(k0 + slot_first(occ)) * g.C + b, KC);
        const float m = sv.m;
        float d[D], v[D], cm[D][D], aw[D][3], cz[D][3];
        for (int a = 0; a < D; ++a) {
          d[a] = sv.p[a] - cb[a];
          v[a] = to_float(sv.v[a]);
        }
        for (int e = 0; e < D * D; ++e) cm[e / D][e % D] = to_float(sv.c[e]);
        for (int a = 0; a < D; ++a)
          for (int r = 0; r < 3; ++r) aw[a][r] = axis_weight(r, d[a]);
        // C[row][D-1] * dist on the last axis, dist = (r - 1) - d
        for (int row = 0; row < D; ++row)
          for (int r = 0; r < 3; ++r) cz[row][r] = cm[row][D - 1] * ((float)(r - 1) - d[D - 1]);
        // the taps by their digits on axes 0 .. D-2 (lead l), then on the
        // last axis (z): what a lead's taps share is computed once for it, in
        // the operations' order: the weight product of the lead's axes and
        // matvec_row's sum over their columns
#pragma unroll
        for (int l = 0; l < NTAPS<D> / 3; ++l) {
          int r[D];
          tap_digits(l * 3, r);
          bool in = true;
          for (int a = 0; a < D - 1; ++a) in = in && ((reach[a] >> r[a]) & 1u);
          if (!in) continue;
          float wl = aw[0][r[0]], cl[D];
          for (int a = 1; a < D - 1; ++a) wl = wl * aw[a][r[a]];
          for (int row = 0; row < D; ++row) {
            cl[row] = cm[row][0] * ((float)(r[0] - 1) - d[0]);
            for (int col = 1; col < D - 1; ++col)
              cl[row] = cl[row] + cm[row][col] * ((float)(r[col] - 1) - d[col]);
          }
#pragma unroll
          for (int z = 0; z < 3; ++z) {
            if (!((reach[D - 1] >> z) & 1u)) continue;
            r[D - 1] = z;
            const float mass_c = (wl * aw[D - 1][z]) * m;  // tap_weight, times the mass
            int n = 0, tn = 0;  // the node in the tile; its tap 2 - r
            for (int a = 0; a < D; ++a) {
              n = n * tile_dim<D>(a) + hc[a] + r[a] - 2;
              tn = tn * 3 + 2 - r[a];
            }
            V4 u = part[tn * NN + n];
            u.x = G::add(u.x, G::enc(mass_c, mult));
            for (int a = 0; a < D; ++a)  // matvec_row, then v + C * dist
              vec_at(u, a + 1) =
                  G::add(vec_at(u, a + 1), G::enc(mass_c * (v[a] + (cl[a] + cz[a][z])), mult));
            part[tn * NN + n] = u;
          }
        }
      }
    }
  }
  __syncthreads();
  if (!valid) return;

  GT gm = 0, gp[D];
  for (int a = 0; a < D; ++a) gp[a] = 0;
#pragma unroll
  for (int t = 0; t < NTAPS<D>; ++t) {
    int tt[D], bx[D];
    tap_digits(t, tt);
    for (int a = 0; a < D; ++a) bx[a] = x[a] + tt[a] - 1;
    if (!in_grid(g, bx)) continue;  // a tap outside the state adds nothing
    V4 u = part[t * NN + threadIdx.x];
    gm = G::add(gm, u.x);
    for (int a = 0; a < D; ++a) gp[a] = G::add(gp[a], vec_at(u, a + 1));
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

// Pass 2 (p2g_force_tile): one block per tile of grid nodes. What the
// per-node gather of earlier versions lost its time to was reloading every
// slot's pos, C (converted from bf16 each time), a_p and b_mu once for each
// of the 3^D nodes it reaches, through L1/L2, one slot after another. Here
// the block stages the occupied slots of the tile's buckets and their halo
// ((tile + 2)^D buckets) in shared memory once, a chunk of FT::KS slot
// indices at a time, as f32 records (pos, a_p, b_mu and C, or S = C + C^T -
// I * C^T under legacy strain), and each thread, one per node, keeps the
// 3^D taps' partial sums in registers: a tap's partial takes the bucket's
// slots in slot order across chunks, and the partials are added to the
// node's accumulator in tap order after the last chunk. Those are the
// operations of the per-node gather in its order, so the result is the
// same bit for bit. Empty slots add nothing and are skipped, as before.
template <int D>
struct ForceTile;
template <>
struct ForceTile<3> {
  static constexpr int NG = 4;          // float4 groups a record
  static constexpr int KS = 2;          // slot indices a chunk
  static constexpr int MIN_BLOCKS = 2;  // per SM: <= 128 registers a thread
};
template <>
struct ForceTile<2> {
  static constexpr int NG = 2;
  static constexpr int KS = 4;
  static constexpr int MIN_BLOCKS = 4;
};
template <int D, typename M = unsigned>
__host__ __device__ constexpr size_t force_tile_smem() {  // records, occupancy masks, chunk count
  return (size_t)ForceTile<D>::KS * ForceTile<D>::NG * tile_buckets<D>() * sizeof(float4) +
         tile_buckets<D>() * sizeof(M) + sizeof(int);
}

// Record layout: D=3 [p0 p1 p2 ap] [bm M0 M1 M2] [M3 .. M6] [M7 M8 - -];
// D=2 [p0 p1 ap bm] [M0 .. M3]; M is C, or S under legacy strain.
template <int D>
__device__ __forceinline__ int rec_pos(int a) { return a; }
template <int D>
__device__ __forceinline__ int rec_ap() { return D; }
template <int D>
__device__ __forceinline__ int rec_bm() { return D + 1; }
template <int D>
__device__ __forceinline__ int rec_m(int e) { return D + 2 + e; }

// Pass 2 added to acc0 (UPDATE: kernel P's pass-1 momentum gmom, then the
// grid update into gvel; else from zero into out, the per-pass kernel B).
// One thread per node of a tile of grid_geom(p.g, s); x below is the
// node's state coordinate (go planes below its grid plane). WIDE (K > 64):
// the occupancy masks hold a chunk of CHUNK slots, restaged chunk after
// chunk, and the tap partials take the chunks in slot order.
template <int D, typename VC, typename GT, bool UPDATE, class Params, typename M = unsigned,
          bool WIDE = false>
__global__ void __launch_bounds__(tile_nodes<D>(), ForceTile<D>::MIN_BLOCKS)
    p2g_force_tile(const float* __restrict__ pos, const VC* __restrict__ Cm,
                   const float* __restrict__ mass, const float* __restrict__ a_p,
                   const float* __restrict__ b_mu, const GT* __restrict__ gmass,
                   const GT* __restrict__ gmom, GT* __restrict__ out, Params p, Slab s) {
  using G = GridCoding<GT>;
  using FT = ForceTile<D>;
  constexpr int HB = tile_buckets<D>();
  constexpr int NG = FT::NG, KS = FT::KS;
  constexpr int NR = NG * 4;  // floats a record
  extern __shared__ float4 smem[];
  float4* rec = smem;                                     // [KS][NG][HB]
  M* occ = (M*)(rec + KS * NG * HB);                      // [HB] slot bits
  int* kmax = (int*)(occ + HB);
  const GridGeom<D>& g = p.g;
  const GridGeom<D> gg = grid_geom(g, s);
  const float mult = grid_mult<GT>(p);
  const size_t KC = (size_t)g.K * g.C;

  // the tile's first node, in state coordinates, and the halo's extents
  int t0[D], hn[D];
  {
    int b = blockIdx.x;
    for (int a = D - 1; a >= 0; --a) {
      const int nt = (gg.n[a] + tile_dim<D>(a) - 1) / tile_dim<D>(a);
      t0[a] = (b % nt) * tile_dim<D>(a);
      b /= nt;
    }
    t0[0] -= s.go;
    for (int a = 0; a < D; ++a) hn[a] = tile_dim<D>(a) + 2;
  }
  // halo bucket h (last axis fastest) is state cell t0 + hc - 1
  auto halo_cell = [&](int h, int (&bx)[D]) {
    for (int a = D - 1; a >= 0; --a) {
      bx[a] = t0[a] + h % hn[a] - 1;
      h /= hn[a];
    }
  };

  // this thread's node
  int lx[D], x[D];
  {
    int r = threadIdx.x;
    for (int a = D - 1; a >= 0; --a) {
      lx[a] = r % tile_dim<D>(a);
      r /= tile_dim<D>(a);
    }
  }
  bool valid = true;
  for (int a = 0; a < D; ++a) {
    x[a] = t0[a] + lx[a];
    valid = valid && x[a] + (a == 0 ? s.go : 0) < gg.n[a];
  }
  GT part[NTAPS<D>][D];
#pragma unroll
  for (int t = 0; t < NTAPS<D>; ++t)
#pragma unroll
    for (int a = 0; a < D; ++a) part[t][a] = 0;

  // slots kc on (bit k - kc of occ): all K, or WIDE, the chunk [kc, kc + CHUNK)
#pragma unroll 1
  for (int kc = 0; kc < (WIDE ? g.K : 1); kc += CHUNK) {  // one pass unless WIDE
    if (kc) __syncthreads();  // the last chunk is consumed and *kmax read
    if (threadIdx.x == 0) *kmax = 0;
    __syncthreads();
    const int kw = WIDE ? min(g.K - kc, CHUNK) : g.K;  // slots in this chunk
    for (int h = threadIdx.x; h < HB; h += blockDim.x) {
      int bx[D];
      halo_cell(h, bx);
      M bits = 0;
      if (in_grid(g, bx)) {
        const int b = flat(g, bx);
        for (int k = 0; k < kw; ++k)
          if (mass[(size_t)(kc + k) * g.C + b] > 0.f) bits |= M(1) << k;
      }
      occ[h] = bits;
      if (bits) atomicMax(kmax, slot_end(bits));
    }
    __syncthreads();
    const int kend = *kmax;

    for (int k0 = 0; k0 < kend; k0 += KS) {
      if (k0) __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < KS * HB; e += blockDim.x) {
        const int kk = e / HB, h = e % HB, k = k0 + kk;
        if (k >= kw || !((occ[h] >> k) & 1)) continue;
        int bx[D];
        halo_cell(h, bx);
        const size_t i = (size_t)(kc + k) * g.C + flat(g, bx);
        float r[NR], Cl[D * D];
        for (int a = 0; a < D; ++a) r[rec_pos<D>(a)] = pos[a * KC + i];
        r[rec_ap<D>()] = a_p[i];
        r[rec_bm<D>()] = b_mu[i];
        for (int a = 0; a < D * D; ++a) Cl[a] = load_vc(Cm, a * KC + i);
        for (int u = 0; u < D; ++u)
          for (int v = 0; v < D; ++v) {
            float m = Cl[u * D + v];
            if (p.legacy_strain) {
              // S = C + C^T - I * C^T (MLSMPM2DFluid.cs:276-281): off-diagonal
              // entries symmetrised, the diagonal C_ii left unscaled
              const float sum = Cl[u * D + v] + Cl[v * D + u];
              m = u == v ? sum - Cl[v * D + u] : sum;
            }
            r[rec_m<D>(u * D + v)] = m;
          }
        for (int q = rec_m<D>(D * D); q < NR; ++q) r[q] = 0.f;
        for (int q = 0; q < NG; ++q)
          rec[(kk * NG + q) * HB + h] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                                                    r[4 * q + 3]);
      }
      __syncthreads();
      if (!valid) continue;
      const int kn = min(KS, kend - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const int k = k0 + kk;
#pragma unroll
        for (int t = 0; t < NTAPS<D>; ++t) {
          // bucket x + tt - 1, halo index lx + tt; its slots reach the node
          // with tap r = 2 - tt
          int tt[D];
          tap_digits(t, tt);
          int h = lx[0] + tt[0];
          for (int a = 1; a < D; ++a) h = h * hn[a] + lx[a] + tt[a];
          if (!((occ[h] >> k) & 1)) continue;
          float r[NR];
          for (int q = 0; q < NG; ++q) {
            const float4 v = rec[(kk * NG + q) * HB + h];
            r[4 * q] = v.x;
            r[4 * q + 1] = v.y;
            r[4 * q + 2] = v.z;
            r[4 * q + 3] = v.w;
          }
          int rr[D];
          float d[D], dist[D], M[D * D];
          for (int a = 0; a < D; ++a) {
            rr[a] = 2 - tt[a];
            const float cb = (global_coord(s, a, x[a]) + 0.5f) + (float)(tt[a] - 1);
            d[a] = r[rec_pos<D>(a)] - cb;
          }
          const float w = tap_weight(rr, d);
          for (int a = 0; a < D; ++a) dist[a] = (float)(rr[a] - 1) - d[a];
          for (int a = 0; a < D * D; ++a) M[a] = r[rec_m<D>(a)];
          const float ap = r[rec_ap<D>()], bm = r[rec_bm<D>()];
          for (int a = 0; a < D; ++a) {
            const float sd = p.legacy_strain
                                 ? matvec_row<D>(M, a, dist)
                                 : matvec_row<D>(M, a, dist) + matvec_t_row<D>(M, a, dist);
            part[t][a] = G::add(part[t][a], G::enc(w * (ap * dist[a] + bm * sd), mult));
          }
        }
      }
    }
  }
  if (!valid) return;

  int gx[D];  // the node on the grid's planes
  for (int a = 0; a < D; ++a) gx[a] = a == 0 ? x[a] + s.go : x[a];
  const int c = flat(gg, gx);
  GT acc[D];
  for (int a = 0; a < D; ++a) acc[a] = UPDATE ? gmom[a * (size_t)gg.C + c] : (GT)0;
#pragma unroll
  for (int t = 0; t < NTAPS<D>; ++t) {
    int tt[D], bx[D];
    tap_digits(t, tt);
    for (int a = 0; a < D; ++a) bx[a] = x[a] + tt[a] - 1;
    if (!in_grid(g, bx)) continue;  // a tap outside the state adds nothing
    for (int a = 0; a < D; ++a) acc[a] = G::add(acc[a], part[t][a]);
  }
  if (!UPDATE) {
    for (int a = 0; a < D; ++a) out[a * (size_t)gg.C + c] = acc[a];
    return;
  }

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
    out[a * (size_t)gg.C + c] = has_mass ? G::enc(v[a], mult) : (GT)0;
}

// Launches pass 2 over the tiles of grid_geom(p.g, s): UPDATE into gvel
// from gmom, else from zero into out.
template <int D, typename VC, typename GT, bool UPDATE, class Params>
cudaError_t launch_p2g_force(const Params& p, const float* pos, const VC* Cm, const float* mass,
                             const float* a_p, const float* b_mu, const GT* gmass,
                             const GT* gmom, GT* out, cudaStream_t stream, const Slab& s) {
  const GridGeom<D> gg = grid_geom(p.g, s);
  unsigned tiles = 1;
  for (int a = 0; a < D; ++a) tiles *= (gg.n[a] + tile_dim<D>(a) - 1) / tile_dim<D>(a);
  const auto kern = by_slots(p.g.K, [](auto m) {
    using S = decltype(m);
    return &p2g_force_tile<D, VC, GT, UPDATE, Params, typename S::M, S::WIDE>;
  });
  const size_t smem = by_slots(
      p.g.K, [](auto m) { return force_tile_smem<D, typename decltype(m)::M>(); });
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<tiles, tile_nodes<D>(), smem, stream>>>(pos, Cm, mass, a_p, b_mu, gmass, gmom, out, p,
                                                 s);
  return cudaGetLastError();
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

// cfl: the cfl_clamped counter, added to (on the planes s counts). code_out:
// each slot's SlotCode for kernel F's migration, or null (the 2D substep).
template <int D, typename VC, typename GT, class Params>
__global__ void g2p_tail(const float* __restrict__ pos, const float* __restrict__ mass,
                         const GT* __restrict__ gvel, float* __restrict__ pos_out,
                         VC* __restrict__ vel_out, VC* __restrict__ C_out,
                         int* __restrict__ cfl, uint8_t* __restrict__ code_out, Params p,
                         Slab s) {
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
    if (code_out) code_out[i] = 0;
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
  unsigned code = SlotCode::OCC;
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
    // the delta bucketed.reject_overflow takes, against the global coordinate
    code |= SlotCode::of_delta(axis_delta(q, a == 0 ? x[a] + s.x0 : x[a])) << (2 * a);
  }
  for (int a = 0; a < D * D; ++a) store_vc(C_out, a * KC + i, 4.0f * B[a]);
  if (code_out) code_out[i] = (uint8_t)code;
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

// bucketed._migrate_axis after rejection, choosing apart from moving. Each
// axis phase moves only what the next phase reads: the positions (the
// axis's own from R), the mass, and each slot's index into the state the
// migration started from (idx; null: the identity, the first phase). One
// thread per destination cell first counts its candidates, bit k of a mask
// for slot k of source j in [stay, from-left, from-right], then fills its K
// output slots in slot order, the n-th candidate into slot n, so that a
// warp's lanes store row n of neighbouring cells together; empty slots get
// zeros and idx -1, the excess counts in `lost`. The payload (vel, C, ids)
// moves once, after the last phase (migrate_gather). WIDE (K > 64): a
// source's masks hold a chunk of CHUNK slots, counted chunk after chunk
// first, then walked in slot order, each source's chunks in turn.
template <int D, typename M = unsigned, bool WIDE = false>
__global__ void migrate_select(const float* __restrict__ pos, const float* __restrict__ R,
                               const float* __restrict__ mass, const int* __restrict__ idx,
                               float* __restrict__ pos_o, float* __restrict__ mass_o,
                               int* __restrict__ idx_o, int* __restrict__ lost, int axis,
                               GridGeom<D> g, Slab s) {
  const size_t KC = (size_t)g.K * g.C;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  const int co = axis_coord(g, c, axis);
  const int st = axis_stride(g, axis);
  const int n_a = axis_extent(g, axis);
  const int xg = axis == 0 ? s.x0 : 0;  // local to global coordinate

  // source j's candidates among slots k0 on (bit k - k0): all K, or WIDE,
  // the chunk [k0, k0 + CHUNK); j: own slots staying (shift 0), the left
  // neighbour's slots moving +1, the right neighbour's moving -1
  auto candidates = [&](int j, int k0) {
    const int shift = j == 0 ? 0 : (j == 1 ? 1 : -1);
    const int src_co = co - shift;
    M m = 0;
    if (src_co < 0 || src_co >= n_a) return m;
    const int src = c - shift * st;
    const int kend = WIDE ? min(g.K, k0 + CHUNK) : g.K;
    for (int k = k0; k < kend; ++k) {
      const size_t i = (size_t)k * g.C + src;
      if (mass[i] > 0.f && axis_delta(R[i], src_co + xg) == (float)shift)
        m |= M(1) << (k - k0);
    }
    return m;
  };
  M sel[3];  // each source's first chunk
  int total = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    sel[j] = candidates(j, 0);
    total += slot_count(sel[j]);
  }
  if constexpr (WIDE)
    for (int j = 0; j < 3; ++j)
      for (int k0 = CHUNK; k0 < g.K; k0 += CHUNK) total += slot_count(candidates(j, k0));
  int j = 0, k0 = 0;
  M m = sel[0];
  for (int n = 0; n < g.K; ++n) {
    const size_t o = (size_t)n * g.C + c;
    while (m == 0 && j < 3) {  // WIDE: this source's next chunk; else the next source
      if constexpr (WIDE)
        if ((k0 += CHUNK) < g.K) {
          m = candidates(j, k0);
          continue;
        }
      k0 = 0;
      if (++j < 3) m = j == 1 ? sel[1] : sel[2];
    }
    if (m == 0) {
      for (int a = 0; a < D; ++a) pos_o[a * KC + o] = 0.f;
      mass_o[o] = 0.f;
      idx_o[o] = -1;
      continue;
    }
    const int k = k0 + slot_first(m);
    m &= m - 1;
    const int src = c - (j == 0 ? 0 : (j == 1 ? st : -st));
    const size_t i = (size_t)k * g.C + src;
    for (int a = 0; a < D; ++a) pos_o[a * KC + o] = a == axis ? R[i] : pos[a * KC + i];
    mass_o[o] = mass[i];
    idx_o[o] = idx ? idx[i] : (int)i;
  }
  if (total > g.K && counted(s, axis_coord(g, c, 0))) atomicAdd(lost, total - g.K);
}

// The payload's one move: output slot o takes vel, C and ids of slot
// idx[o] of the state the migration started from (T: raw bits, uint16_t
// for bf16, uint32_t for float32), or zeros and id -1 when idx[o] < 0.
// One thread an output slot, so a warp's stores are contiguous. ids_o may
// be idx itself: each thread reads its idx before it writes.
template <int D, typename T>
__global__ void migrate_gather(const int* idx, const T* __restrict__ vel,
                               const T* __restrict__ Cm, const int* __restrict__ ids,
                               T* __restrict__ vel_o, T* __restrict__ C_o, int* ids_o,
                               size_t KC) {
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= KC) return;
  const int i = idx[o];
  if (i < 0) {
    for (int a = 0; a < D; ++a) vel_o[a * KC + o] = 0;
    for (int a = 0; a < D * D; ++a) C_o[a * KC + o] = 0;
    ids_o[o] = -1;
    return;
  }
  for (int a = 0; a < D; ++a) vel_o[a * KC + o] = vel[a * KC + i];
  for (int a = 0; a < D * D; ++a) C_o[a * KC + o] = Cm[a * KC + i];
  ids_o[o] = ids[i];
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

// The first n of m's slots in slot order; all of them when n >= their count.
template <typename MT>
__device__ __forceinline__ MT first_slots(MT m, int n) {
  if (n >= slot_count(m)) return m;
  MT rest = m;
  for (int i = 0; i < n; ++i) rest &= rest - 1;
  return m ^ rest;
}

// One axis phase of kernel F's migration (bucketed._migrate_axis with
// reject_overflow before it) on slot codes: code and idx in (idx null: the
// identity, the first phase), code_o and idx_o out, one thread per
// destination cell c. A phase's choices depend on the codes alone: which
// slots of cells c-2 .. c+1 are occupied and which move up or down the axis.
// Movers are taken in slot order, so each rule of reject_overflow, "rank i
// is accepted iff occ0(dest) + i < K" (a left-mover's i also counting the
// right-movers of its cell - 2), accepts the first K - occ0(dest) movers:
// c's own up-movers against occ0(c+1) and the ceiling band, its own
// down-movers against occ0(c-1) + up(c-2), cell c-1's up-movers and cell
// c+1's down-movers into c against occ0(c) (+ up(c-1) for the latter). The
// neighbours evaluate the same counts, so both ends of an exchange agree.
// The thread then fills its K output slots from its [stay, from-left,
// from-right] candidates in slot order, as migrate_select does, and
// rewrites the phase's field of each: REJ for a mover kept back, 0 else. It
// counts `deferred` and `ceiling` for its own cell's rejections and `lost`
// for its excess, on the planes s counts. WIDE (K > 64): the counts over
// every chunk of CHUNK slots first, then the walk a chunk at a time.
template <int D, typename M = unsigned, bool WIDE = false>
__global__ void migrate_select_codes(const uint8_t* __restrict__ code, const int* __restrict__ idx,
                                     uint8_t* __restrict__ code_o, int* __restrict__ idx_o,
                                     int* __restrict__ lost, int* __restrict__ deferred,
                                     int* __restrict__ ceiling, int axis, int ceil_band_y,
                                     GridGeom<D> g, Slab s) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  const int co = axis_coord(g, c, axis);
  const int st = axis_stride(g, axis);
  const int n_a = axis_extent(g, axis);
  const int K = g.K;

  // cell co + off's slots k0 on (bit k - k0; all K, or WIDE the chunk
  // [k0, k0 + CHUNK)): occupied, moving up, moving down; none past the ends
  struct Slots {
    M occ, up, down;
  };
  auto slots = [&](int off, int k0) {
    Slots b = {0, 0, 0};
    if (co + off < 0 || co + off >= n_a) return b;
    const int cell = c + off * st;
    const int kend = WIDE ? min(K, k0 + CHUNK) : K;
    for (int k = k0; k < kend; ++k) {
      const unsigned e = code[(size_t)k * g.C + cell];
      const unsigned f = SlotCode::field(e, axis);
      const M bit = M(1) << (k - k0);
      if (e & SlotCode::OCC) b.occ |= bit;
      if (f == SlotCode::UP) b.up |= bit;
      if (f == SlotCode::DOWN) b.down |= bit;
    }
    return b;
  };
  const Slots own = slots(0, 0), left = slots(-1, 0), right = slots(1, 0);
  int occ_c = slot_count(own.occ), up_c = slot_count(own.up), down_c = slot_count(own.down);
  int occ_l = slot_count(left.occ), up_l = slot_count(left.up);
  int occ_r = slot_count(right.occ), down_r = slot_count(right.down);
  int up_l2 = slot_count(slots(-2, 0).up);
  if constexpr (WIDE)
    for (int k0 = CHUNK; k0 < K; k0 += CHUNK) {
      const Slots o = slots(0, k0), l = slots(-1, k0), r = slots(1, k0);
      occ_c += slot_count(o.occ);
      up_c += slot_count(o.up);
      down_c += slot_count(o.down);
      occ_l += slot_count(l.occ);
      up_l += slot_count(l.up);
      occ_r += slot_count(r.occ);
      down_r += slot_count(r.down);
      up_l2 += slot_count(slots(-2, k0).up);
    }
  // the air window's ceiling: upward moves out of the band are rejected
  auto band = [&](int y) { return axis == 1 && ceil_band_y >= 0 && y >= ceil_band_y; };
  // movers accepted by the overflow rule (a count, taken in slot order)
  const int up_ok = min(up_c, K - occ_r);
  const int down_ok = min(down_c, max(K - occ_l - up_l2, 0));
  const int n_ceil = band(co) ? up_ok : 0;
  // movers left to accept of each source, used up as the walk meets them
  int go_up = up_ok - n_ceil, go_down = down_ok;
  int take_l = band(co - 1) ? 0 : min(up_l, K - occ_c);
  int take_r = min(down_r, max(K - occ_c - up_l, 0));
  const int total = occ_c - go_up - go_down + take_l + take_r;
  const int n_rej = up_c + down_c - go_up - go_down;

  // source j's candidates among the slots of b: j 0, c's own slots that stay
  // (or are kept back); 1, the left neighbour's accepted up-movers; 2, the
  // right neighbour's accepted down-movers
  auto candidates = [&](int j, const Slots& b) {
    if (j == 0) {
      const M up = first_slots(b.up, go_up), down = first_slots(b.down, go_down);
      go_up -= slot_count(up);
      go_down -= slot_count(down);
      return M(b.occ & ~(up | down));
    }
    M m;
    if (j == 1) {
      m = first_slots(b.up, take_l);
      take_l -= slot_count(m);
    } else {
      m = first_slots(b.down, take_r);
      take_r -= slot_count(m);
    }
    return m;
  };
  M sel[3];  // each source's first chunk
  sel[0] = candidates(0, own);
  sel[1] = candidates(1, left);
  sel[2] = candidates(2, right);
  int j = 0, k0 = 0;
  M m = sel[0];
  for (int n = 0; n < K; ++n) {
    const size_t o = (size_t)n * g.C + c;
    while (m == 0 && j < 3) {  // WIDE: this source's next chunk; else the next source
      if constexpr (WIDE)
        if ((k0 += CHUNK) < K) {
          m = candidates(j, slots(j == 0 ? 0 : (j == 1 ? -1 : 1), k0));
          continue;
        }
      k0 = 0;
      if (++j < 3) m = j == 1 ? sel[1] : sel[2];
    }
    if (m == 0) {
      code_o[o] = 0;
      idx_o[o] = -1;
      continue;
    }
    const int k = k0 + slot_first(m);
    m &= m - 1;
    const int src = c - (j == 0 ? 0 : (j == 1 ? st : -st));
    const size_t i = (size_t)k * g.C + src;
    const unsigned e = code[i];
    const unsigned f = j == 0 && SlotCode::field(e, axis) ? SlotCode::REJ : 0u;
    code_o[o] = (uint8_t)((e & ~(3u << (2 * axis))) | (f << (2 * axis)));
    idx_o[o] = idx ? idx[i] : (int)i;
  }
  if (!counted(s, axis_coord(g, c, 0))) return;
  if (n_rej) atomicAdd(deferred, n_rej);
  if (n_ceil) atomicAdd(ceiling, n_ceil);
  if (total > K) atomicAdd(lost, total - K);
}

// Kernel F's one move of the state, after the last code phase: output slot
// o takes pos, mass, vel, C and ids of slot idx[o] of the state the
// migration started from (T: raw bits of vel and C), or zeros and id -1
// when idx[o] < 0. On each axis whose field of code[o] reads REJ the
// position is clamped into the output cell, which is the cell the phase
// kept the slot in, as bucketed.reject_overflow clamps it. A thread takes
// GATHER_SLOTS output slots, blockDim.x apart so that a warp's accesses stay
// contiguous, and issues every load of all of them before its first store:
// one slot a thread leaves too few bytes in flight (on an H100, at the 1M
// pool's 1.8M slots, 110 us a call at one slot, 66 at two, 68 at four).
// ids_o may be idx itself: each thread reads its idx before it writes.
constexpr int GATHER_SLOTS = 2;

template <int D, typename T>
__global__ void migrate_gather_codes(const int* idx, const uint8_t* __restrict__ code,
                                     StateBuf<T> src, StateBuf<T> out, GridGeom<D> g, Slab s) {
  constexpr int U = GATHER_SLOTS;
  const size_t KC = (size_t)g.K * g.C;
  const size_t o0 = (size_t)blockIdx.x * (U * blockDim.x) + threadIdx.x;
  int i[U];
  unsigned e[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const size_t o = o0 + (size_t)u * blockDim.x;
    i[u] = o < KC ? idx[o] : -1;
    e[u] = o < KC ? code[o] : 0u;
  }
  float p[U][D], m[U];
  T v[U][D], cm[U][D * D];
  int id[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool full = i[u] >= 0;
    const size_t j = full ? (size_t)i[u] : 0;
    for (int a = 0; a < D; ++a) {
      p[u][a] = full ? src.pos[a * KC + j] : 0.f;
      v[u][a] = full ? src.vel[a * KC + j] : T(0);
    }
    for (int a = 0; a < D * D; ++a) cm[u][a] = full ? src.C[a * KC + j] : T(0);
    m[u] = full ? src.mass[j] : 0.f;
    id[u] = full ? src.ids[j] : -1;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const size_t o = o0 + (size_t)u * blockDim.x;
    if (o >= KC) return;
    for (int a = 0; a < D; ++a) {
      float xa = p[u][a];
      if (SlotCode::field(e[u], a) == SlotCode::REJ) {
        const float cg = global_coord(s, a, axis_coord(g, (int)(o % g.C), a));
        xa = fminf(fmaxf(xa, cg), (cg + 1.0f) - CFL_EPS);
      }
      out.pos[a * KC + o] = xa;
      out.vel[a * KC + o] = v[u][a];
    }
    for (int a = 0; a < D * D; ++a) out.C[a * KC + o] = cm[u][a];
    out.mass[o] = m[u];
    out.ids[o] = id[u];
  }
}

constexpr int THREADS = 256;

// Kernel P's first launch: pass-1 mass and momentum on the nodes of
// grid_geom(p.g, s), over its tiles. The sharded stage 1 (p2g_shard.cu)
// and the per-pass kernel A (planes.cu) are this launch alone.
template <int D, typename VC, typename GT, class Params>
cudaError_t launch_p2g_pass1(const Params& p, const float* pos, const VC* vel, const VC* Cm,
                             const float* mass, GT* gmass, GT* gmom, cudaStream_t stream,
                             const Slab& s = whole_grid()) {
  const GridGeom<D> gg = grid_geom(p.g, s);
  unsigned tiles = 1;
  for (int a = 0; a < D; ++a) tiles *= (gg.n[a] + tile_dim<D>(a) - 1) / tile_dim<D>(a);
  constexpr size_t smem = mass_tile_smem<D>();
  const auto kern = by_slots(p.g.K, [](auto m) {
    using S = decltype(m);
    return &p2g_mass_tile<D, VC, GT, Params, typename S::M, S::WIDE>;
  });
  if constexpr (smem > 48 * 1024) {  // above 48 KB only when asked for
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<tiles, tile_nodes<D>(), smem, stream>>>(pos, vel, Cm, mass, gmass, gmom, p, s);
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
  return launch_p2g_force<D, VC, GT, true>(p, pos, Cm, mass, a_p, b_mu, gmass, gmom, gvel,
                                          stream, s);
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
                            cudaStream_t stream, const Slab& s = whole_grid(),
                            uint8_t* code_out = nullptr) {
  const size_t KC = (size_t)p.g.K * p.g.C;
  g2p_tail<D, VC, GT><<<blocks_for(KC, THREADS), THREADS, 0, stream>>>(
      pos, mass, gvel, pos_out, vel_out, C_out, cfl, code_out, p, s);
  return cudaGetLastError();
}

// bucketed.migrate on `stream`: one reject/select phase per axis, the last
// axis first, then the payload's gather. The phases carry pos, mass and the
// source index in the pos, mass and ids arrays of out0 and out1 in turns,
// the first reading src; the gather then reads src's vel, C and ids and
// writes the last phase's buffer, which holds the result (out0 for D = 3,
// out1 for D = 2). src.vel, src.C and src.ids must not be out0's or out1's;
// src.pos may be out1's (the first phase has read it when the second
// writes). R is a [K, C] scratch row.
template <int D, typename T>
cudaError_t launch_migrate(const GridGeom<D>& g, StateBuf<T> src, StateBuf<T> out0,
                           StateBuf<T> out1, float* R, int* lost, int* deferred,
                           int* ceiling, int ceil_band_y, cudaStream_t stream,
                           const Slab& s = whole_grid()) {
  const StateBuf<T> first = src;
  const auto select = by_slots(g.K, [](auto m) {
    using S = decltype(m);
    return &migrate_select<D, typename S::M, S::WIDE>;
  });
  StateBuf<T> dst = out0;
  const int* idx = nullptr;
  for (int ph = 0; ph < D; ++ph) {
    const int axis = D - 1 - ph;
    migrate_reject<D><<<blocks_for(g.C, THREADS), THREADS, 0, stream>>>(
        src.pos, src.mass, R, deferred, ceiling, axis, ceil_band_y, g, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    select<<<blocks_for(g.C, THREADS), THREADS, 0, stream>>>(
        src.pos, R, src.mass, idx, dst.pos, dst.mass, dst.ids, lost, axis, g, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
    idx = dst.ids;
    dst = ph % 2 == 0 ? out1 : out0;
  }
  const size_t KC = (size_t)g.K * g.C;
  migrate_gather<D, T><<<blocks_for(KC, THREADS), THREADS, 0, stream>>>(
      src.ids, first.vel, first.C, first.ids, src.vel, src.C, src.ids, KC);
  return cudaGetLastError();
}


// Kernel F's migration (bucketed.migrate) on `stream`, after g2p_tail has
// written the slot codes into codes0: one migrate_select_codes launch per
// axis, the last axis first, carrying codes through codes1, codes0, codes1
// (D = 3) and source indices through out.ids and idx1 in turns, the last
// phase's into out.ids; then the gather moves src into out through them.
// codes1 is a [K, C] scratch row of bytes, idx1 one of int32; src's arrays
// must not be out's.
template <int D, typename T>
cudaError_t launch_migrate_codes(const GridGeom<D>& g, StateBuf<T> src, StateBuf<T> out,
                                 uint8_t* codes0, uint8_t* codes1, int* idx1, int* lost,
                                 int* deferred, int* ceiling, int ceil_band_y,
                                 cudaStream_t stream, const Slab& s) {
  const auto select = by_slots(g.K, [](auto m) {
    using S = decltype(m);
    return &migrate_select_codes<D, typename S::M, S::WIDE>;
  });
  const uint8_t* code = codes0;
  const int* idx = nullptr;
  for (int ph = 0; ph < D; ++ph) {
    const int axis = D - 1 - ph;
    uint8_t* code_o = ph % 2 == 0 ? codes1 : codes0;
    int* idx_o = axis % 2 == 0 ? out.ids : idx1;  // the last phase (axis 0) into out.ids
    select<<<blocks_for(g.C, THREADS), THREADS, 0, stream>>>(
        code, idx, code_o, idx_o, lost, deferred, ceiling, axis, ceil_band_y, g, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    code = code_o;
    idx = idx_o;
  }
  const size_t KC = (size_t)g.K * g.C;
  migrate_gather_codes<D, T><<<blocks_for(KC, GATHER_SLOTS * THREADS), THREADS, 0, stream>>>(
      idx, code, src, out, g, s);
  return cudaGetLastError();
}

}  // namespace mpm
