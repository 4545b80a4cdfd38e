// Kernel F for Hopper (sm_90a): G2P gather and APIC C rebuild, the advection
// tail, then the three axis phases of bucket migration with overflow and
// air-window ceiling rejection, and on request the per-cell splat emission.
//
// Replaces: mpm_tpu/ops/pallas/fused.py:_fused_kernel (called from
// _g2p_migrate_fused, entries substep_fused and substep_fused_emit), the
// TPU's kernel F. What it computes is mpm_tpu/ops/bucketed g2p_bucketed
// followed by migrate; the plain PyTorch version is
// mpm_tpu_torch/ops/cuda/g2p_migrate.g2p_migrate_plain, followed by
// ops/cuda/extract_cells.cell_splats_plain when splats are emitted.
//
// What bounds it on this card: device-memory traffic. Each slot's state is
// 68 B in float32 storage (pos 12, vel 12, C 36, mass 4, ids 4) and 44 B
// with bf16 vel and C. The G2P/tail pass reads pos and mass and writes pos,
// vel and C; each of the three axis phases reads the slot state of a cell
// and its two neighbours along the axis (the neighbours' mass and axis
// position twice: once to reject, once to select) and writes it out once:
// roughly 4 x 68 + 3 x 2 x 24 = 420 B per slot per substep in f32, and about
// 300 B in bf16. The 27 grid-velocity reads per slot come from L1/L2 (the
// grid is 12 B per cell). The FLOPs are few.
//
// The simple design:
//   g2p_tail    one thread per slot: the G2P gather over 27 nodes, C = 4B,
//               then the tail exactly as bucketed.g2p_bucketed: advect,
//               clamp against dres, interactions, wall springs, CFL clamp
//               (CFL_EPS), park empty slots at the cell centre. vel and C
//               round to bf16 only at the store.
//   per axis z, y, x, two launches:
//   reject      one thread per source cell: the conservative rule
//               occ0(dest) + i < K, where a left-mover's i also counts the
//               right-movers of cell - 2, plus the ceiling band on y. It
//               writes the axis position of every slot to a scratch row,
//               clamped back into the cell for rejected movers. Reading the
//               counts of other cells and writing only its own slots' row,
//               it needs no ordering between threads.
//   select      one thread per destination cell: walks its 3K candidates in
//               [stay, from-left, from-right] slot order, writes the first K
//               out of place into the other buffer, zeroes the rest (ids -1)
//               and counts any excess in `lost`.
//   emission    when asked, kernel X's per-cell extraction
//               (extract_cells.cuh) runs as the chain's last launch, on the
//               post-migration buffers and the same stream. The TPU fused it
//               into the last sweep to save a re-read of the state; here the
//               re-read is the same ~40 MB at the pool window (tens of us),
//               so a separate launch is kept.
// Counters are int32 atomicAdds, exact in any order. Neighbours come from
// 3D coordinates with bounds checks; the plain version's flat offsets wrap
// rows instead, and the two agree because the position clamps keep every
// axis's edge planes empty. The TPU kernel's plane sweep, rings, packed
// bf16 pairs and zero-mover gates do not carry over.

#include "extract_cells.cuh"

namespace {

using mpm::Geom;

constexpr int MAX_INTER = 8;
constexpr int INTER_VALS = 7;  // cx, cy, cz, radius, strength, inv_falloff, active

struct G2PParams {
  Geom g;
  int dres[3];
  int n_inter;
  int ceil_band_y;  // >= 0: upward y-moves out of cells with y >= this are rejected
  float dt;
  float clamp_lo, clamp_hi_offset;
  float wall_min, wall_max_offset, wall_stiffness;
  float inter[MAX_INTER * INTER_VALS];
};

enum { CNT_LOST = 0, CNT_CFL = 1, CNT_DEFERRED = 2, CNT_CEILING = 3 };

template <typename VC>
__global__ void g2p_tail(const float* __restrict__ pos, const float* __restrict__ mass,
                         const float* __restrict__ gvel, float* __restrict__ pos_out,
                         VC* __restrict__ vel_out, VC* __restrict__ C_out,
                         int* __restrict__ cnt, G2PParams p) {
  const Geom g = p.g;
  const size_t KC = (size_t)g.K * g.C;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= KC) return;
  int c = (int)(i % g.C);
  int x, y, z;
  mpm::cell_xyz(g, c, x, y, z);
  const int xyz[3] = {x, y, z};
  float center[3];
  for (int a = 0; a < 3; ++a) center[a] = (float)xyz[a] + 0.5f;
  if (!(mass[i] > 0.f)) {  // park empty slots at the cell centre
    for (int a = 0; a < 3; ++a) {
      pos_out[a * KC + i] = center[a];
      mpm::store_vc(vel_out, a * KC + i, 0.f);
    }
    for (int a = 0; a < 9; ++a) mpm::store_vc(C_out, a * KC + i, 0.f);
    return;
  }
  float d[3];
  for (int a = 0; a < 3; ++a) d[a] = pos[a * KC + i] - center[a];
  float vel[3] = {0.f, 0.f, 0.f};
  float B[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int tx = 0; tx < 3; ++tx)
    for (int ty = 0; ty < 3; ++ty)
      for (int tz = 0; tz < 3; ++tz) {
        int nx_ = x + tx - 1, ny_ = y + ty - 1, nz_ = z + tz - 1;
        if (!mpm::in_grid(g, nx_, ny_, nz_)) continue;
        int n = mpm::flat(g, nx_, ny_, nz_);
        float w = mpm::tap_weight(tx, ty, tz, d);
        float dist[3] = {(float)(tx - 1) - d[0], (float)(ty - 1) - d[1],
                         (float)(tz - 1) - d[2]};
        for (int a = 0; a < 3; ++a) {
          float wv = w * gvel[a * (size_t)g.C + n];
          vel[a] = vel[a] + wv;
          for (int b = 0; b < 3; ++b) B[a * 3 + b] = B[a * 3 + b] + wv * dist[b];
        }
      }

  float ps[3];
  for (int a = 0; a < 3; ++a) {
    float q = pos[a * KC + i] + vel[a] * p.dt;
    ps[a] = fminf(fmaxf(q, p.clamp_lo), (float)p.dres[a] - p.clamp_hi_offset);
  }

  for (int j = 0; j < p.n_inter; ++j) {  // ops/interact.apply_interactions
    const float* it = p.inter + j * INTER_VALS;
    float dd[3] = {ps[0] - it[0], ps[1] - it[1], ps[2] - it[2]};
    float r2 = dd[0] * dd[0];
    r2 = r2 + dd[1] * dd[1];
    r2 = r2 + dd[2] * dd[2];
    bool inside = (r2 < it[3] * it[3]) && (it[6] > 0.f);
    float norm = sqrtf(r2);
    float safe = norm > 0.f ? norm : 1.0f;
    float falloff = 1.0f + it[5] * (it[3] / safe - 1.0f);
    float sf = it[4] * falloff;
    float force[3];
    bool finite = true;
    for (int a = 0; a < 3; ++a) {
      force[a] = (dd[a] / safe) * sf;
      finite = finite && isfinite(force[a]);
    }
    if (inside && norm > 0.f && finite)
      for (int a = 0; a < 3; ++a) vel[a] = vel[a] + force[a];
  }

  bool moved = false;
  for (int a = 0; a < 3; ++a) {
    // predictive wall spring (g2p.glsl:131-140)
    float x_n = ps[a] + vel[a];
    float hi = (float)p.dres[a] - p.wall_max_offset;
    vel[a] = vel[a] + p.wall_stiffness * (fmaxf(p.wall_min - x_n, 0.f) + fminf(hi - x_n, 0.f));
    // CFL bucket clamp: stay within the +-1-cell migration range
    float cell = center[a] - 0.5f;
    float q = fminf(fmaxf(ps[a], cell - 1.0f), (cell + 2.0f) - mpm::CFL_EPS);
    moved = moved || (q != ps[a]);
    pos_out[a * KC + i] = q;
    mpm::store_vc(vel_out, a * KC + i, vel[a]);
  }
  for (int a = 0; a < 9; ++a) mpm::store_vc(C_out, a * KC + i, 4.0f * B[a]);
  if (moved) atomicAdd(cnt + CNT_CFL, 1);
}

__device__ __forceinline__ float axis_delta(float pa, int coord) {
  return fminf(fmaxf(floorf(pa) - (float)coord, -1.0f), 1.0f);
}

__device__ __forceinline__ int axis_stride(const Geom& g, int axis) {
  return axis == 0 ? g.ny * g.nz : (axis == 1 ? g.nz : 1);
}

__device__ __forceinline__ int axis_extent(const Geom& g, int axis) {
  return axis == 0 ? g.nx : (axis == 1 ? g.ny : g.nz);
}

__device__ __forceinline__ int axis_coord(const Geom& g, int c, int axis) {
  int x, y, z;
  mpm::cell_xyz(g, c, x, y, z);
  return axis == 0 ? x : (axis == 1 ? y : z);
}

// bucketed.reject_overflow for the cells of one axis phase.
__global__ void migrate_reject(const float* __restrict__ pos, const float* __restrict__ mass,
                               float* __restrict__ R, int* __restrict__ cnt, int axis,
                               G2PParams p) {
  const Geom g = p.g;
  const size_t KC = (size_t)g.K * g.C;
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  const int co = axis_coord(g, c, axis);
  const int s = axis_stride(g, axis);
  const int n_a = axis_extent(g, axis);
  const float* pa = pos + axis * KC;

  int occ0_r = 0, occ0_l = 0, nmovr_l2 = 0;
  for (int k = 0; k < g.K; ++k) {
    size_t row = (size_t)k * g.C;
    if (co + 1 < n_a && mass[row + c + s] > 0.f) ++occ0_r;
    if (co - 1 >= 0 && mass[row + c - s] > 0.f) ++occ0_l;
    if (co - 2 >= 0 && mass[row + c - 2 * s] > 0.f &&
        axis_delta(pa[row + c - 2 * s], co - 2) == 1.0f)
      ++nmovr_l2;
  }
  const bool ceil_band = axis == 1 && p.ceil_band_y >= 0 && co >= p.ceil_band_y;
  int rank_r = 0, rank_l = 0, n_rej = 0, n_ceil = 0;
  for (int k = 0; k < g.K; ++k) {
    size_t i = (size_t)k * g.C + c;
    float x = pa[i];
    if (mass[i] > 0.f) {
      float delta = axis_delta(x, co);
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
        x = fminf(fmaxf(x, (float)co), ((float)co + 1.0f) - mpm::CFL_EPS);
        ++n_rej;
      }
    }
    R[i] = x;
  }
  if (n_rej) atomicAdd(cnt + CNT_DEFERRED, n_rej);
  if (n_ceil) atomicAdd(cnt + CNT_CEILING, n_ceil);
}

// bucketed._migrate_axis after rejection: vel and C move as raw bits (T is
// uint16_t for bf16 storage, uint32_t for float32).
template <typename T>
__global__ void migrate_select(const float* __restrict__ pos, const float* __restrict__ R,
                               const T* __restrict__ vel, const T* __restrict__ Cm,
                               const float* __restrict__ mass, const int* __restrict__ ids,
                               float* __restrict__ pos_o, T* __restrict__ vel_o,
                               T* __restrict__ C_o, float* __restrict__ mass_o,
                               int* __restrict__ ids_o, int* __restrict__ cnt, int axis,
                               G2PParams p) {
  const Geom g = p.g;
  const size_t KC = (size_t)g.K * g.C;
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  const int co = axis_coord(g, c, axis);
  const int s = axis_stride(g, axis);
  const int n_a = axis_extent(g, axis);

  int n = 0;
  // candidates: own slots staying (shift 0), the left neighbour's slots
  // moving +1, the right neighbour's moving -1
  for (int src_i = 0; src_i < 3; ++src_i) {
    const int shift = src_i == 0 ? 0 : (src_i == 1 ? 1 : -1);
    const int src_co = co - shift;
    if (src_co < 0 || src_co >= n_a) continue;
    const int src = c - shift * s;
    for (int k = 0; k < g.K; ++k) {
      size_t i = (size_t)k * g.C + src;
      if (!(mass[i] > 0.f) || axis_delta(R[i], src_co) != (float)shift) continue;
      if (n < g.K) {
        size_t o = (size_t)n * g.C + c;
        for (int a = 0; a < 3; ++a) {
          pos_o[a * KC + o] = a == axis ? R[i] : pos[a * KC + i];
          vel_o[a * KC + o] = vel[a * KC + i];
        }
        for (int a = 0; a < 9; ++a) C_o[a * KC + o] = Cm[a * KC + i];
        mass_o[o] = mass[i];
        ids_o[o] = ids[i];
      }
      ++n;
    }
  }
  for (int j = n; j < g.K; ++j) {
    size_t o = (size_t)j * g.C + c;
    for (int a = 0; a < 3; ++a) {
      pos_o[a * KC + o] = 0.f;
      vel_o[a * KC + o] = 0;
    }
    for (int a = 0; a < 9; ++a) C_o[a * KC + o] = 0;
    mass_o[o] = 0.f;
    ids_o[o] = -1;
  }
  if (n > g.K) atomicAdd(cnt + CNT_LOST, n - g.K);
}

inline unsigned blocks_for(size_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

struct Buf {
  float* pos;
  void* vel;
  void* C;
  float* mass;
  int* ids;
};

template <typename VC, typename RAW>
cudaError_t launch(const G2PParams& p, Buf in, const float* gvel, Buf A, Buf B, float* R,
                   int* cnt, const mpm::RenderScals* rs, float* splats,
                   cudaStream_t stream) {
  const int T = 256;
  const size_t KC = (size_t)p.g.K * p.g.C;
  g2p_tail<VC><<<blocks_for(KC, T), T, 0, stream>>>(
      in.pos, in.mass, gvel, A.pos, (VC*)A.vel, (VC*)A.C, cnt, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // G2P leaves mass and ids unchanged: the z phase reads them from the input
  Buf src = {A.pos, A.vel, A.C, in.mass, in.ids};
  Buf dst = B;
  for (int axis = 2; axis >= 0; --axis) {  // z, y, x (bucketed.migrate)
    migrate_reject<<<blocks_for(p.g.C, T), T, 0, stream>>>(src.pos, src.mass, R, cnt, axis, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    migrate_select<RAW><<<blocks_for(p.g.C, T), T, 0, stream>>>(
        src.pos, R, (const RAW*)src.vel, (const RAW*)src.C, src.mass, src.ids, dst.pos,
        (RAW*)dst.vel, (RAW*)dst.C, dst.mass, dst.ids, cnt, axis, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    Buf next = (dst.pos == B.pos) ? A : B;
    src = dst;
    dst = next;
  }
  // src is now B, the result
  if (splats != nullptr)
    return mpm::launch_extract(src.pos, (const VC*)src.vel, src.mass, p.g.K, p.g.C, *rs,
                               splats, stream);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int g2p_migrate_params_size() { return (int)sizeof(G2PParams); }
int g2p_migrate_max_interactions() { return MAX_INTER; }

// Input state (pos, vel, C, mass, ids) and grid velocity gvel [3, C]. A and
// B are two full state buffers; the result is left in B. R is a [K, C]
// scratch row. cnt [4] int32 = lost, cfl_clamped, deferred, ceiling, added to.
// splats [5, C] f32, or null for no emission; scals: 16 host floats
// (mpm::RenderScals), read only when splats is not null.
int g2p_migrate(const void* params, const float* pos, const void* vel, const void* Cm,
                const float* mass, const int* ids, const float* gvel, float* a_pos,
                void* a_vel, void* a_C, float* a_mass, int* a_ids, float* b_pos, void* b_vel,
                void* b_C, float* b_mass, int* b_ids, float* R, int* cnt, int vc_bf16,
                const float* scals, float* splats, void* stream) {
  const G2PParams& p = *(const G2PParams*)params;
  Buf in = {(float*)pos, (void*)vel, (void*)Cm, (float*)mass, (int*)ids};
  Buf A = {a_pos, a_vel, a_C, a_mass, a_ids};
  Buf B = {b_pos, b_vel, b_C, b_mass, b_ids};
  mpm::RenderScals rs;
  if (splats != nullptr)
    for (int i = 0; i < 16; ++i) rs.s[i] = scals[i];
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = vc_bf16
      ? launch<__nv_bfloat16, uint16_t>(p, in, gvel, A, B, R, cnt, &rs, splats, s)
      : launch<float, uint32_t>(p, in, gvel, A, B, R, cnt, &rs, splats, s);
  return (int)err;
}

}  // extern "C"
