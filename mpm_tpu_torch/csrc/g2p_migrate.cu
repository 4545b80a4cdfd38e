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
// vel and C; the migration needs each slot's state read and written once
// more, beside the axis positions and masses its three phases choose by.
// The 27 grid-velocity reads per slot come from L1/L2 (the grid is 12 B per
// cell). The FLOPs are few.
//
// The design (the kernels are bucket_kernels.cuh's, for D = 3):
//   g2p_tail    one thread per slot over 27 nodes, then the tail.
//   per axis z, y, x, two launches:
//   reject      one thread per source cell, with the ceiling band on y.
//               Reading the counts of other cells and writing only its own
//               slots' row, it needs no ordering between threads.
//   select      one thread per destination cell, out of place into the
//               other buffer. It chooses (a bit mask of its 3K candidates)
//               apart from moving, and moves only what the next phase
//               reads: pos, mass and each slot's source index, 20 B a slot
//               instead of the whole state, its K output rows written in
//               step across a warp.
//   gather      one thread per output slot, after the last phase: vel, C
//               and ids moved once, through the composed source index, the
//               stores of a warp contiguous.
//   emission    when asked, kernel X's per-cell extraction
//               (extract_cells.cuh) runs as the chain's last launch, on the
//               post-migration buffers and the same stream. The TPU fused it
//               into the last sweep to save a re-read of the state; here the
//               re-read is the same ~40 MB at the pool window (tens of us),
//               so a separate launch is kept.
// The earlier select copied the whole state (three copies a substep,
// one serial candidate walk a cell with stores scattered over K rows). The
// TPU kernel's plane sweep, rings, packed bf16 pairs and zero-mover
// gates do not carry over. In fixed-point mode (fused.py:508-515) the grid
// velocity is int32 and the gather decodes each node as it reads it.
//
// Shard mode (fused.py:439-442, 985-996; parallel/domain.py): the state is
// a slab padded with two neighbour planes a side, the grid velocity has one
// plane more than the state on each side (go = 1), physical coordinates
// take the slab's global offset x0, and the counters count only the slab's
// own planes [2, L-3]. All of it is the parameter block's Slab; the whole
// grid is mpm::whole_grid().

#include "bucket_kernels.cuh"
#include "extract_cells.cuh"

namespace {

using mpm::Geom;

struct G2PParams {
  Geom g;
  int dres[3];
  int n_inter;
  int ceil_band_y;  // >= 0: upward y-moves out of cells with y >= this are rejected
  mpm::Slab slab;   // shard mode; mpm::whole_grid() otherwise
  float dt;
  float clamp_lo, clamp_hi_offset;
  float wall_min, wall_max_offset, wall_stiffness;
  float fixed_mult;  // fixed-point multiplier (read for an int32 grid only)
  const float* inter;  // device [n_inter, INTER_VALS<3>]; null when n_inter is 0
};

enum { CNT_LOST = 0, CNT_CFL = 1, CNT_DEFERRED = 2, CNT_CEILING = 3 };

template <typename VC, typename RAW, typename GT>
cudaError_t launch(const G2PParams& p, mpm::StateBuf<RAW> in, const GT* gvel,
                   mpm::StateBuf<RAW> A, mpm::StateBuf<RAW> B, float* R, int* cnt,
                   const mpm::RenderScals* rs, float* splats, cudaStream_t stream) {
  cudaError_t err = mpm::launch_g2p_tail<3>(p, in.pos, in.mass, gvel, A.pos, (VC*)A.vel,
                                            (VC*)A.C, cnt + CNT_CFL, stream, p.slab);
  if (err != cudaSuccess) return err;
  // G2P leaves mass and ids unchanged: the z phase reads them from the
  // input. The phases carry pos, mass and indices through B, A, B; the
  // payload gather then moves A's vel and C and the input's ids into B.
  mpm::StateBuf<RAW> src = {A.pos, A.vel, A.C, in.mass, in.ids};
  err = mpm::launch_migrate<3>(p.g, src, B, A, R, cnt + CNT_LOST, cnt + CNT_DEFERRED,
                               cnt + CNT_CEILING, p.ceil_band_y, stream, p.slab);
  if (err != cudaSuccess || splats == nullptr) return err;
  return mpm::launch_extract(B.pos, (const VC*)B.vel, B.mass, p.g.K, p.g.C, *rs, splats,
                             stream);
}

}  // namespace

extern "C" {

int g2p_migrate_params_size() { return (int)sizeof(G2PParams); }

// Input state (pos, vel, C, mass, ids) and grid velocity gvel [3, C] (on a
// slab [3, C + 2 * go * plane cells]), float32, or int32 fixed point when
// `fixed` (decoded as it is read). A and
// B are two full state buffers; the result is left in B. R is a [K, C]
// scratch row. cnt [4] int32 = lost, cfl_clamped, deferred, ceiling, added to.
// splats [5, C] f32, or null for no emission; scals: 16 host floats
// (mpm::RenderScals), read only when splats is not null.
int g2p_migrate(const void* params, const float* pos, const void* vel, const void* Cm,
                const float* mass, const int* ids, const void* gvel, float* a_pos,
                void* a_vel, void* a_C, float* a_mass, int* a_ids, float* b_pos, void* b_vel,
                void* b_C, float* b_mass, int* b_ids, float* R, int* cnt, int vc_bf16,
                int fixed, const float* scals, float* splats, void* stream) {
  const G2PParams& p = *(const G2PParams*)params;
  mpm::RenderScals rs;
  if (splats != nullptr)
    for (int i = 0; i < 16; ++i) rs.s[i] = scals[i];
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (vc_bf16) {
    using R16 = uint16_t;
    mpm::StateBuf<R16> in = {(float*)pos, (R16*)vel, (R16*)Cm, (float*)mass, (int*)ids};
    mpm::StateBuf<R16> A = {a_pos, (R16*)a_vel, (R16*)a_C, a_mass, a_ids};
    mpm::StateBuf<R16> B = {b_pos, (R16*)b_vel, (R16*)b_C, b_mass, b_ids};
    err = fixed ? launch<__nv_bfloat16>(p, in, (const int*)gvel, A, B, R, cnt, &rs, splats, s)
                : launch<__nv_bfloat16>(p, in, (const float*)gvel, A, B, R, cnt, &rs, splats, s);
  } else {
    using R32 = uint32_t;
    mpm::StateBuf<R32> in = {(float*)pos, (R32*)vel, (R32*)Cm, (float*)mass, (int*)ids};
    mpm::StateBuf<R32> A = {a_pos, (R32*)a_vel, (R32*)a_C, a_mass, a_ids};
    mpm::StateBuf<R32> B = {b_pos, (R32*)b_vel, (R32*)b_C, b_mass, b_ids};
    err = fixed ? launch<float>(p, in, (const int*)gvel, A, B, R, cnt, &rs, splats, s)
                : launch<float>(p, in, (const float*)gvel, A, B, R, cnt, &rs, splats, s);
  }
  return (int)err;
}

}  // extern "C"
