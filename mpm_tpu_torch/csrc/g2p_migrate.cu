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
// more. What its three phases choose by is a few bits a slot, so they move
// a one-byte code and a source index (about 10 B a slot a phase), not the
// positions and masses (about 56 B a slot a phase).
// The 27 grid-velocity reads per slot come from L1/L2 (the grid is 12 B per
// cell). The FLOPs are few.
//
// The design (the kernels are bucket_kernels.cuh's, for D = 3), five
// launches, six with the emission:
//   g2p_tail    one thread per slot over 27 nodes, then the tail; it also
//               writes each slot's code (mpm::SlotCode): occupied, and on
//               each axis the cell delta of its clamped position, which no
//               phase of another axis changes.
//   per axis z, y, x, one launch (migrate_select_codes):
//               one thread per destination cell reads the codes of cells
//               c-2 .. c+1 on the axis and decides from them the
//               conservative rejection of its own movers and of the movers
//               of its two neighbours into it (occupancy, ranks in slot
//               order, the right-movers of the cell two to the left, the
//               ceiling band on y: bucketed.reject_overflow's rule); then
//               it fills its K output slots out of place in [stay,
//               from-left, from-right] slot order, a code (the axis's field
//               now "rejected" or not) and a composed source index each, its
//               K output rows written in step across a warp.
//   gather      two output slots a thread, after the last phase
//               (migrate_gather_codes): pos, mass, vel, C and ids moved
//               once, through the composed source index, the stores of a
//               warp contiguous; on each axis whose field reads "rejected"
//               the position clamped into the output cell,
//               fminf(fmaxf(x, cg), cg + 1 - CFL_EPS), with the global cg
//               on x in shard mode.
//   emission    when asked, kernel X's per-cell extraction
//               (extract_cells.cuh) runs as the chain's last launch, on the
//               post-migration buffers and the same stream. The TPU fused it
//               into the last sweep to save a re-read of the state; here the
//               re-read is the same ~40 MB at the pool window (tens of us),
//               so a separate launch is kept.
// The per-pass kernel E and migrate2d keep the older chain, a reject and a
// select launch a phase that carry positions, masses and indices
// (mpm::launch_migrate). The TPU kernel's plane sweep, rings, packed
// bf16 pairs and zero-mover gates do not carry over. In fixed-point mode
// (fused.py:508-515) the grid velocity is int32 and the gather decodes each
// node as it reads it.
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

// A: G2P's pos, vel and C, and in A.ids the phases' scratch index row
// (A.mass is not read). codes: two [K, C] byte rows.
template <typename VC, typename RAW, typename GT>
cudaError_t launch(const G2PParams& p, mpm::StateBuf<RAW> in, const GT* gvel,
                   mpm::StateBuf<RAW> A, mpm::StateBuf<RAW> B, uint8_t* codes, int* cnt,
                   const mpm::RenderScals* rs, float* splats, cudaStream_t stream) {
  const size_t KC = (size_t)p.g.K * p.g.C;
  cudaError_t err = mpm::launch_g2p_tail<3>(p, in.pos, in.mass, gvel, A.pos, (VC*)A.vel,
                                            (VC*)A.C, cnt + CNT_CFL, stream, p.slab, codes);
  if (err != cudaSuccess) return err;
  // G2P leaves mass and ids unchanged: the gather reads them from the
  // input, and pos, vel and C from A, and writes B.
  mpm::StateBuf<RAW> src = {A.pos, A.vel, A.C, in.mass, in.ids};
  err = mpm::launch_migrate_codes<3>(p.g, src, B, codes, codes + KC, A.ids, cnt + CNT_LOST,
                                     cnt + CNT_DEFERRED, cnt + CNT_CEILING, p.ceil_band_y,
                                     stream, p.slab);
  if (err != cudaSuccess || splats == nullptr) return err;
  return mpm::launch_extract(B.pos, (const VC*)B.vel, B.mass, p.g.K, p.g.C, *rs, splats,
                             stream);
}

}  // namespace

extern "C" {

int g2p_migrate_params_size() { return (int)sizeof(G2PParams); }

// Input state (pos, vel, C, mass, ids) and grid velocity gvel [3, C] (on a
// slab [3, C + 2 * go * plane cells]), float32, or int32 fixed point when
// `fixed` (decoded as it is read). A (pos, vel, C, ids) and B (a full state)
// are scratch and output; the result is left in B. codes is a [2, K, C]
// byte scratch. cnt [4] int32 = lost, cfl_clamped, deferred, ceiling, added to.
// splats [5, C] f32, or null for no emission; scals: 16 host floats
// (mpm::RenderScals), read only when splats is not null.
int g2p_migrate(const void* params, const float* pos, const void* vel, const void* Cm,
                const float* mass, const int* ids, const void* gvel, float* a_pos,
                void* a_vel, void* a_C, int* a_ids, float* b_pos, void* b_vel, void* b_C,
                float* b_mass, int* b_ids, uint8_t* codes, int* cnt, int vc_bf16,
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
    mpm::StateBuf<R16> A = {a_pos, (R16*)a_vel, (R16*)a_C, nullptr, a_ids};
    mpm::StateBuf<R16> B = {b_pos, (R16*)b_vel, (R16*)b_C, b_mass, b_ids};
    err = fixed
              ? launch<__nv_bfloat16>(p, in, (const int*)gvel, A, B, codes, cnt, &rs, splats, s)
              : launch<__nv_bfloat16>(p, in, (const float*)gvel, A, B, codes, cnt, &rs, splats, s);
  } else {
    using R32 = uint32_t;
    mpm::StateBuf<R32> in = {(float*)pos, (R32*)vel, (R32*)Cm, (float*)mass, (int*)ids};
    mpm::StateBuf<R32> A = {a_pos, (R32*)a_vel, (R32*)a_C, nullptr, a_ids};
    mpm::StateBuf<R32> B = {b_pos, (R32*)b_vel, (R32*)b_C, b_mass, b_ids};
    err = fixed ? launch<float>(p, in, (const int*)gvel, A, B, codes, cnt, &rs, splats, s)
                : launch<float>(p, in, (const float*)gvel, A, B, codes, cnt, &rs, splats, s);
  }
  return (int)err;
}

}  // extern "C"
