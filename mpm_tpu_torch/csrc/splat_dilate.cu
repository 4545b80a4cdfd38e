// The splat pass for Hopper (sm_90a): the z-buffer of the splat points (or
// their velocity key) and the sphere dilation of a z-buffer into impostor
// discs, each in hand-written CUDA.
//
// Replaces: no TPU kernel. The JAX package's z-buffer and dilation
// (mpm_tpu/render/splat.py) are plain jnp that XLA fuses; the port's plain
// versions, mpm_tpu_torch/render/splat.zbuffer_cells_plain,
// velocity_key_plain and _dilate_spheres, stay as the CPU path and the
// oracle. On the card the plain dilation runs 13 tap rows of about 7
// operations, each writing a full [h, 2R+1, w] intermediate: about 9 GB of
// traffic and 134 launches for a 1080p crop whose work needs some 8 MB.
//
// Z-buffer (splat_zbuffer): one launch fills the buffer (BG_DEPTH's bits, or
// KEY_EMPTY for the key), a second gives a thread a splat point: its centre
// pixel floor(px) - x0, floor(py) - y0, on the buffer and nearer than
// CELL_BG, takes an atomic min. A depth's float bits order as the depth
// while its sign bit is clear (atomicMin on the bits); a negative depth takes
// a compare-and-swap loop on the float. A min is exact in any order, so the
// buffer equals the plain scatter_reduce_(..., "amin") bit for bit.
//
// Dilation (splat_dilate): a thread a pixel, a block a tile of TW x TH
// pixels. The block stages its tile and an R-pixel halo of (depth, Q) in
// shared memory, Q = max((z / f)^2, r^2 / R^2) of an occupied source (z <
// BG_DEPTH), infinite otherwise, computed once a source as it loads (an
// exact division by f). The pixel starts at z - r where it is occupied, and
// walks its (2R+1)^2 - 1 taps, dy then dx ascending: the source at (y - dy,
// x - dx) offers z - sqrt_rn(r^2 - Q c), c = dx^2 + dy^2, where r^2 - Q c >=
// 0 (the plain version's NaN there becomes +inf and never wins, so such taps,
// and every tap of an empty source, are skipped). The depth keeps the least
// offer; with the velocity or the normals tracked an offer replaces the best
// only when strictly smaller, the JAX loop's tie rule, and the winner's
// velocity and its sphere-local offsets (dx, dy) sqrt(Q) / r are taken. A
// tile walks only the taps within its reach, the largest offset at which the
// least Q of its tile-plus-halo still offers: the others offer nothing to
// any of its pixels, and a tile with no occupied pixel in reach walks none.
// Every operation rounds as the plain version's, built with --fmad=false, so
// the buffers equal it bit for bit. With `raw` the depth is a z-buffer as it
// came out of splat_zbuffer or its slab composite: the plain version's
// decode (d < BG_DEPTH ? d : BG_DEPTH, the velocity from the key's low 12
// bits) happens as the kernel reads it.
//
// What bounds it on this card: the taps. A pixel has (2R+1)^2 - 1 = 168 at
// the benchmark's crop (992 x 1024, R = 6), a shared load, a multiply, an add
// and a compare each, and a correctly rounded square root and a min inside
// its sources' discs: some 1.7e8 taps a frame, against 8 MB of buffers in and
// out (utils/roofline.dilate_work). Its spheres (r 0.2 at depths near 80)
// reach 2 pixels, so the tiles' reach leaves a 5 x 5 walk of them.

#include <cuda_runtime.h>

#include <cstring>

// A named namespace, so that a trace names the kernels (splat::dilate<...>).
namespace splat {

constexpr float BG_DEPTH = 4000.0f;  // render/splat.BG_DEPTH
constexpr int KEY_EMPTY = 0x7F7FFFFF;  // render/splat.KEY_EMPTY
constexpr int TW = 32, TH = 8;         // a dilation block's tile of pixels
constexpr int MAX_SMEM = 232448;       // shared memory a block may use
constexpr int SCATTER_THREADS = 256;

struct DilateParams {
  int h, w, R;
  int raw;      // the depth is a raw z-buffer; the velocity comes from the key
  float focal;  // camera.focal_px in float32
  float r;      // the sphere radius
  float r2;     // r^2 in float32
  float q_clamp;  // r^2 / R^2 in float32
  float inv_r;    // 1 / r in float32
};

__global__ void fill(int* __restrict__ out, int n, int value) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = value;
}

// A float min at `slot` over float bits.
__device__ __forceinline__ void float_min(int* slot, float d) {
  const int bits = __float_as_int(d);
  if (bits >= 0) {  // a positive depth: its bits order as its value
    atomicMin(slot, bits);
    return;
  }
  int old = *slot;
  while (d < __int_as_float(old)) {
    const int prev = atomicCAS(slot, old, bits);
    if (prev == old) break;
    old = prev;
  }
}

// cells: [5, m] rows (pixel x, pixel y, depth, |vel|, count), `stride`
// floats apart (a slab's splats are a column slice of its padded rows). KEY:
// the velocity key (float bits of max(depth, 1e-6) & ~0xFFF) | clamp(|vel| *
// 64, 0, 4095), else the depth.
template <bool KEY>
__global__ void scatter(const float* __restrict__ cells, int m, int stride, int y0, int x0,
                        int h, int w, float cell_bg, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float d = cells[2 * (size_t)stride + i];
  const long long ix = __float2ll_rz(floorf(cells[i])) - x0;
  const long long iy = __float2ll_rz(floorf(cells[(size_t)stride + i])) - y0;
  if (!(ix >= 0 && ix < w && iy >= 0 && iy < h && d < cell_bg)) return;
  int* slot = out + (iy * w + ix);
  if (KEY) {
    float q = cells[3 * (size_t)stride + i] * 64.0f;
    q = isnan(q) ? q : fminf(fmaxf(q, 0.0f), 4095.0f);  // torch.clamp: NaN passes
    atomicMin(slot, (__float_as_int(fmaxf(d, 1e-6f)) & ~0xFFF) | __float2int_rz(q));
  } else {
    float_min(slot, d);
  }
}

__device__ __forceinline__ float key_velocity(int k) { return (float)(k & 0xFFF) * 0.015625f; }

// A thread a pixel of an [h, w] buffer; the tile of (depth, Q) with its halo
// in dynamic shared memory, (TW + 2R) x (TH + 2R) float2.
template <bool VEL, bool NRM>
__global__ void __launch_bounds__(TW * TH)
    dilate(const float* __restrict__ depth, const float* __restrict__ vel,
           const int* __restrict__ key, float* __restrict__ out_d, float* __restrict__ out_v,
           float* __restrict__ out_sx, float* __restrict__ out_sy, DilateParams p) {
  extern __shared__ float2 tile[];
  __shared__ float warp_qmin[TW * TH / 32];
  const int R = p.R, sw = TW + 2 * R, n = sw * (TH + 2 * R);
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, tid = threadIdx.y * TW + threadIdx.x;
  float qmin = INFINITY;
  for (int j = tid; j < n; j += TW * TH) {
    const int sy = j / sw, gy = y0 - R + sy, gx = x0 - R + (j - sy * sw);
    float d = BG_DEPTH, q = INFINITY;
    if (gy >= 0 && gy < p.h && gx >= 0 && gx < p.w) {
      d = depth[(size_t)gy * p.w + gx];
      if (p.raw && !(d < BG_DEPTH)) d = BG_DEPTH;
      if (d < BG_DEPTH) {
        const float t = d / p.focal;
        q = fmaxf(t * t, p.q_clamp);
        qmin = fminf(qmin, q);
      }
    }
    tile[j] = make_float2(d, q);
  }
  for (int o = 16; o > 0; o >>= 1) qmin = fminf(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
  if ((tid & 31) == 0) warp_qmin[tid >> 5] = qmin;
  __syncthreads();
  for (int k = 0; k < TW * TH / 32; ++k) qmin = fminf(qmin, warp_qmin[k]);
  // The tile's reach: the largest k <= R at which the tile's widest disc
  // (least Q) still offers on the axis, r^2 - Q k^2 >= 0. A tap with
  // max(|dx|, |dy|) > reach has c >= (reach + 1)^2, so r^2 - Q c < 0 for
  // every source of the tile (the rounded product and difference are
  // monotone): it never offers, and the walk stops short of it. 0 for a
  // tile whose tile-plus-halo is empty (Q infinite).
  int reach = R;
  while (reach > 0 && !(p.r2 - qmin * (float)(reach * reach) >= 0.0f)) --reach;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  // c[-dy * sw - dx]: the source at (y - dy, x - dx)
  const float2* c = tile + (threadIdx.y + R) * sw + threadIdx.x + R;
  const float d0 = c[0].x;
  float best = d0 < BG_DEPTH ? d0 - p.r : d0;  // a centre pixel shows its sphere's pole
  const size_t i = (size_t)y * p.w + x;
  constexpr bool TRACK = VEL || NRM;
  if (!TRACK && isnan(best)) best = INFINITY;  // torch.fmin(NaN, offer) is the offer
  int wdx = 0, wdy = 0;
  bool won = false;
  for (int dy = -reach; dy <= reach; ++dy) {
    const float2* row = c - dy * sw;
    for (int dx = -reach; dx <= reach; ++dx) {
      const float2 s = row[-dx];
      const float t = p.r2 - s.y * (float)(dx * dx + dy * dy);
      if (t >= 0.0f && (dx | dy)) {
        const float o = s.x - __fsqrt_rn(t);
        if (!TRACK) {
          best = fminf(best, o);
        } else if (o < best) {  // the first least offer in the walk's order wins
          best = o;
          wdx = dx;
          wdy = dy;
          won = true;
        }
      }
    }
  }
  out_d[i] = best;
  if (VEL) {
    const size_t src = won ? (size_t)(y - wdy) * p.w + (x - wdx) : i;
    out_v[i] = !p.raw ? vel[src] : (won || d0 < BG_DEPTH) ? key_velocity(key[src]) : 0.0f;
  }
  if (NRM) {
    float sx = 0.0f, sy = 0.0f;
    if (won) {
      const float sq = __fsqrt_rn(c[-wdy * sw - wdx].y) * p.inv_r;
      sx = (float)wdx * sq;
      sy = (float)wdy * sq;
    }
    out_sx[i] = sx;
    out_sy[i] = sy;
  }
}

int dilate_smem(int R) { return (TW + 2 * R) * (TH + 2 * R) * (int)sizeof(float2); }

// Raises a kernel's dynamic shared memory limit where `smem` needs it, once
// per device and size (set: the limits raised so far, by device).
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int* set) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && smem <= set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) set[dev] = smem;
  return err;
}

template <bool VEL, bool NRM>
int launch_dilate(const float* depth, const float* vel, const int* key, float* out_d,
                  float* out_v, float* out_sx, float* out_sy, const DilateParams& p,
                  cudaStream_t s) {
  static int set[64];
  const int smem = dilate_smem(p.R);
  cudaError_t err = allow_smem(dilate<VEL, NRM>, smem, set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.w + TW - 1) / TW, (p.h + TH - 1) / TH);
  dilate<VEL, NRM><<<grid, dim3(TW, TH), smem, s>>>(depth, vel, key, out_d, out_v, out_sx,
                                                      out_sy, p);
  return (int)cudaGetLastError();
}

}  // namespace splat

using namespace splat;

extern "C" {

// The dilation's dynamic shared memory at splat radius R; more than
// splat_dilate_max_smem() is refused (R above 75).
int splat_dilate_smem(int R) { return dilate_smem(R); }

int splat_dilate_max_smem() { return MAX_SMEM; }

// cells: [5, m] f32 on the device, its rows `stride` floats apart; out: [h,
// w] int32 (key) or the bits of f32 depths, on the device. The fill and the
// scatter are queued on `stream`.
int splat_zbuffer(const float* cells, int m, int stride, int y0, int x0, int h, int w,
                  float cell_bg, int key, int* out, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int empty = KEY_EMPTY;
  if (!key) std::memcpy(&empty, &BG_DEPTH, sizeof(int));
  const int n = h * w;
  fill<<<(n + 1023) / 1024, 256, 0, s>>>(out, n, empty);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m <= 0) return (int)err;
  const int blocks = (m + SCATTER_THREADS - 1) / SCATTER_THREADS;
  if (key)
    scatter<true><<<blocks, SCATTER_THREADS, 0, s>>>(cells, m, stride, y0, x0, h, w, cell_bg,
                                                     out);
  else
    scatter<false><<<blocks, SCATTER_THREADS, 0, s>>>(cells, m, stride, y0, x0, h, w, cell_bg,
                                                      out);
  return (int)cudaGetLastError();
}

// depth: [h, w] f32; vel: [h, w] f32 or null; key: [h, w] int32 or null (with
// raw); the outputs [h, w] f32, out_v with track_vel, out_sx and out_sy with
// track_nrm. Queued on `stream`.
int splat_dilate(const float* depth, const float* vel, const int* key, float* out_d,
                 float* out_v, float* out_sx, float* out_sy, int h, int w, int R, int raw,
                 float focal, float r, float r2, float q_clamp, float inv_r, int track_vel,
                 int track_nrm, void* stream) {
  if (R < 0 || dilate_smem(R) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return 0;
  const DilateParams p = {h, w, R, raw, focal, r, r2, q_clamp, inv_r};
  cudaStream_t s = (cudaStream_t)stream;
  if (track_vel && track_nrm)
    return launch_dilate<true, true>(depth, vel, key, out_d, out_v, out_sx, out_sy, p, s);
  if (track_vel)
    return launch_dilate<true, false>(depth, vel, key, out_d, out_v, out_sx, out_sy, p, s);
  if (track_nrm)
    return launch_dilate<false, true>(depth, vel, key, out_d, out_v, out_sx, out_sy, p, s);
  return launch_dilate<false, false>(depth, vel, key, out_d, out_v, out_sx, out_sy, p, s);
}

}  // extern "C"
