// Kernel BL for Hopper (sm_90a): the depth-adaptive separable bilateral blur
// of the SSFR depth buffer, an X pass then a Y pass, each staged in shared
// memory.
//
// Replaces: mpm_tpu/render/blur_kernel.py:_pass_kernel (launched by
// blur_depth_pallas, X pass and Y pass). The plain PyTorch version is
// mpm_tpu_torch/render/blur_kernel.blur_depth_plain.
//
// Per live pixel (0 < d <= FAR_GUARD) of a pass:
//   fsize = min(max_filter, ceil(proj_const / max(d, 1e-3)), radius)
//   sigma = max(fsize / 3, 1e-3)
//   num = d, den = 1; for k = 1..fsize, the tap at -k then the one at +k:
//     w = expf(-(k^2 / (2 sigma^2) + (s - d)^2 / (2 depth_threshold^2)))
//     num += s w, den += w
//   out = num / max(den, 1e-9)
// Taps outside the image read BG_DEPTH (the Pallas kernel's padding); pixels
// that are not live pass through. One exponential per tap, as the Pallas
// kernel computes it; the TPU's block-wide trip count added exact zeros past
// a pixel's own fsize, so stopping at fsize gives the same sums.
//
// What bounds it on this card: the taps, some 15 float instructions each
// (one exponential, on the special-function units at 16 a clock an SM
// against 128 float lanes), and the serial tap loop of the pixels nearest
// the camera: a pixel's sum is one chain of up to 2 x 100 taps a pass. At
// the render crops (fsize <= 13) a call is a few microseconds of device time
// and its host wrapper; the buffers are a few MB and stay in L2.
//
// The design: two launches on the stream. The X pass gives each warp a row's
// 32 pixels: it stages the row from x0 - r to x0 + 32 + r in its own buffer
// in shared memory, r the largest filter size of the 32, and sums each
// pixel's taps from there into tmp, and the least live depth it wrote. The
// Y pass gives a block a tile of 8 rows by 32 columns: from its rows' least
// depths it has the tile's largest filter size R before it loads anything
// else, stages the tile's rows of tmp with the R rows above and below in one
// round trip, and sums each pixel's taps from the staged column strip, a
// shared load a tap instead of a dependent load from L2. Every pixel
// sums its taps in the plain version's order, one expf each, built with
// --fmad=false: the result equals the plain version bit for bit. One launch
// for both passes, the tile's R halo rows' X pass done again in each tile
// and never written out, ran slower summed over the render crops and the
// near-patch frames (PERF.md).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr float FAR_GUARD = 3990.0f;  // render/ssfr.FAR_GUARD
constexpr float BG_DEPTH = 4000.0f;   // render/splat.BG_DEPTH
constexpr int TW = 32;                // a segment's and a tile's columns: a warp's lanes
constexpr int TH = 8;                 // a Y tile's rows
constexpr int NWARPS = 8;             // warps a block
constexpr int MAX_SMEM = 232448;      // shared memory a block may use

struct BlurParams {
  int h, w;
  int radius, max_filter;
  float proj_const;  // projected particle constant, pixels x depth
  float inv_2sr2;    // 1 / (2 depth_threshold^2)
  int reach;         // min(radius, max_filter): no filter size exceeds it
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ bool live(float d) { return d > 0.f && d <= FAR_GUARD; }

// The filter size of a live pixel of depth d, and its 1 / (2 sigma^2).
__device__ __forceinline__ int filter_size(float d, const BlurParams& p, float& inv_2ss2) {
  float fsize = fminf((float)p.max_filter, ceilf(p.proj_const / fmaxf(d, 1e-3f)));
  fsize = fminf(fsize, (float)p.radius);
  const float sigma = fmaxf(fsize / 3.0f, 1e-3f);
  inv_2ss2 = 1.0f / (2.0f * sigma * sigma);
  return (int)fsize;
}

// One pixel's weighted sum over its n taps on each side, tap(k) reading the
// sample k steps along the pass (BG_DEPTH outside the image).
template <typename Tap>
__device__ __forceinline__ float blur_sum(float d, int n, float inv_2ss2, float inv_2sr2,
                                          Tap tap) {
  float num = d, den = 1.0f;
  for (int k = 1; k <= n; ++k) {
    const float kf = (float)k;
    const float ws = (kf * kf) * inv_2ss2;
    const float sm = tap(-k);
    const float rm = sm - d;
    const float wm = expf(-(ws + (rm * rm) * inv_2sr2));
    num = num + sm * wm;
    den = den + wm;
    const float sp = tap(k);
    const float rp = sp - d;
    const float wp = expf(-(ws + (rp * rp) * inv_2sr2));
    num = num + sp * wp;
    den = den + wp;
  }
  return num / fmaxf(den, 1e-9f);
}

// A pixel of depth d: itself if not live, else its weighted sum.
template <typename Tap>
__device__ __forceinline__ float blur_pixel(float d, const BlurParams& p, Tap tap) {
  if (!live(d)) return d;
  float inv_2ss2;
  const int n = filter_size(d, p, inv_2ss2);
  return blur_sum(d, n, inv_2ss2, p.inv_2sr2, tap);
}

// The X pass: a block of NWARPS rows by TW columns, a warp a row segment. A
// warp's buffer holds columns x0 - reach .. x0 + TW + reach. Each segment's
// least live result goes to seg_min[bx * h + y] as its float bits (live
// depths are positive, so the bits order as the depths; INT_MAX: none), from
// which the Y pass finds its tile's largest filter size.
__global__ void __launch_bounds__(NWARPS * 32)
    blur_x(const float* __restrict__ in, float* __restrict__ tmp, int* __restrict__ seg_min,
           BlurParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TW, y = blockIdx.y * NWARPS + warp, x = x0 + lane;
  if (y >= p.h) return;
  const float* row = in + (size_t)y * p.w;
  const float d = x < p.w ? row[x] : 0.f;
  float inv_2ss2;
  const int n = x < p.w && live(d) ? filter_size(d, p, inv_2ss2) : 0;
  const int r = __reduce_max_sync(0xffffffffu, n);
  float* seg = smem + warp * (TW + 2 * p.reach) + p.reach;  // seg[j]: column x0 + j
  for (int j = lane - r; j < TW + r; j += 32)
    seg[j] = x0 + j >= 0 && x0 + j < p.w ? row[x0 + j] : BG_DEPTH;
  __syncwarp();
  int m = INT_MAX;
  if (x < p.w) {
    const float o = blur_pixel(d, p, [&](int k) { return seg[lane + k]; });
    tmp[(size_t)y * p.w + x] = o;
    if (live(o)) m = __float_as_int(o);
  }
  m = __reduce_min_sync(0xffffffffu, m);
  if (lane == 0) seg_min[(size_t)blockIdx.x * p.h + y] = m;
}

// The Y pass: a block a tile of TH rows by TW columns. Its largest filter
// size R is that of the least live depth of its rows' segments (the filter
// size falls as the depth grows); the strip of rows y0 - R .. y0 + TH + R of
// tmp (inside the image) is staged, and each pixel's taps read from it.
__global__ void __launch_bounds__(NWARPS * 32)
    blur_y(const float* __restrict__ tmp, const int* __restrict__ seg_min,
           float* __restrict__ out, BlurParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, x = x0 + lane;
  const int y1 = min(y0 + TH, p.h);  // the tile's rows: [y0, y1)
  int m = lane < y1 - y0 ? seg_min[(size_t)blockIdx.x * p.h + y0 + lane] : INT_MAX;
  m = __reduce_min_sync(0xffffffffu, m);
  float inv_2ss2;
  const int R = m == INT_MAX ? 0 : imax(filter_size(__int_as_float(m), p, inv_2ss2), 0);
  float* col = smem + p.reach * TW + lane;  // col[(y - y0) * TW]: row y
  for (int y = max(y0 - R, 0) + warp; y < min(y1 + R, p.h); y += NWARPS)
    col[(y - y0) * TW] = x < p.w ? tmp[(size_t)y * p.w + x] : 0.f;
  __syncthreads();
  if (x >= p.w) return;
  for (int y = y0 + warp; y < y1; y += NWARPS) {
    const float* c = col + (y - y0) * TW;  // c[k * TW]: row y + k
    out[(size_t)y * p.w + x] = blur_pixel(c[0], p, [&](int k) {
      return y + k >= 0 && y + k < p.h ? c[k * TW] : BG_DEPTH;
    });
  }
}

int smem_x(int reach) { return NWARPS * (TW + 2 * reach) * (int)sizeof(float); }
int smem_y(int reach) { return TW * (TH + 2 * reach) * (int)sizeof(float); }

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

}  // namespace

extern "C" {

// The larger dynamic shared memory of the two launches; more than
// blur_depth_max_smem() is refused: min(radius, max_filter) over 904.
int blur_depth_smem(int radius, int max_filter) {
  const int reach = imax(0, min(radius, max_filter));
  return imax(smem_x(reach), smem_y(reach));
}

int blur_depth_max_smem() { return MAX_SMEM; }

// 4-byte words of the scratch buffer of a call on an [h, w] buffer: the X
// pass, then each row segment's least live result.
int blur_depth_scratch_words(int h, int w) { return h * w + h * ((w + TW - 1) / TW); }

// depth and out: [h, w] f32 on the device; scratch: blur_depth_scratch_words
// on the device. Both passes are queued on `stream`.
int blur_depth(const float* depth, float* scratch, float* out, int h, int w, int radius,
               int max_filter, float proj_const, float inv_2sr2, void* stream) {
  const BlurParams p = {h, w, radius, max_filter, proj_const, inv_2sr2,
                        imax(0, min(radius, max_filter))};
  const int sx = smem_x(p.reach), sy = smem_y(p.reach);
  if (imax(sx, sy) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static int set_x[64], set_y[64];
  cudaError_t err = allow_smem(blur_x, sx, set_x);
  if (err == cudaSuccess) err = allow_smem(blur_y, sy, set_y);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 gx((w + TW - 1) / TW, (h + NWARPS - 1) / NWARPS);
  int* seg_min = (int*)(scratch + (size_t)h * w);
  blur_x<<<gx, NWARPS * 32, sx, s>>>(depth, scratch, seg_min, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blur_y<<<dim3((w + TW - 1) / TW, (h + TH - 1) / TH), NWARPS * 32, sy, s>>>(scratch, seg_min,
                                                                           out, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
