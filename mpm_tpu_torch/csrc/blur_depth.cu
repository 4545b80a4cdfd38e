// Kernel BL for Hopper (sm_90a): the depth-adaptive separable bilateral blur
// of the SSFR depth buffer, an X pass then a Y pass.
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
// What bounds it on this card: the exponentials and the tap reads, up to 2 x
// 100 per pixel and pass near the camera. The simple design: one thread per
// pixel, blocks of 128 threads along a row. Neighbouring threads read
// neighbouring addresses in both passes (the X pass's taps overlap from
// thread to thread, the Y pass's rows are 128 floats wide), so the reads are
// served by L1/L2 with no shared memory. A warp costs its largest fsize.
// Built with --fmad=false and expf (no fast math), so it rounds as the plain
// version does on the card.

#include <cuda_runtime.h>

namespace {

constexpr float FAR_GUARD = 3990.0f;  // render/ssfr.FAR_GUARD
constexpr float BG_DEPTH = 4000.0f;   // render/splat.BG_DEPTH

struct BlurParams {
  int h, w;
  int radius, max_filter;
  float proj_const;  // projected particle constant, pixels x depth
  float inv_2sr2;    // 1 / (2 depth_threshold^2)
};

__global__ void blur_pass(const float* __restrict__ in, float* __restrict__ out, int axis,
                          BlurParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= p.w) return;
  const size_t i = (size_t)y * p.w + x;
  const float d = in[i];
  if (!(d > 0.f && d <= FAR_GUARD)) {
    out[i] = d;
    return;
  }
  float fsize = fminf((float)p.max_filter, ceilf(p.proj_const / fmaxf(d, 1e-3f)));
  fsize = fminf(fsize, (float)p.radius);
  const float sigma = fmaxf(fsize / 3.0f, 1e-3f);
  const float inv_2ss2 = 1.0f / (2.0f * sigma * sigma);
  const int co = axis == 1 ? x : y;          // coordinate along the pass
  const int n_a = axis == 1 ? p.w : p.h;     // extent along the pass
  const long stride = axis == 1 ? 1 : p.w;   // element step along the pass
  const int n = (int)fsize;
  float num = d, den = 1.0f;
  for (int k = 1; k <= n; ++k) {
    const float kf = (float)k;
    const float ws = (kf * kf) * inv_2ss2;
    const float sm = co - k >= 0 ? in[i - k * stride] : BG_DEPTH;
    const float rm = sm - d;
    const float wm = expf(-(ws + (rm * rm) * p.inv_2sr2));
    num = num + sm * wm;
    den = den + wm;
    const float sp = co + k < n_a ? in[i + k * stride] : BG_DEPTH;
    const float rp = sp - d;
    const float wp = expf(-(ws + (rp * rp) * p.inv_2sr2));
    num = num + sp * wp;
    den = den + wp;
  }
  out[i] = num / fmaxf(den, 1e-9f);
}

}  // namespace

extern "C" {

// depth, tmp and out: [h, w] f32 on the device; tmp holds the X pass. Both
// passes are queued on `stream`.
int blur_depth(const float* depth, float* tmp, float* out, int h, int w, int radius,
               int max_filter, float proj_const, float inv_2sr2, void* stream) {
  BlurParams p = {h, w, radius, max_filter, proj_const, inv_2sr2};
  const int T = 128;
  dim3 grid((w + T - 1) / T, h);
  cudaStream_t s = (cudaStream_t)stream;
  blur_pass<<<grid, T, 0, s>>>(depth, tmp, 1, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blur_pass<<<grid, T, 0, s>>>(tmp, out, 0, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
