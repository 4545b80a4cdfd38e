// Kernel SH for Hopper (sm_90a): the SSFR shade pass of the default render
// mode (fluid_render_fixed_depth.glsl:52-153 as ported), composited over the
// background into the full frame, in one launch.
//
// Replaces: no TPU kernel. The JAX package's shade (mpm_tpu/render/ssfr.py:
// 232) is plain jnp that XLA fuses; the port's plain version,
// mpm_tpu_torch/render/ssfr.shade, is some 170 small PyTorch ops a frame on
// the card plus the upload of its constants, so the host's launch rate, not
// the card, set its time. This kernel takes those ops into one launch and
// gets every constant of the pass by value (render/shade_kernel.ShadeArgs,
// built once for each view, camera, parameters and crop).
//
// Per pixel of the depth buffer (the crop, or the frame): live when depth <=
// FAR_GUARD and the background is no nearer. A live pixel's view position
// and those of its four neighbours (wrapping at the buffer's edges, as
// torch.roll does) give the normal by the min-|dz| pick and a cross product;
// then the ray, the Blinn specular, the Schlick Fresnel, the reflection
// rotated to world space and sampled from the procedural sky or a cubemap's
// nearest texel, the refraction's offset gather from the background (with
// downsample N > 1, pixel (y, x) of the buffer takes the sample of (y / N * N,
// x / N * N), computed from that pixel's own normal), Beer's law, and the
// composite. Every other pixel of the frame takes the background's colour.
//
// What bounds it on this card: bytes. A frame pixel reads and writes 12 bytes
// of colour, a buffer pixel reads its depth and the background's, writes its
// live byte, and a live one gathers one refracted sample; some 225 float
// operations a live pixel are far under the card's float32 rate. At the
// benchmark's 1080p frame that is about 59 MB, 18 us at 3.35 TB/s.
//
// The design: one thread a frame pixel, 32 x 8 tiles, so one pass writes the
// whole frame and no copy of the background precedes it; the neighbours'
// depths come through the L1 cache, shared by the tile's rows. Each pixel
// computes in the plain version's order, operation for operation, built with
// --fmad=false: IEEE division and sqrtf where the plain version divides and
// takes roots, powf and expf where it calls torch.pow and torch.exp, dot
// products and norms summed left to right, and torch's clamps (NaN passes
// through). The reflection's rotation `refl_v @ rot` is a cuBLAS product in
// the plain version; here it is a chain of fused multiply-adds over the
// rows in order. torch.pow takes x * x, x * x * x, a square root or a
// reciprocal for the exponents 2, 3, +-0.5, -1 and -2, which this kernel's
// powf may round apart from in the last bit.

#include <cuda_runtime.h>

namespace {

constexpr float FAR_GUARD = 3990.0f;  // render/ssfr.FAR_GUARD
constexpr int TW = 32, TH = 8;        // a block's tile of frame pixels

// render/shade_kernel.ShadeArgs, field for field.
struct ShadeArgs {
  int fh, fw;        // the frame
  int y0, x0, h, w;  // the depth buffer's rectangle in the frame
  int ds;            // the refraction gather's stride
  int faces;         // the cubemap's face size; 0: the procedural sky
  float focal;       // camera.focal_px
  float ox, oy;      // 0.5 + x0, 0.5 + y0
  float half_w, half_h;
  float rot[9];      // the view's rotation, rows
  float light[3];    // view space, from the surface toward the light
  float spec_power, fresnel_clamp, f0, one_minus_f0;
  float eta, eta2;   // ETA and ETA * ETA
  float uv_scale;    // thickness * refraction_strength
  float refr_strength, thickness;
  float absorb[3];   // -optical_density * (1 - diffuse_color)
  float horizon[3], zenith[3], ground[3], sun_dir[3], sun_color[3];
  float sun_cos, sun_width;
};

struct V3 {
  float x, y, z;
};

// torch.clamp_min and torch.clamp on the card: NaN passes through.
__device__ __forceinline__ float clamp_min_t(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float dot3(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

__device__ __forceinline__ float norm3(V3 v) { return sqrtf((v.x * v.x + v.y * v.y) + v.z * v.z); }

__device__ __forceinline__ V3 normalized(V3 v) {
  const float n = clamp_min_t(norm3(v), 1e-9f);
  return {v.x / n, v.y / n, v.z / n};
}

// Tan offsets of buffer column c and row r (camera._pixel_axes).
__device__ __forceinline__ float tan_x(int c, const ShadeArgs& a) {
  return ((float)c + a.ox - a.half_w) / a.focal;
}
__device__ __forceinline__ float tan_y(int r, const ShadeArgs& a) {
  return -(((float)r + a.oy - a.half_h) / a.focal);
}

// One axis of reconstruct_normals' pick: (next - here) unless its |dz| is
// the larger, then -(prev - here).
__device__ __forceinline__ V3 pick(V3 here, V3 next, V3 prev) {
  const V3 d1 = {next.x - here.x, next.y - here.y, next.z - here.z};
  const V3 d2 = {-(prev.x - here.x), -(prev.y - here.y), -(prev.z - here.z)};
  return fabsf(d1.z) > fabsf(d2.z) ? d2 : d1;
}

// What the shade needs of buffer pixel (r, c): its unit normal, its ray and
// cos(normal, -ray).
struct Surface {
  V3 n, ray;
  float cos_t;
};

__device__ Surface surface_at(const float* __restrict__ depth, int r, int c,
                              const ShadeArgs& a) {
  const int rn = r + 1 == a.h ? 0 : r + 1, rp = r == 0 ? a.h - 1 : r - 1;
  const int cn = c + 1 == a.w ? 0 : c + 1, cp = c == 0 ? a.w - 1 : c - 1;
  const float tx = tan_x(c, a), ty = tan_y(r, a);
  const float d = depth[(size_t)r * a.w + c];
  const float dyn = depth[(size_t)rn * a.w + c], dyp = depth[(size_t)rp * a.w + c];
  const float dxn = depth[(size_t)r * a.w + cn], dxp = depth[(size_t)r * a.w + cp];
  const float tyn = tan_y(rn, a), typ = tan_y(rp, a);
  const float txn = tan_x(cn, a), txp = tan_x(cp, a);
  const V3 here = {tx * d, ty * d, -d};
  const V3 dy = pick(here, {tx * dyn, tyn * dyn, -dyn}, {tx * dyp, typ * dyp, -dyp});
  const V3 dx = pick(here, {txn * dxn, ty * dxn, -dxn}, {txp * dxp, ty * dxp, -dxp});
  Surface s;
  s.n = normalized({dy.y * dx.z - dy.z * dx.y, dy.z * dx.x - dy.x * dx.z,
                    dy.x * dx.y - dy.y * dx.x});
  const float rl = sqrtf((tx * tx + ty * ty) + 1.0f);
  s.ray = {tx / rl, ty / rl, -1.0f / rl};
  s.cos_t = dot3(s.n, {-s.ray.x, -s.ray.y, -s.ray.z});
  return s;
}

// The flat index into the frame of pixel (r, c)'s refracted background
// sample; uvs: its thickness times the refraction strength.
__device__ __forceinline__ int refracted(const Surface& s, float uvs, int r, int c,
                                        const ShadeArgs& a) {
  const float cos_i = clamp_t(s.cos_t, -1.0f, 1.0f);
  const float k = 1.0f - a.eta2 * (1.0f - cos_i * cos_i);
  const float coef = a.eta * cos_i - sqrtf(clamp_min_t(k, 0.0f));
  const float rx = a.eta * s.ray.x + coef * s.n.x;
  const float ry = a.eta * s.ray.y + coef * s.n.y;
  const float fw = (float)a.fw, fh = (float)a.fh;
  const int sx = (int)clamp_t((float)(c + a.x0) + (rx * uvs) * fw, 0.0f, fw - 1.0f);
  const int sy = (int)clamp_t((float)(r + a.y0) - (ry * uvs) * fh, 0.0f, fh - 1.0f);
  return sy * a.fw + sx;
}

// background.sky_color of a world direction.
__device__ __forceinline__ void sky(V3 d, const ShadeArgs& a, float out[3]) {
  const float y = clamp_t(d.y, -1.0f, 1.0f);
  const float t = clamp_t(y, 0.0f, 1.0f);
  const float below = clamp_t(-y, 0.0f, 1.0f);
  const float cs = dot3(d, {a.sun_dir[0], a.sun_dir[1], a.sun_dir[2]});
  const float sun = clamp_t((cs - a.sun_cos) / a.sun_width, 0.0f, 1.0f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float col = a.horizon[ch] * (1.0f - t) + a.zenith[ch] * t;
    out[ch] = (col * (1.0f - below) + a.ground[ch] * below) + sun * a.sun_color[ch];
  }
}

// background.make_cubemap_sampler's nearest texel of a world direction.
__device__ __forceinline__ void cubemap(V3 d, const float* __restrict__ faces,
                                        const ShadeArgs& a, float out[3]) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const bool is_x = ax >= ay && ax >= az;
  const bool is_y = !is_x && ay >= az;
  const int face = is_x ? (d.x > 0.0f ? 0 : 1) : is_y ? (d.y > 0.0f ? 2 : 3) : (d.z > 0.0f ? 4 : 5);
  const float ma = clamp_min_t(is_x ? ax : is_y ? ay : az, 1e-9f);
  const float u = is_x ? (d.x > 0.0f ? -d.z : d.z) : is_y ? d.x : (d.z > 0.0f ? d.x : -d.x);
  const float v = is_x ? -d.y : is_y ? (d.y > 0.0f ? d.z : -d.z) : -d.y;
  const int f = a.faces;
  const float fm1 = (float)(f - 1);
  const int ui = min(max((int)(((u / ma + 1.0f) * 0.5f) * fm1), 0), f - 1);
  const int vi = min(max((int)(((v / ma + 1.0f) * 0.5f) * fm1), 0), f - 1);
  const float* texel = faces + (((size_t)face * f + vi) * f + ui) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) out[ch] = texel[ch];
}

__global__ void __launch_bounds__(TW * TH)
    ssfr_shade_kernel(const float* __restrict__ depth, const float* __restrict__ bg_color,
                      const float* __restrict__ bg_depth, const float* __restrict__ thickness,
                      const float* __restrict__ faces, float* __restrict__ out,
                      unsigned char* __restrict__ live_out, const ShadeArgs a) {
  const int fx = blockIdx.x * TW + threadIdx.x, fy = blockIdx.y * TH + threadIdx.y;
  if (fx >= a.fw || fy >= a.fh) return;
  const size_t px = (size_t)fy * a.fw + fx;
  const int r = fy - a.y0, c = fx - a.x0;
  bool live = false;
  if (r >= 0 && r < a.h && c >= 0 && c < a.w) {
    const float d = depth[(size_t)r * a.w + c];
    live = d <= FAR_GUARD && bg_depth[px] >= d;
    live_out[(size_t)r * a.w + c] = live;
  }
  if (!live) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[px * 3 + ch] = bg_color[px * 3 + ch];
    return;
  }
  const Surface s = surface_at(depth, r, c, a);
  const V3 lh = {a.light[0] - s.ray.x, a.light[1] - s.ray.y, a.light[2] - s.ray.z};
  const float spec = powf(clamp_min_t(dot3(normalized(lh), s.n), 0.0f), a.spec_power);
  const float fres = clamp_t(
      a.f0 + a.one_minus_f0 * powf(clamp_min_t(1.0f - s.cos_t, 0.0f), 5.0f), 0.0f,
      a.fresnel_clamp);

  // the reflection, rotated to world space: refl_v @ rot
  const float tc = 2.0f * s.cos_t;
  const V3 rv = {s.ray.x - tc * -s.n.x, s.ray.y - tc * -s.n.y, s.ray.z - tc * -s.n.z};
  V3 world;
  world.x = fmaf(rv.z, a.rot[6], fmaf(rv.y, a.rot[3], rv.x * a.rot[0]));
  world.y = fmaf(rv.z, a.rot[7], fmaf(rv.y, a.rot[4], rv.x * a.rot[1]));
  world.z = fmaf(rv.z, a.rot[8], fmaf(rv.y, a.rot[5], rv.x * a.rot[2]));
  float refl[3];
  if (a.faces > 0)
    cubemap(world, faces, a, refl);
  else
    sky(world, a, refl);

  const size_t pix = (size_t)r * a.w + c;
  const float thick = thickness != nullptr ? thickness[pix] : a.thickness;
  int src;
  if (a.ds > 1 && (r % a.ds != 0 || c % a.ds != 0)) {
    const int ra = r / a.ds * a.ds, ca = c / a.ds * a.ds;
    const float uva = thickness != nullptr ? thickness[(size_t)ra * a.w + ca] * a.refr_strength
                                           : a.uv_scale;
    src = refracted(surface_at(depth, ra, ca, a), uva, ra, ca, a);
  } else {
    src = refracted(s, thickness != nullptr ? thick * a.refr_strength : a.uv_scale, r, c, a);
  }
  const float* sample = bg_color + (size_t)src * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float refr = sample[ch] * expf(a.absorb[ch] * thick);
    out[px * 3 + ch] = (refr * (1.0f - fres) + refl[ch] * fres) + spec;
  }
}

}  // namespace

extern "C" {

// depth (and thickness, or null): [h, w] f32; bg_color, out: [fh, fw, 3]
// f32; bg_depth: [fh, fw] f32; faces: [6, F, F, 3] f32 or null; live: [h,
// w] bytes; all on the device. args: a host ShadeArgs, read before the
// launch returns. Queued on `stream`.
int ssfr_shade(const float* depth, const float* bg_color, const float* bg_depth,
               const float* thickness, const float* faces, float* out, unsigned char* live,
               const void* args, void* stream) {
  const ShadeArgs a = *static_cast<const ShadeArgs*>(args);
  const dim3 grid((a.fw + TW - 1) / TW, (a.fh + TH - 1) / TH);
  ssfr_shade_kernel<<<grid, dim3(TW, TH), 0, (cudaStream_t)stream>>>(
      depth, bg_color, bg_depth, thickness, faces, out, live, a);
  return (int)cudaGetLastError();
}

int ssfr_shade_args_bytes() { return (int)sizeof(ShadeArgs); }

}  // extern "C"
