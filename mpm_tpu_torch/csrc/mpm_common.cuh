// Shared device helpers for the bucket-state kernels (p2g_update.cu,
// g2p_migrate.cu).
//
// Layout (the JAX package's, mpm_tpu/ops/bucketed.py): pos [3, K, C],
// vel [3, K, C], C [9, K, C], mass [K, C], ids [K, C], with C the flat
// row-major cell index (x slowest, z fastest) and element (row, k, c) at
// (row * K + k) * C + c. mass == 0 marks an empty slot.
//
// Arithmetic follows the plain PyTorch version (ops/bucketed.py) operation
// for operation. Kernel F builds with --fmad=false, so it rounds where the
// plain version rounds; kernel P lets nvcc fuse multiply-adds and differs
// from it in the last bit (ops/cuda/build.py says why).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mpm {

constexpr float CFL_EPS = 1e-3f;  // ops/bucketed.CFL_EPS

struct Geom {
  int nx, ny, nz;  // array extents (grid_res)
  int K;           // slots per cell
  int C;           // nx * ny * nz
};

__device__ __forceinline__ void cell_xyz(const Geom& g, int c, int& x, int& y, int& z) {
  z = c % g.nz;
  y = (c / g.nz) % g.ny;
  x = c / (g.nz * g.ny);
}

__device__ __forceinline__ bool in_grid(const Geom& g, int x, int y, int z) {
  return x >= 0 && x < g.nx && y >= 0 && y < g.ny && z >= 0 && z < g.nz;
}

__device__ __forceinline__ int flat(const Geom& g, int x, int y, int z) {
  return (x * g.ny + y) * g.nz + z;
}

// Quadratic B-spline weight of tap index t in {0, 1, 2} on one axis
// (bspline.axis_weight).
__device__ __forceinline__ float axis_weight(int t, float d) {
  if (t == 0) {
    float u = 0.5f - d;
    return 0.5f * (u * u);
  }
  if (t == 1) return 0.75f - d * d;
  float u = 0.5f + d;
  return 0.5f * (u * u);
}

__device__ __forceinline__ float tap_weight(int t0, int t1, int t2, const float d[3]) {
  float w = axis_weight(t0, d[0]);
  w = w * axis_weight(t1, d[1]);
  w = w * axis_weight(t2, d[2]);
  return w;
}

// M [3][3] @ v, rows summed left to right (bspline.matvec).
__device__ __forceinline__ float matvec_row(const float M[9], int i, const float v[3]) {
  float acc = M[i * 3 + 0] * v[0];
  acc = acc + M[i * 3 + 1] * v[1];
  acc = acc + M[i * 3 + 2] * v[2];
  return acc;
}

// (M^T @ v)[i] (bspline.matvec_t).
__device__ __forceinline__ float matvec_t_row(const float M[9], int i, const float v[3]) {
  float acc = M[0 * 3 + i] * v[0];
  acc = acc + M[1 * 3 + i] * v[1];
  acc = acc + M[2 * 3 + i] * v[2];
  return acc;
}

__device__ __forceinline__ float load_vc(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_vc(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_vc(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_vc(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);  // rounds once, at the store (.astype(vc_dtype))
}

}  // namespace mpm
