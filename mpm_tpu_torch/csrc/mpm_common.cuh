// Shared device helpers for the bucket-state kernels (bucket_kernels.cuh,
// built by p2g_update.cu, g2p_migrate.cu and substep2d.cu).
//
// Layout (the JAX package's, mpm_tpu/ops/bucketed.py), for D = 2 or 3 axes:
// pos [D, K, C], vel [D, K, C], C [D*D, K, C], mass [K, C], ids [K, C],
// with C the flat row-major cell index (axis 0 slowest, the last axis
// fastest) and element (row, k, c) at (row * K + k) * C + c. mass == 0
// marks an empty slot.
//
// Arithmetic follows the plain PyTorch version (ops/bucketed.py) operation
// for operation, and every kernel builds with --fmad=false, so it rounds
// where the plain version rounds (ops/cuda/build.py says why).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mpm {

constexpr float CFL_EPS = 1e-3f;  // ops/bucketed.CFL_EPS

// The grid of a bucket state. Its layout is mirrored by the ctypes
// parameter blocks of ops/cuda (nx, ny[, nz], K, C).
template <int D>
struct GridGeom {
  int n[D];  // array extents (grid_res)
  int K;     // slots per cell
  int C;     // cells: the product of n
};
using Geom = GridGeom<3>;
using Geom2 = GridGeom<2>;

template <int D>
constexpr int NTAPS = D == 2 ? 9 : 27;  // 3^D nodes of the quadratic B-spline

// Where a state's arrays sit in an x-slab decomposition (ops/bucketed.Slab,
// parallel/domain.py). x0: the global plane of the state's plane 0; it
// enters only where a coordinate becomes physical (cell centres, migration
// deltas, boundary bands), and neighbour indexing stays local, with cells
// past the array's ends empty. go: the grid arrays hold go more planes than
// the state on each side of axis 0 (grid plane j is state plane j - go).
// c_lo, c_hi: the state planes whose counter events count. Mirrored by
// ops/cuda/g2p_migrate.SlabC.
struct Slab {
  int x0;
  int go;
  int c_lo, c_hi;
};
// The whole grid: no offset, no halo planes, every plane counted.
__host__ __device__ constexpr Slab whole_grid() { return {0, 0, 0, 0x7fffffff}; }

// The grid of a slab: the state's geometry, go planes wider on each side.
template <int D>
__host__ __device__ __forceinline__ GridGeom<D> grid_geom(const GridGeom<D>& g, const Slab& s) {
  GridGeom<D> r = g;
  r.n[0] = g.n[0] + 2 * s.go;
  r.C = g.C / g.n[0] * r.n[0];
  return r;
}

// The global coordinate, as a float, of local coordinate x on axis a.
__device__ __forceinline__ float global_coord(const Slab& s, int a, int x) {
  return (float)(a == 0 ? x + s.x0 : x);
}

// Whether counter events of state plane `plane` count.
__device__ __forceinline__ bool counted(const Slab& s, int plane) {
  return plane >= s.c_lo && plane <= s.c_hi;
}

template <int D>
__device__ __forceinline__ void cell_coords(const GridGeom<D>& g, int c, int (&x)[D]) {
  for (int a = D - 1; a >= 0; --a) {
    x[a] = c % g.n[a];
    c /= g.n[a];
  }
}

template <int D>
__device__ __forceinline__ bool in_grid(const GridGeom<D>& g, const int (&x)[D]) {
  bool in = true;
  for (int a = 0; a < D; ++a) in = in && x[a] >= 0 && x[a] < g.n[a];
  return in;
}

template <int D>
__device__ __forceinline__ int flat(const GridGeom<D>& g, const int (&x)[D]) {
  int f = x[0];
  for (int a = 1; a < D; ++a) f = f * g.n[a] + x[a];
  return f;
}

// Flat-index distance between neighbours along `axis`.
template <int D>
__device__ __forceinline__ int axis_stride(const GridGeom<D>& g, int axis) {
  int s = 1;
  for (int a = D - 1; a > axis; --a) s *= g.n[a];
  return s;
}

// Tap t of the 3^D in (x, y[, z]) order, the last axis fastest: one digit
// in {0, 1, 2} an axis.
template <int D>
__device__ __forceinline__ void tap_digits(int t, int (&tt)[D]) {
  for (int a = D - 1; a >= 0; --a) {
    tt[a] = t % 3;
    t /= 3;
  }
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

// The axis weights multiplied in axis order (bspline.tap_weight).
template <int D>
__device__ __forceinline__ float tap_weight(const int (&t)[D], const float (&d)[D]) {
  float w = axis_weight(t[0], d[0]);
  for (int a = 1; a < D; ++a) w = w * axis_weight(t[a], d[a]);
  return w;
}

// stress.pow_static: binary exponentiation in the JAX package's order.
__device__ __forceinline__ float pow_static(float x, int n) {
  float result = 0.f;
  bool have = false;
  float base = x;
  while (n) {
    if (n & 1) {
      result = have ? result * base : base;
      have = true;
    }
    n >>= 1;
    if (n) base = base * base;
  }
  return result;
}

// (M @ v)[i] for M [D][D], the row summed left to right (bspline.matvec).
template <int D>
__device__ __forceinline__ float matvec_row(const float (&M)[D * D], int i,
                                            const float (&v)[D]) {
  float acc = M[i * D] * v[0];
  for (int j = 1; j < D; ++j) acc = acc + M[i * D + j] * v[j];
  return acc;
}

// (M^T @ v)[i] (bspline.matvec_t).
template <int D>
__device__ __forceinline__ float matvec_t_row(const float (&M)[D * D], int i,
                                              const float (&v)[D]) {
  float acc = M[i] * v[0];
  for (int j = 1; j < D; ++j) acc = acc + M[j * D + i] * v[j];
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

// Grid accumulator codings (ops/fixed_point.py). FloatGrid sums float32
// contributions; FixedGrid encodes each slot's contribution as
// trunc(x * mult) in int32 and sums integers, which wrap as XLA's int32
// sums do: they are added as uint32, since signed overflow is undefined in
// C++. dec is int32 -> float32, then an IEEE division by mult.
struct FloatGrid {
  using T = float;
  __device__ static float enc(float x, float) { return x; }
  __device__ static float dec(float x, float) { return x; }
  __device__ static float add(float a, float b) { return a + b; }
};
struct FixedGrid {
  using T = int;
  __device__ static int enc(float x, float mult) { return (int)truncf(x * mult); }
  __device__ static float dec(int x, float mult) { return (float)x / mult; }
  __device__ static int add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
};
// The coding of a grid whose elements are GT (float or int).
template <typename GT>
struct GridCoding;
template <>
struct GridCoding<float> : FloatGrid {};
template <>
struct GridCoding<int> : FixedGrid {};

inline unsigned blocks_for(size_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace mpm
