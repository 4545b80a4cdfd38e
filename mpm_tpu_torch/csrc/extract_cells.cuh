// Per-cell splat extraction, shared by kernel X (extract_cells.cu) and kernel
// F's splat emission (g2p_migrate.cu).
//
// For one cell c of a bucket state (pos [3, K, C] float32, vel [3, K, C]
// float32 or bf16, mass [K, C]) it writes the column c of splats [5, C]:
// (pixel x, pixel y, linear depth, |vel|) of the cell's nearest valid slot,
// and the count of valid slots. A slot is valid when mass > 0 and its depth
// is beyond the near plane. The winner is the FIRST slot in slot order whose
// masked depth equals the cell's minimum, as mpm_tpu/render/extract_kernel.py
// _extract_kernel selects it; depth CELL_BG marks a cell with no valid slot.
//
// The projection and |vel| round operation for operation as the plain
// PyTorch version (mpm_tpu_torch/ops/cuda/extract_cells.py) does. Both
// including sources build with --fmad=false: a fused projection breaks a
// depth tie differently and picks another slot, which moves px, py and |vel|
// wholesale.
#pragma once

#include "mpm_common.cuh"

namespace mpm {

constexpr float CELL_BG = 1.0e9f;  // ops/cuda/extract_cells.CELL_BG

// World->view rows (3x4, row-major) then focal_px, width/2, height/2, near:
// the layout of mpm_tpu/ops/pallas/fused.render_scals_for.
struct RenderScals {
  float s[16];
};

template <typename V>
__device__ __forceinline__ void extract_cell(const float* __restrict__ pos,
                                             const V* __restrict__ vel,
                                             const float* __restrict__ mass, int K, int C,
                                             int c, const RenderScals& rs,
                                             float* __restrict__ out) {
  const size_t KC = (size_t)K * C;
  const float* s = rs.s;
  float dmin = __int_as_float(0x7f800000);  // +inf
  int win = -1;
  float sel_px = 0.f, sel_py = 0.f, sel_v = 0.f;
  int count = 0;
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * C + c;
    const float p0 = pos[i], p1 = pos[KC + i], p2 = pos[2 * KC + i];
    float vp[3];
    for (int r = 0; r < 3; ++r) {
      float acc = s[4 * r] * p0;
      acc = acc + s[4 * r + 1] * p1;
      acc = acc + s[4 * r + 2] * p2;
      vp[r] = acc + s[4 * r + 3];
    }
    const float depth = -vp[2];
    const bool valid = mass[i] > 0.f && depth > s[15];
    count += valid;
    const float dm = valid ? depth : CELL_BG;
    // first valid slot among those at the minimum (an invalid slot's
    // CELL_BG may reach the minimum first; a valid one equal to it still wins)
    const bool take = dm < dmin || (dm == dmin && valid && win < 0);
    if (dm < dmin) dmin = dm;
    if (take) {
      win = valid ? k : -1;
      if (valid) {
        const float safe = depth > 1e-6f ? depth : 1e-6f;
        sel_px = s[13] + (s[12] * vp[0]) / safe;
        sel_py = s[14] - (s[12] * vp[1]) / safe;
        const float v0 = load_vc(vel, i), v1 = load_vc(vel, KC + i),
                    v2 = load_vc(vel, 2 * KC + i);
        float m2 = v0 * v0;
        m2 = m2 + v1 * v1;
        m2 = m2 + v2 * v2;
        sel_v = sqrtf(m2);
      }
    }
  }
  const bool found = win >= 0;
  out[c] = found ? sel_px : 0.f;
  out[(size_t)C + c] = found ? sel_py : 0.f;
  out[2 * (size_t)C + c] = found ? dmin : CELL_BG;
  out[3 * (size_t)C + c] = found ? sel_v : 0.f;
  out[4 * (size_t)C + c] = (float)count;
}

template <typename V>
__global__ void extract_cells_kernel(const float* __restrict__ pos, const V* __restrict__ vel,
                                     const float* __restrict__ mass, int K, int C,
                                     RenderScals rs, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) extract_cell(pos, vel, mass, K, C, c, rs, out);
}

// Launches the extraction of every cell on `stream`.
template <typename V>
cudaError_t launch_extract(const float* pos, const V* vel, const float* mass, int K, int C,
                           const RenderScals& rs, float* out, cudaStream_t stream) {
  const int T = 256;
  extract_cells_kernel<V><<<(C + T - 1) / T, T, 0, stream>>>(pos, vel, mass, K, C, rs, out);
  return cudaGetLastError();
}

}  // namespace mpm
