// Kernel P's parameter block, shared by p2g_update.cu and the per-pass
// kernels of planes.cu. Its layout is mirrored by P2GParams in
// ops/cuda/p2g_update.py.
#pragma once

#include "bucket_kernels.cuh"

namespace mpm {

struct P2GParams {
  Geom g;
  int dres[3];          // true domain (domain_res, or grid_res)
  int bc;               // 0 slip, 1 stick, 2 friction
  int band_lo, band_hi;
  int eos_pow_n;        // > 0: integer exponent unrolled (stress.pow_static)
  int legacy_strain;
  float eos_pow_f;      // exponent for powf when eos_pow_n == 0
  float dt;
  float gravity[3];
  float rest_density;
  float mu;             // dynamic viscosity
  float eos_k;
  float pressure_floor;
  float friction;
  float fixed_mult;     // fixed-point multiplier (read for int32 grids only)
};

}  // namespace mpm
