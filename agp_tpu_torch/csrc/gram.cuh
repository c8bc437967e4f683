// The stationary gram formula that every kernel of the port with a gram
// shares (kernels 1-4, 6, 8-9): the counterpart of the kinds of the
// reference's gram (agp_tpu/ops/pallas_kernels.py, _cavi_fused_kernel,
// kind = rbf, matern12, matern32, matern52).
//
// r2 = |x/ls - z/ls|^2 comes in the direct form sum_d (x_d - z_d)^2, which
// does not cancel; each Matern sqrt takes max(., 1e-36) as the reference
// does.  The kernels apply the formula once an entry, after its r2 sum
// (pair_core.cuh::gram_slab), so they take the kind at run time
// (gram_from_r2_of, a branch uniform across the block; kernels 8-9 take
// the RBF gram only).  Kernels 4 and 6's float64 form takes the same
// formula in double, with the double math functions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// codes of the kinds: the order of KINDS in ops/cuda_kernels.py
enum GramKind : int { KIND_RBF = 0, KIND_MATERN12 = 1, KIND_MATERN32 = 2, KIND_MATERN52 = 3 };

template <int KIND>
__device__ __forceinline__ float gram_from_r2(float r2, float var) {
  static_assert(KIND >= KIND_RBF && KIND <= KIND_MATERN52, "unknown gram kind");
  if constexpr (KIND == KIND_RBF) {
    return var * expf(-0.5f * r2);
  } else if constexpr (KIND == KIND_MATERN12) {
    const float r = sqrtf(fmaxf(r2, 1e-36f));
    return var * expf(-r);
  } else if constexpr (KIND == KIND_MATERN32) {
    const float r = sqrtf(fmaxf(3.0f * r2, 1e-36f));
    return var * (1.0f + r) * expf(-r);
  } else {
    const float r = sqrtf(fmaxf(5.0f * r2, 1e-36f));
    return var * (1.0f + r + r * r / 3.0f) * expf(-r);
  }
}

// gram_from_r2 of the runtime code `kind` (rbf for an unknown code: the
// callers check the code on the host)
__device__ __forceinline__ float gram_from_r2_of(int kind, float r2, float var) {
  switch (kind) {
    case KIND_MATERN12:
      return gram_from_r2<KIND_MATERN12>(r2, var);
    case KIND_MATERN32:
      return gram_from_r2<KIND_MATERN32>(r2, var);
    case KIND_MATERN52:
      return gram_from_r2<KIND_MATERN52>(r2, var);
    default:
      return gram_from_r2<KIND_RBF>(r2, var);
  }
}

// gram_from_r2_of in double (kernels 4 and 6's float64 form)
__device__ __forceinline__ double gram_from_r2_of(int kind, double r2, double var) {
  switch (kind) {
    case KIND_MATERN12: {
      const double r = sqrt(fmax(r2, 1e-36));
      return var * exp(-r);
    }
    case KIND_MATERN32: {
      const double r = sqrt(fmax(3.0 * r2, 1e-36));
      return var * (1.0 + r) * exp(-r);
    }
    case KIND_MATERN52: {
      const double r = sqrt(fmax(5.0 * r2, 1e-36));
      return var * (1.0 + r + r * r / 3.0) * exp(-r);
    }
    default:
      return var * exp(-0.5 * r2);
  }
}
