// Definitions shared by the kernel sources of this directory: the negative
// return codes of the C entries (named by kernel_error_string, common.cu)
// and small device helpers.
#pragma once

#include <cuda_runtime.h>

namespace tpu3drecon {

constexpr unsigned kFull = 0xffffffffu;

// Codes for arguments the kernels do not take; cudaError_t values are >= 0.
enum : int { kErrNp = -1, kErrSmem = -2, kErrDtype = -3, kErrOd = -4, kErrTerms = -5,
             kErrProbe = -6, kErrGeom = -7 };

// IRLS weight rho'(s) of the robust loss with code `loss` (LOSS_CODES in
// geometry/losses.py): geometry.losses.robust_weight, operation for
// operation.
template <typename T>
__device__ __forceinline__ T robust_weight(int loss, T s) {
  if (loss == 1) return T(1) / (T(1) + s);                      // Cauchy
  if (loss == 2) return s <= T(1) ? T(1) : T(1) / sqrt(s > T(1) ? s : T(1));  // Huber
  return T(1);
}

// Sum over the 32 lanes of a warp; the total lands in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

}  // namespace tpu3drecon
