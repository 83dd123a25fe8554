// Definitions shared by the kernel sources of this directory: the negative
// return codes of the C entries (named by kernel_error_string, common.cu),
// small device helpers (warp sums, 16-byte span copies) and the opt-in to
// large dynamic shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// Elements of T that a region of n elements occupies, rounded up to whole
// 16-byte vectors.
template <typename T>
__host__ __device__ constexpr int vec_up(int n) {
  constexpr int ve = 16 / sizeof(T);
  return (n + ve - 1) / ve * ve;
}

// The offset (elements) that puts a shared copy of p on p's alignment
// within a 16-byte vector.
template <typename T>
__device__ __forceinline__ int vec_shift(const T* p) {
  return int((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % (16 / sizeof(T)));
}

// Block-wide copy of n elements from shared memory src to device memory
// dst, on the same alignment within a 16-byte vector: a scalar head,
// 16-byte vectors, a scalar tail.
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, int n) {
  constexpr int ve = 16 / sizeof(T);
  int head = (ve - vec_shift(src)) % ve;
  if (head > n) head = n;
  const int nv = (n - head) / ve;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = s4[i];
  for (int i = head + nv * ve + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// One cp.async (sm_80+) of BYTES (4, 8 or 16) from device memory to shared
// memory: the copy lands without passing through registers, and every copy
// a thread issues is in flight at once.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES)
                 : "memory");
}

// Block-wide asynchronous copy of n elements from device memory src to
// shared memory dst, on the same alignment within a 16-byte vector (a
// scalar head, 16-byte vectors, a scalar tail).  The block waits for it
// with copy_async_wait() and a barrier.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n) {
  constexpr int ve = 16 / sizeof(T);
  int head = (ve - vec_shift(src)) % ve;
  if (head > n) head = n;
  const int nv = (n - head) / ve;
  for (int i = threadIdx.x; i < head; i += blockDim.x) cp_async<sizeof(T)>(dst + i, src + i);
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    cp_async<16>(dst + head + i * ve, src + head + i * ve);
  for (int i = head + nv * ve + threadIdx.x; i < n; i += blockDim.x)
    cp_async<sizeof(T)>(dst + i, src + i);
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- host --
inline int smem_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

// Opt the kernel in to `smem` bytes of dynamic shared memory (kErrSmem
// above the card's per-block limit: the wrapper asked for the shared mode
// where its tile does not fit).
template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > (size_t)smem_limit()) return kErrSmem;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace tpu3drecon
