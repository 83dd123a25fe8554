// The library-wide C entries: the error string of a return code (every C
// entry returns cudaGetLastError() after its launch, or a negative code of
// common.cuh) and the shared memory a block may use.

#include "common.cuh"

// Shared memory one block may opt in to on CUDA device `device` (bytes).
extern "C" int kernel_smem_limit(int device) {
  int limit = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? limit : -1;
}

extern "C" const char* kernel_error_string(int code) {
  using namespace tpu3drecon;
  if (code == kErrNp) return "unsupported camera block width (np must be 8, 10 or 12)";
  if (code == kErrSmem)
    return "shared-memory mode asked for a tile above the per-block limit";
  if (code == kErrDtype) return "unsupported dtype (float32 or float64)";
  if (code == kErrOd) return "want_od requires use_sj (the band rows reuse the W/WV factors)";
  if (code == kErrTerms)
    return "unsupported split terms (coupling 1, 2 or 3; linearize 2 or 3)";
  if (code == kErrProbe) return "unsupported probe variant, block size or layout";
  if (code == kErrGeom)
    return "launch geometry (warps per point group, groups per block, shared bytes) "
           "does not match the kernel";
  return cudaGetErrorString((cudaError_t)code);
}
