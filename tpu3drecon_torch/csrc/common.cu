// The library-wide C entry: the error string of a return code (every C
// entry returns cudaGetLastError() after its launch, or a negative code of
// common.cuh).

#include "common.cuh"

extern "C" const char* kernel_error_string(int code) {
  using namespace tpu3drecon;
  if (code == kErrNp) return "unsupported camera block width (np must be 8, 10 or 12)";
  if (code == kErrSmem)
    return "shared memory above the per-block limit (a shared-memory mode forced "
           "where its tile does not fit)";
  if (code == kErrDtype) return "unsupported dtype (float32 or float64)";
  if (code == kErrOd) return "want_od requires use_sj (the band rows reuse the W/WV factors)";
  if (code == kErrTerms)
    return "unsupported split terms (coupling 1, 2 or 3; linearize 2 or 3)";
  if (code == kErrProbe) return "unsupported probe variant, block size or layout";
  if (code == kErrGeom)
    return "launch geometry (warps per point group, groups per block, shared bytes, "
           "one-hot vector width, lanes per thread) does not match the kernel";
  return cudaGetErrorString((cudaError_t)code);
}
