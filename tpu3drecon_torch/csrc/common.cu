// The one error-string entry of the kernel library: every C entry returns
// cudaGetLastError() after its launch, or a negative code of common.cuh.

#include "common.cuh"

extern "C" const char* kernel_error_string(int code) {
  using namespace tpu3drecon;
  if (code == kErrNp) return "unsupported camera block width (np must be 8, 10 or 12)";
  if (code == kErrSmem) return "window too wide: shared memory exceeds the per-block limit";
  if (code == kErrDtype) return "unsupported dtype (float32 or float64)";
  return cudaGetErrorString((cudaError_t)code);
}
