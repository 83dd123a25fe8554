// The reduced-fidelity float instantiations of kernels B1 and B2
// (wtt_kernels.cuh), in an object of their own so that they compile beside
// wtt_kernels.cu:
//
//   B1 at TERMS = 2 (linearize_kernel "index2"), with and without the band
//      pair rows, <- wtt_linearize.py:wtt_linearize_fused_idx(terms=2)
//   B2 at TERMS = 1 and 2 (matvec_kernel "index1" / "index2")
//      <- wtt_matvec.py:wtt_coupling_rows_idx(terms=1|2)
//
// The TPU kernels split a float operand into `terms` bfloat16 pieces so that
// their one-hot selection and reduction dots run as single-pass MXU dots;
// the rounding that gives (slot.cuh split_round) is applied here at the
// same places, to each value a slot reads from or adds to a window row.
// Double inputs never reach these entries: the TPU kernels' f64 path is
// exact, and the C entries of wtt_kernels.cu run their exact kernels then.
// Only the CG operator (B2) and B1's u | g | coupling | od columns are
// rounded; B1's rhs columns, camera rows and Jacobians stay exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "slot.cuh"
#include "wtt_kernels.cuh"

namespace tpu3drecon {

int wtt_linearize_reduced(int np, int terms, const void* wcam, const void* tw,
                          const void* pts, const void* uv, const void* mask,
                          const void* lam, const void* inv_w, void* rows, void* jc,
                          void* jp, void* vinv, void* gpt, void* damp, int G, int Tb,
                          int Pc, int W, int want_od, LinFlags f, int tc, int ng, int smem,
                          cudaStream_t s) {
  if (terms != 2) return kErrTerms;
  using T = float;
#define LIN2(NPV)                                                                        \
  return want_od ? lin_launch<T, NPV, true, 2>(wcam, tw, pts, uv, mask, lam, inv_w, rows, \
                                               jc, jp, vinv, gpt, damp, G, Tb, Pc, W, f,   \
                                               tc, ng, smem, s)                            \
                 : lin_launch<T, NPV, false, 2>(wcam, tw, pts, uv, mask, lam, inv_w, rows, \
                                                jc, jp, vinv, gpt, damp, G, Tb, Pc, W, f,  \
                                                tc, ng, smem, s)
  if (np == 8) LIN2(8);
  if (np == 10) LIN2(10);
  if (np == 12) LIN2(12);
#undef LIN2
  return kErrNp;
}

int wtt_coupling_reduced(int np, int terms, const void* xw_t, const void* wcam,
                         const void* jc, const void* jp, const void* vinv, void* out,
                         int G, int Tb, int Pc, int W, int tc, int ng, int smem,
                         cudaStream_t s) {
  using T = float;
#define COUP(NPV, TERMSV) \
  return coupling_launch<T, NPV, TERMSV>(xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, tc, ng, \
                                         smem, s)
  if (terms == 1) {
    if (np == 8) COUP(8, 1);
    if (np == 10) COUP(10, 1);
    if (np == 12) COUP(12, 1);
    return kErrNp;
  }
  if (terms == 2) {
    if (np == 8) COUP(8, 2);
    if (np == 10) COUP(10, 2);
    if (np == 12) COUP(12, 2);
    return kErrNp;
  }
#undef COUP
  return kErrTerms;
}

}  // namespace tpu3drecon
