// Windowed track-table ("wtt") bundle-adjustment kernels for Hopper (sm_90a).
//
// Hand-written CUDA C++ counterparts of the four Pallas kernels on the
// medium solve's path (tpu3drecon/ops/pallas/):
//
//   wtt_linearize  <- wtt_linearize.py:wtt_linearize_fused_idx (_lin_fused_kernel)
//   wtt_coupling   <- wtt_matvec.py:wtt_coupling_rows_idx      (_matvec_kernel_idx)
//   wtt_wt_planes  <- wtt_matvec.py:wtt_wt_planes_idx          (_wt_kernel_idx)
//   wtt_cost       <- wtt_cost.py:wtt_cost_cols_idx            (_cost_kernel)
//
// Design of B3 and B4.  One thread owns one point column (g, p) of a
// bucket: its whole track (the Tb slots) lives in that thread, so W^T x and
// the cost column never leave registers; the grid is (ceil(Pc / 256), G).
//
// Design of B1 and B2 (wtt_kernels.cuh): slot-major.  One lane owns one
// track slot: a warp holds slot t of 32 consecutive point columns and a
// block the Tb warps of one or more 32-point groups, so a bucket runs on
// Tb * Pc threads (1,152 blocks on the medium problem's five buckets of
// G = 1, where one thread per point gives 396).  The
// per-point sums (V and g_pt, W^T x) cross warps through shared memory and
// one lane per point adds them in slot order, the order of the loop they
// replace; each slot keeps its Jacobian planes in registers from phase 1
// to phase 2, so B2 reads jc/jp once and B1 calls tt_blocks once per slot.
//
// Every kernel reads its slot's window row directly (wcam is int16, -1 =
// padding) from device memory, where the TPU kernels rebuild one-hot tiles
// and select camera rows with bf16-split MXU dots; a padded slot takes an
// all-zero camera row (and x column) without reading one, exactly as the
// TPU's empty one-hot column gives it.  Nothing is staged per window, so
// any window width runs (the hub layout's W = 1664 too).
//
// Reductions into window-camera rows (linearize rows, coupling rows) cross
// threads: they go straight to the global rows (zeroed by the wrapper) with
// atomics.  B1 and B2 write a warp's column values into the warp's shared
// row tile, and one lane per (distinct row, column) sums its lanes and
// sends one atomic, so the 32 lanes of a row-uniform warp (the common
// case, since points are sorted by their minimum camera) issue a slot's
// atomics at once (slot.cuh tile_put).  A block-local shared (W, K) tile
// flushed once per block measured 1.45-4.6x slower on the H100 than direct
// atomics (PERF.md): a block touches few rows of a wide tile but has to
// zero and flush all of it.
//
// What bounds them on the H100 (PERF.md): B2 on the medium buckets by the
// atomics that many warps send to the same 128 x 8 row entries, on the BAL
// buckets by its phase 1, the jc/jp stream; B1 by latency at the occupancy
// its registers allow (capped at 128 in float by a 512-thread bound, so
// two blocks of 256 threads share an SM); the back-substitution and cost
// kernels by the bytes of jc/jp (resp. uv/mask) they stream.
// Atomic reduction order varies from run to run, so f32 row sums vary in
// the last bits.
//
// Built with --fmad=false (ops/_build.py): products and sums round one at a
// time, as PyTorch's elementwise ops do, so each kernel matches its plain
// version to the last bits outside its reductions — the closed-form V^-1
// of a point seen once is conditioned ~1/lam and would amplify a fused
// multiply-add's rounding difference that much.
//
// Every C entry returns cudaGetLastError() after its launch, or a negative
// code for arguments the kernels do not take (common.cuh; named by
// kernel_error_string in common.cu).  The kernels allocate nothing;
// scalars that change every LM iteration (lam, inv_w) are read from device
// memory, so no launch needs a host sync.  The slot formulas, the camera
// row and x reads, the contribution columns, the two halves of the
// coupling product and the row reductions (warp-aggregated, and B1's and
// B2's row tiles) live in slot.cuh,
// shared with the route kernels (wtt_route_kernels.cu) and the dense
// track-table kernels (tt_kernels.cu).  B1's and B2's kernel templates live
// in wtt_kernels.cuh: their reduced-fidelity float instantiations (the TPU
// kernels' `terms` 1 and 2, split_round in slot.cuh) compile in
// wtt_terms_kernels.cu, and the C entries below hand those calls over.
// On Hopper the rounding removes no bytes or gathers (a slot reads its own
// camera row either way), so the reduced modes exist for the users who pick
// them, not for speed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "slot.cuh"
#include "wtt_kernels.cuh"

using namespace tpu3drecon;

namespace {

// ---------------------------------------------------------------- B3 ----
// The back-substitution's (W^T x) planes: phase 1 of B2 (wtt_kernels.cuh),
// always exact.
template <typename T, int NP>
__global__ void __launch_bounds__(kBlock)
wt_planes_kernel(const T* __restrict__ xw_t, const int16_t* __restrict__ wcam,
                 const T* __restrict__ jc, const T* __restrict__ jp,
                 T* __restrict__ out, int G, int Tb, int Pc, int W) {
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  T wtx[3];
  wt_x<T, NP>(xw_t + (size_t)g * NP * W, wcam, jc, jp, g, p, live, G, Tb, Pc, W, wtx);
  if (live) {
    const size_t GP = (size_t)G * Pc;
#pragma unroll
    for (int l = 0; l < 3; ++l) out[l * GP + (size_t)g * Pc + p] = wtx[l];
  }
}

// ---------------------------------------------------------------- B4 ----
template <typename T>
__global__ void __launch_bounds__(kBlock)
cost_kernel(const int16_t* __restrict__ wcam, const T* __restrict__ tw,
            const T* __restrict__ pts, const T* __restrict__ uv,
            const T* __restrict__ mask, T* __restrict__ out, int G, int Tb,
            int Pc, int W, int loss) {
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= Pc) return;
  const T* tw_g = tw + (size_t)g * W * kD;
  const size_t GP = (size_t)G * Pc;
  const T px = pts[0 * GP + (size_t)g * Pc + p];
  const T py = pts[1 * GP + (size_t)g * Pc + p];
  const T pz = pts[2 * GP + (size_t)g * Pc + p];
  T total = T(0);
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    T buf[kD];
    const T* cp = cam_row(tw_g, int(wcam[ts]), buf);
    const T x = cp[0] * px + cp[1] * py + cp[2] * pz + cp[9];
    const T y = cp[3] * px + cp[4] * py + cp[5] * pz + cp[10];
    const T z = cp[6] * px + cp[7] * py + cp[8] * pz + cp[11];
    const T iz = T(1) / (fabs(z) < T(1e-12) ? T(1) : z);
    const T mx = x * iz, my = y * iz;
    const T r2 = mx * mx + my * my;
    const T s_rad = T(1) + cp[17] * r2 + cp[18] * r2 * r2;
    const T u = cp[12] * s_rad * mx + cp[16] * s_rad * my + cp[14];
    const T v = cp[13] * s_rad * my + cp[15];
    const T r0 = u - uv[(((size_t)g * 2 + 0) * Tb + t) * Pc + p];
    const T r1 = v - uv[(((size_t)g * 2 + 1) * Tb + t) * Pc + p];
    const T s = r0 * r0 + r1 * r1;
    const T m = mask[ts];
    total += s * robust_weight<T>(loss, s) * (m * m);
  }
  out[(size_t)g * Pc + p] = total;
}

// ---------------------------------------------------------------- host --
template <typename T, int NP>
int wt_launch(const void* xw_t, const void* wcam, const void* jc, const void* jp,
              void* out, int G, int Tb, int Pc, int W, cudaStream_t stream) {
  wt_planes_kernel<T, NP><<<grid_of(Pc, G), kBlock, 0, stream>>>(
      (const T*)xw_t, (const int16_t*)wcam, (const T*)jc, (const T*)jp, (T*)out,
      G, Tb, Pc, W);
  return (int)cudaGetLastError();
}

template <typename T>
int cost_launch(const void* wcam, const void* tw, const void* pts, const void* uv,
                const void* mask, void* out, int G, int Tb, int Pc, int W,
                int loss, cudaStream_t stream) {
  cost_kernel<T><<<grid_of(Pc, G), kBlock, 0, stream>>>(
      (const int16_t*)wcam, (const T*)tw, (const T*)pts, (const T*)uv,
      (const T*)mask, (T*)out, G, Tb, Pc, W, loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wtt_linearize(int dtype, int np, int terms, const void* wcam, const void* tw,
                  const void* pts, const void* uv, const void* mask,
                  const void* lam, const void* inv_w, void* rows, void* jc,
                  void* jp, void* vinv, void* gpt, void* damp, int G, int Tb,
                  int Pc, int W, int use_sj, int want_od, int loss, int focal,
                  int points, int dist, int pp, int tc, int ng, int smem, void* stream) {
  if (want_od && !use_sj) return kErrOd;
  if (terms != 2 && terms != 3) return kErrTerms;
  if (G == 0 || Pc == 0) return 0;
  const LinFlags f{use_sj, loss, focal, points, dist, pp};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && terms < 3)
    return wtt_linearize_reduced(np, terms, wcam, tw, pts, uv, mask, lam, inv_w, rows, jc,
                                 jp, vinv, gpt, damp, G, Tb, Pc, W, want_od, f, tc, ng, smem,
                                 s);
  NP_DISPATCH(dtype, np,
              (want_od ? lin_launch<T, NP, true, 3>(wcam, tw, pts, uv, mask, lam, inv_w,
                                                    rows, jc, jp, vinv, gpt, damp, G, Tb,
                                                    Pc, W, f, tc, ng, smem, s)
                       : lin_launch<T, NP, false, 3>(wcam, tw, pts, uv, mask, lam, inv_w,
                                                     rows, jc, jp, vinv, gpt, damp, G, Tb,
                                                     Pc, W, f, tc, ng, smem, s)));
}

int wtt_coupling(int dtype, int np, int terms, const void* xw_t, const void* wcam,
                 const void* jc, const void* jp, const void* vinv, void* out,
                 int G, int Tb, int Pc, int W, int tc, int ng, int smem, void* stream) {
  if (terms < 1 || terms > 3) return kErrTerms;
  if (G == 0 || Pc == 0) return 0;
  if (dtype == 0 && terms < 3)
    return wtt_coupling_reduced(np, terms, xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, tc,
                                ng, smem, (cudaStream_t)stream);
  NP_DISPATCH(dtype, np, (coupling_launch<T, NP, 3>(xw_t, wcam, jc, jp, vinv, out, G, Tb,
                                                    Pc, W, tc, ng, smem,
                                                    (cudaStream_t)stream)));
}

int wtt_wt_planes(int dtype, int np, const void* xw_t, const void* wcam,
                  const void* jc, const void* jp, void* out, int G, int Tb,
                  int Pc, int W, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  NP_DISPATCH(dtype, np, (wt_launch<T, NP>(xw_t, wcam, jc, jp, out, G, Tb, Pc, W,
                                           (cudaStream_t)stream)));
}

int wtt_cost(int dtype, const void* wcam, const void* tw, const void* pts,
             const void* uv, const void* mask, void* out, int G, int Tb, int Pc,
             int W, int loss, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  if (dtype == 0)
    return cost_launch<float>(wcam, tw, pts, uv, mask, out, G, Tb, Pc, W, loss,
                              (cudaStream_t)stream);
  if (dtype == 1)
    return cost_launch<double>(wcam, tw, pts, uv, mask, out, G, Tb, Pc, W, loss,
                               (cudaStream_t)stream);
  return kErrDtype;
}

}  // extern "C"
