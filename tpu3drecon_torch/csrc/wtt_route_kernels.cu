// Kernels of the wtt engine's unfused and one-hot routes for Hopper (sm_90a).
//
// Hand-written CUDA C++ counterparts of four Pallas kernels
// (tpu3drecon/ops/pallas/):
//
//   wtt_cam_planes       <- wtt_linearize.py:wtt_cam_planes_idx   (_cam_planes_kernel)  B7
//   wtt_contrib          <- wtt_linearize.py:wtt_contrib_rows_idx (_contrib_kernel)     B8
//   wtt_w_rows           <- wtt_matvec.py:wtt_w_rows_idx          (_w_kernel_idx)       B5
//   wtt_coupling_onehot  <- wtt_matvec.py:wtt_coupling_rows_fused (_matvec_kernel)      B6
//
// B7 and B8 are the unfused linearization's two halves around the PyTorch
// Jacobian planes: B7 selects each slot's window camera row (one thread per
// slot, a copy with no reduction: bound by the 19 output planes it writes);
// B8 is kernel B1's pass 2 on its own, reading jc/jp/r/v_inv from device
// memory (one thread per point column walks its track; the u | g | coupling
// columns go to the global rows with warp-aggregated atomics).  B5 is
// kernel B2's phase 2 on its
// own (W y rows, the Schur rhs when the linearization is unfused).  B6 is
// B2's whole product with each slot's window row taken from the dense
// one-hot column instead of wcam: a thread scans the W entries of its
// slot's column (adjacent slots are adjacent bytes, so a warp's loads
// coalesce), keeps the first nonzero row (an all-zero column is a padded
// slot: no row, exact zeros) in shared memory for phase 2, and otherwise
// runs B2.  B6 reads W bytes of int8 one-hot per slot on top of B2's
// jc/jp stream, so its bound is about twice B2's.
//
// The TPU kernels rebuild one-hot tiles and select or reduce with
// bf16-split MXU dots; none of that carries over.  Every value is the same
// product and sum as the plain versions (ops/wtt_linearize.py,
// ops/wtt_matvec.py); only the order of the atomic window-row sums differs,
// so B5, B6 and B8 vary in the last bits from run to run and B7 is exact.
// Per-slot formulas and the row reduction come from slot.cuh, shared with
// B1-B4 (wtt_kernels.cu).  B5 and B8 reduce into device memory directly,
// as B1 and B2 do.  B6 alone keeps a shared-memory mode (x staged as
// (NP, W + 1), rows reduced into a shared (NP, W) tile, slot.cuh), which
// measured 1.77x faster than the direct atomics on the medium buckets
// (PERF.md): its wrapper passes the tile's bytes where they fit the card's
// per-block limit, 0 for the global mode.  Every C entry returns
// cudaGetLastError() after its launch, or a negative code of common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "slot.cuh"

using namespace tpu3drecon;

namespace {

// ---------------------------------------------------------------- B7 ----
// out (G, 19, N) = the window row tw[g, wcam[g, n]] of each slot n, exact
// zeros for padding (-1).
template <typename T>
__global__ void __launch_bounds__(kBlock)
cam_planes_kernel(const int16_t* __restrict__ wcam, const T* __restrict__ tw,
                  T* __restrict__ out, int N, int W) {
  const int g = blockIdx.y;
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= N) return;
  const int w = wcam[(size_t)g * N + n];
  const T* row = tw + ((size_t)g * W + (w >= 0 ? w : 0)) * kD;
  T* o = out + (size_t)g * kD * N + n;
#pragma unroll
  for (int d = 0; d < kD; ++d) o[(size_t)d * N] = w >= 0 ? row[d] : T(0);
}

// ---------------------------------------------------------------- B5 ----
// W y rows (G, NP, W): z = jc (jp y) of every slot reduced into its window
// row; y is (3, G, Pc).
template <typename T, int NP>
__global__ void __launch_bounds__(kBlock)
w_rows_kernel(const T* __restrict__ y, const int16_t* __restrict__ wcam,
              const T* __restrict__ jc, const T* __restrict__ jp,
              T* __restrict__ out, int G, int Tb, int Pc, int W) {
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  T* out_g = out + (size_t)g * NP * W;  // (NP, W)
  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;
  const size_t pp = (size_t)g * Pc + p;
  const T y0 = live ? y[pp] : T(0);
  const T y1 = live ? y[GP + pp] : T(0);
  const T y2 = live ? y[2 * GP + pp] : T(0);
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    w_slot<T, NP>(out_g, live ? int(wcam[ts]) : -1, W, jc, jp, ts, GTP, y0, y1, y2);
  }
}

// ---------------------------------------------------------------- B6 ----
// Byte offset of B6's float tiles after its (Tb, kBlock) int16 row table,
// aligned for T.
template <typename T>
__host__ __device__ __forceinline__ size_t tile_offset(int Tb) {
  const size_t n = sizeof(int16_t) * (size_t)Tb * kBlock;
  return (n + sizeof(T) - 1) / sizeof(T) * sizeof(T);
}

// B2's coupling rows with each slot's window row read from the one-hot
// (G, W, Tb * Pc) of element type OH (int8, or the data's float type).
// Each thread keeps its slots' rows in a shared (Tb, kBlock) int16 table in
// both memory modes; only the x window and the (NP, W) tile depend on GM.
template <typename T, typename OH, int NP, bool GM>
__global__ void __launch_bounds__(kBlock)
onehot_coupling_kernel(const T* __restrict__ xw_t, const OH* __restrict__ onehot,
                       const T* __restrict__ jc, const T* __restrict__ jp,
                       const T* __restrict__ vinv, T* __restrict__ out, int G,
                       int Tb, int Pc, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* s_row = reinterpret_cast<int16_t*>(smem);         // (Tb, kBlock)
  T* s_xw = reinterpret_cast<T*>(smem + tile_offset<T>(Tb));  // (NP, W + 1), shared mode
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  const T* xw_g = xw_t + (size_t)g * NP * W;
  T* out_g = out + (size_t)g * NP * W;
  stage_xw<T, NP, GM>(xw_g, s_xw, W);
  T* acc = start_rows<T, GM>(s_xw + NP * (W + 1), out_g, NP * W);  // (NP, W)
  __syncthreads();

  const size_t N = (size_t)Tb * Pc;
  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;
  // Phase 1: each slot's row from its one-hot column, then (W^T x).
  T wtx[3] = {T(0), T(0), T(0)};
  for (int t = 0; t < Tb; ++t) {
    int w = -1;
    if (live) {
      // Scanned from the last row down, so w ends on the first nonzero row
      // and no load waits on an earlier one's compare.
      const OH* col = onehot + (size_t)g * W * N + (size_t)t * Pc + p;
#pragma unroll 8
      for (int i = W - 1; i >= 0; --i) w = col[(size_t)i * N] != OH(0) ? i : w;
      wt_slot<T, NP, GM>(s_xw, xw_g, w, W, jc, jp, ((size_t)g * Tb + t) * Pc + p, GTP,
                         wtx);
    }
    s_row[t * kBlock + threadIdx.x] = (int16_t)w;
  }
  T v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = live ? vinv[k * GP + (size_t)g * Pc + p] : T(0);
  const T y0 = v[0] * wtx[0] + v[1] * wtx[1] + v[2] * wtx[2];
  const T y1 = v[1] * wtx[0] + v[3] * wtx[1] + v[4] * wtx[2];
  const T y2 = v[2] * wtx[0] + v[4] * wtx[1] + v[5] * wtx[2];

  // Phase 2: z = jc (jp y) reduced into the (NP, W) window rows.
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    w_slot<T, NP>(acc, s_row[t * kBlock + threadIdx.x], W, jc, jp, ts, GTP, y0, y1, y2);
  }
  finish_rows<T, GM>(acc, out_g, NP * W);
}

// ---------------------------------------------------------------- B8 ----
// With OD (want_od) the rows gain np^2 band pair columns after the coupling
// (wtt_linearize.py:163-190), formed as in B1 from the previous slot's
// W V^-1 factor kept in registers (slot.cuh add_pair_rows).
template <typename T, int NP, bool OD>
__global__ void __launch_bounds__(kBlock)
contrib_kernel(const int16_t* __restrict__ wcam, const T* __restrict__ jc,
               const T* __restrict__ jp, const T* __restrict__ r,
               const T* __restrict__ vinv, T* __restrict__ rows, int G, int Tb,
               int Pc, int W, int use_sj) {
  constexpr int NT = NP * (NP + 1) / 2;
  const int K = NT + NP + (use_sj ? NT : 0) + (OD ? NP * NP : 0);
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  T* rows_g = rows + (size_t)g * W * K;  // (W, K)

  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;
  T vi[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    vi[k] = live && use_sj ? vinv[k * GP + (size_t)g * Pc + p] : T(0);
  T wv_prev[3][NP];
  int w_prev = -1;
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    const int w = live ? int(wcam[ts]) : -1;
    const WarpRow wr = warp_row(w);
    if (!wr.any) {  // warp-uniform
      w_prev = -1;
      continue;
    }
    const bool own = w >= 0;
    T j[2 * NP], q[6];
#pragma unroll
    for (int k = 0; k < 2 * NP; ++k) j[k] = own ? jc[k * GTP + ts] : T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = own && use_sj ? jp[k * GTP + ts] : T(0);
    const T r0 = own ? r[ts] : T(0);
    const T r1 = own ? r[GTP + ts] : T(0);
    T wl[3][NP], wv[3][NP];
    const int col = add_contribs<T, NP>(rows_g, wr, (own ? w : 0) * K, wr.w0 * K, j,
                                        j + NP, q, r0, r1, vi, use_sj, wl, wv);
    if constexpr (OD) {
      add_pair_rows<T, NP>(rows_g, K, col, w_prev, w, wv_prev, wl);
#pragma unroll
      for (int l = 0; l < 3; ++l)
#pragma unroll
        for (int i = 0; i < NP; ++i) wv_prev[l][i] = wv[l][i];
      w_prev = w;
    }
  }
}

// ---------------------------------------------------------------- host --
template <typename T>
int cam_planes_launch(const void* wcam, const void* tw, void* out, int G, int N,
                      int W, cudaStream_t stream) {
  cam_planes_kernel<T><<<grid_of(N, G), kBlock, 0, stream>>>(
      (const int16_t*)wcam, (const T*)tw, (T*)out, N, W);
  return (int)cudaGetLastError();
}

template <typename T, int NP, bool OD>
int contrib_launch(const void* wcam, const void* jc, const void* jp, const void* r,
                   const void* vinv, void* rows, int G, int Tb, int Pc, int W,
                   int use_sj, cudaStream_t stream) {
  contrib_kernel<T, NP, OD><<<grid_of(Pc, G), kBlock, 0, stream>>>(
      (const int16_t*)wcam, (const T*)jc, (const T*)jp, (const T*)r,
      (const T*)vinv, (T*)rows, G, Tb, Pc, W, use_sj);
  return (int)cudaGetLastError();
}

template <typename T, int NP>
int w_rows_launch(const void* y, const void* wcam, const void* jc, const void* jp,
                  void* out, int G, int Tb, int Pc, int W, cudaStream_t stream) {
  w_rows_kernel<T, NP><<<grid_of(Pc, G), kBlock, 0, stream>>>(
      (const T*)y, (const int16_t*)wcam, (const T*)jc, (const T*)jp, (T*)out, G,
      Tb, Pc, W);
  return (int)cudaGetLastError();
}

// `tiles`: the bytes of the shared mode's x window and rows tile, 0 in the
// global mode; the row table comes first in both.
template <typename T, typename OH, int NP, bool GM>
int onehot_launch(const void* xw_t, const void* onehot, const void* jc,
                  const void* jp, const void* vinv, void* out, int G, int Tb,
                  int Pc, int W, int tiles, cudaStream_t stream) {
  const size_t smem = tile_offset<T>(Tb) + (size_t)tiles;
  const int err = prepare(onehot_coupling_kernel<T, OH, NP, GM>, smem);
  if (err) return err;
  onehot_coupling_kernel<T, OH, NP, GM><<<grid_of(Pc, G), kBlock, smem, stream>>>(
      (const T*)xw_t, (const OH*)onehot, (const T*)jc, (const T*)jp,
      (const T*)vinv, (T*)out, G, Tb, Pc, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wtt_cam_planes(int dtype, const void* wcam, const void* tw, void* out, int G,
                   int N, int W, void* stream) {
  if (G == 0 || N == 0) return 0;
  if (dtype == 0)
    return cam_planes_launch<float>(wcam, tw, out, G, N, W, (cudaStream_t)stream);
  if (dtype == 1)
    return cam_planes_launch<double>(wcam, tw, out, G, N, W, (cudaStream_t)stream);
  return kErrDtype;
}

int wtt_contrib(int dtype, int np, const void* wcam, const void* jc, const void* jp,
                const void* r, const void* vinv, void* rows, int G, int Tb, int Pc,
                int W, int use_sj, int want_od, void* stream) {
  if (want_od && !use_sj) return kErrOd;
  if (G == 0 || Pc == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  NP_DISPATCH(dtype, np,
              (want_od ? contrib_launch<T, NP, true>(wcam, jc, jp, r, vinv, rows, G, Tb, Pc,
                                                     W, use_sj, s)
                       : contrib_launch<T, NP, false>(wcam, jc, jp, r, vinv, rows, G, Tb, Pc,
                                                      W, use_sj, s)));
}

int wtt_w_rows(int dtype, int np, const void* y, const void* wcam, const void* jc,
               const void* jp, void* out, int G, int Tb, int Pc, int W, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  NP_DISPATCH(dtype, np, (w_rows_launch<T, NP>(y, wcam, jc, jp, out, G, Tb, Pc, W,
                                               (cudaStream_t)stream)));
}

// onehot_float: 0 = int8 one-hot, 1 = one-hot in the data's float type.
// tiles: the bytes of the shared mode's tiles as the wrapper computed them
// (ops/wtt_matvec.py), 0 for the global mode.
int wtt_coupling_onehot(int dtype, int np, int onehot_float, const void* xw_t,
                        const void* onehot, const void* jc, const void* jp,
                        const void* vinv, void* out, int G, int Tb, int Pc, int W,
                        int tiles, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  if (onehot_float != 0 && onehot_float != 1) return kErrDtype;
  NP_DISPATCH(dtype, np, (with_mode(tiles == 0, [&](auto m) {
    constexpr bool GM = decltype(m)::value;
    return onehot_float
               ? onehot_launch<T, T, NP, GM>(xw_t, onehot, jc, jp, vinv, out, G, Tb, Pc,
                                             W, tiles, (cudaStream_t)stream)
               : onehot_launch<T, int8_t, NP, GM>(xw_t, onehot, jc, jp, vinv, out, G,
                                                  Tb, Pc, W, tiles, (cudaStream_t)stream);
  })));
}

}  // extern "C"
