// Device code shared by the track-table kernels (wtt_kernels.cu,
// wtt_route_kernels.cu and tt_kernels.cu): the per-slot residual/Jacobian
// formulas, the staged camera table and x window with their all-zero
// padding row, the per-slot contribution columns, band pair rows and
// coupling-product halves, the warp-aggregated shared-memory row reduction
// and its flush, and the host-side launch helpers.
//
// The track-table layouts keep one point's whole track in one thread: a
// slot (t, p) reads its camera's row of a (rows + 1, 19) table staged in
// shared memory, where the extra last row is all zero.  A padded slot reads
// that zero row, exactly as the TPU kernels' empty one-hot column gives it:
// z = 0 -> z_safe = 1, so every output of the slot is exactly 0.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace tpu3drecon {

constexpr int kD = 19;        // camera table width: R(9) t(3) f(2) c(3) k(2)
constexpr int kBlock = 256;   // threads per block = point columns per block

struct LinFlags {
  int use_sj, loss, focal, points, dist, pp;
};

// Plane index of entry (j, l) of a symmetric 3x3 packed (00 01 02 11 12 22).
__device__ __forceinline__ constexpr int sym_idx(int j, int l) {
  return j == 0 ? l : (j == 1 ? (l == 0 ? 1 : l + 2) : (l == 0 ? 2 : l + 3));
}

// Target row of one slot for the whole warp: this lane's row `w`
// (-1 = none) and, when every live lane shares one row, that row `w0`.
struct WarpRow {
  int w;
  int w0;
  bool uniform;
  bool any;
};

__device__ __forceinline__ WarpRow warp_row(int w) {
  WarpRow r;
  r.w = w;
  const unsigned valid = __ballot_sync(kFull, w >= 0);
  r.any = valid != 0;
  const int src = r.any ? __ffs(valid) - 1 : 0;
  r.w0 = __shfl_sync(kFull, w, src);
  r.uniform = __all_sync(kFull, w < 0 || w == r.w0);
  return r;
}

// acc[idx] += val for this lane's row; all lanes of the warp call it.
// `self` / `lead` are the element offsets for rows w and w0.
template <typename T>
__device__ __forceinline__ void row_add(T* acc, const WarpRow& wr, int self,
                                        int lead, T val) {
  if (wr.uniform) {
    const T s = warp_sum(wr.w >= 0 ? val : T(0));
    if ((threadIdx.x & 31) == 0) atomicAdd(acc + lead, s);
  } else if (wr.w >= 0) {
    atomicAdd(acc + self, val);
  }
}

// One global atomic per nonzero entry of the block's shared tile.
template <typename T>
__device__ __forceinline__ void flush(const T* acc, T* out, int n) {
  for (int i = threadIdx.x; i < n; i += kBlock) {
    const T v = acc[i];
    if (v != T(0)) atomicAdd(out + i, v);
  }
}

// Residual and Jacobian planes of one slot: ba_tt._tt_blocks.
template <typename T, int NP>
struct Slot {
  T jc[2 * NP];
  T jp[6];
  T r0, r1;
};

template <typename T, int NP>
__device__ __forceinline__ void tt_blocks(const T* cp, T X, T Y, T Z, T u_obs,
                                          T v_obs, T m, T inv_w,
                                          const LinFlags& f, Slot<T, NP>& o) {
  const T x = cp[0] * X + cp[1] * Y + cp[2] * Z + cp[9];
  const T y = cp[3] * X + cp[4] * Y + cp[5] * Z + cp[10];
  const T z = cp[6] * X + cp[7] * Y + cp[8] * Z + cp[11];
  const T z_safe = fabs(z) < T(1e-12) ? T(1) : z;
  const T iz = T(1) / z_safe;
  const T fx = cp[12], fy = cp[13], cx = cp[14], cy = cp[15], sk = cp[16];
  const T k1 = cp[17], k2 = cp[18];
  const T mx = x * iz, my = y * iz;
  const T r2 = mx * mx + my * my;
  const T s_rad = T(1) + k1 * r2 + k2 * r2 * r2;
  const T g_rad = T(2) * k1 + T(4) * k2 * r2;
  const T mdx = s_rad * mx, mdy = s_rad * my;
  const T u = fx * mdx + sk * mdy + cx;
  const T v = fy * mdy + cy;
  const T r0 = u - u_obs, r1 = v - v_obs;
  const T s = r0 * r0 + r1 * r1;
  const T scale = sqrt(robust_weight<T>(f.loss, s)) * m * inv_w;

  const T axx = s_rad + g_rad * mx * mx;
  const T axy = g_rad * mx * my;
  const T ayy = s_rad + g_rad * my * my;
  const T b00 = axx * iz, b01 = axy * iz, b02 = -(axx * mx + axy * my) * iz;
  const T b10 = axy * iz, b11 = ayy * iz, b12 = -(axy * mx + ayy * my) * iz;
  const T a11 = fx * b00 + sk * b10, a12 = fx * b01 + sk * b11;
  const T a13 = fx * b02 + sk * b12;
  const T a21 = fy * b10, a22 = fy * b11, a23 = fy * b12;

  T* j0 = o.jc;
  T* j1 = o.jc + NP;
  j0[0] = -a12 * z + a13 * y;
  j0[1] = a11 * z - a13 * x;
  j0[2] = -a11 * y + a12 * x;
  j0[3] = a11;
  j0[4] = a12;
  j0[5] = a13;
  j0[6] = f.focal ? mdx : T(0);
  j0[7] = T(0);
  j1[0] = -a22 * z + a23 * y;
  j1[1] = a21 * z - a23 * x;
  j1[2] = -a21 * y + a22 * x;
  j1[3] = a21;
  j1[4] = a22;
  j1[5] = a23;
  j1[6] = T(0);
  j1[7] = f.focal ? mdy : T(0);
  // Columns 8.. : dist (k1, k2) then principal point (cx, cy), as enabled;
  // NP == 8 + 2 * dist + 2 * pp (checked by the wrapper).
  if constexpr (NP >= 10) {
    const T du_ds = fx * mx + sk * my, dv_ds = fy * my;
    if (f.dist) {
      j0[8] = du_ds * r2;
      j0[9] = du_ds * r2 * r2;
      j1[8] = dv_ds * r2;
      j1[9] = dv_ds * r2 * r2;
    } else {
      j0[8] = T(1);
      j0[9] = T(0);
      j1[8] = T(0);
      j1[9] = T(1);
    }
  }
  if constexpr (NP >= 12) {
    j0[10] = T(1);
    j0[11] = T(0);
    j1[10] = T(0);
    j1[11] = T(1);
  }
#pragma unroll
  for (int k = 0; k < 2 * NP; ++k) o.jc[k] *= scale;
  const T ps = f.points ? scale : T(0);
  o.jp[0] = (a11 * cp[0] + a12 * cp[3] + a13 * cp[6]) * ps;
  o.jp[1] = (a11 * cp[1] + a12 * cp[4] + a13 * cp[7]) * ps;
  o.jp[2] = (a11 * cp[2] + a12 * cp[5] + a13 * cp[8]) * ps;
  o.jp[3] = (a21 * cp[0] + a22 * cp[3] + a23 * cp[6]) * ps;
  o.jp[4] = (a21 * cp[1] + a22 * cp[4] + a23 * cp[7]) * ps;
  o.jp[5] = (a21 * cp[2] + a22 * cp[5] + a23 * cp[8]) * ps;
  o.r0 = r0 * scale;
  o.r1 = r1 * scale;
}

// Stage W camera rows (W, 19) plus one all-zero row W.
template <typename T>
__device__ __forceinline__ void stage_window(const T* tw, T* s_tw, int W) {
  const int n = W * kD;
  for (int i = threadIdx.x; i < n + kD; i += kBlock) s_tw[i] = i < n ? tw[i] : T(0);
}

// Stage the group's x window rows (NP, W) transposed as (NP, W + 1) with a
// zero column W for padding slots.
template <typename T, int NP>
__device__ __forceinline__ void stage_xw(const T* xw_t, T* s_xw, int W) {
  for (int i = threadIdx.x; i < NP * (W + 1); i += kBlock) {
    const int r = i / (W + 1), w = i % (W + 1);
    s_xw[i] = w < W ? xw_t[r * W + w] : T(0);
  }
}

// Contribution columns u (NT) | g (NP) [| Schur-Jacobi coupling (NT)] of one
// slot (kernel B1's pass 2 and kernel B8), added into a (rows, K) tile at
// element offsets `self` / `lead` (rows w / w0).  `j0`, `j1` are the two
// camera-Jacobian rows, `q` the point-Jacobian planes, `vi` the point's
// V^-1 (sym3 packing).  With `use_sj` the slot's W factor and W V^-1 are
// left in `wl` / `wv` (the band pair rows reuse them).  Returns the next
// free column.
template <typename T, int NP>
__device__ __forceinline__ int add_contribs(T* acc, const WarpRow& wr, int self,
                                            int lead, const T* j0, const T* j1,
                                            const T* q, T r0, T r1, const T* vi,
                                            bool use_sj, T (&wl)[3][NP],
                                            T (&wv)[3][NP]) {
  int col = 0;
#pragma unroll
  for (int dd = 0; dd < NP; ++dd)
#pragma unroll
    for (int i = 0; i < NP - dd; ++i, ++col)
      row_add(acc, wr, self + col, lead + col, j0[i] * j0[i + dd] + j1[i] * j1[i + dd]);
#pragma unroll
  for (int i = 0; i < NP; ++i, ++col)
    row_add(acc, wr, self + col, lead + col, j0[i] * r0 + j1[i] * r1);
  if (use_sj) {
    // W factor w_l[i] = jc0[i] jp0[l] + jc1[i] jp1[l]; WV = W sym3(V^-1).
#pragma unroll
    for (int l = 0; l < 3; ++l)
#pragma unroll
      for (int i = 0; i < NP; ++i) wl[l][i] = j0[i] * q[l] + j1[i] * q[3 + l];
#pragma unroll
    for (int l = 0; l < 3; ++l)
#pragma unroll
      for (int i = 0; i < NP; ++i)
        wv[l][i] = wl[0][i] * vi[sym_idx(0, l)] + wl[1][i] * vi[sym_idx(1, l)] +
                   wl[2][i] * vi[sym_idx(2, l)];
#pragma unroll
    for (int dd = 0; dd < NP; ++dd)
#pragma unroll
      for (int i = 0; i < NP - dd; ++i, ++col)
        row_add(acc, wr, self + col, lead + col,
                wv[0][i] * wl[0][i + dd] + wv[1][i] * wl[1][i + dd] +
                    wv[2][i] * wl[2][i + dd]);
  }
  return col;
}

// Band pair rows S_{c,c+1} of one slot (kernels B1 and B8 with want_od):
// where this lane's previous track slot sits on window row `w_prev` and this
// slot on row w_prev + 1, od[i * NP + j] = sum_l wv_prev[l][i] wl[l][j] is
// added into row w_prev at columns col0 + i * NP + j of the (rows, K) tile.
// Padded slots (-1) never form a pair.  The whole warp calls it.
template <typename T, int NP>
__device__ __forceinline__ void add_pair_rows(T* acc, int K, int col0, int w_prev,
                                              int w, const T (&wv_prev)[3][NP],
                                              const T (&wl)[3][NP]) {
  const int pw = (w_prev >= 0 && w == w_prev + 1) ? w_prev : -1;
  const WarpRow pr = warp_row(pw);
  if (!pr.any) return;  // warp-uniform
  const int self = (pw >= 0 ? pw : 0) * K + col0;
  const int lead = pr.w0 * K + col0;
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < NP; ++j)
      row_add(acc, pr, self + i * NP + j, lead + i * NP + j,
              wv_prev[0][i] * wl[0][j] + wv_prev[1][i] * wl[1][j] +
                  wv_prev[2][i] * wl[2][j]);
}

// (W^T x) of one slot added to wtx[3]: x read from column `col` of the
// staged (NP, W + 1) window; `ts` is the slot's (G, Tb, Pc) offset and GTP
// the plane stride of jc/jp.
template <typename T, int NP>
__device__ __forceinline__ void wt_slot(const T* s_xw, int col, int W, const T* jc,
                                        const T* jp, size_t ts, size_t GTP, T wtx[3]) {
  T s0 = T(0), s1 = T(0);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const T xg = s_xw[i * (W + 1) + col];
    s0 += jc[i * GTP + ts] * xg;
    s1 += jc[(NP + i) * GTP + ts] * xg;
  }
#pragma unroll
  for (int l = 0; l < 3; ++l) wtx[l] += jp[l * GTP + ts] * s0 + jp[(3 + l) * GTP + ts] * s1;
}

// z = jc (jp y) of one slot reduced into the (NP, W) tile at row w (-1 =
// none; the whole warp calls it).
template <typename T, int NP>
__device__ __forceinline__ void w_slot(T* acc, int w, int W, const T* jc, const T* jp,
                                       size_t ts, size_t GTP, T y0, T y1, T y2) {
  const WarpRow wr = warp_row(w);
  if (!wr.any) return;  // warp-uniform
  T q[6], j[2 * NP];
#pragma unroll
  for (int k = 0; k < 6; ++k) q[k] = w >= 0 ? jp[k * GTP + ts] : T(0);
#pragma unroll
  for (int k = 0; k < 2 * NP; ++k) j[k] = w >= 0 ? jc[k * GTP + ts] : T(0);
  const T s0p = q[0] * y0 + q[1] * y1 + q[2] * y2;
  const T s1p = q[3] * y0 + q[4] * y1 + q[5] * y2;
  const int ws = w >= 0 ? w : 0;
#pragma unroll
  for (int i = 0; i < NP; ++i)
    row_add(acc, wr, i * W + ws, i * W + wr.w0, j[i] * s0p + j[NP + i] * s1p);
}

// ---------------------------------------------------------------- host --
inline int smem_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

// Opt the kernel in to `smem` bytes of dynamic shared memory (kErrSmem
// above the card's per-block limit).
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

inline dim3 grid_of(int Pc, int G) { return dim3((Pc + kBlock - 1) / kBlock, G); }

}  // namespace tpu3drecon

// Dispatch on (dtype code, np): 0 = float, 1 = double; np in {8, 10, 12}.
#define NP_DISPATCH(DTYPE, NPV, CALL)                        \
  do {                                                       \
    if ((DTYPE) == 0) {                                      \
      using T = float;                                       \
      if ((NPV) == 8) { constexpr int NP = 8; return CALL; } \
      if ((NPV) == 10) { constexpr int NP = 10; return CALL; } \
      if ((NPV) == 12) { constexpr int NP = 12; return CALL; } \
      return kErrNp;                                         \
    }                                                        \
    if ((DTYPE) == 1) {                                      \
      using T = double;                                      \
      if ((NPV) == 8) { constexpr int NP = 8; return CALL; } \
      if ((NPV) == 10) { constexpr int NP = 10; return CALL; } \
      if ((NPV) == 12) { constexpr int NP = 12; return CALL; } \
      return kErrNp;                                         \
    }                                                        \
    return kErrDtype;                                        \
  } while (0)
