// Device code shared by the track-table kernels (wtt_kernels.cu,
// wtt_route_kernels.cu and tt_kernels.cu): the per-slot residual/Jacobian
// formulas, camera-row and x reads with their all-zero padding, the
// coupling-product halves, the warp-aggregated row reduction of the kernels
// that walk a track in one thread (B5), the slot-major grid and row tiles
// (B1, B2, B6, B8 and B12-B15), the contribution columns that the
// slot-major B1, B8, B12 and B13 put into their row tiles, and the
// host-side launch helpers.
//
// B3, B4, B5, B7 and B16 keep one point's whole track in one thread; the
// slot-major kernels run one slot per lane.  Either way a slot (t, p) reads
// its camera's row of a (rows, 19) table.  A padded slot reads an all-zero
// row, exactly as the TPU kernels' empty one-hot column gives it: z = 0 ->
// z_safe = 1, so every output of the slot is exactly 0.
//
// Memory.  The kernels read camera rows and x straight from device memory
// (__ldg into registers, zeros for padding) and send their atomics
// straight to the output rows, which the wrapper zeroes, so any window
// width or camera count runs.  B15 (tt_kernels.cu) alone can point its row
// tiles at a block-shared tile of the camera rows instead, flushed once per
// block; its wrapper picks that mode at small camera counts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// x as the TPU kernels' reduced-fidelity selection and reduction dots see
// it (tpu3drecon/ops/pallas/splitdot.py): split into TERMS bfloat16 pieces,
// h1 = bf16(x), h2 = bf16(x - h1), ..., each rounded to nearest even, and
// folded back in float as (h1 + h2) + h3.  TERMS >= 3 is exact for float,
// and double is never split (the TPU kernels' f64 path takes one exact
// dot), so both return x unchanged.
template <int TERMS, typename T>
__device__ __forceinline__ T split_round(T x) {
  if constexpr (TERMS >= 3 || !std::is_same_v<T, float>) {
    return x;
  } else {
    float acc = __bfloat162float(__float2bfloat16_rn(x));
    float rem = x - acc;
#pragma unroll
    for (int k = 1; k < TERMS; ++k) {
      const float h = __bfloat162float(__float2bfloat16_rn(rem));
      rem = rem - h;
      acc = acc + h;
    }
    return acc;
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

// Camera row of a slot on row `w` (-1 = padding) of `table`, read from
// device memory into `buf`; all zero for padding.
template <typename T>
__device__ __forceinline__ const T* cam_row(const T* table, int w, T (&buf)[kD]) {
#pragma unroll
  for (int k = 0; k < kD; ++k) buf[k] = w >= 0 ? __ldg(table + (size_t)w * kD + k) : T(0);
  return buf;
}

// (W^T x) of one slot on window row w (-1 = padding) added to wtx[3]: x
// read from the group's window rows xw_t (NP, W) in device memory (0 for
// padding) and passed through split_round<TERMS>; `ts` is the slot's
// (G, Tb, Pc) offset and GTP the plane stride of jc/jp.
template <typename T, int NP, int TERMS = 3>
__device__ __forceinline__ void wt_slot(const T* xw_t, int w, int W, const T* jc,
                                        const T* jp, size_t ts, size_t GTP, T wtx[3]) {
  T s0 = T(0), s1 = T(0);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const T xg = split_round<TERMS>(w >= 0 ? __ldg(xw_t + (size_t)i * W + w) : T(0));
    s0 += jc[i * GTP + ts] * xg;
    s1 += jc[(NP + i) * GTP + ts] * xg;
  }
#pragma unroll
  for (int l = 0; l < 3; ++l) wtx[l] += jp[l * GTP + ts] * s0 + jp[(3 + l) * GTP + ts] * s1;
}

// z = jc (jp y) of one slot, passed through split_round<TERMS>, reduced
// into the (NP, W) rows at row w (-1 = none; the whole warp calls it).
template <typename T, int NP, int TERMS = 3>
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
    row_add(acc, wr, i * W + ws, i * W + wr.w0, split_round<TERMS>(j[i] * s0p + j[NP + i] * s1p));
}

// ------------------------------------------------ slot-major grid ------
// The slot-major kernels (B1, B2 and B6 in wtt_kernels.cuh, B8 in
// wtt_route_kernels.cu, B12-B15 in tt_kernels.cu) run one lane per track
// slot: a warp holds slot t of 32 consecutive point columns, a block holds `ng` such 32-point groups as `tc`
// warps each (warp ti of a group holds slot c * tc + ti in chunk c), and a
// track longer than tc slots is walked in ceil(Tb / tc) chunks.  The
// wrappers compute tc, ng and the shared bytes (ops/_wtt_common.py
// slot_geometry).
// This lane's place in the slot-major grid: a 1-D grid of G groups times
// ceil(Pc / (32 ng)) blocks each, so no G is refused.
struct SlotLane {
  int lane, warp, gi, ti, g, p, nchunk;
  bool live;
};

__device__ __forceinline__ SlotLane slot_lane(int tc, int ng, int Tb, int Pc) {
  SlotLane s;
  const int nb = (Pc + 32 * ng - 1) / (32 * ng);
  s.g = blockIdx.x / nb;
  s.lane = threadIdx.x & 31;
  s.warp = threadIdx.x >> 5;
  s.gi = s.warp / tc;
  s.ti = s.warp - s.gi * tc;
  s.p = ((blockIdx.x - s.g * nb) * ng + s.gi) * 32 + s.lane;
  s.live = s.p < Pc;
  s.nchunk = (Tb + tc - 1) / tc;
  return s;
}

// The per-point sums of the slot-major kernels (B1's and B12's V | g_pt,
// B2's and B14's W^T x).  Each lane writes the N parts of its slot at
// parts[((gi * tc + ti) * N + k) * 32 + lane], its group's (tc, N, 32) block
// of an (ng, tc, N, 32) array; after a barrier lane p of the group's warp 0
// adds chunk c's parts into acc in slot order, the order of the plain
// versions' track sums, so the sums keep their last bits.
template <int N, typename T>
__device__ __forceinline__ void add_parts(T (&acc)[N], const T* parts, const SlotLane& sl,
                                          int tc, int Tb, int c) {
  if (sl.ti != 0) return;
  const int n = min(tc, Tb - c * tc);
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += parts[((size_t)(sl.gi * tc + s) * N + k) * 32 + sl.lane];
}

// The V (sym3 packing) | g_pt parts of one slot (B1, B12) at part[k * 32].
template <typename T, int NP>
__device__ __forceinline__ void put_point_parts(T* part, const Slot<T, NP>& o) {
  const T* q = o.jp;
  part[0 * 32] = q[0] * q[0] + q[3] * q[3];
  part[1 * 32] = q[0] * q[1] + q[3] * q[4];
  part[2 * 32] = q[0] * q[2] + q[3] * q[5];
  part[3 * 32] = q[1] * q[1] + q[4] * q[4];
  part[4 * 32] = q[1] * q[2] + q[4] * q[5];
  part[5 * 32] = q[2] * q[2] + q[5] * q[5];
#pragma unroll
  for (int i = 0; i < 3; ++i) part[(6 + i) * 32] = q[i] * o.r0 + q[3 + i] * o.r1;
}

// ------------------------------------------------ slot-major row tiles --
// The row reduction of the slot-major kernels (B1, B2, B6, B8, B12, B13 and
// B15),
// where a warp holds one track slot of 32 point columns: its lanes' column
// values go to window rows that are mostly one row.  Each lane writes its
// values into the warp's shared (32, KT + 1) tile (a row per lane, padded
// against bank conflicts); the lanes are grouped by row with
// __match_any_sync, and each (distinct row, column) pair is summed over its
// lanes by one lane and leaves as one atomic.  A row-uniform warp thus sends
// KT columns' atomics from KT lanes at once, with no shuffle per column.
// Lanes on no row (-1: padding, past the track) are left out.  Columns are
// put one at a time in the order of the output's columns; the tile flushes
// every KT columns and at the segment's end.
constexpr int kTile = 32;  // tile columns of B1, B8, B12 and B13 (B2's, B6's and B15's: np)

template <typename T, int KT>
struct RowTile {
  T* v;       // (32, KT + 1) column values, row = lane
  int* meta;  // (3, 32): each lane's row, its row's lanes, the leader lanes
  T* out;     // element (row w, column c) at out + w * rs + c * cs
  size_t rs, cs;
  int nd;     // distinct rows among the warp's live lanes
};

// Groups the warp's lanes by row `w` (-1 = none); the whole warp calls it,
// and a warp with rt.nd == 0 has nothing to reduce.
template <typename T, int KT>
__device__ __forceinline__ void tile_rows(RowTile<T, KT>& rt, int w) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, w);
  const bool leader = w >= 0 && lane == __ffs(peers) - 1;
  const unsigned leaders = __ballot_sync(kFull, leader);
  __syncwarp();  // the previous flush is done with meta
  rt.meta[lane] = w;
  rt.meta[32 + lane] = int(peers);
  if (leader) rt.meta[64 + __popc(leaders & ((1u << lane) - 1u))] = lane;
  rt.nd = __popc(leaders);
  __syncwarp();
}

// Adds tile columns [0, n) into the output columns col0 .. col0 + n - 1 of
// each distinct row: one lane per (row, column), one atomic each.  The sum
// reads all 32 tile rows (independent loads, four partial sums) and keeps
// the row's lanes by selection, so a lane outside the row (whose value may
// be anything) adds nothing.
template <typename T, int KT>
__device__ __forceinline__ void tile_flush(const RowTile<T, KT>& rt, int n, int col0) {
  __syncwarp();
  for (int item = threadIdx.x & 31; item < rt.nd * n; item += 32) {
    const int r = item / n, c = item - r * n;
    const int l0 = rt.meta[64 + r];
    const unsigned m = unsigned(rt.meta[32 + l0]);
    T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const T v = rt.v[l * (KT + 1) + c];
      s[l & 3] += (m >> l) & 1u ? v : T(0);
    }
    const T sum = (s[0] + s[1]) + (s[2] + s[3]);
    if (sum != T(0))
      atomicAdd(rt.out + size_t(rt.meta[l0]) * rt.rs + size_t(col0 + c) * rt.cs, sum);
  }
  __syncwarp();
}

// Puts this lane's value of column `col` of an NCOL-column segment that
// starts at output column col0.  The kernels call it from fully unrolled
// loops, so `col` is a constant and the flush test folds away.
template <int NCOL, typename T, int KT>
__device__ __forceinline__ void tile_put(const RowTile<T, KT>& rt, int col, T val, int col0) {
  rt.v[(threadIdx.x & 31) * (KT + 1) + col % KT] = val;
  if (col % KT == KT - 1 || col == NCOL - 1) tile_flush(rt, col % KT + 1, col0 + col - col % KT);
}

// ------------------------------------------------ contribution columns --
// The per-slot camera columns of B1's pass 2, B8, B12 and B13, put into the
// warp's row tile in the output's diagonal-major _triu_pairs order from
// column `col` of an NCOL-column segment that starts at output column 0;
// each value passes split_round<TERMS> (B1's reduced-fidelity mode; exact
// at TERMS = 3).  The callers' loops unroll fully, so every column index is
// a constant.  Each returns the next free column.

// u (NT) | g (NP): j0, j1 are the slot's two camera-Jacobian rows, r0, r1
// its whitened residual (ba_tt._u_g_contribs).
template <int NCOL, int NP, int TERMS, typename T, int KT>
__device__ __forceinline__ int put_ug(const RowTile<T, KT>& rt, int col, const T* j0,
                                      const T* j1, T r0, T r1) {
#pragma unroll
  for (int dd = 0; dd < NP; ++dd)
#pragma unroll
    for (int i = 0; i < NP - dd; ++i, ++col)
      tile_put<NCOL>(rt, col, split_round<TERMS>(j0[i] * j0[i + dd] + j1[i] * j1[i + dd]), 0);
#pragma unroll
  for (int i = 0; i < NP; ++i, ++col)
    tile_put<NCOL>(rt, col, split_round<TERMS>(j0[i] * r0 + j1[i] * r1), 0);
  return col;
}

// The slot's W factor wl[l][i] = j0[i] q[l] + j1[i] q[3 + l] and W V^-1,
// wv = W sym3(vi), where q are its point-Jacobian planes and vi the point's
// V^-1 (sym3 packing) (ba_tt._coupling_contribs).
template <typename T, int NP>
__device__ __forceinline__ void w_factors(const T* j0, const T* j1, const T* q, const T* vi,
                                          T (&wl)[3][NP], T (&wv)[3][NP]) {
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
}

// The Schur-Jacobi coupling W V^-1 W^T (NT): sum_l wv[l][i] wl[l][i + dd].
template <int NCOL, int NP, int TERMS, typename T, int KT>
__device__ __forceinline__ int put_coupling(const RowTile<T, KT>& rt, int col,
                                            const T (&wl)[3][NP], const T (&wv)[3][NP]) {
#pragma unroll
  for (int dd = 0; dd < NP; ++dd)
#pragma unroll
    for (int i = 0; i < NP - dd; ++i, ++col)
      tile_put<NCOL>(rt, col,
                     split_round<TERMS>(wv[0][i] * wl[0][i + dd] + wv[1][i] * wl[1][i + dd] +
                                        wv[2][i] * wl[2][i + dd]),
                     0);
  return col;
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

// The launch of a slot-major kernel at the wrapper's geometry: tc warps per 32-point
// group, ng groups per block, `smem` bytes, which must be the kernel's own
// count (kErrGeom otherwise); above 48 KB the kernel is opted in first.
template <typename K>
int slot_launch(K kernel, int max_threads, size_t need, int tc, int ng, int smem, int G,
                int Pc, dim3& grid, dim3& block) {
  if (tc < 1 || ng < 1 || tc * ng * 32 > max_threads || size_t(smem) != need) return kErrGeom;
  if (need > 48 * 1024) {
    const int e = prepare(kernel, need);
    if (e) return e;
  }
  grid = dim3(unsigned((Pc + 32 * ng - 1) / (32 * ng)) * unsigned(G));
  block = dim3(32 * tc * ng);
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
