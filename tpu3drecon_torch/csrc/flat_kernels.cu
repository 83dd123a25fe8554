// The flat engine's linearization for Hopper (sm_90a): two kernels over the
// flat observation list (BAL layout: cam_idx, pt_idx, uv, mask of N
// observations), in place of ops/jacobians.py's gather_obs_blocks and the
// segment sums of solvers/schur.py build_normal_blocks.
//
//   flat_lin_kernel       one pass over the observations: r, J_c (2xNP) and
//                         J_p (2x3) in registers (slot.cuh tt_blocks, the
//                         operation order of obs_blocks), W = J_c^T J_p
//                         written (N, NP, 3), U (NP (NP + 1) / 2
//                         upper-triangle entries) and g_c (NP) reduced per
//                         camera, V (6) and g_p (3) per point.
//   flat_coupling_kernel  one pass for the Schur-Jacobi preconditioner,
//                         once V^-1 is known: sum W V^-1 W^T (NP (NP + 1) / 2
//                         entries) per camera.
//
// Both are templates on the camera width NP: 8 (so3 | t | fx fy) or 10
// (... | k1 k2, BAL's radial camera with k1 and k2 optimized), each in
// float and double.
//
// They replace no TPU kernel: the JAX flat engine leaves this to XLA
// (tpu3drecon/solvers/schur.py, tpu3drecon/ops/jacobians.py).
//
// Their least time on the H100 (at NP = 8; portbench/flat_roofline.py
// counts both widths).  flat_lin_kernel reads 20 B of each
// observation (two int32 indices, uv, mask), its point (12 B, mostly from
// cache: BAL sorts the observations by point) and its camera row (76 B,
// from L2: the whole table is ~1 MB), and writes W (96 B in float32).  At
// Final-13682 (29.0M observations, 4.46M points) that is ~3.6 GB, 1.1 ms at
// 3.35 TB/s; its ~440 operations an observation take less.
// flat_coupling_kernel recomputes J from the observation rather than read
// W back: 20 B an observation plus the point and V^-1 (48 B a point) against
// 104 B an observation for W and the indices, ~0.8 GB, 0.24 ms, about the
// time of its ~560 operations an observation at 67 TFLOP/s.  Measured there
// (f32, each kernel alone): 3.1 and 1.7 ms.  With the warp sums' atomics
// taken out altogether they take 2.2 and 1.5 ms, and built with
// --fmad=true (fewer instructions) within 3 % of their time, so neither
// the atomics nor the operation count holds them at that distance from
// the bound; chip_smoke.py times both at the benchmark's shapes.  At
// NP = 10 (floors ~1.3 and ~0.32 ms there) they take 8.9 and 2.9 ms, for
// ~1.2 times the bytes.  Why is not measured.  Untested candidates: 79 and
// 80 registers and a 34,816-byte tile a block leave 24 warps an SM where
// NP = 8 has 36; each camera row sends 65 atomics where it sent 44; the
// float W rows of 120 B go out in 15 8-byte stores a lane, which scatter
// each store instruction of a warp over 32 rows.
//
// The atomics.  One lane per observation, 32 consecutive observations per
// warp.  The warp's lanes are grouped by camera (then by point) with
// __match_any_sync; each lane puts its columns into the warp's shared
// (32, TileW) tile (TileW = 45 at NP = 8, 65 at NP = 10: odd, so that the
// 32 lanes' rows fall in distinct banks), and each (distinct row, column)
// pair is summed over its lanes by one lane and leaves as one atomic.  This adapts to the order of
// the observations with no flag: sorted by point (BAL files, the benchmark's
// generator), a warp holds ~5 points and the ~6 consecutive cameras that
// see each, so the point sums leave in ~5 x 9 atomics and the camera sums in
// (distinct cameras) x (NP (NP + 1) / 2 + NP); sorted by camera (the COLMAP packing), the
// camera sums leave in ~1 x 44 and the points, mostly distinct, lane by
// lane.  In a random order it degrades to one atomic per lane and column.
// Summation order therefore varies from run to run.
//
// Built with --fmad=false (ops/_build.py): every product and sum rounds on
// its own, as PyTorch's elementwise ops round them.  Every C entry returns
// cudaGetLastError() after its launch, or a negative code of common.cuh.
// The kernels allocate nothing (the wrapper zeroes the sums) and read
// inv_w from device memory, so no launch needs a host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "slot.cuh"

using namespace tpu3drecon;

namespace {

constexpr int kStaticSmem = 48 * 1024;  // a block's static shared memory

// The launch shape of the kernels at camera width NP: the upper-triangle
// entries of an NP x NP block, the tile's row (the widest segment, U | g,
// made odd), and 4 warps a block where their tiles fit the static shared
// memory (every instance but double at NP = 10, whose 4 tiles would take
// 66,560 B), else 2.
template <typename T, int NP>
struct FlatShape {
  static constexpr int kSym = NP * (NP + 1) / 2;
  static constexpr int kTileW = (kSym + NP) | 1;
  static constexpr int kWarps =
      4 * (32 * kTileW * (int)sizeof(T) + 96 * (int)sizeof(int)) <= kStaticSmem ? 4 : 2;
  static constexpr int kBlock = 32 * kWarps;
};

// The camera tensors of the flat problem, each where it lives: rmats
// (C, 3, 3), tvecs (C, 3), fx_fy (C, 2), cx_cy_skew (C, 3), dist (C, 2).
template <typename T>
struct FlatCams {
  const T* rmats;
  const T* tvecs;
  const T* fx_fy;
  const T* cx_cy_skew;
  const T* dist;
};

// The observation inputs shared by both kernels.
template <typename T>
struct FlatObs {
  FlatCams<T> cams;
  const T* points;   // (P, 3)
  const int* cam_idx;
  const int* pt_idx;
  const T* uv;       // (N, 2)
  const T* mask;     // (N,)
  const T* inv_w;    // () 1 / avg_cam_width
  int N, C, P;
};

// Residual and Jacobian rows of observation n into o; its camera and point
// rows in c, p (an index outside [0, C) or [0, P) traps).
template <typename T, int NP>
__device__ __forceinline__ void flat_obs(const FlatObs<T>& a, size_t n, const LinFlags& f,
                                         Slot<T, NP>& o, int& c, int& p) {
  c = __ldg(a.cam_idx + n);
  p = __ldg(a.pt_idx + n);
  if ((unsigned)c >= (unsigned)a.C || (unsigned)p >= (unsigned)a.P) __trap();
  T cp[kD];  // slot.cuh's camera row: R(9) t(3) f(2) c(3) k(2)
#pragma unroll
  for (int k = 0; k < 9; ++k) cp[k] = __ldg(a.cams.rmats + (size_t)c * 9 + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) cp[9 + k] = __ldg(a.cams.tvecs + (size_t)c * 3 + k);
#pragma unroll
  for (int k = 0; k < 2; ++k) cp[12 + k] = __ldg(a.cams.fx_fy + (size_t)c * 2 + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) cp[14 + k] = __ldg(a.cams.cx_cy_skew + (size_t)c * 3 + k);
#pragma unroll
  for (int k = 0; k < 2; ++k) cp[17 + k] = __ldg(a.cams.dist + (size_t)c * 2 + k);
  const T* x = a.points + (size_t)p * 3;
  tt_blocks<T, NP>(cp, __ldg(x), __ldg(x + 1), __ldg(x + 2), __ldg(a.uv + 2 * n),
                  __ldg(a.uv + 2 * n + 1), __ldg(a.mask + n), __ldg(a.inv_w), f, o);
}

// W = J_c^T J_p of one observation: w[i][l] = jc0[i] jp0[l] + jc1[i] jp1[l],
// the plain version's order.
template <typename T, int NP>
__device__ __forceinline__ void w_block(const Slot<T, NP>& o, T (&w)[NP][3]) {
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) w[i][l] = o.jc[i] * o.jp[l] + o.jc[NP + i] * o.jp[3 + l];
}

// The widest vector store that divides a W row of NP x 3 values: 16 B
// (float at NP = 8, double at either width), else 8 B (float at NP = 10,
// whose 120-byte rows start on 8-byte boundaries only).
template <typename T, int Bytes>
struct VecOf;
template <>
struct VecOf<float, 16> { using type = float4; };
template <>
struct VecOf<double, 16> { using type = double2; };
template <>
struct VecOf<float, 8> { using type = float2; };

// ------------------------------------------------------ warp row sums ---
// One warp's (32, TW) tile of column values (row = lane) and its
// grouping: each lane's row (-1: none), each lane's peers (lanes of the
// same row) and the leader lane of each distinct row.
template <typename T, int TW>
struct WarpSums {
  T* v;
  int* meta;  // row[32] | peers[32] | leaders[32]
  int nd;     // distinct rows among the warp's live lanes
};

// Groups the warp's lanes by row `row` (-1 = none); the whole warp calls it.
template <typename T, int TW>
__device__ __forceinline__ void group_rows(WarpSums<T, TW>& ws, int row) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, row);
  const bool leader = row >= 0 && lane == __ffs(peers) - 1;
  const unsigned leaders = __ballot_sync(kFull, leader);
  __syncwarp();  // the previous flush is done with meta and the tile
  ws.meta[lane] = row;
  ws.meta[32 + lane] = int(peers);
  if (leader) ws.meta[64 + __popc(leaders & ((1u << lane) - 1u))] = lane;
  ws.nd = __popc(leaders);
}

template <typename T, int TW>
__device__ __forceinline__ void put(const WarpSums<T, TW>& ws, int col, T val) {
  ws.v[(threadIdx.x & 31) * TW + col] = val;
}

// Adds tile columns [0, NA + NB) of each distinct row: column c < NA to
// a[row * NA + c], column NA + c to b[row * NB + c].  One lane per (row,
// column), which sums the row's lanes in lane order and sends one atomic;
// a sum of exactly 0 (padding rows) sends none.
template <int NA, int NB, typename T, int TW>
__device__ __forceinline__ void flush_rows(const WarpSums<T, TW>& ws, T* a, T* b) {
  constexpr int n = NA + NB;
  __syncwarp();
  for (int item = threadIdx.x & 31; item < ws.nd * n; item += 32) {
    const int r = item / n, c = item - r * n;
    const int l0 = ws.meta[64 + r];
    unsigned m = unsigned(ws.meta[32 + l0]);
    T s = T(0);
    while (m) {
      const int l = __ffs(m) - 1;
      m &= m - 1u;
      s += ws.v[l * TW + c];
    }
    const size_t row = size_t(ws.meta[l0]);
    if (s != T(0)) atomicAdd(c < NA ? a + row * NA + c : b + row * NB + (c - NA), s);
  }
}

// ------------------------------------------------------------ kernels ---
template <typename T>
struct LinOut {
  T* w;      // (N, NP, 3)
  T* u;      // (C, NP (NP + 1) / 2) row-major upper triangle of U
  T* g_cam;  // (C, NP)
  T* v;      // (P, 6) 00 01 02 11 12 22 of V
  T* g_pt;   // (P, 3)
};

template <typename T, int NP>
__global__ void __launch_bounds__(FlatShape<T, NP>::kBlock)
flat_lin_kernel(const FlatObs<T> a, const LinOut<T> out, const LinFlags f) {
  using S = FlatShape<T, NP>;
  __shared__ T tile[S::kWarps][32 * S::kTileW];
  __shared__ int meta[S::kWarps][96];
  const int warp = threadIdx.x >> 5;
  const size_t n = (size_t)blockIdx.x * S::kBlock + threadIdx.x;
  const bool live = n < (size_t)a.N;
  Slot<T, NP> o;
  int c = -1, p = -1;
  if (live) {
    flat_obs(a, n, f, o, c, p);
    T w[NP][3];
    w_block(o, w);
    // A row of 3 NP values in whole vectors (VecOf).
    constexpr int row_bytes = 3 * NP * (int)sizeof(T);
    constexpr int vec_bytes = row_bytes % 16 == 0 ? 16 : 8;
    static_assert(row_bytes % vec_bytes == 0, "a W row is whole vectors");
    using V = typename VecOf<T, vec_bytes>::type;
    constexpr int per = vec_bytes / sizeof(T);
    V* dst = reinterpret_cast<V*>(out.w + n * (3 * NP));
    const T* flat = &w[0][0];
#pragma unroll
    for (int k = 0; k < 3 * NP / per; ++k) {
      V q;
      T* qe = reinterpret_cast<T*>(&q);
#pragma unroll
      for (int e = 0; e < per; ++e) qe[e] = flat[k * per + e];
      dst[k] = q;
    }
  }
  WarpSums<T, S::kTileW> ws{tile[warp], meta[warp], 0};

  // Camera side: U = sum J_c^T J_c (row-major i <= j), g_c = sum J_c^T r.
  group_rows(ws, c);
  if (live) {
    const T* j0 = o.jc;
    const T* j1 = o.jc + NP;
    int col = 0;
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = i; j < NP; ++j, ++col) put(ws, col, j0[i] * j0[j] + j1[i] * j1[j]);
#pragma unroll
    for (int i = 0; i < NP; ++i) put(ws, S::kSym + i, j0[i] * o.r0 + j1[i] * o.r1);
  }
  flush_rows<S::kSym, NP>(ws, out.u, out.g_cam);

  // Point side: V = sum J_p^T J_p (00 01 02 11 12 22), g_p = sum J_p^T r.
  group_rows(ws, p);
  if (live) {
    const T* q = o.jp;
    int col = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = k; l < 3; ++l, ++col) put(ws, col, q[k] * q[l] + q[3 + k] * q[3 + l]);
#pragma unroll
    for (int k = 0; k < 3; ++k) put(ws, 6 + k, q[k] * o.r0 + q[3 + k] * o.r1);
  }
  flush_rows<6, 3>(ws, out.v, out.g_pt);
}

// sum W V^-1 W^T per camera (row-major i <= j), W recomputed from the
// observation: wv = W V^-1[p] (3x3, read whole), then wv_i . w_j, the plain
// version's order.
template <typename T, int NP>
__global__ void __launch_bounds__(FlatShape<T, NP>::kBlock)
flat_coupling_kernel(const FlatObs<T> a, const T* __restrict__ v_inv, T* __restrict__ out,
                     const LinFlags f) {
  using S = FlatShape<T, NP>;
  __shared__ T tile[S::kWarps][32 * S::kTileW];
  __shared__ int meta[S::kWarps][96];
  const int warp = threadIdx.x >> 5;
  const size_t n = (size_t)blockIdx.x * S::kBlock + threadIdx.x;
  const bool live = n < (size_t)a.N;
  WarpSums<T, S::kTileW> ws{tile[warp], meta[warp], 0};
  Slot<T, NP> o;
  int c = -1, p = -1;
  if (live) flat_obs(a, n, f, o, c, p);
  group_rows(ws, c);
  if (live) {
    T w[NP][3], vi[9], wv[NP][3];
    w_block(o, w);
#pragma unroll
    for (int k = 0; k < 9; ++k) vi[k] = __ldg(v_inv + (size_t)p * 9 + k);
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        wv[i][l] = w[i][0] * vi[l] + w[i][1] * vi[3 + l] + w[i][2] * vi[6 + l];
    int col = 0;
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = i; j < NP; ++j, ++col)
        put(ws, col, wv[i][0] * w[j][0] + wv[i][1] * w[j][1] + wv[i][2] * w[j][2]);
  }
  flush_rows<S::kSym, 0>(ws, out, out);
}

template <typename T>
FlatObs<T> flat_obs_args(const void* rmats, const void* tvecs, const void* fx_fy,
                         const void* cx_cy_skew, const void* dist, const void* points,
                         const void* cam_idx, const void* pt_idx, const void* uv,
                         const void* mask, const void* inv_w, int N, int C, int P) {
  return FlatObs<T>{{(const T*)rmats, (const T*)tvecs, (const T*)fx_fy,
                     (const T*)cx_cy_skew, (const T*)dist},
                    (const T*)points, (const int*)cam_idx, (const int*)pt_idx,
                    (const T*)uv, (const T*)mask, (const T*)inv_w, N, C, P};
}

template <typename T, int NP>
unsigned flat_grid(int N) {
  constexpr int b = FlatShape<T, NP>::kBlock;
  return unsigned((N + b - 1) / b);
}

template <typename T, int NP>
int lin_launch(const FlatObs<T>& a, const LinOut<T>& out, const LinFlags& f,
               cudaStream_t stream) {
  flat_lin_kernel<T, NP><<<flat_grid<T, NP>(a.N), FlatShape<T, NP>::kBlock, 0, stream>>>(
      a, out, f);
  return (int)cudaGetLastError();
}

template <typename T, int NP>
int coupling_launch(const FlatObs<T>& a, const void* v_inv, void* out, const LinFlags& f,
                    cudaStream_t stream) {
  flat_coupling_kernel<T, NP><<<flat_grid<T, NP>(a.N), FlatShape<T, NP>::kBlock, 0,
                                stream>>>(a, (const T*)v_inv, (T*)out, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// flat_lin_kernel at camera width np (8, or 10 with k1, k2) into the
// zeroed u (C, np (np + 1) / 2), g_cam (C, np), v (P, 6) and g_pt (P, 3);
// w (N, np, 3) is written whole.  focal / points_on: 0 zeroes J_c's focal
// columns / J_p (optimize_focal / optimize_points False).
int flat_linearize(int dtype, int np, const void* rmats, const void* tvecs,
                   const void* fx_fy, const void* cx_cy_skew, const void* dist,
                   const void* points, const void* cam_idx, const void* pt_idx, const void* uv,
                   const void* mask, const void* inv_w, void* w, void* u, void* g_cam, void* v,
                   void* g_pt, int N, int C, int P, int loss, int focal, int points_on,
                   void* stream) {
  if (N < 0 || C < 0 || P < 0) return kErrGeom;
  if (np != 8 && np != 10) return kErrGeom;
  if (N == 0) return 0;
  const LinFlags f{0, loss, focal, points_on, np == 10, 0};
  const cudaStream_t s = (cudaStream_t)stream;
#define FLAT_LIN(T, NP)                                                                      \
  lin_launch<T, NP>(flat_obs_args<T>(rmats, tvecs, fx_fy, cx_cy_skew, dist, points, cam_idx, \
                                     pt_idx, uv, mask, inv_w, N, C, P),                      \
                    LinOut<T>{(T*)w, (T*)u, (T*)g_cam, (T*)v, (T*)g_pt}, f, s)
  if (dtype == 0) return np == 8 ? FLAT_LIN(float, 8) : FLAT_LIN(float, 10);
  if (dtype == 1) return np == 8 ? FLAT_LIN(double, 8) : FLAT_LIN(double, 10);
#undef FLAT_LIN
  return kErrDtype;
}

// flat_coupling_kernel at camera width np into the zeroed out (C, np (np +
// 1) / 2); v_inv (P, 3, 3).
int flat_coupling(int dtype, int np, const void* rmats, const void* tvecs, const void* fx_fy,
                  const void* cx_cy_skew, const void* dist, const void* points,
                  const void* cam_idx, const void* pt_idx, const void* uv, const void* mask,
                  const void* inv_w, const void* v_inv, void* out, int N, int C, int P,
                  int loss, int focal, int points_on, void* stream) {
  if (N < 0 || C < 0 || P < 0) return kErrGeom;
  if (np != 8 && np != 10) return kErrGeom;
  if (N == 0) return 0;
  const LinFlags f{0, loss, focal, points_on, np == 10, 0};
  const cudaStream_t s = (cudaStream_t)stream;
#define FLAT_COUPLING(T, NP)                                                                 \
  coupling_launch<T, NP>(flat_obs_args<T>(rmats, tvecs, fx_fy, cx_cy_skew, dist, points,     \
                                          cam_idx, pt_idx, uv, mask, inv_w, N, C, P),        \
                         v_inv, out, f, s)
  if (dtype == 0) return np == 8 ? FLAT_COUPLING(float, 8) : FLAT_COUPLING(float, 10);
  if (dtype == 1) return np == 8 ? FLAT_COUPLING(double, 8) : FLAT_COUPLING(double, 10);
#undef FLAT_COUPLING
  return kErrDtype;
}

}  // extern "C"
