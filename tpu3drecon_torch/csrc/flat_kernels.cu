// The flat engine's linearization for Hopper (sm_90a): two kernels over the
// flat observation list (BAL layout: cam_idx, pt_idx, uv, mask of N
// observations), in place of ops/jacobians.py's gather_obs_blocks and the
// segment sums of solvers/schur.py build_normal_blocks.
//
//   flat_lin_kernel       one pass over the observations: r, J_c (2x8) and
//                         J_p (2x3) in registers (slot.cuh tt_blocks, the
//                         operation order of obs_blocks), W = J_c^T J_p
//                         written (N, 8, 3), U (36 upper-triangle entries)
//                         and g_c (8) reduced per camera, V (6) and g_p (3)
//                         per point.
//   flat_coupling_kernel  one pass for the Schur-Jacobi preconditioner,
//                         once V^-1 is known: sum W V^-1 W^T (36 entries)
//                         per camera.
//
// They replace no TPU kernel: the JAX flat engine leaves this to XLA
// (tpu3drecon/solvers/schur.py, tpu3drecon/ops/jacobians.py).
//
// Their least time on the H100.  flat_lin_kernel reads 20 B of each
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
// the bound; chip_smoke.py times both at the benchmark's shapes.
//
// The atomics.  One lane per observation, 32 consecutive observations per
// warp.  The warp's lanes are grouped by camera (then by point) with
// __match_any_sync; each lane puts its columns into the warp's shared
// (32, 45) tile, and each (distinct row, column) pair is summed over its
// lanes by one lane and leaves as one atomic.  This adapts to the order of
// the observations with no flag: sorted by point (BAL files, the benchmark's
// generator), a warp holds ~5 points and the ~6 consecutive cameras that
// see each, so the point sums leave in ~5 x 9 atomics and the camera sums in
// (distinct cameras) x 44; sorted by camera (the COLMAP packing), the
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

constexpr int kFlatBlock = 128;             // threads per block
constexpr int kFlatWarps = kFlatBlock / 32;
constexpr int kSym8 = 36;                   // upper-triangle entries of an 8x8
constexpr int kTileW = kSym8 + 8 + 1;       // tile row: the widest segment (U | g) + 1

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
template <typename T>
__device__ __forceinline__ void flat_obs(const FlatObs<T>& a, size_t n, const LinFlags& f,
                                         Slot<T, 8>& o, int& c, int& p) {
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
  tt_blocks<T, 8>(cp, __ldg(x), __ldg(x + 1), __ldg(x + 2), __ldg(a.uv + 2 * n),
                  __ldg(a.uv + 2 * n + 1), __ldg(a.mask + n), __ldg(a.inv_w), f, o);
}

// W = J_c^T J_p of one observation: w[i][l] = jc0[i] jp0[l] + jc1[i] jp1[l],
// the plain version's order.
template <typename T>
__device__ __forceinline__ void w_block(const Slot<T, 8>& o, T (&w)[8][3]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) w[i][l] = o.jc[i] * o.jp[l] + o.jc[8 + i] * o.jp[3 + l];
}

// ------------------------------------------------------ warp row sums ---
// One warp's (32, kTileW) tile of column values (row = lane) and its
// grouping: each lane's row (-1: none), each lane's peers (lanes of the
// same row) and the leader lane of each distinct row.
template <typename T>
struct WarpSums {
  T* v;
  int* meta;  // row[32] | peers[32] | leaders[32]
  int nd;     // distinct rows among the warp's live lanes
};

// Groups the warp's lanes by row `row` (-1 = none); the whole warp calls it.
template <typename T>
__device__ __forceinline__ void group_rows(WarpSums<T>& ws, int row) {
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

template <typename T>
__device__ __forceinline__ void put(const WarpSums<T>& ws, int col, T val) {
  ws.v[(threadIdx.x & 31) * kTileW + col] = val;
}

// Adds tile columns [0, NA + NB) of each distinct row: column c < NA to
// a[row * NA + c], column NA + c to b[row * NB + c].  One lane per (row,
// column), which sums the row's lanes in lane order and sends one atomic;
// a sum of exactly 0 (padding rows) sends none.
template <int NA, int NB, typename T>
__device__ __forceinline__ void flush_rows(const WarpSums<T>& ws, T* a, T* b) {
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
      s += ws.v[l * kTileW + c];
    }
    const size_t row = size_t(ws.meta[l0]);
    if (s != T(0)) atomicAdd(c < NA ? a + row * NA + c : b + row * NB + (c - NA), s);
  }
}

// ------------------------------------------------------------ kernels ---
template <typename T>
struct LinOut {
  T* w;      // (N, 8, 3)
  T* u;      // (C, 36) row-major upper triangle of U
  T* g_cam;  // (C, 8)
  T* v;      // (P, 6) 00 01 02 11 12 22 of V
  T* g_pt;   // (P, 3)
};

template <typename T>
__global__ void __launch_bounds__(kFlatBlock)
flat_lin_kernel(const FlatObs<T> a, const LinOut<T> out, const LinFlags f) {
  __shared__ T tile[kFlatWarps][32 * kTileW];
  __shared__ int meta[kFlatWarps][96];
  const int warp = threadIdx.x >> 5;
  const size_t n = (size_t)blockIdx.x * kFlatBlock + threadIdx.x;
  const bool live = n < (size_t)a.N;
  Slot<T, 8> o;
  int c = -1, p = -1;
  if (live) {
    flat_obs(a, n, f, o, c, p);
    T w[8][3];
    w_block(o, w);
    // 96 (float) or 192 (double) bytes a row: whole 16-byte vectors.
    using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    constexpr int per = 16 / sizeof(T);
    V* dst = reinterpret_cast<V*>(out.w + n * 24);
    const T* flat = &w[0][0];
#pragma unroll
    for (int k = 0; k < 24 / per; ++k) {
      V q;
      T* qe = reinterpret_cast<T*>(&q);
#pragma unroll
      for (int e = 0; e < per; ++e) qe[e] = flat[k * per + e];
      dst[k] = q;
    }
  }
  WarpSums<T> ws{tile[warp], meta[warp], 0};

  // Camera side: U = sum J_c^T J_c (row-major i <= j), g_c = sum J_c^T r.
  group_rows(ws, c);
  if (live) {
    const T* j0 = o.jc;
    const T* j1 = o.jc + 8;
    int col = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = i; j < 8; ++j, ++col) put(ws, col, j0[i] * j0[j] + j1[i] * j1[j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) put(ws, kSym8 + i, j0[i] * o.r0 + j1[i] * o.r1);
  }
  flush_rows<kSym8, 8>(ws, out.u, out.g_cam);

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
template <typename T>
__global__ void __launch_bounds__(kFlatBlock)
flat_coupling_kernel(const FlatObs<T> a, const T* __restrict__ v_inv, T* __restrict__ out,
                     const LinFlags f) {
  __shared__ T tile[kFlatWarps][32 * kTileW];
  __shared__ int meta[kFlatWarps][96];
  const int warp = threadIdx.x >> 5;
  const size_t n = (size_t)blockIdx.x * kFlatBlock + threadIdx.x;
  const bool live = n < (size_t)a.N;
  WarpSums<T> ws{tile[warp], meta[warp], 0};
  Slot<T, 8> o;
  int c = -1, p = -1;
  if (live) flat_obs(a, n, f, o, c, p);
  group_rows(ws, c);
  if (live) {
    T w[8][3], vi[9], wv[8][3];
    w_block(o, w);
#pragma unroll
    for (int k = 0; k < 9; ++k) vi[k] = __ldg(v_inv + (size_t)p * 9 + k);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        wv[i][l] = w[i][0] * vi[l] + w[i][1] * vi[3 + l] + w[i][2] * vi[6 + l];
    int col = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = i; j < 8; ++j, ++col)
        put(ws, col, wv[i][0] * w[j][0] + wv[i][1] * w[j][1] + wv[i][2] * w[j][2]);
  }
  flush_rows<kSym8, 0>(ws, out, out);
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

inline unsigned flat_grid(int N) { return unsigned((N + kFlatBlock - 1) / kFlatBlock); }

template <typename T>
int lin_launch(const FlatObs<T>& a, const LinOut<T>& out, const LinFlags& f,
               cudaStream_t stream) {
  flat_lin_kernel<T><<<flat_grid(a.N), kFlatBlock, 0, stream>>>(a, out, f);
  return (int)cudaGetLastError();
}

template <typename T>
int coupling_launch(const FlatObs<T>& a, const void* v_inv, void* out, const LinFlags& f,
                    cudaStream_t stream) {
  flat_coupling_kernel<T><<<flat_grid(a.N), kFlatBlock, 0, stream>>>(a, (const T*)v_inv,
                                                                      (T*)out, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// flat_lin_kernel into the zeroed u (C, 36), g_cam (C, 8), v (P, 6) and
// g_pt (P, 3); w (N, 8, 3) is written whole.  focal / points_on: 0 zeroes
// J_c's focal columns / J_p (optimize_focal / optimize_points False).
int flat_linearize(int dtype, const void* rmats, const void* tvecs, const void* fx_fy,
                   const void* cx_cy_skew, const void* dist, const void* points,
                   const void* cam_idx, const void* pt_idx, const void* uv, const void* mask,
                   const void* inv_w, void* w, void* u, void* g_cam, void* v, void* g_pt,
                   int N, int C, int P, int loss, int focal, int points_on, void* stream) {
  if (N < 0 || C < 0 || P < 0) return kErrGeom;
  if (N == 0) return 0;
  const LinFlags f{0, loss, focal, points_on, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
#define FLAT_LIN(T)                                                                          \
  lin_launch<T>(flat_obs_args<T>(rmats, tvecs, fx_fy, cx_cy_skew, dist, points, cam_idx,     \
                                 pt_idx, uv, mask, inv_w, N, C, P),                          \
                LinOut<T>{(T*)w, (T*)u, (T*)g_cam, (T*)v, (T*)g_pt}, f, s)
  if (dtype == 0) return FLAT_LIN(float);
  if (dtype == 1) return FLAT_LIN(double);
#undef FLAT_LIN
  return kErrDtype;
}

// flat_coupling_kernel into the zeroed out (C, 36); v_inv (P, 3, 3).
int flat_coupling(int dtype, const void* rmats, const void* tvecs, const void* fx_fy,
                  const void* cx_cy_skew, const void* dist, const void* points,
                  const void* cam_idx, const void* pt_idx, const void* uv, const void* mask,
                  const void* inv_w, const void* v_inv, void* out, int N, int C, int P,
                  int loss, int focal, int points_on, void* stream) {
  if (N < 0 || C < 0 || P < 0) return kErrGeom;
  if (N == 0) return 0;
  const LinFlags f{0, loss, focal, points_on, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
#define FLAT_COUPLING(T)                                                                     \
  coupling_launch<T>(flat_obs_args<T>(rmats, tvecs, fx_fy, cx_cy_skew, dist, points,         \
                                      cam_idx, pt_idx, uv, mask, inv_w, N, C, P),            \
                     v_inv, out, f, s)
  if (dtype == 0) return FLAT_COUPLING(float);
  if (dtype == 1) return FLAT_COUPLING(double);
#undef FLAT_COUPLING
  return kErrDtype;
}

}  // extern "C"
