// Grid-layout bundle-adjustment kernels for Hopper (sm_90a).
//
// Hand-written CUDA C++ counterparts of the three Pallas kernels of the
// fused-kernel grid engine (tpu3drecon/solvers/ba_pallas.py), all in
// tpu3drecon/ops/pallas/:
//
//   grid_cam_normal   <- cam_normal.py:cam_normal_fused     (_cam_normal_kernel)
//   grid_point_normal <- point_normal.py:point_normal_fused (_point_normal_kernel)
//   grid_coupling     <- coupling.py:coupling_fused         (_coupling_kernel)
//
// Layouts are the JAX package's: component-major (C, comp, K) planes with
// the observation axis K contiguous, so a warp's 32 lanes read and write 32
// neighbouring addresses of one plane; point_normal's track rows are
// row-major per point, (P, T2, 3) and (P, T2).
//
// What bounds them on the H100: all three move far more bytes than they
// compute on.  At the medium shapes (C = 100, K = 2048, f32) cam_normal
// reads 6 planes and writes 24 (~24.6 MB, ~7.3 us at 3.35 TB/s against
// ~1.2 us of float32 arithmetic at 67 TFLOP/s); coupling reads 28 planes
// (~22.9 MB, ~6.8 us); point_normal reads 16 B per track row and writes
// 60 B per point (~15 MB over the five track buckets, ~4.5 us).
//
// The camera kernels (B9, B11) run one block of 256 threads per camera
// row, as the first port did; each thread takes LPT consecutive lanes per
// step (ops/cam_normal.py grid_lanes: 1, or 4 in float32 where each thread
// still takes two steps), moved as one 16-byte vector per plane where K
// and the plane addresses allow it, else lane by lane (B11 at LPT 1 keeps
// the first port's loop, which measured faster there).  Every per-lane
// intermediate (the camera Jacobian rows, W = jc^T jp, T = W V^-1) stays
// in registers, and each input byte is read once.  The per-camera sums (36
// U + 8 g, 36 coupling) are register partials, reduced per block in shared
// memory by a reduce-scatter that halves the sums a lane holds at each warp
// step: the same additions as one warp butterfly per sum, so at LPT 1 the
// sums come out bit for bit in the first port's order.  No atomics and no
// scratch buffer: two calls are bit-equal.  Two row sources share each
// kernel: the JAX planes (x_w (C, 3, K), V^-1 planes (C, 6, K)), or the
// points (P, 3) and V^-1 (P, 3, 3) read through the grid's pt_idx (C, K),
// which is what the grid solve calls: no gathered planes are written or
// read back (an index outside [0, P) traps).  The camera parameters are
// read where they live, 20 values per block.
//
// point_normal runs one launch over all the track buckets of a
// linearization (each block finds its bucket in a by-value table), stages
// each block's contiguous row spans through shared memory with 16-byte
// loads and stores, gives every track row a lane and sums each point's
// rows in one lane in row order.
//
// Built with --fmad=false (ops/_build.py): every product and sum rounds on
// its own, as PyTorch's elementwise ops round them, so the per-element
// outputs match the plain versions to the last bit (point_normal's too,
// whose sums run in the plain version's order) and only the per-camera
// reduced outputs (U, g, coupling) differ by summation order.
//
// Every C entry returns cudaGetLastError() after its launches, or a
// negative code of common.cuh.  The kernels allocate nothing; lam is read
// from device memory, so no launch needs a host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

using namespace tpu3drecon;

namespace {

constexpr int kBlock = 256;             // threads per block
constexpr int kWarps = kBlock / 32;
constexpr int kSym8 = 36;               // upper-triangle entries of an 8x8
constexpr int kUg = kSym8 + 8;          // B9's sums: U | g
constexpr int kCamVals = 20;            // R 9 | t 3 | fx fy | cx cy skew | inv_w | k1 k2

// Row-major upper-triangle index of (i, j), i <= j, of an 8x8.
__device__ __forceinline__ constexpr int triu8(int i, int j) {
  return i * (15 - i) / 2 + j;
}

// N sums padded to a multiple of 16: the shared row of one warp's totals.
__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// ------------------------------------------------------- lane vectors ---
// N consecutive lanes of one plane, aligned as one vector load or store of
// N * sizeof(T) bytes (two 16-byte vectors for four doubles).
template <typename T, int N>
struct alignas(N * sizeof(T) < 16 ? N * sizeof(T) : 16) LaneVec {
  T v[N];
};

// v[i] = p[i] for the first n lanes (0 past them); `full` (all N lanes
// in range, the plane aligned) as one vector.
template <int N, typename T>
__device__ __forceinline__ void load_lanes(const T* __restrict__ p, bool full, int n,
                                           T (&v)[N]) {
  if (full) {
    const LaneVec<T, N> q = *reinterpret_cast<const LaneVec<T, N>*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = q.v[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = i < n ? p[i] : T(0);
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_lanes(T* __restrict__ p, bool full, int n,
                                            const T (&v)[N]) {
  if (full) {
    LaneVec<T, N> q;
#pragma unroll
    for (int i = 0; i < N; ++i) q.v[i] = v[i];
    *reinterpret_cast<LaneVec<T, N>*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) p[i] = v[i];
  }
}

// ------------------------------------------------------- block sums -----
// Block-wide totals of each thread's N partial sums into tot[0..N) (shared
// memory); `red` is a shared (kWarps, pad16(N)) scratch.  All threads call
// it.  Per warp, a reduce-scatter by halving: at each of the steps o = 16,
// 8, 4, 2 a lane keeps half of the sums it holds (the upper half where
// lane bit o is set), sends the other half to lane ^ o and adds what that
// lane sends; after the fourth step lanes l and l ^ 1 hold the same
// pad16(N) / 16 sums, which one more exchange completes: 24 + 12 + 6 + 3
// + 3 = 48 shuffles for 44 or 36 sums, against 220 or 180 for one
// butterfly per sum, and the same additions in the same tree (a + b and b
// + a round alike).  Then thread n adds the warps' n-th totals in warp
// order.
template <typename T, int M, int H>
__device__ __forceinline__ void halve(T (&v)[H], int lane, int o, int& first) {
  const bool up = (lane & o) != 0;
  if (up) first += M;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const T send = up ? v[i] : v[M + i];
    const T keep = up ? v[M + i] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, o);
  }
}

template <typename T, int N>
__device__ __forceinline__ void block_sums(const T (&part)[N], T* red, T* tot) {
  constexpr int NP = pad16(N);
  constexpr int H = NP / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The first step reads the partials in place (the padding is zeros).
  const bool up = (lane & 16) != 0;
  int first = up ? H : 0;  // the first of this lane's sums
  T v[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T hi = H + i < N ? part[H + i] : T(0);
    const T send = up ? part[i] : hi;
    v[i] = (up ? hi : part[i]) + __shfl_xor_sync(kFull, send, 16);
  }
  halve<T, NP / 4>(v, lane, 8, first);
  halve<T, NP / 8>(v, lane, 4, first);
  halve<T, NP / 16>(v, lane, 2, first);
#pragma unroll
  for (int i = 0; i < NP / 16; ++i) v[i] += __shfl_xor_sync(kFull, v[i], 1);
  if ((lane & 1) == 0) {
#pragma unroll
    for (int i = 0; i < NP / 16; ++i) red[warp * NP + first + i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * NP + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// Writes the symmetric 8x8 of the row-major upper triangle `tot` to out.
template <typename T>
__device__ __forceinline__ void store_sym8(const T* tot, T* out) {
  for (int e = threadIdx.x; e < 64; e += kBlock) {
    const int i = e / 8, j = e % 8;
    out[e] = i <= j ? tot[triu8(i, j)] : tot[triu8(j, i)];
  }
}

// The camera tensors of the JAX signature, each where it lives: rmats
// (C, 3, 3), tvecs (C, 3), fx_fy (C, 2), cx_cy_skew (C, 3), dist (C, 2),
// inv_w a 0-d scalar.
template <typename T>
struct CamRows {
  const T* rmats;
  const T* tvecs;
  const T* fx_fy;
  const T* cx_cy_skew;
  const T* dist;
  const T* inv_w;
};

// ---------------------------------------------------------------- B9 ----
// One block per camera row; thread x takes lanes base .. base + LPT - 1
// for base = x LPT, (x + 256) LPT, ... (at LPT 1 the first port's lanes x,
// x + 256, ...), and accumulates its partials lane by lane in that order.
// IDX: lane k's point is points[pt_idx[c, k]] (P, 3), else the x_w planes.
template <typename T, int LPT, bool IDX>
__global__ void __launch_bounds__(kBlock)
grid_cam_normal_kernel(const CamRows<T> cr, const T* __restrict__ xw,
                       const T* __restrict__ pts, const int* __restrict__ pt_idx, int P,
                       const T* __restrict__ uv, const T* __restrict__ mask,
                       T* __restrict__ r_out, T* __restrict__ jp_out,
                       T* __restrict__ jc_out, T* __restrict__ u_out,
                       T* __restrict__ g_out, int K, int loss, int vec) {
  constexpr int NP = pad16(kUg);
  __shared__ T red[kWarps * NP];
  __shared__ T tot[NP];
  __shared__ T s_cam[kCamVals];
  const int cam = blockIdx.x;
  if (threadIdx.x < kCamVals) {
    const int i = threadIdx.x;
    s_cam[i] = i < 9    ? cr.rmats[(size_t)cam * 9 + i]
               : i < 12 ? cr.tvecs[(size_t)cam * 3 + i - 9]
               : i < 14 ? cr.fx_fy[(size_t)cam * 2 + i - 12]
               : i < 17 ? cr.cx_cy_skew[(size_t)cam * 3 + i - 14]
               : i == 17 ? *cr.inv_w
                         : cr.dist[(size_t)cam * 2 + i - 18];
  }
  __syncthreads();
  const T r00 = s_cam[0], r01 = s_cam[1], r02 = s_cam[2];
  const T r10 = s_cam[3], r11 = s_cam[4], r12 = s_cam[5];
  const T r20 = s_cam[6], r21 = s_cam[7], r22 = s_cam[8];
  const T t0 = s_cam[9], t1 = s_cam[10], t2 = s_cam[11];
  const T fx = s_cam[12], fy = s_cam[13];
  const T cx = s_cam[14], cy = s_cam[15], sk = s_cam[16];
  const T inv_w = s_cam[17];
  const T k1 = s_cam[18], k2 = s_cam[19];

  const size_t row = (size_t)cam * K;
  const T* xw0 = xw + 3 * row;
  const int* idx = pt_idx + row;
  const T* uvc = uv + 2 * row;
  const T* m = mask + row;
  T* rr = r_out + 2 * row;
  T* jpc = jp_out + 6 * row;
  T* jcc = jc_out + 16 * row;

  T part[kUg];
#pragma unroll
  for (int n = 0; n < kUg; ++n) part[n] = T(0);

  for (int base = threadIdx.x * LPT; base < K; base += kBlock * LPT) {
    const int n_in = LPT == 1 ? 1 : min(LPT, K - base);
    const bool full = LPT == 1 || (vec && n_in == LPT);
    T X[LPT], Y[LPT], Z[LPT], U0[LPT], U1[LPT], M[LPT];
    if constexpr (IDX) {
      int id[LPT];
      load_lanes<LPT>(idx + base, full, n_in, id);
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        const bool in = i < n_in;
        if (in && (unsigned)id[i] >= (unsigned)P) __trap();  // pt_idx outside [0, P)
        const T* p = pts + 3 * (size_t)id[i];
        X[i] = in ? p[0] : T(0);
        Y[i] = in ? p[1] : T(0);
        Z[i] = in ? p[2] : T(0);
      }
    } else {
      load_lanes<LPT>(xw0 + base, full, n_in, X);
      load_lanes<LPT>(xw0 + K + base, full, n_in, Y);
      load_lanes<LPT>(xw0 + 2 * K + base, full, n_in, Z);
    }
    load_lanes<LPT>(uvc + base, full, n_in, U0);
    load_lanes<LPT>(uvc + K + base, full, n_in, U1);
    load_lanes<LPT>(m + base, full, n_in, M);

    T o_r[2][LPT], o_jp[6][LPT], o_jc[16][LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      if (LPT > 1 && l >= n_in) break;
      const T Xl = X[l], Yl = Y[l], Zl = Z[l];
      // Camera-frame point.
      const T x = r00 * Xl + r01 * Yl + r02 * Zl + t0;
      const T y = r10 * Xl + r11 * Yl + r12 * Zl + t1;
      const T z = r20 * Xl + r21 * Yl + r22 * Zl + t2;
      const T z_safe = fabs(z) < T(1e-12) ? T(1) : z;
      const T iz = T(1) / z_safe;
      // Radial distortion on normalized coordinates: m' = s m.
      const T mx = x * iz, my = y * iz;
      const T rr2 = mx * mx + my * my;
      const T s_rad = T(1) + k1 * rr2 + k2 * rr2 * rr2;
      const T g_rad = T(2) * k1 + T(4) * k2 * rr2;
      const T mdx = s_rad * mx, mdy = s_rad * my;
      const T u_px = fx * mdx + sk * mdy + cx;
      const T v_px = fy * mdy + cy;
      const T res0 = u_px - U0[l], res1 = v_px - U1[l];
      const T s = res0 * res0 + res1 * res1;
      const T scale = sqrt(robust_weight<T>(loss, s)) * M[l] * inv_w;

      const T axx = s_rad + g_rad * mx * mx;
      const T axy = g_rad * mx * my;
      const T ayy = s_rad + g_rad * my * my;
      const T b00 = axx * iz, b01 = axy * iz, b02 = -(axx * mx + axy * my) * iz;
      const T b10 = axy * iz, b11 = ayy * iz, b12 = -(axy * mx + ayy * my) * iz;
      const T a11 = fx * b00 + sk * b10, a12 = fx * b01 + sk * b11;
      const T a13 = fx * b02 + sk * b12;
      const T a21 = fy * b10, a22 = fy * b11, a23 = fy * b12;

      // Whitened camera-Jacobian rows; (0, 7) and (1, 6) are structural zeros.
      T j0[8], j1[8];
      j0[0] = (-a12 * z + a13 * y) * scale;
      j0[1] = (a11 * z - a13 * x) * scale;
      j0[2] = (-a11 * y + a12 * x) * scale;
      j0[3] = a11 * scale;
      j0[4] = a12 * scale;
      j0[5] = a13 * scale;
      j0[6] = mdx * scale;
      j0[7] = T(0);
      j1[0] = (-a22 * z + a23 * y) * scale;
      j1[1] = (a21 * z - a23 * x) * scale;
      j1[2] = (-a21 * y + a22 * x) * scale;
      j1[3] = a21 * scale;
      j1[4] = a22 * scale;
      j1[5] = a23 * scale;
      j1[6] = T(0);
      j1[7] = mdy * scale;
      const T rw0 = res0 * scale, rw1 = res1 * scale;

      o_r[0][l] = rw0;
      o_r[1][l] = rw1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o_jc[i][l] = j0[i];
        o_jc[8 + i][l] = j1[i];
      }
      // Whitened point-Jacobian rows: d(pi)/dx @ R.
      o_jp[0][l] = (a11 * r00 + a12 * r10 + a13 * r20) * scale;
      o_jp[1][l] = (a11 * r01 + a12 * r11 + a13 * r21) * scale;
      o_jp[2][l] = (a11 * r02 + a12 * r12 + a13 * r22) * scale;
      o_jp[3][l] = (a21 * r00 + a22 * r10 + a23 * r20) * scale;
      o_jp[4][l] = (a21 * r01 + a22 * r11 + a23 * r21) * scale;
      o_jp[5][l] = (a21 * r02 + a22 * r12 + a23 * r22) * scale;

      int n = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = i; j < 8; ++j, ++n) part[n] += j0[i] * j0[j] + j1[i] * j1[j];
#pragma unroll
      for (int i = 0; i < 8; ++i) part[kSym8 + i] += j0[i] * rw0 + j1[i] * rw1;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) store_lanes<LPT>(rr + q * K + base, full, n_in, o_r[q]);
#pragma unroll
    for (int q = 0; q < 6; ++q) store_lanes<LPT>(jpc + q * K + base, full, n_in, o_jp[q]);
#pragma unroll
    for (int q = 0; q < 16; ++q) store_lanes<LPT>(jcc + q * K + base, full, n_in, o_jc[q]);
  }

  block_sums(part, red, tot);
  store_sym8(tot, u_out + (size_t)cam * 64);
  if (threadIdx.x < 8) g_out[(size_t)cam * 8 + threadIdx.x] = tot[kSym8 + threadIdx.x];
}

// ---------------------------------------------------------------- B10 ---
// One launch over up to kPnBuckets track buckets, whose pointers, sizes and
// output rows travel by value in PnBuckets.  A block owns `ppb` consecutive
// points of one bucket (ops/point_normal.py point_geometry), i.e. one
// contiguous span of jp_g (P, T2, 3) and of r_g (P, T2), and per chunk of
// kPnChunk track rows:
//   1. stages the chunk's two spans into shared memory with 16-byte
//      cp.async copies, all in flight at once;
//   2. lane j forms the 9 products (6 of V, 3 of g) of rows j and j +
//      kPnThreads into shared memory, row (p, t) at slot p * T2s + t (T2s =
//      T2 | 1, an odd stride: the per-point reads of step 3 fall on
//      distinct banks);
//   3. one lane per point adds its rows' products from zero in row order
//      (point_normal_fused_plain's order: the sums are bit-equal).
// Two rows per lane let the medium problem's 557,056 rows run in about one
// wave of resident blocks.  A point with more than kPnChunk rows is a block
// of its own (ppb = 1) and its rows come in several chunks, still added in
// order.  Then the
// point's lane forms the damping and the adjugate inverse in registers,
// stages its 15 outputs, and the block writes its three output spans
// (v_inv, g, damp) with 16-byte stores.
constexpr int kPnThreads = 256;   // lanes per block
constexpr int kPnChunk = 2 * kPnThreads;  // track rows per chunk: two per lane
constexpr int kPnMaxPoints = 128;  // points per block at most
constexpr int kPnBuckets = 8;     // buckets per launch

struct PnBuckets {
  const void* jp[kPnBuckets];
  const void* r[kPnBuckets];
  int P[kPnBuckets];
  int T2[kPnBuckets];
  int ppb[kPnBuckets];               // points per block
  int row0[kPnBuckets];              // the bucket's first output row
  int block0[kPnBuckets + 1];        // the bucket's first block; block0[n] = grid
  int n;
};

// The shared layout of one block (elements of T): the staged inputs of a
// chunk, later the staged outputs (io), then the (9, RS) products.
__host__ __device__ constexpr bool pn_chunked(int ppb, int T2) { return ppb * T2 > kPnChunk; }
__host__ __device__ constexpr int pn_rs(int ppb, int T2) {
  return pn_chunked(ppb, T2) ? kPnChunk : ppb * (T2 | 1);
}
template <typename T>
__host__ __device__ constexpr int pn_io(int ppb) {
  constexpr int ve = 16 / sizeof(T);
  const int in = 4 * kPnChunk + 2 * ve;
  const int out = vec_up<T>(9 * ppb) + 2 * vec_up<T>(3 * ppb) + 3 * ve;
  return in > out ? in : out;
}
template <typename T>
__host__ __device__ constexpr size_t pn_smem(int ppb, int T2) {
  return size_t(pn_io<T>(ppb) + 9 * pn_rs(ppb, T2)) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kPnThreads)
point_normal_rows_kernel(const PnBuckets bk, const T* __restrict__ lam_p,
                         T* __restrict__ vinv_out, T* __restrict__ g_out,
                         T* __restrict__ damp_out, T diag_floor) {
  extern __shared__ __align__(16) unsigned char pn_raw[];
  T* s_io = reinterpret_cast<T*>(pn_raw);
  constexpr int ve = 16 / sizeof(T);
  int b = 0;
  while (b + 1 < bk.n && int(blockIdx.x) >= bk.block0[b + 1]) ++b;  // block-uniform
  const int T2 = bk.T2[b], ppb = bk.ppb[b];
  const int p0 = (int(blockIdx.x) - bk.block0[b]) * ppb;
  const int np = min(ppb, bk.P[b] - p0);
  const int rows = np * T2;
  const bool chunked = pn_chunked(ppb, T2);
  const int T2s = T2 | 1, RS = pn_rs(ppb, T2);
  T* s_prod = s_io + pn_io<T>(ppb);
  const T* jp = static_cast<const T*>(bk.jp[b]) + size_t(p0) * T2 * 3;
  const T* r = static_cast<const T*>(bk.r[b]) + size_t(p0) * T2;
  const int tid = threadIdx.x;

  T acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = T(0);
  for (int c0 = 0; c0 < rows; c0 += kPnChunk) {
    const int cn = min(kPnChunk, rows - c0);
    T* s_jp = s_io + vec_shift(jp + 3 * c0);
    T* s_r = s_io + 3 * kPnChunk + ve + vec_shift(r + c0);
    copy_async(s_jp, jp + 3 * c0, 3 * cn);
    copy_async(s_r, r + c0, cn);
    copy_async_wait();
    __syncthreads();
#pragma unroll 1
    for (int j = tid; j < cn; j += kPnThreads) {
      const T c0v = s_jp[3 * j], c1 = s_jp[3 * j + 1], c2 = s_jp[3 * j + 2];
      const T rt = s_r[j];
      const int row = c0 + j;
      T* pp = s_prod + (chunked ? j : (row / T2) * T2s + row % T2);
      pp[0] = c0v * c0v;
      pp[RS] = c0v * c1;
      pp[2 * RS] = c0v * c2;
      pp[3 * RS] = c1 * c1;
      pp[4 * RS] = c1 * c2;
      pp[5 * RS] = c2 * c2;
      pp[6 * RS] = c0v * rt;
      pp[7 * RS] = c1 * rt;
      pp[8 * RS] = c2 * rt;
    }
    __syncthreads();
    if (tid < np) {
      const T* pp = s_prod + (chunked ? 0 : tid * T2s);
      const int nt = chunked ? cn : T2;
#pragma unroll 4
      for (int t = 0; t < nt; ++t)
#pragma unroll
        for (int k = 0; k < 9; ++k) acc[k] += pp[k * RS + t];
    }
    if (c0 + kPnChunk < rows) __syncthreads();  // the next chunk reuses the staging
  }

  const size_t row0 = size_t(bk.row0[b]) + p0;
  T* vo = vinv_out + row0 * 9;
  T* go = g_out + row0 * 3;
  T* dout = damp_out + row0 * 3;
  T* s_v = s_io + vec_shift(vo);
  T* s_g = s_io + vec_up<T>(9 * ppb) + ve + vec_shift(go);
  T* s_d = s_io + vec_up<T>(9 * ppb) + vec_up<T>(3 * ppb) + 2 * ve + vec_shift(dout);
  if (tid < np) {
    const T v00 = acc[0], v01 = acc[1], v02 = acc[2];
    const T v11 = acc[3], v12 = acc[4], v22 = acc[5];
    // Damping lam * max(diag, floor), then the closed-form adjugate inverse
    // in the JAX kernel's cofactor layout and operation order.
    const T lam = *lam_p;
    const T d0 = lam * (v00 < diag_floor ? diag_floor : v00);
    const T d1 = lam * (v11 < diag_floor ? diag_floor : v11);
    const T d2 = lam * (v22 < diag_floor ? diag_floor : v22);
    const T a = v00 + d0, bb = v01, c = v02;
    const T d = v01, e = v11 + d1, f = v12;
    const T gg = v02, h = v12, i = v22 + d2;
    const T co_a = e * i - f * h;
    const T co_b = c * h - bb * i;
    const T co_c = bb * f - c * e;
    const T det = a * co_a + d * co_b + gg * co_c;
    const T inv_det = T(1) / (fabs(det) < T(1e-32) ? T(1) : det);
    T* vi = s_v + 9 * tid;
    vi[0] = co_a * inv_det;
    vi[1] = co_b * inv_det;
    vi[2] = co_c * inv_det;
    vi[3] = (f * gg - d * i) * inv_det;
    vi[4] = (a * i - c * gg) * inv_det;
    vi[5] = (c * d - a * f) * inv_det;
    vi[6] = (d * h - e * gg) * inv_det;
    vi[7] = (bb * gg - a * h) * inv_det;
    vi[8] = (a * e - bb * d) * inv_det;
    s_g[3 * tid] = acc[6];
    s_g[3 * tid + 1] = acc[7];
    s_g[3 * tid + 2] = acc[8];
    s_d[3 * tid] = d0;
    s_d[3 * tid + 1] = d1;
    s_d[3 * tid + 2] = d2;
  }
  __syncthreads();
  copy_span(vo, s_v, 9 * np);
  copy_span(go, s_g, 3 * np);
  copy_span(dout, s_d, 3 * np);
}

// ---------------------------------------------------------------- B11 ---
// Lane k's V^-1 entries 00 01 02 11 12 22: from v_inv[pt_idx[c, k]] (P, 3,
// 3; entries 0 1 2 4 5 8) where IDX, zeros for a lane past the row (`in`
// false) and a trap on an index outside [0, P); else from the row's (6, K)
// planes.
template <bool IDX, typename T>
__device__ __forceinline__ void vinv_lane(const T* __restrict__ vc, const T* __restrict__ vinv,
                                          int id, int P, int K, int k, bool in, T (&v)[6]) {
  if constexpr (IDX) {
    if (in && (unsigned)id >= (unsigned)P) __trap();
    const T* vp = vinv + 9 * (size_t)id;
#pragma unroll
    for (int q = 0; q < 6; ++q) v[q] = in ? vp[q < 3 ? q : q == 5 ? 8 : q + 1] : T(0);
  } else {
#pragma unroll
    for (int q = 0; q < 6; ++q) v[q] = vc[q * K + k];
  }
}

// Adds one lane's 36 upper-triangle partials of T W^T, W = jc^T jp (8x3)
// and T = W V^-1, to part; jc(q) is the lane's q-th jc entry.
template <typename T, typename Jc>
__device__ __forceinline__ void add_coupling(const T (&p0)[3], const T (&p1)[3],
                                             const T (&v)[6], Jc jc, T (&part)[kSym8]) {
  const T vr[3][3] = {{v[0], v[1], v[2]}, {v[1], v[3], v[4]}, {v[2], v[4], v[5]}};
  T w[8][3], tm[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const T c0 = jc(i), c1 = jc(8 + i);
#pragma unroll
    for (int j = 0; j < 3; ++j) w[i][j] = c0 * p0[j] + c1 * p1[j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      tm[i][l] = w[i][0] * vr[0][l] + w[i][1] * vr[1][l] + w[i][2] * vr[2][l];
  int n = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int mm = i; mm < 8; ++mm, ++n)
      part[n] += tm[i][0] * w[mm][0] + tm[i][1] * w[mm][1] + tm[i][2] * w[mm][2];
}

// B9's block and lane order, the partials of each lane in registers.  LPT
// 1 keeps the first port's loop, each input loaded where it is used: B9's
// lane arrays measured 6-15 % slower there.
template <typename T, int LPT, bool IDX>
__global__ void __launch_bounds__(kBlock)
grid_coupling_kernel(const T* __restrict__ jc, const T* __restrict__ jp,
                     const T* __restrict__ vinv6, const T* __restrict__ vinv,
                     const int* __restrict__ pt_idx, int P, T* __restrict__ out, int K,
                     int vec) {
  constexpr int NP = pad16(kSym8);
  __shared__ T red[kWarps * NP];
  __shared__ T tot[NP];
  const int cam = blockIdx.x;
  const size_t row = (size_t)cam * K;
  const T* jcc = jc + 16 * row;
  const T* jpc = jp + 6 * row;
  const T* vc = vinv6 + 6 * row;
  const int* idx = pt_idx + row;

  T part[kSym8];
#pragma unroll
  for (int n = 0; n < kSym8; ++n) part[n] = T(0);

  if constexpr (LPT == 1) {
    for (int k = threadIdx.x; k < K; k += kBlock) {
      T p0[3], p1[3], v[6];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        p0[j] = jpc[j * K + k];
        p1[j] = jpc[(3 + j) * K + k];
      }
      vinv_lane<IDX>(vc, vinv, IDX ? idx[k] : 0, P, K, k, true, v);
      add_coupling(p0, p1, v, [&](int q) { return jcc[q * K + k]; }, part);
    }
  } else {
    for (int base = threadIdx.x * LPT; base < K; base += kBlock * LPT) {
      const int n_in = min(LPT, K - base);
      const bool full = vec && n_in == LPT;
      T p[6][LPT], vp[6][LPT], c[16][LPT];
#pragma unroll
      for (int q = 0; q < 6; ++q) load_lanes<LPT>(jpc + q * K + base, full, n_in, p[q]);
      if constexpr (IDX) {
        int id[LPT];
        load_lanes<LPT>(idx + base, full, n_in, id);
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
          T v[6];
          vinv_lane<true>(vc, vinv, id[l], P, K, base + l, l < n_in, v);
#pragma unroll
          for (int q = 0; q < 6; ++q) vp[q][l] = v[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < 6; ++q) load_lanes<LPT>(vc + q * K + base, full, n_in, vp[q]);
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) load_lanes<LPT>(jcc + q * K + base, full, n_in, c[q]);
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        if (l >= n_in) break;
        const T p0[3] = {p[0][l], p[1][l], p[2][l]};
        const T p1[3] = {p[3][l], p[4][l], p[5][l]};
        const T v[6] = {vp[0][l], vp[1][l], vp[2][l], vp[3][l], vp[4][l], vp[5][l]};
        add_coupling(p0, p1, v, [&](int q) { return c[q][l]; }, part);
      }
    }
  }

  block_sums(part, red, tot);
  store_sym8(tot, out + (size_t)cam * 64);
}

// ---------------------------------------------------------------- host --
#define GRID_DISPATCH(DTYPE, CALL)             \
  do {                                         \
    if ((DTYPE) == 0) { using T = float; return CALL; }  \
    if ((DTYPE) == 1) { using T = double; return CALL; } \
    return kErrDtype;                          \
  } while (0)

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The lanes per thread the C entries take (ops/cam_normal.py LANES): 1, or
// 4 in float32 (a float64 thread of 4 lanes spills); grid_lanes picks them.
bool grid_lanes_ok(int dtype, int lanes) { return lanes == 1 || (lanes == 4 && dtype == 0); }

// 16-byte vectors of LPT lanes where K and every plane address allow them.
template <typename T, int LPT>
bool lanes_vec(int K, std::initializer_list<const void*> planes) {
  constexpr size_t va = LPT * sizeof(T) < 16 ? LPT * sizeof(T) : 16;
  if (K % LPT != 0) return false;
  for (const void* p : planes)
    if (p != nullptr && !aligned(p, va)) return false;
  return true;
}

struct CamNormalArgs {
  const void *rmats, *tvecs, *fx_fy, *cx_cy_skew, *dist, *inv_w;
  const void *xw, *points, *pt_idx, *uv, *mask;
  void *r, *jp, *jc, *u, *g;
  int C, K, P, loss;
  cudaStream_t stream;
};

template <typename T, int LPT>
int cam_normal_launch(const CamNormalArgs& a, bool indexed) {
  const bool vec = lanes_vec<T, LPT>(a.K, {a.uv, a.mask, a.r, a.jp, a.jc}) &&
                   (indexed ? aligned(a.pt_idx, LPT * sizeof(int))
                            : lanes_vec<T, LPT>(a.K, {a.xw}));
  const CamRows<T> cr{(const T*)a.rmats, (const T*)a.tvecs, (const T*)a.fx_fy,
                      (const T*)a.cx_cy_skew, (const T*)a.dist, (const T*)a.inv_w};
  const auto kernel = indexed ? &grid_cam_normal_kernel<T, LPT, true>
                              : &grid_cam_normal_kernel<T, LPT, false>;
  kernel<<<a.C, kBlock, 0, a.stream>>>(
      cr, (const T*)a.xw, (const T*)a.points, (const int*)a.pt_idx, a.P, (const T*)a.uv,
      (const T*)a.mask, (T*)a.r, (T*)a.jp, (T*)a.jc, (T*)a.u, (T*)a.g, a.K, a.loss, (int)vec);
  return (int)cudaGetLastError();
}

template <typename T, int LPT>
int coupling_launch(const void* jc, const void* jp, const void* vinv6, const void* vinv,
                    const void* pt_idx, void* out, int C, int K, int P, bool indexed,
                    cudaStream_t stream) {
  const bool vec = lanes_vec<T, LPT>(K, {jc, jp}) &&
                   (indexed ? aligned(pt_idx, LPT * sizeof(int)) : lanes_vec<T, LPT>(K, {vinv6}));
  const auto kernel = indexed ? &grid_coupling_kernel<T, LPT, true>
                              : &grid_coupling_kernel<T, LPT, false>;
  kernel<<<C, kBlock, 0, stream>>>((const T*)jc, (const T*)jp, (const T*)vinv6,
                                   (const T*)vinv, (const int*)pt_idx, P, (T*)out, K,
                                   (int)vec);
  return (int)cudaGetLastError();
}

// B10 over n buckets: one launch per kPnBuckets of them.  jp_g and r_g are
// host arrays of the buckets' device pointers, P, T2 and ppb host arrays of
// their points, rows per point and points per block (ops/point_normal.py
// point_geometry: kErrGeom for a block of more than kPnMaxPoints points or
// of several points over more than kPnChunk rows, kErrSmem past the card's
// shared memory per block; above 48 KB the kernel is opted in first).
template <typename T>
int point_normal_buckets_launch(int n, const uint64_t* jp_g, const uint64_t* r_g,
                                const int* P, const int* T2, const int* ppb, const void* lam,
                                void* vinv, void* g, void* damp, double diag_floor,
                                cudaStream_t stream) {
  int row0 = 0;
  for (int first = 0; first < n; first += kPnBuckets) {
    PnBuckets bk{};
    bk.n = n - first < kPnBuckets ? n - first : kPnBuckets;
    size_t smem = 0;
    int blocks = 0;
    for (int i = 0; i < bk.n; ++i) {
      const int j = first + i;
      if (P[j] < 0 || T2[j] < 0 || ppb[j] < 1 || ppb[j] > kPnMaxPoints ||
          (ppb[j] > 1 && pn_chunked(ppb[j], T2[j])))
        return kErrGeom;
      const size_t need = pn_smem<T>(ppb[j], T2[j]);
      if (need > smem) smem = need;
      bk.jp[i] = reinterpret_cast<const void*>(jp_g[j]);
      bk.r[i] = reinterpret_cast<const void*>(r_g[j]);
      bk.P[i] = P[j];
      bk.T2[i] = T2[j];
      bk.ppb[i] = ppb[j];
      bk.row0[i] = row0;
      bk.block0[i] = blocks;
      row0 += P[j];
      blocks += (P[j] + ppb[j] - 1) / ppb[j];
    }
    bk.block0[bk.n] = blocks;
    if (blocks == 0) continue;
    if (smem > 48 * 1024) {
      const int e = prepare(point_normal_rows_kernel<T>, smem);
      if (e) return e;
    }
    point_normal_rows_kernel<T><<<blocks, kPnThreads, smem, stream>>>(
        bk, (const T*)lam, (T*)vinv, (T*)g, (T*)damp, (T)diag_floor);
    const int e = (int)cudaGetLastError();
    if (e) return e;
  }
  return 0;
}

}  // namespace

extern "C" {

// B9.  indexed = 0: x_w (C, 3, K) planes; 1: points (P, 3) read through
// pt_idx (C, K) int32 (a kernel trap on an index outside [0, P)).  lanes:
// grid_lanes' LPT (kErrGeom for another value).
int grid_cam_normal(int dtype, int indexed, const void* rmats, const void* tvecs,
                    const void* fx_fy, const void* cx_cy_skew, const void* dist,
                    const void* inv_w, const void* xw, const void* points, const void* pt_idx,
                    const void* uv, const void* mask, void* r, void* jp, void* jc, void* u,
                    void* g, int C, int K, int P, int loss, int lanes, void* stream) {
  if (!grid_lanes_ok(dtype, lanes) || (indexed != 0 && indexed != 1) || K < 0 || P < 0)
    return kErrGeom;
  if (C <= 0) return 0;
  const CamNormalArgs a{rmats, tvecs, fx_fy, cx_cy_skew, dist, inv_w, xw, points, pt_idx,
                        uv, mask, r, jp, jc, u, g, C, K, P, loss, (cudaStream_t)stream};
  if (lanes == 4) return cam_normal_launch<float, 4>(a, indexed);
  GRID_DISPATCH(dtype, (cam_normal_launch<T, 1>(a, indexed)));
}

int grid_point_normal(int dtype, int n, const void* jp_g, const void* r_g, const void* P,
                      const void* T2, const void* ppb, const void* lam, void* vinv,
                      void* g, void* damp, double diag_floor, void* stream) {
  if (n <= 0) return 0;
  GRID_DISPATCH(dtype, (point_normal_buckets_launch<T>(
                           n, (const uint64_t*)jp_g, (const uint64_t*)r_g, (const int*)P,
                           (const int*)T2, (const int*)ppb, lam, vinv, g, damp, diag_floor,
                           (cudaStream_t)stream)));
}

// B11.  indexed = 0: vinv6 (C, 6, K) planes; 1: v_inv (P, 3, 3) read
// through pt_idx (C, K) int32 (a kernel trap on an index outside [0, P)).
int grid_coupling(int dtype, int indexed, const void* jc, const void* jp, const void* vinv6,
                  const void* vinv, const void* pt_idx, void* out, int C, int K, int P,
                  int lanes, void* stream) {
  if (!grid_lanes_ok(dtype, lanes) || (indexed != 0 && indexed != 1) || K < 0 || P < 0)
    return kErrGeom;
  if (C <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 4)
    return coupling_launch<float, 4>(jc, jp, vinv6, vinv, pt_idx, out, C, K, P, indexed, st);
  GRID_DISPATCH(dtype, (coupling_launch<T, 1>(jc, jp, vinv6, vinv, pt_idx, out, C, K, P,
                                              indexed, st)));
}

}  // extern "C"
