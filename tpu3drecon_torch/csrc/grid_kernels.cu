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
// 60 B per point (~15 MB over the five track buckets, ~4.5 us).  What the
// design does about it: the camera kernels keep every per-lane
// intermediate (the camera Jacobian rows, W = jc^T jp, T = W V^-1) in
// registers, read each input byte once, and reduce the per-camera sums (36
// U + 8 g sums, 36 coupling sums) as register partials once per block with
// warp shuffles and shared memory — no atomics, so every sum is
// deterministic.  They run one block per camera row: 100 blocks on 132 SMs
// is under one wave, so at the medium size they cannot reach the byte
// bound; splitting K across blocks is later work.  point_normal runs one
// launch over all the track buckets of a linearization (each block finds
// its bucket in a by-value table), stages each block's contiguous row
// spans through shared memory with 16-byte loads and stores, gives every
// track row a lane and sums each point's rows in one lane in row order.
//
// Built with --fmad=false (ops/_build.py): every product and sum rounds on
// its own, as PyTorch's elementwise ops round them, so the per-element
// outputs match the plain versions to the last bits (point_normal's too,
// whose sums run in the plain version's order) and only the per-camera
// reduced outputs (U, g, coupling) differ by summation order.
//
// Every C entry returns cudaGetLastError() after its launches, or a
// negative code of common.cuh.  The kernels allocate nothing; lam is read
// from device memory, so no launch needs a host sync.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

using namespace tpu3drecon;

namespace {

constexpr int kBlock = 256;             // threads per block
constexpr int kWarps = kBlock / 32;
constexpr int kParamWidth = 24;         // ops/cam_normal.py PARAM_WIDTH
constexpr int kSym8 = 36;               // upper-triangle entries of an 8x8

// Row-major upper-triangle index of (i, j), i <= j, of an 8x8.
__device__ __forceinline__ constexpr int triu8(int i, int j) {
  return i * (15 - i) / 2 + j;
}

// Block-wide totals of each thread's N partial sums into tot[0..N) (shared
// memory); `red` is a shared (kWarps, N) scratch.  All threads call it.
template <typename T, int N>
__device__ __forceinline__ void block_sums(const T (&part)[N], T* red, T* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const T v = warp_sum(part[n]);
    if (lane == 0) red[warp * N + n] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * N + threadIdx.x];
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

// ---------------------------------------------------------------- B9 ----
// One block per camera row; thread x owns lanes x, x + 256, ... of K.
template <typename T>
__global__ void __launch_bounds__(kBlock)
cam_normal_kernel(const T* __restrict__ params, const T* __restrict__ xw,
                  const T* __restrict__ uv, const T* __restrict__ mask,
                  T* __restrict__ r_out, T* __restrict__ jp_out,
                  T* __restrict__ jc_out, T* __restrict__ u_out,
                  T* __restrict__ g_out, int K, int loss) {
  __shared__ T red[kWarps * (kSym8 + 8)];
  __shared__ T tot[kSym8 + 8];
  const int cam = blockIdx.x;
  const T* p = params + (size_t)cam * kParamWidth;
  const T r00 = p[0], r01 = p[1], r02 = p[2];
  const T r10 = p[3], r11 = p[4], r12 = p[5];
  const T r20 = p[6], r21 = p[7], r22 = p[8];
  const T t0 = p[9], t1 = p[10], t2 = p[11];
  const T fx = p[12], fy = p[13];
  const T cx = p[14], cy = p[15], sk = p[16];
  const T inv_w = p[17];
  const T k1 = p[18], k2 = p[19];

  const size_t row = (size_t)cam * K;
  const T* xw0 = xw + 3 * row;
  const T* uvc = uv + 2 * row;
  const T* m = mask + row;
  T* rr = r_out + 2 * row;
  T* jpc = jp_out + 6 * row;
  T* jcc = jc_out + 16 * row;

  T part[kSym8 + 8];
#pragma unroll
  for (int n = 0; n < kSym8 + 8; ++n) part[n] = T(0);

  for (int k = threadIdx.x; k < K; k += kBlock) {
    const T X = xw0[k], Y = xw0[K + k], Z = xw0[2 * K + k];
    // Camera-frame point.
    const T x = r00 * X + r01 * Y + r02 * Z + t0;
    const T y = r10 * X + r11 * Y + r12 * Z + t1;
    const T z = r20 * X + r21 * Y + r22 * Z + t2;
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
    const T res0 = u_px - uvc[k], res1 = v_px - uvc[K + k];
    const T s = res0 * res0 + res1 * res1;
    const T scale = sqrt(robust_weight<T>(loss, s)) * m[k] * inv_w;

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

    rr[k] = rw0;
    rr[K + k] = rw1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      jcc[i * K + k] = j0[i];
      jcc[(8 + i) * K + k] = j1[i];
    }
    // Whitened point-Jacobian rows: d(pi)/dx @ R.
    jpc[k] = (a11 * r00 + a12 * r10 + a13 * r20) * scale;
    jpc[K + k] = (a11 * r01 + a12 * r11 + a13 * r21) * scale;
    jpc[2 * K + k] = (a11 * r02 + a12 * r12 + a13 * r22) * scale;
    jpc[3 * K + k] = (a21 * r00 + a22 * r10 + a23 * r20) * scale;
    jpc[4 * K + k] = (a21 * r01 + a22 * r11 + a23 * r21) * scale;
    jpc[5 * K + k] = (a21 * r02 + a22 * r12 + a23 * r22) * scale;

    int n = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = i; j < 8; ++j, ++n) part[n] += j0[i] * j0[j] + j1[i] * j1[j];
#pragma unroll
    for (int i = 0; i < 8; ++i) part[kSym8 + i] += j0[i] * rw0 + j1[i] * rw1;
  }

  block_sums<T, kSym8 + 8>(part, red, tot);
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
// One block per camera row: per lane W = jc^T jp (8x3), T = W V^-1, and the
// 36 upper-triangle partials of T W^T, all in registers.
template <typename T>
__global__ void __launch_bounds__(kBlock)
coupling_kernel(const T* __restrict__ jc, const T* __restrict__ jp,
                const T* __restrict__ vinv6, T* __restrict__ out, int K) {
  __shared__ T red[kWarps * kSym8];
  __shared__ T tot[kSym8];
  const int cam = blockIdx.x;
  const size_t row = (size_t)cam * K;
  const T* jcc = jc + 16 * row;
  const T* jpc = jp + 6 * row;
  const T* vc = vinv6 + 6 * row;

  T part[kSym8];
#pragma unroll
  for (int n = 0; n < kSym8; ++n) part[n] = T(0);

  for (int k = threadIdx.x; k < K; k += kBlock) {
    T p0[3], p1[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p0[j] = jpc[j * K + k];
      p1[j] = jpc[(3 + j) * K + k];
    }
    const T v00 = vc[k], v01 = vc[K + k], v02 = vc[2 * K + k];
    const T v11 = vc[3 * K + k], v12 = vc[4 * K + k], v22 = vc[5 * K + k];
    const T vr[3][3] = {{v00, v01, v02}, {v01, v11, v12}, {v02, v12, v22}};
    T w[8][3], tm[8][3];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const T c0 = jcc[i * K + k], c1 = jcc[(8 + i) * K + k];
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

  block_sums<T, kSym8>(part, red, tot);
  store_sym8(tot, out + (size_t)cam * 64);
}

// ---------------------------------------------------------------- host --
#define GRID_DISPATCH(DTYPE, CALL)             \
  do {                                         \
    if ((DTYPE) == 0) { using T = float; return CALL; }  \
    if ((DTYPE) == 1) { using T = double; return CALL; } \
    return kErrDtype;                          \
  } while (0)

template <typename T>
int cam_normal_launch(const void* params, const void* xw, const void* uv,
                      const void* mask, void* r, void* jp, void* jc, void* u,
                      void* g, int C, int K, int loss, cudaStream_t stream) {
  cam_normal_kernel<T><<<C, kBlock, 0, stream>>>(
      (const T*)params, (const T*)xw, (const T*)uv, (const T*)mask, (T*)r,
      (T*)jp, (T*)jc, (T*)u, (T*)g, K, loss);
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

template <typename T>
int coupling_launch(const void* jc, const void* jp, const void* vinv6,
                    void* out, int C, int K, cudaStream_t stream) {
  coupling_kernel<T><<<C, kBlock, 0, stream>>>(
      (const T*)jc, (const T*)jp, (const T*)vinv6, (T*)out, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int grid_cam_normal(int dtype, const void* params, const void* xw, const void* uv,
                    const void* mask, void* r, void* jp, void* jc, void* u,
                    void* g, int C, int K, int loss, void* stream) {
  if (C == 0) return 0;
  GRID_DISPATCH(dtype, (cam_normal_launch<T>(params, xw, uv, mask, r, jp, jc,
                                             u, g, C, K, loss,
                                             (cudaStream_t)stream)));
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

int grid_coupling(int dtype, const void* jc, const void* jp,
                  const void* vinv6, void* out, int C, int K, void* stream) {
  if (C == 0) return 0;
  GRID_DISPATCH(dtype, (coupling_launch<T>(jc, jp, vinv6, out, C, K,
                                           (cudaStream_t)stream)));
}

}  // extern "C"
