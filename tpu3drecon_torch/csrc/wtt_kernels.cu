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
// Design (the same for all four).  One thread owns one point column (g, p)
// of a bucket: its whole track (the Tb slots) lives in that thread, so the
// per-point quantities (V^-1, g_pt, W^T x, the cost column) never leave
// registers.  The grid is (ceil(Pc / 256), G): on the medium problem every
// bucket has G = 1, so all parallelism comes from the point-column axis.
// The TPU kernels rebuild one-hot tiles from wcam and select camera rows
// with bf16-split MXU dots because row gathers are slow there; here a
// thread reads its slot's window row directly (wcam is int16, -1 =
// padding), from a copy of the group's window staged in shared memory with
// one extra all-zero row that padding slots point at — so a padded slot
// sees the all-zero camera row exactly as the TPU's empty one-hot column
// gives it, and never reads row -1.
//
// Reductions into window-camera rows (linearize rows, coupling rows) cross
// threads: each block accumulates into a shared-memory (W, K) tile with
// atomics and flushes its nonzero entries to the global rows (zeroed by the
// wrapper) with one global atomicAdd each.  When all live lanes of a warp
// address the same window row — the common case for a point's first slot,
// since points are sorted by their minimum camera — the warp reduces the
// value with shuffles and issues one atomic instead of 32 conflicting ones.
//
// What bounds them on the H100: the linearize and coupling kernels are
// bound by shared-memory atomics (K = 88 columns per slot for the
// linearize), the back-substitution and cost kernels by the bytes of
// jc/jp (resp. uv/mask) they stream.  Atomic reduction order varies from
// run to run, so f32 row sums vary in the last bits.
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
// memory, so no launch needs a host sync.  The slot formulas, the staged
// window with its zero row, the contribution columns, the two halves of the
// coupling product and the warp-aggregated row reduction live in slot.cuh,
// shared with the route kernels (wtt_route_kernels.cu) and the dense
// track-table kernels (tt_kernels.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "slot.cuh"

using namespace tpu3drecon;

namespace {

// ---------------------------------------------------------------- B1 ----
// With OD (want_od) the rows gain np^2 band pair columns after the rhs:
// od[i * np + j] of window row w sums wv(slot t-1)[i] w(slot t)[j] over the
// adjacent track slots on rows w and w + 1 (the pair one-hot of
// wtt_linearize.py:515-538).  Each thread keeps its previous slot's W V^-1
// factor and row in registers; the pair rows go through the same
// warp-aggregated shared-memory atomics as the other columns.
template <typename T, int NP, bool OD>
__global__ void __launch_bounds__(kBlock)
lin_kernel(const int16_t* __restrict__ wcam, const T* __restrict__ tw,
           const T* __restrict__ pts, const T* __restrict__ uv,
           const T* __restrict__ mask, const T* __restrict__ lam_p,
           const T* __restrict__ invw_p, T* __restrict__ rows,
           T* __restrict__ jc_out, T* __restrict__ jp_out,
           T* __restrict__ vinv_out, T* __restrict__ gpt_out,
           T* __restrict__ damp_out, int G, int Tb, int Pc, int W,
           LinFlags f) {
  constexpr int NT = NP * (NP + 1) / 2;
  const int K = NT + NP + (f.use_sj ? NT : 0) + NP + (OD ? NP * NP : 0);
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tw = reinterpret_cast<T*>(smem);  // (W + 1, 19)
  T* s_acc = s_tw + (W + 1) * kD;        // (W, K)
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  stage_window(tw + (size_t)g * W * kD, s_tw, W);
  for (int i = threadIdx.x; i < W * K; i += kBlock) s_acc[i] = T(0);
  __syncthreads();

  const T lam = *lam_p, inv_w = *invw_p;
  const size_t GP = (size_t)G * Pc;
  const size_t GTP = GP * Tb;
  const T X = live ? pts[0 * GP + (size_t)g * Pc + p] : T(0);
  const T Y = live ? pts[1 * GP + (size_t)g * Pc + p] : T(0);
  const T Z = live ? pts[2 * GP + (size_t)g * Pc + p] : T(0);

  auto slot = [&](int t, int& w, Slot<T, NP>& o) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;  // (G, Tb, Pc) offset
    w = live ? int(wcam[((size_t)g * Tb + t) * Pc + p]) : -1;
    const T* cp = s_tw + (w >= 0 ? w : W) * kD;
    const T u_obs = live ? uv[(((size_t)g * 2 + 0) * Tb + t) * Pc + p] : T(0);
    const T v_obs = live ? uv[(((size_t)g * 2 + 1) * Tb + t) * Pc + p] : T(0);
    const T m = live ? mask[ts] : T(0);
    tt_blocks<T, NP>(cp, X, Y, Z, u_obs, v_obs, m, inv_w, f, o);
    return ts;
  };

  // Pass 1: Jacobian planes out, point normal accumulated over the track.
  T v6[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  T gp[3] = {T(0), T(0), T(0)};
  for (int t = 0; t < Tb; ++t) {
    int w;
    Slot<T, NP> o;
    const size_t ts = slot(t, w, o);
    if (live) {
#pragma unroll
      for (int k = 0; k < 2 * NP; ++k) jc_out[k * GTP + ts] = o.jc[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) jp_out[k * GTP + ts] = o.jp[k];
    }
    const T* q = o.jp;
    v6[0] += q[0] * q[0] + q[3] * q[3];
    v6[1] += q[0] * q[1] + q[3] * q[4];
    v6[2] += q[0] * q[2] + q[3] * q[5];
    v6[3] += q[1] * q[1] + q[4] * q[4];
    v6[4] += q[1] * q[2] + q[4] * q[5];
    v6[5] += q[2] * q[2] + q[5] * q[5];
#pragma unroll
    for (int i = 0; i < 3; ++i) gp[i] += q[i] * o.r0 + q[3 + i] * o.r1;
  }
  // Damped V and its closed-form inverse (ba_tt._sym3_inv_planes).
  const T d0 = lam * (v6[0] > T(1e-8) ? v6[0] : T(1e-8));
  const T d1 = lam * (v6[3] > T(1e-8) ? v6[3] : T(1e-8));
  const T d2 = lam * (v6[5] > T(1e-8) ? v6[5] : T(1e-8));
  const T a = v6[0] + d0, b = v6[1], c = v6[2], d = v6[3] + d1, e = v6[4];
  const T ff = v6[5] + d2;
  const T co_a = d * ff - e * e, co_b = c * e - b * ff, co_c = b * e - c * d;
  const T det = a * co_a + b * co_b + c * co_c;
  const T inv_det = T(1) / (fabs(det) < T(1e-32) ? T(1) : det);
  T vi[6] = {co_a * inv_det, co_b * inv_det, co_c * inv_det,
             (a * ff - c * c) * inv_det, (b * c - a * e) * inv_det,
             (a * d - b * b) * inv_det};
  if (live) {
    const size_t pp = (size_t)g * Pc + p;
#pragma unroll
    for (int k = 0; k < 6; ++k) vinv_out[k * GP + pp] = vi[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) gpt_out[k * GP + pp] = gp[k];
    damp_out[0 * GP + pp] = d0;
    damp_out[1 * GP + pp] = d1;
    damp_out[2 * GP + pp] = d2;
  }
  // rhs factor vw = V^-1 g_pt.
  const T vw0 = vi[0] * gp[0] + vi[1] * gp[1] + vi[2] * gp[2];
  const T vw1 = vi[1] * gp[0] + vi[3] * gp[1] + vi[4] * gp[2];
  const T vw2 = vi[2] * gp[0] + vi[4] * gp[1] + vi[5] * gp[2];

  // Pass 2: contribution columns u | g [| coupling] | rhs [| od] into window
  // rows.
  T wv_prev[3][NP];
  int w_prev = -1;
  for (int t = 0; t < Tb; ++t) {
    int w;
    Slot<T, NP> o;
    slot(t, w, o);
    const WarpRow wr = warp_row(w);
    if (!wr.any) {  // warp-uniform
      w_prev = -1;
      continue;
    }
    const int self = (w >= 0 ? w : 0) * K;
    const int lead = wr.w0 * K;
    const T* j0 = o.jc;
    const T* j1 = o.jc + NP;
    T wl[3][NP], wv[3][NP];
    const int col = add_contribs<T, NP>(s_acc, wr, self, lead, j0, j1, o.jp, o.r0,
                                        o.r1, vi, f.use_sj, wl, wv);
    const T s0r = o.jp[0] * vw0 + o.jp[1] * vw1 + o.jp[2] * vw2;
    const T s1r = o.jp[3] * vw0 + o.jp[4] * vw1 + o.jp[5] * vw2;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      row_add(s_acc, wr, self + col + i, lead + col + i, j0[i] * s0r + j1[i] * s1r);
    }
    if constexpr (OD) {
      add_pair_rows<T, NP>(s_acc, K, col + NP, w_prev, w, wv_prev, wl);
#pragma unroll
      for (int l = 0; l < 3; ++l)
#pragma unroll
        for (int i = 0; i < NP; ++i) wv_prev[l][i] = wv[l][i];
      w_prev = w;
    }
  }
  __syncthreads();
  flush(s_acc, rows + (size_t)g * W * K, W * K);
}

// ---------------------------------------------------------------- B2/B3 --
// Phase 1 of the coupling product: (W^T x) of this thread's point over its
// track, x read from the group's window rows staged as (NP, W + 1) with a
// zero column W for padding slots.
template <typename T, int NP>
__device__ __forceinline__ void wt_x(const T* s_xw, const int16_t* wcam,
                                     const T* jc, const T* jp, int g, int p,
                                     bool live, int G, int Tb, int Pc, int W,
                                     T wtx[3]) {
  const size_t GTP = (size_t)G * Tb * Pc;
  wtx[0] = wtx[1] = wtx[2] = T(0);
  if (!live) return;
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    const int w = wcam[ts];
    wt_slot<T, NP>(s_xw, w >= 0 ? w : W, W, jc, jp, ts, GTP, wtx);
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(kBlock)
coupling_kernel(const T* __restrict__ xw_t, const int16_t* __restrict__ wcam,
                const T* __restrict__ jc, const T* __restrict__ jp,
                const T* __restrict__ vinv, T* __restrict__ out, int G, int Tb,
                int Pc, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_xw = reinterpret_cast<T*>(smem);  // (NP, W + 1)
  T* s_acc = s_xw + NP * (W + 1);        // (NP, W)
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  stage_xw<T, NP>(xw_t + (size_t)g * NP * W, s_xw, W);
  for (int i = threadIdx.x; i < NP * W; i += kBlock) s_acc[i] = T(0);
  __syncthreads();

  T wtx[3];
  wt_x<T, NP>(s_xw, wcam, jc, jp, g, p, live, G, Tb, Pc, W, wtx);
  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;
  T v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = live ? vinv[k * GP + (size_t)g * Pc + p] : T(0);
  const T y0 = v[0] * wtx[0] + v[1] * wtx[1] + v[2] * wtx[2];
  const T y1 = v[1] * wtx[0] + v[3] * wtx[1] + v[4] * wtx[2];
  const T y2 = v[2] * wtx[0] + v[4] * wtx[1] + v[5] * wtx[2];

  // Phase 2: z = jc (jp y) reduced into the (NP, W) window rows.
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    w_slot<T, NP>(s_acc, live ? int(wcam[ts]) : -1, W, jc, jp, ts, GTP, y0, y1, y2);
  }
  __syncthreads();
  flush(s_acc, out + (size_t)g * NP * W, NP * W);
}

template <typename T, int NP>
__global__ void __launch_bounds__(kBlock)
wt_planes_kernel(const T* __restrict__ xw_t, const int16_t* __restrict__ wcam,
                 const T* __restrict__ jc, const T* __restrict__ jp,
                 T* __restrict__ out, int G, int Tb, int Pc, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_xw = reinterpret_cast<T*>(smem);  // (NP, W + 1)
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  stage_xw<T, NP>(xw_t + (size_t)g * NP * W, s_xw, W);
  __syncthreads();
  T wtx[3];
  wt_x<T, NP>(s_xw, wcam, jc, jp, g, p, live, G, Tb, Pc, W, wtx);
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
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tw = reinterpret_cast<T*>(smem);  // (W + 1, 19)
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  stage_window(tw + (size_t)g * W * kD, s_tw, W);
  __syncthreads();
  if (p >= Pc) return;
  const size_t GP = (size_t)G * Pc;
  const T px = pts[0 * GP + (size_t)g * Pc + p];
  const T py = pts[1 * GP + (size_t)g * Pc + p];
  const T pz = pts[2 * GP + (size_t)g * Pc + p];
  T total = T(0);
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    const int w = wcam[ts];
    const T* cp = s_tw + (w >= 0 ? w : W) * kD;
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
template <typename T, int NP, bool OD>
int lin_launch(const void* wcam, const void* tw, const void* pts, const void* uv,
               const void* mask, const void* lam, const void* inv_w, void* rows,
               void* jc, void* jp, void* vinv, void* gpt, void* damp, int G,
               int Tb, int Pc, int W, LinFlags f, cudaStream_t stream) {
  constexpr int NT = NP * (NP + 1) / 2;
  const int K = NT + NP + (f.use_sj ? NT : 0) + NP + (OD ? NP * NP : 0);
  const size_t smem = sizeof(T) * ((size_t)(W + 1) * kD + (size_t)W * K);
  const int err = prepare(lin_kernel<T, NP, OD>, smem);
  if (err) return err;
  lin_kernel<T, NP, OD><<<grid_of(Pc, G), kBlock, smem, stream>>>(
      (const int16_t*)wcam, (const T*)tw, (const T*)pts, (const T*)uv,
      (const T*)mask, (const T*)lam, (const T*)inv_w, (T*)rows, (T*)jc,
      (T*)jp, (T*)vinv, (T*)gpt, (T*)damp, G, Tb, Pc, W, f);
  return (int)cudaGetLastError();
}

template <typename T, int NP>
int coupling_launch(const void* xw_t, const void* wcam, const void* jc,
                    const void* jp, const void* vinv, void* out, int G, int Tb,
                    int Pc, int W, cudaStream_t stream) {
  const size_t smem = sizeof(T) * ((size_t)NP * (W + 1) + (size_t)NP * W);
  const int err = prepare(coupling_kernel<T, NP>, smem);
  if (err) return err;
  coupling_kernel<T, NP><<<grid_of(Pc, G), kBlock, smem, stream>>>(
      (const T*)xw_t, (const int16_t*)wcam, (const T*)jc, (const T*)jp,
      (const T*)vinv, (T*)out, G, Tb, Pc, W);
  return (int)cudaGetLastError();
}

template <typename T, int NP>
int wt_launch(const void* xw_t, const void* wcam, const void* jc, const void* jp,
              void* out, int G, int Tb, int Pc, int W, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)NP * (W + 1);
  const int err = prepare(wt_planes_kernel<T, NP>, smem);
  if (err) return err;
  wt_planes_kernel<T, NP><<<grid_of(Pc, G), kBlock, smem, stream>>>(
      (const T*)xw_t, (const int16_t*)wcam, (const T*)jc, (const T*)jp, (T*)out,
      G, Tb, Pc, W);
  return (int)cudaGetLastError();
}

template <typename T>
int cost_launch(const void* wcam, const void* tw, const void* pts, const void* uv,
                const void* mask, void* out, int G, int Tb, int Pc, int W,
                int loss, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)(W + 1) * kD;
  const int err = prepare(cost_kernel<T>, smem);
  if (err) return err;
  cost_kernel<T><<<grid_of(Pc, G), kBlock, smem, stream>>>(
      (const int16_t*)wcam, (const T*)tw, (const T*)pts, (const T*)uv,
      (const T*)mask, (T*)out, G, Tb, Pc, W, loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wtt_linearize(int dtype, int np, const void* wcam, const void* tw,
                  const void* pts, const void* uv, const void* mask,
                  const void* lam, const void* inv_w, void* rows, void* jc,
                  void* jp, void* vinv, void* gpt, void* damp, int G, int Tb,
                  int Pc, int W, int use_sj, int want_od, int loss, int focal,
                  int points, int dist, int pp, void* stream) {
  if (want_od && !use_sj) return kErrOd;
  if (G == 0 || Pc == 0) return 0;
  const LinFlags f{use_sj, loss, focal, points, dist, pp};
  NP_DISPATCH(dtype, np,
               (want_od ? lin_launch<T, NP, true>(wcam, tw, pts, uv, mask, lam,
                                                  inv_w, rows, jc, jp, vinv, gpt,
                                                  damp, G, Tb, Pc, W, f,
                                                  (cudaStream_t)stream)
                        : lin_launch<T, NP, false>(wcam, tw, pts, uv, mask, lam,
                                                   inv_w, rows, jc, jp, vinv, gpt,
                                                   damp, G, Tb, Pc, W, f,
                                                   (cudaStream_t)stream)));
}

int wtt_coupling(int dtype, int np, const void* xw_t, const void* wcam,
                 const void* jc, const void* jp, const void* vinv, void* out,
                 int G, int Tb, int Pc, int W, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  NP_DISPATCH(dtype, np,
               (coupling_launch<T, NP>(xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc,
                                       W, (cudaStream_t)stream)));
}

int wtt_wt_planes(int dtype, int np, const void* xw_t, const void* wcam,
                  const void* jc, const void* jp, void* out, int G, int Tb,
                  int Pc, int W, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  NP_DISPATCH(dtype, np,
               (wt_launch<T, NP>(xw_t, wcam, jc, jp, out, G, Tb, Pc, W,
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
    return cost_launch<double>(wcam, tw, pts, uv, mask, out, G, Tb, Pc, W,
                               loss, (cudaStream_t)stream);
  return kErrDtype;
}

}  // extern "C"
