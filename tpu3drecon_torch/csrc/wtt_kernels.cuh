// Kernels B1 (wtt_linearize) and B2 (wtt_coupling) as templates over the
// number of bfloat16 split terms of the TPU kernels' reduced-fidelity modes
// (TERMS, slot.cuh split_round): wtt_kernels.cu instantiates the exact
// kernels (TERMS = 3, float and double), wtt_terms_kernels.cu the float
// kernels at TERMS = 1 and 2 in an object of their own, so the two sources
// compile in parallel.  The design notes are in wtt_kernels.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "slot.cuh"

// The kernels live in the including source's anonymous namespace (a second
// one nested in tpu3drecon would give nvcc's launch stubs two namespaces of
// the same name), so each source keeps its own instantiations.
namespace {

using namespace tpu3drecon;

// ---------------------------------------------------------------- B1 ----
// With OD (want_od) the rows gain np^2 band pair columns after the rhs:
// od[i * np + j] of window row w sums wv(slot t-1)[i] w(slot t)[j] over the
// adjacent track slots on rows w and w + 1 (the pair one-hot of
// wtt_linearize.py:515-538).  Each thread keeps its previous slot's W V^-1
// factor and row in registers; the pair rows go through the same
// warp-aggregated atomics as the other columns.
//
// TERMS < 3 (float only) is the TPU kernel's reduced-fidelity linearization
// (linearize_kernel "index2", wtt_linearize.py:502-531): the u | g |
// coupling and od column values pass split_round<TERMS> before their
// reduction; the camera rows, the Jacobian planes, the point normal and the
// rhs columns stay exact.
template <typename T, int NP, bool OD, int TERMS>
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
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  const T* tw_g = tw + (size_t)g * W * kD;
  T* rows_g = rows + (size_t)g * W * K;  // (W, K)

  const T lam = *lam_p, inv_w = *invw_p;
  const size_t GP = (size_t)G * Pc;
  const size_t GTP = GP * Tb;
  const T X = live ? pts[0 * GP + (size_t)g * Pc + p] : T(0);
  const T Y = live ? pts[1 * GP + (size_t)g * Pc + p] : T(0);
  const T Z = live ? pts[2 * GP + (size_t)g * Pc + p] : T(0);

  auto slot = [&](int t, int& w, Slot<T, NP>& o) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;  // (G, Tb, Pc) offset
    w = live ? int(wcam[((size_t)g * Tb + t) * Pc + p]) : -1;
    T buf[kD];
    const T* cp = cam_row(tw_g, w, buf);
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
    const int col = add_contribs<T, NP, TERMS>(rows_g, wr, self, lead, j0, j1, o.jp, o.r0,
                                        o.r1, vi, f.use_sj, wl, wv);
    const T s0r = o.jp[0] * vw0 + o.jp[1] * vw1 + o.jp[2] * vw2;
    const T s1r = o.jp[3] * vw0 + o.jp[4] * vw1 + o.jp[5] * vw2;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      row_add(rows_g, wr, self + col + i, lead + col + i, j0[i] * s0r + j1[i] * s1r);
    }
    if constexpr (OD) {
      add_pair_rows<T, NP, TERMS>(rows_g, K, col + NP, w_prev, w, wv_prev, wl);
#pragma unroll
      for (int l = 0; l < 3; ++l)
#pragma unroll
        for (int i = 0; i < NP; ++i) wv_prev[l][i] = wv[l][i];
      w_prev = w;
    }
  }
}

// ---------------------------------------------------------------- B2/B3 --
// Phase 1 of the coupling product: (W^T x) of this thread's point over its
// track, x read from the group's window rows xw_g (NP, W) in device memory
// (through split_round<TERMS>).
template <typename T, int NP, int TERMS = 3>
__device__ __forceinline__ void wt_x(const T* xw_g, const int16_t* wcam, const T* jc,
                                     const T* jp, int g, int p, bool live, int G,
                                     int Tb, int Pc, int W, T wtx[3]) {
  const size_t GTP = (size_t)G * Tb * Pc;
  wtx[0] = wtx[1] = wtx[2] = T(0);
  if (!live) return;
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    wt_slot<T, NP, true, TERMS>(nullptr, xw_g, int(wcam[ts]), W, jc, jp, ts, GTP, wtx);
  }
}

// TERMS < 3 (float only) is the TPU kernel's reduced-fidelity CG operator
// (matvec_kernel "index1" / "index2", wtt_matvec.py:215): each window-row
// value of x that a slot reads and each z value it reduces pass
// split_round<TERMS>.
template <typename T, int NP, int TERMS>
__global__ void __launch_bounds__(kBlock)
coupling_kernel(const T* __restrict__ xw_t, const int16_t* __restrict__ wcam,
                const T* __restrict__ jc, const T* __restrict__ jp,
                const T* __restrict__ vinv, T* __restrict__ out, int G, int Tb,
                int Pc, int W) {
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  const T* xw_g = xw_t + (size_t)g * NP * W;
  T* out_g = out + (size_t)g * NP * W;  // (NP, W)

  T wtx[3];
  wt_x<T, NP, TERMS>(xw_g, wcam, jc, jp, g, p, live, G, Tb, Pc, W, wtx);
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
    w_slot<T, NP, TERMS>(out_g, live ? int(wcam[ts]) : -1, W, jc, jp, ts, GTP, y0, y1, y2);
  }
}

// ---------------------------------------------------------------- host --
template <typename T, int NP, bool OD, int TERMS>
int lin_launch(const void* wcam, const void* tw, const void* pts, const void* uv,
               const void* mask, const void* lam, const void* inv_w, void* rows,
               void* jc, void* jp, void* vinv, void* gpt, void* damp, int G,
               int Tb, int Pc, int W, LinFlags f, cudaStream_t stream) {
  lin_kernel<T, NP, OD, TERMS><<<grid_of(Pc, G), kBlock, 0, stream>>>(
      (const int16_t*)wcam, (const T*)tw, (const T*)pts, (const T*)uv,
      (const T*)mask, (const T*)lam, (const T*)inv_w, (T*)rows, (T*)jc,
      (T*)jp, (T*)vinv, (T*)gpt, (T*)damp, G, Tb, Pc, W, f);
  return (int)cudaGetLastError();
}

template <typename T, int NP, int TERMS>
int coupling_launch(const void* xw_t, const void* wcam, const void* jc,
                    const void* jp, const void* vinv, void* out, int G, int Tb,
                    int Pc, int W, cudaStream_t stream) {
  coupling_kernel<T, NP, TERMS><<<grid_of(Pc, G), kBlock, 0, stream>>>(
      (const T*)xw_t, (const int16_t*)wcam, (const T*)jc, (const T*)jp,
      (const T*)vinv, (T*)out, G, Tb, Pc, W);
  return (int)cudaGetLastError();
}

}  // namespace

namespace tpu3drecon {

// C entries of the reduced-fidelity float kernels (wtt_terms_kernels.cu),
// called by wtt_linearize (terms 2) and wtt_coupling (terms 1, 2) of
// wtt_kernels.cu.
int wtt_linearize_reduced(int np, int terms, const void* wcam, const void* tw,
                          const void* pts, const void* uv, const void* mask,
                          const void* lam, const void* inv_w, void* rows, void* jc,
                          void* jp, void* vinv, void* gpt, void* damp, int G, int Tb,
                          int Pc, int W, int want_od, LinFlags f, cudaStream_t stream);
int wtt_coupling_reduced(int np, int terms, const void* xw_t, const void* wcam,
                         const void* jc, const void* jp, const void* vinv, void* out,
                         int G, int Tb, int Pc, int W, cudaStream_t stream);

}  // namespace tpu3drecon
