// Kernels B1 (wtt_linearize) and B2 (wtt_coupling) as templates over the
// number of bfloat16 split terms of the TPU kernels' reduced-fidelity modes
// (TERMS, slot.cuh split_round): wtt_kernels.cu instantiates the exact
// kernels (TERMS = 3, float and double), wtt_terms_kernels.cu the float
// kernels at TERMS = 1 and 2 in an object of their own, so the two sources
// compile in parallel.  B2's kernel is also a template over where a slot's
// window row comes from: wcam (B2) or the dense one-hot (B6, instantiated
// at TERMS = 3 in wtt_route_kernels.cu).  B3 (wtt_kernels.cu) runs on B2's
// grid and thread limit (kCouplingThreads).
//
// Slot-major design of B1, B2 and B6.  A warp holds one track slot t of 32
// consecutive point columns, one lane per slot; a block holds `ng` such
// 32-point groups as `tc` warps each (warp ti of a group holds slot
// c * tc + ti in chunk c), so a bucket runs on Tb * Pc threads, not Pc.
// A track longer than tc slots is cut into ceil(Tb / tc) chunks that the
// block walks in order.  The wrapper computes tc, ng and the shared bytes
// (ops/_wtt_common.py slot_geometry) and the C entries check them against
// *_smem below.
//
// Per-point sums (B2: W^T x; B1: V and g_pt) cross warps through shared
// memory: each lane writes its slot's part, and lane p of the group's warp
// 0 adds the Tb parts in slot order t = 0 .. Tb - 1, exactly the order of
// the one-thread-per-point loop they replace, so under --fmad=false V^-1,
// g_pt, damp and y keep their last bits against the plain versions (V^-1
// of a point seen once is conditioned ~1/lam and would amplify any other
// order).  That lane computes the point's V^-1 and y = V^-1 W^T x (B2) or
// the rhs factor V^-1 g_pt (B1) once and shares them back.
//
// Each slot stays in registers from phase 1 to phase 2: B2 reads its jc/jp
// once, B1 calls tt_blocks once.  A track of several chunks keeps only its
// last chunk there; phase 2 re-reads (B2) or recomputes (B1) the slots of
// the earlier chunks (tracks longer than the largest tc: 16 slots for B2
// and for B1 in float, 8 for B1 in double).  Window-row reductions go through the
// warp's shared row tile (slot.cuh tile_put): every lane of a warp issues
// atomics at once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "slot.cuh"

// The kernels live in the including source's anonymous namespace (a second
// one nested in tpu3drecon would give nvcc's launch stubs two namespaces of
// the same name), so each source keeps its own instantiations.
namespace {

using namespace tpu3drecon;

// Threads per block at most (the wrapper's geometry keeps to them; they
// bound the registers per thread): B1 holds a slot's Jacobians and its W,
// W V^-1 factors, B2 (and B3) a slot's jc/jp.
template <typename T>
constexpr int lin_threads() { return sizeof(T) == 4 ? 512 : 256; }
constexpr int kCouplingThreads = 512;

// ---------------------------------------------------------------- B1 ----
// Shared memory of B1 (elements): the (ng, tc, 9, 32) per-slot V | g_pt
// parts, aliased by the warps' (32, kTile + 1) row tiles; the (ng, 9, 32)
// V^-1 | V^-1 g_pt of each point; with OD the (ng, tc + 1, 3 np, 32)
// W V^-1 factors and (ng, tc + 1, 32) window rows of the slots (index 0:
// the slot before the chunk); the warps' (3, 32) tile meta.
template <typename T, int NP, bool OD>
constexpr size_t lin_smem(int tc, int ng) {
  const size_t nw = size_t(tc) * ng;
  const size_t parts = nw * 9 * 32, tiles = nw * 32 * (kTile + 1);
  const size_t vals = (parts > tiles ? parts : tiles) + size_t(ng) * 9 * 32 +
                      (OD ? size_t(ng) * (tc + 1) * 3 * NP * 32 : 0);
  const size_t ints = (OD ? size_t(ng) * (tc + 1) * 32 : 0) + nw * 96;
  return vals * sizeof(T) + ints * sizeof(int);
}

// B1 <- wtt_linearize.py:wtt_linearize_fused_idx.  Pass 1: each lane forms
// its slot's residual and Jacobian planes (tt_blocks), writes jc/jp, and
// its V | g_pt parts go to the point's summing lane.  Pass 2: each lane
// puts its slot's columns u | g [| coupling (SJ)] | rhs into the row tile
// of its window row.  With OD (want_od) the np^2 band pair columns follow:
// od[i * np + j] of window row w sums wv(slot t-1)[i] w(slot t)[j] over the
// adjacent track slots on rows w and w + 1 (wtt_linearize.py:515-538); slot
// t reads slot t-1's W V^-1 factor from the shared copy that warp t-1 wrote
// (the slot before a chunk: from jc/jp, which pass 1 wrote).  The u | g |
// coupling columns are B8's (slot.cuh put_ug, put_coupling); B8
// (wtt_route_kernels.cu) keeps a copy of the od step.
//
// TERMS < 3 (float only) is the TPU kernel's reduced-fidelity linearization
// (linearize_kernel "index2", wtt_linearize.py:502-531): the u | g |
// coupling and od column values pass split_round<TERMS> before their
// reduction; the camera rows, the Jacobian planes, the point normal and the
// rhs columns stay exact.
template <typename T, int NP, bool SJ, bool OD, int TERMS>
__global__ void __launch_bounds__(sizeof(T) == 4 ? 512 : 256)  // lin_threads<T>()
lin_kernel(const int16_t* __restrict__ wcam, const T* __restrict__ tw,
           const T* __restrict__ pts, const T* __restrict__ uv,
           const T* __restrict__ mask, const T* __restrict__ lam_p,
           const T* __restrict__ invw_p, T* __restrict__ rows,
           T* __restrict__ jc_out, T* __restrict__ jp_out,
           T* __restrict__ vinv_out, T* __restrict__ gpt_out,
           T* __restrict__ damp_out, int G, int Tb, int Pc, int W,
           LinFlags f, int tc, int ng) {
  constexpr int NT = NP * (NP + 1) / 2;
  constexpr int K0 = NT + NP + (SJ ? NT : 0) + NP;  // u | g [| coupling] | rhs
  constexpr int K = K0 + (OD ? NP * NP : 0);
  extern __shared__ __align__(16) unsigned char smem[];
  const SlotLane sl = slot_lane(tc, ng, Tb, Pc);
  const int lane = sl.lane, gi = sl.gi, ti = sl.ti, p = sl.p;
  const int nw = tc * ng;
  T* s_a = reinterpret_cast<T*>(smem);  // parts, then row tiles
  const size_t n_a = size_t(nw) * 32 * (kTile + 1);
  T* s_pt = s_a + n_a;                  // (ng, 9, 32)
  T* s_wv = s_pt + ng * 9 * 32;         // OD: (ng, tc + 1, 3 NP, 32)
  int* s_w = reinterpret_cast<int*>(s_wv + (OD ? ng * (tc + 1) * 3 * NP * 32 : 0));
  int* s_meta = s_w + (OD ? ng * (tc + 1) * 32 : 0);

  const int g = sl.g;
  const T* tw_g = tw + (size_t)g * W * kD;
  const T lam = *lam_p, inv_w = *invw_p;
  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;
  const T X = sl.live ? pts[0 * GP + (size_t)g * Pc + p] : T(0);
  const T Y = sl.live ? pts[1 * GP + (size_t)g * Pc + p] : T(0);
  const T Z = sl.live ? pts[2 * GP + (size_t)g * Pc + p] : T(0);

  // Slot t of this lane's point: window row w (-1 = padding or past the
  // track) and its planes o (all zero past the track).
  Slot<T, NP> o;
  int w;
  auto compute = [&](int t) {
    const bool real = sl.live && t < Tb;
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    w = real ? int(wcam[ts]) : -1;
    T buf[kD];
    const T* cp = cam_row(tw_g, w, buf);
    const T u_obs = real ? uv[(((size_t)g * 2 + 0) * Tb + t) * Pc + p] : T(0);
    const T v_obs = real ? uv[(((size_t)g * 2 + 1) * Tb + t) * Pc + p] : T(0);
    const T m = real ? mask[ts] : T(0);
    tt_blocks<T, NP>(cp, X, Y, Z, u_obs, v_obs, m, inv_w, f, o);
  };

  // Pass 1: Jacobian planes out, V | g_pt parts summed in slot order.
  T acc[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  T* part = s_a + (size_t)(gi * tc + ti) * 9 * 32 + lane;
  for (int c = 0; c < sl.nchunk; ++c) {
    const int t = c * tc + ti;
    compute(t);
    if (sl.live && t < Tb) {
      const size_t ts = ((size_t)g * Tb + t) * Pc + p;
#pragma unroll
      for (int k = 0; k < 2 * NP; ++k) jc_out[k * GTP + ts] = o.jc[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) jp_out[k * GTP + ts] = o.jp[k];
    }
    put_point_parts(part, o);
    __syncthreads();
    add_parts(acc, s_a, sl, tc, Tb, c);
    __syncthreads();
  }
  T* pt = s_pt + gi * 9 * 32 + lane;
  if (ti == 0) {
    // Damped V and its closed-form inverse (ba_tt._sym3_inv_planes).
    const T* v6 = acc;
    const T d0 = lam * (v6[0] > T(1e-8) ? v6[0] : T(1e-8));
    const T d1 = lam * (v6[3] > T(1e-8) ? v6[3] : T(1e-8));
    const T d2 = lam * (v6[5] > T(1e-8) ? v6[5] : T(1e-8));
    const T a = v6[0] + d0, b = v6[1], cc = v6[2], d = v6[3] + d1, e = v6[4];
    const T ff = v6[5] + d2;
    const T co_a = d * ff - e * e, co_b = cc * e - b * ff, co_c = b * e - cc * d;
    const T det = a * co_a + b * co_b + cc * co_c;
    const T inv_det = T(1) / (fabs(det) < T(1e-32) ? T(1) : det);
    const T vi[6] = {co_a * inv_det, co_b * inv_det, co_c * inv_det,
                     (a * ff - cc * cc) * inv_det, (b * cc - a * e) * inv_det,
                     (a * d - b * b) * inv_det};
    const T* gp = acc + 6;
    if (sl.live) {
      const size_t pp = (size_t)g * Pc + p;
#pragma unroll
      for (int k = 0; k < 6; ++k) vinv_out[k * GP + pp] = vi[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) gpt_out[k * GP + pp] = gp[k];
      damp_out[0 * GP + pp] = d0;
      damp_out[1 * GP + pp] = d1;
      damp_out[2 * GP + pp] = d2;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) pt[k * 32] = vi[k];
    // rhs factor vw = V^-1 g_pt.
    pt[6 * 32] = vi[0] * gp[0] + vi[1] * gp[1] + vi[2] * gp[2];
    pt[7 * 32] = vi[1] * gp[0] + vi[3] * gp[1] + vi[4] * gp[2];
    pt[8 * 32] = vi[2] * gp[0] + vi[4] * gp[1] + vi[5] * gp[2];
  }
  __syncthreads();
  T vi[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) vi[k] = pt[k * 32];
  const T vw0 = pt[6 * 32], vw1 = pt[7 * 32], vw2 = pt[8 * 32];

  // Pass 2: columns u | g [| coupling] | rhs [| od] into the window rows,
  // the last chunk first (its slots are still in registers).
  RowTile<T, kTile> rt{s_a + (size_t)sl.warp * 32 * (kTile + 1), s_meta + sl.warp * 96,
                       rows + (size_t)g * W * K, size_t(K), 1, 0};
  for (int c = sl.nchunk - 1; c >= 0; --c) {
    if (c != sl.nchunk - 1) compute(c * tc + ti);
    const T* j0 = o.jc;
    const T* j1 = o.jc + NP;
    const T* q = o.jp;
    T wl[3][NP], wv[3][NP];
    if constexpr (SJ) w_factors(j0, j1, q, vi, wl, wv);
    if constexpr (OD) {
      const size_t base = (size_t)gi * (tc + 1);
#pragma unroll
      for (int l = 0; l < 3; ++l)
#pragma unroll
        for (int i = 0; i < NP; ++i)
          s_wv[((base + ti + 1) * 3 * NP + l * NP + i) * 32 + lane] = wv[l][i];
      s_w[(base + ti + 1) * 32 + lane] = w;
      if (ti == 0) {  // the slot before this chunk, as pass 1 wrote it
        int wp = -1;
        if (c > 0 && sl.live) {
          const size_t tsp = ((size_t)g * Tb + c * tc - 1) * Pc + p;
          wp = int(wcam[tsp]);
          T jcp[2 * NP], jpp[6], wlp[3][NP], wvp[3][NP];
#pragma unroll
          for (int k = 0; k < 2 * NP; ++k) jcp[k] = jc_out[k * GTP + tsp];
#pragma unroll
          for (int k = 0; k < 6; ++k) jpp[k] = jp_out[k * GTP + tsp];
          w_factors(jcp, jcp + NP, jpp, vi, wlp, wvp);
#pragma unroll
          for (int l = 0; l < 3; ++l)
#pragma unroll
            for (int i = 0; i < NP; ++i)
              s_wv[((base + 0) * 3 * NP + l * NP + i) * 32 + lane] = wvp[l][i];
        }
        s_w[base * 32 + lane] = wp;
      }
    }
    tile_rows(rt, w);
    if (rt.nd > 0) {  // warp-uniform
      int col = put_ug<K0, NP, TERMS>(rt, 0, j0, j1, o.r0, o.r1);
      if constexpr (SJ) col = put_coupling<K0, NP, TERMS>(rt, col, wl, wv);
      const T s0r = q[0] * vw0 + q[1] * vw1 + q[2] * vw2;
      const T s1r = q[3] * vw0 + q[4] * vw1 + q[5] * vw2;
#pragma unroll
      for (int i = 0; i < NP; ++i, ++col) tile_put<K0>(rt, col, j0[i] * s0r + j1[i] * s1r, 0);
    }
    if constexpr (OD) {
      __syncthreads();
      const size_t prev = (size_t)gi * (tc + 1) + ti;  // slot t - 1
      const int w_prev = s_w[prev * 32 + lane];
      tile_rows(rt, (w_prev >= 0 && w == w_prev + 1) ? w_prev : -1);
      if (rt.nd > 0) {  // warp-uniform
        const T* wvp = s_wv + prev * 3 * NP * 32 + lane;
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int j = 0; j < NP; ++j)
            tile_put<NP * NP>(rt, i * NP + j,
                              split_round<TERMS>(wvp[(0 * NP + i) * 32] * wl[0][j] +
                                                 wvp[(1 * NP + i) * 32] * wl[1][j] +
                                                 wvp[(2 * NP + i) * 32] * wl[2][j]),
                              K0);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- B2 ----
// Where a slot's window row comes from.  Each source is a functor that the
// whole warp calls for slot t of its 32 point columns (t is warp-uniform;
// `real`: this lane's slot exists, p < Pc and t < Tb) and that returns this
// lane's row, -1 for padding or no slot.  kScratch: the shared ints per warp
// it needs (B2 and B6 otherwise share coupling_kernel's layout).

// B2: the row is wcam[ts], int16, -1 = padding.
struct WcamRows {
  static constexpr int kScratch = 0;
  const int16_t* wcam;
  __device__ __forceinline__ int operator()(const SlotLane&, int, size_t ts, bool real,
                                            int*) const {
    return real ? int(wcam[ts]) : -1;
  }
};

// V bytes of one-hot entries from p into v (V / sizeof(OH) entries), one
// read-only vector load; V is the wrapper's vector width (onehot_vector_bytes
// in ops/_wtt_common.py), so p is V-aligned.
template <int V, typename OH, int E>
__device__ __forceinline__ void load_vec(const OH* p, OH (&v)[E]) {
  static_assert(E * sizeof(OH) == V, "one vector");
  if constexpr (V == sizeof(OH)) {
    v[0] = __ldg(p);
  } else if constexpr (V == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(v, &u, V);
  } else if constexpr (V == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(v, &u, V);
  } else {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    memcpy(v, &u, V);
  }
}

// The first nonzero row of each of the warp's 32 one-hot columns, lowered
// into the warp's shared (32,) table s_row (which holds W before).  `col`
// points at row 0 of column 0; rows are N entries apart and a row's 32
// entries are contiguous, read as R = 32 / E vectors of E entries each.
// Lane l reads vector l % R of rows l / R, l / R + 32 / R, ...: 32 / R rows
// per warp-wide load (16 at int8 with V = 16, so W = 128 takes 8 loads per
// lane).  Each lane keeps, per entry of its vector, the first row where it
// saw a nonzero (rows rise, so the first is the least), then lowers the
// table with one shared atomicMin per entry it found.  Columns at or past
// `ncol` (the bucket's ragged edge) are not read: Pc * sizeof(OH) is a
// multiple of V, so no vector straddles the edge.
template <typename OH, int V>
__device__ __forceinline__ void first_rows(const OH* col, size_t N, int W, int ncol, int lane,
                                           int* s_row) {
  if constexpr (V >= sizeof(OH)) {
    constexpr int E = V / int(sizeof(OH)), R = 32 / E, RPL = 32 / R;
    const int j = lane % R;
    if (j * E >= ncol) return;
    const OH* p = col + j * E;
    int first[E];
#pragma unroll
    for (int e = 0; e < E; ++e) first[e] = W;
#pragma unroll 4
    for (int i = lane / R; i < W; i += RPL) {
      OH v[E];
      load_vec<V>(p + size_t(i) * N, v);
#pragma unroll
      for (int e = 0; e < E; ++e) first[e] = (first[e] == W && v[e] != OH(0)) ? i : first[e];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (first[e] < W) atomicMin(s_row + j * E + e, first[e]);
  }
}

// B6: the row is the first nonzero row of the slot's column of the one-hot
// (G, W, Tb * Pc), int8 or the data's float type; an all-zero column is a
// padded slot.  The warp decodes its 32 columns at once (first_rows) with
// `vec`-byte loads.
template <typename OH>
struct OnehotRows {
  static constexpr int kScratch = 32;
  const OH* onehot;
  int Tb, Pc, W, vec;
  __device__ __forceinline__ int operator()(const SlotLane& sl, int t, size_t, bool,
                                            int* s_row) const {
    if (t >= Tb) return -1;  // warp-uniform
    const size_t N = size_t(Tb) * Pc;
    const int p0 = sl.p - sl.lane;
    const OH* col = onehot + size_t(sl.g) * W * N + size_t(t) * Pc + p0;
    const int ncol = min(32, Pc - p0);
    s_row[sl.lane] = W;
    __syncwarp();
    switch (vec) {
      case 16: first_rows<OH, 16>(col, N, W, ncol, sl.lane, s_row); break;
      case 8: first_rows<OH, 8>(col, N, W, ncol, sl.lane, s_row); break;
      case 4: first_rows<OH, 4>(col, N, W, ncol, sl.lane, s_row); break;
      default: first_rows<OH, 1>(col, N, W, ncol, sl.lane, s_row); break;
    }
    __syncwarp();
    const int w = s_row[sl.lane];
    __syncwarp();
    return w < W ? w : -1;
  }
};

// Shared memory of B2 and B6 (elements): the (ng, tc, 3, 32) per-slot W^T x
// parts, aliased by the warps' (32, NP + 1) row tiles; the (ng, 3, 32) y of
// each point; the warps' (3, 32) tile meta and the row source's scratch.
template <typename T, int NP, typename Rows>
constexpr size_t coupling_smem(int tc, int ng) {
  const size_t nw = size_t(tc) * ng;
  const size_t parts = nw * 3 * 32, tiles = nw * 32 * (NP + 1);
  return ((parts > tiles ? parts : tiles) + size_t(ng) * 3 * 32) * sizeof(T) +
         nw * (96 + Rows::kScratch) * sizeof(int);
}

// B2 <- wtt_matvec.py:wtt_coupling_rows_idx, with Rows = WcamRows, and
// B6 <- wtt_matvec.py:wtt_coupling_rows_fused, with Rows = OnehotRows (at
// TERMS = 3: the JAX kernel takes no terms).  Phase 1: each lane takes its
// slot's window row from `rows`, reads jc/jp and x, and its W^T x part goes
// to the point's summing lane; y = V^-1 W^T x comes back.  Phase 2: z = jc
// (jp y) of the slot into the (NP, W) window rows through the warp's row
// tile.
//
// TERMS < 3 (float only) is the TPU kernel's reduced-fidelity CG operator
// (matvec_kernel "index1" / "index2", wtt_matvec.py:215): each window-row
// value of x that a slot reads and each z value it reduces pass
// split_round<TERMS>.
template <typename T, int NP, int TERMS, typename Rows>
__global__ void __launch_bounds__(kCouplingThreads)
coupling_kernel(const T* __restrict__ xw_t, Rows rows, const T* __restrict__ jc,
                const T* __restrict__ jp, const T* __restrict__ vinv, T* __restrict__ out,
                int G, int Tb, int Pc, int W, int tc, int ng) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SlotLane sl = slot_lane(tc, ng, Tb, Pc);
  const int lane = sl.lane, gi = sl.gi, ti = sl.ti, p = sl.p;
  const int nw = tc * ng;
  T* s_a = reinterpret_cast<T*>(smem);  // parts, then row tiles
  const size_t n_a = size_t(nw) * 32 * (NP + 1);
  T* s_y = s_a + n_a;                   // (ng, 3, 32)
  int* s_meta = reinterpret_cast<int*>(s_y + ng * 3 * 32);
  int* s_scratch = s_meta + nw * 96 + sl.warp * Rows::kScratch;

  const int g = sl.g;
  const T* xw_g = xw_t + (size_t)g * NP * W;
  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;

  // Slot t of this lane's point: window row w (-1 = padding or past the
  // track) and its planes (zero where w = -1).  The planes are read before
  // the row is known, and a padded slot's are dropped.
  int w;
  T j[2 * NP], q[6];
  auto load = [&](int t) {
    const bool real = sl.live && t < Tb;
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
#pragma unroll
    for (int k = 0; k < 2 * NP; ++k) j[k] = real ? jc[k * GTP + ts] : T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = real ? jp[k * GTP + ts] : T(0);
    w = rows(sl, t, ts, real, s_scratch);
    if (w < 0) {
#pragma unroll
      for (int k = 0; k < 2 * NP; ++k) j[k] = T(0);
#pragma unroll
      for (int k = 0; k < 6; ++k) q[k] = T(0);
    }
  };
  // The point's V^-1, read ahead for the summing lanes.
  T v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    v[k] = sl.live && ti == 0 ? vinv[k * GP + (size_t)g * Pc + p] : T(0);

  // Phase 1: W^T x parts, summed in slot order.
  T wtx[3] = {T(0), T(0), T(0)};
  T* part = s_a + (size_t)(gi * tc + ti) * 3 * 32 + lane;
  for (int c = 0; c < sl.nchunk; ++c) {
    load(c * tc + ti);
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const T xg = split_round<TERMS>(w >= 0 ? __ldg(xw_g + (size_t)i * W + w) : T(0));
      s0 += j[i] * xg;
      s1 += j[NP + i] * xg;
    }
#pragma unroll
    for (int l = 0; l < 3; ++l) part[l * 32] = q[l] * s0 + q[3 + l] * s1;
    __syncthreads();
    add_parts(wtx, s_a, sl, tc, Tb, c);
    __syncthreads();
  }
  T* yp = s_y + gi * 3 * 32 + lane;
  if (ti == 0) {
    yp[0] = v[0] * wtx[0] + v[1] * wtx[1] + v[2] * wtx[2];
    yp[32] = v[1] * wtx[0] + v[3] * wtx[1] + v[4] * wtx[2];
    yp[64] = v[2] * wtx[0] + v[4] * wtx[1] + v[5] * wtx[2];
  }
  __syncthreads();
  const T y0 = yp[0], y1 = yp[32], y2 = yp[64];

  // Phase 2: z = jc (jp y) into the (NP, W) window rows, the last chunk
  // first (its slots are still in registers).
  RowTile<T, NP> rt{s_a + (size_t)sl.warp * 32 * (NP + 1), s_meta + sl.warp * 96,
                    out + (size_t)g * NP * W, 1, size_t(W), 0};
  for (int c = sl.nchunk - 1; c >= 0; --c) {
    if (c != sl.nchunk - 1) load(c * tc + ti);
    tile_rows(rt, w);
    if (rt.nd == 0) continue;  // warp-uniform
    const T s0p = q[0] * y0 + q[1] * y1 + q[2] * y2;
    const T s1p = q[3] * y0 + q[4] * y1 + q[5] * y2;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      tile_put<NP>(rt, i, split_round<TERMS>(j[i] * s0p + j[NP + i] * s1p), 0);
  }
}

// ---------------------------------------------------------------- host --
// B6's one-hot load width in bytes: the widest of 16, 8, 4 and 1 that is no
// narrower than an entry of `size` bytes and divides both the one-hot's
// address and Pc entries (so every column block's offset g W N + i N +
// t Pc + p0 is aligned, p0 being a multiple of 32); 0 if none.
// ops/_wtt_common.py onehot_vector_bytes is the same rule.
inline int onehot_vec(const void* onehot, int Pc, int size) {
  const int widths[] = {16, 8, 4, 1};
  for (const int v : widths)
    if (v >= size && uintptr_t(onehot) % v == 0 && size_t(Pc) * size % v == 0) return v;
  return 0;
}

template <typename T, int NP, bool SJ, bool OD, int TERMS>
int lin_launch_sj(const void* wcam, const void* tw, const void* pts, const void* uv,
                  const void* mask, const void* lam, const void* inv_w, void* rows,
                  void* jc, void* jp, void* vinv, void* gpt, void* damp, int G, int Tb,
                  int Pc, int W, LinFlags f, int tc, int ng, int smem,
                  cudaStream_t stream) {
  auto kernel = lin_kernel<T, NP, SJ, OD, TERMS>;
  dim3 grid, block;
  const int e = slot_launch(kernel, lin_threads<T>(), lin_smem<T, NP, OD>(tc, ng), tc, ng,
                            smem, G, Pc, grid, block);
  if (e) return e;
  kernel<<<grid, block, smem, stream>>>(
      (const int16_t*)wcam, (const T*)tw, (const T*)pts, (const T*)uv, (const T*)mask,
      (const T*)lam, (const T*)inv_w, (T*)rows, (T*)jc, (T*)jp, (T*)vinv, (T*)gpt,
      (T*)damp, G, Tb, Pc, W, f, tc, ng);
  return (int)cudaGetLastError();
}

// B1 with want_od (OD) or without, on f.use_sj (OD needs it: kErrOd).
template <typename T, int NP, bool OD, int TERMS>
int lin_launch(const void* wcam, const void* tw, const void* pts, const void* uv,
               const void* mask, const void* lam, const void* inv_w, void* rows,
               void* jc, void* jp, void* vinv, void* gpt, void* damp, int G,
               int Tb, int Pc, int W, LinFlags f, int tc, int ng, int smem,
               cudaStream_t stream) {
  if (f.use_sj)
    return lin_launch_sj<T, NP, true, OD, TERMS>(wcam, tw, pts, uv, mask, lam, inv_w, rows,
                                                 jc, jp, vinv, gpt, damp, G, Tb, Pc, W, f,
                                                 tc, ng, smem, stream);
  if constexpr (OD) {
    return kErrOd;
  } else {
    return lin_launch_sj<T, NP, false, false, TERMS>(wcam, tw, pts, uv, mask, lam, inv_w,
                                                     rows, jc, jp, vinv, gpt, damp, G, Tb,
                                                     Pc, W, f, tc, ng, smem, stream);
  }
}

// B2 (Rows = WcamRows) or B6 (Rows = OnehotRows) at the wrapper's geometry.
template <typename T, int NP, int TERMS, typename Rows>
int coupling_launch_rows(const void* xw_t, Rows rows, const void* jc, const void* jp,
                         const void* vinv, void* out, int G, int Tb, int Pc, int W, int tc,
                         int ng, int smem, cudaStream_t stream) {
  auto kernel = coupling_kernel<T, NP, TERMS, Rows>;
  dim3 grid, block;
  const int e = slot_launch(kernel, kCouplingThreads, coupling_smem<T, NP, Rows>(tc, ng), tc,
                            ng, smem, G, Pc, grid, block);
  if (e) return e;
  kernel<<<grid, block, smem, stream>>>((const T*)xw_t, rows, (const T*)jc, (const T*)jp,
                                        (const T*)vinv, (T*)out, G, Tb, Pc, W, tc, ng);
  return (int)cudaGetLastError();
}

template <typename T, int NP, int TERMS>
int coupling_launch(const void* xw_t, const void* wcam, const void* jc,
                    const void* jp, const void* vinv, void* out, int G, int Tb,
                    int Pc, int W, int tc, int ng, int smem, cudaStream_t stream) {
  return coupling_launch_rows<T, NP, TERMS>(xw_t, WcamRows{(const int16_t*)wcam}, jc, jp,
                                            vinv, out, G, Tb, Pc, W, tc, ng, smem, stream);
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
                          int Pc, int W, int want_od, LinFlags f, int tc, int ng, int smem,
                          cudaStream_t stream);
int wtt_coupling_reduced(int np, int terms, const void* xw_t, const void* wcam,
                         const void* jc, const void* jp, const void* vinv, void* out,
                         int G, int Tb, int Pc, int W, int tc, int ng, int smem,
                         cudaStream_t stream);

}  // namespace tpu3drecon
