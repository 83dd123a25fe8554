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
// All four are slot-major.  One lane owns one track slot: a warp holds slot
// t of 32 consecutive point columns and a block the Tb warps of one or more
// 32-point groups, so a bucket runs on Tb * Pc threads (1,152 blocks on the
// medium problem's five buckets of G = 1, where one thread per point gave
// 396) and every slot's chain of dependent loads (wcam -> camera row or x
// row, jc/jp, uv/mask) runs beside the others instead of Tb times in a row.
// The per-point sums (B1's V and g_pt, B2's and B3's W^T x, B4's cost
// column) cross warps through shared memory and one lane per point adds
// them in slot order, the order of the loop they replace (slot.cuh
// add_parts), so they keep their last bits.  B1 and B2 (wtt_kernels.cuh)
// keep each slot's Jacobian planes in registers from phase 1 to phase 2, so
// B2 reads jc/jp once and B1 calls tt_blocks once per slot.  B3 is B2's
// phase 1 on its own and B4 the cost of B16 (tt_kernels.cu) on the wtt
// layout, both on B2's grid: no window-row output, so no atomics, and a
// point's planes or column are written once.  Where a bucket's points
// alone fill the card, B3 and B4 walk each track in one lane instead.
//
// Every kernel reads its slot's window row directly (wcam is int16, -1 =
// padding) from device memory, where the TPU kernels rebuild one-hot tiles
// and select camera rows with bf16-split MXU dots; a padded slot takes an
// all-zero camera row (and x column) without reading one, exactly as the
// TPU's empty one-hot column gives it.  Nothing is staged per window, so
// any window width runs (the hub layout's W = 1664 too).
//
// Reductions into window-camera rows (linearize rows, coupling rows) cross
// threads: they go straight to the global rows (zeroed by the wrapper) with
// atomics.  B1 and B2 write a warp's column values into the warp's shared
// row tile, and one lane per (distinct row, column) sums its lanes and
// sends one atomic, so the 32 lanes of a row-uniform warp (the common
// case, since points are sorted by their minimum camera) issue a slot's
// atomics at once (slot.cuh tile_put).  A block-local shared (W, K) tile
// flushed once per block measured 1.45-4.6x slower on the H100 than direct
// atomics (PERF.md): a block touches few rows of a wide tile but has to
// zero and flush all of it.
//
// What bounds them on the H100 (PERF.md): B2 on the medium buckets by the
// atomics that many warps send to the same 128 x 8 row entries, on the BAL
// buckets by its phase 1, the jc/jp stream; B1 by latency at the occupancy
// its registers allow (capped at 128 in float by a 512-thread bound, so
// two blocks of 256 threads share an SM); B3 by the jc/jp stream of the
// slots that have a window row (88 B a slot at np = 8); B4, which reads
// wcam, uv and mask per slot and writes one value per point, by its launch
// on the medium buckets.  In one thread per point both were bound by
// latency: the long buckets ran on few threads, each walking its wcam ->
// camera row or x row -> jc/jp or uv/mask chain Tb times in a row.
// Atomic reduction order varies from run to run, so f32 row sums vary in
// the last bits.
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
// memory, so no launch needs a host sync.  The slot formulas, the camera
// row and x reads, the contribution columns, the two halves of the
// coupling product and the row reductions (warp-aggregated, and B1's and
// B2's row tiles) live in slot.cuh,
// shared with the route kernels (wtt_route_kernels.cu) and the dense
// track-table kernels (tt_kernels.cu).  B1's and B2's kernel templates live
// in wtt_kernels.cuh: their reduced-fidelity float instantiations (the TPU
// kernels' `terms` 1 and 2, split_round in slot.cuh) compile in
// wtt_terms_kernels.cu, and the C entries below hand those calls over.
// On Hopper the rounding removes no bytes or gathers (a slot reads its own
// camera row either way), so the reduced modes exist for the users who pick
// them, not for speed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "slot.cuh"
#include "wtt_kernels.cuh"

using namespace tpu3drecon;

namespace {

// ---------------------------------------------------------------- B3 ----
// <- wtt_matvec.py:wtt_wt_planes_idx.  Slot-major, B2's phase 1 on its own
// (wtt_kernels.cuh coupling_kernel) on B2's grid and thread limit: each lane
// reads its slot's wcam and, where the slot has a window row, its jc/jp and
// the x column of that row (a padded slot reads no planes, which may hold
// NaN, and gives exact zeros), and forms its part jp[l] s0 + jp[3 + l] s1;
// lane p of the group's warp 0 adds the Tb parts in slot order (add_parts)
// and writes the point's three planes once.  No window-row output, so no
// atomics and no row tile; the planes equal the ordered plain version's
// (ops/wtt_matvec.py _wt_planes_ordered) bit for bit.  Shared memory: the
// (ng, tc, 3, 32) parts.
//
// B3 and B4 walk each track in one lane (WALK, tc = 1: a warp per 32-point
// group, a chunk per slot, blocks of kBlock threads) where the bucket's
// points alone fill the card's resident threads (the largest BAL buckets;
// ops/_wtt_common.py walks_tracks): one slot per lane measured 8-29 %
// slower there than one thread per point (PERF.md), its warps waiting at
// each chunk's block barrier for the slowest.  A walking lane is its
// point's summing lane: it adds its parts in slot order in registers, with
// no shared memory and no barrier.  The C entries take WALK at tc = 1
// (also a one-slot track's geometry, where it is the same sum).
template <typename T>
constexpr size_t wt_smem(int tc, int ng) {
  return size_t(tc) * ng * 3 * 32 * sizeof(T);
}

// No minimum of blocks per SM (-Xptxas -v, PERF.md): every minimum tried
// either spilled (the float np 8 walk at 48 registers, the double walks)
// or raised the registers of the instantiations it did not hold.  Without
// one, the float np 12 walk alone spills, 8 bytes at 64 registers.
template <typename T, int NP, bool WALK>
__global__ void __launch_bounds__(WALK ? kBlock : kCouplingThreads)
wt_planes_kernel(const T* __restrict__ xw_t, const int16_t* __restrict__ wcam,
                 const T* __restrict__ jc, const T* __restrict__ jp, T* __restrict__ out,
                 int G, int Tb, int Pc, int W, int tc, int ng) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SlotLane sl = slot_lane(tc, ng, Tb, Pc);
  const int g = sl.g, p = sl.p;
  T* s_part = reinterpret_cast<T*>(smem);
  T* part = s_part + (size_t)(sl.gi * tc + sl.ti) * 3 * 32 + sl.lane;
  const T* xw_g = xw_t + (size_t)g * NP * W;
  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;
  T wtx[3] = {T(0), T(0), T(0)};
  for (int c = 0; c < sl.nchunk; ++c) {
    const int t = c * tc + sl.ti;
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    const int w = sl.live && t < Tb ? int(wcam[ts]) : -1;
    T j[2 * NP], q[6];
#pragma unroll
    for (int k = 0; k < 2 * NP; ++k) j[k] = w >= 0 ? jc[k * GTP + ts] : T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = w >= 0 ? jp[k * GTP + ts] : T(0);
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const T xg = w >= 0 ? __ldg(xw_g + (size_t)i * W + w) : T(0);
      s0 += j[i] * xg;
      s1 += j[NP + i] * xg;
    }
    if constexpr (WALK) {
#pragma unroll
      for (int l = 0; l < 3; ++l) wtx[l] += q[l] * s0 + q[3 + l] * s1;
    } else {
#pragma unroll
      for (int l = 0; l < 3; ++l) part[l * 32] = q[l] * s0 + q[3 + l] * s1;
      __syncthreads();
      add_parts(wtx, s_part, sl, tc, Tb, c);
      if (c + 1 < sl.nchunk) __syncthreads();  // the parts are read before the next chunk's
    }
  }
  if (sl.ti == 0 && sl.live) {
#pragma unroll
    for (int l = 0; l < 3; ++l) out[l * GP + (size_t)g * Pc + p] = wtx[l];
  }
}

// ---------------------------------------------------------------- B4 ----
// <- wtt_cost.py:wtt_cost_cols_idx.  Slot-major, B16's design (tt_kernels.cu
// tt_cost_kernel) on the wtt layout and B2's grid, and B3's walk on the
// largest buckets: each lane reads its slot's wcam, its window row of tw
// (zeros for padding, never row 0's values), uv and mask (on every slot,
// padded ones too: the function multiplies them by m^2, and a caller may
// pass a nonzero mask there), projects with radial distortion and forms
// s rho'(s) m^2 as its part; lane p of the group's warp 0 adds the Tb parts
// from zero in slot order, the order of the ordered plain version's track
// sum (ops/wtt_cost.py _cost_cols_ordered), so each column keeps its last
// bits and the result is deterministic (the trust region compares two
// costs).  Shared memory: the (ng, tc, 32) parts; no row tile, no atomics.
template <typename T>
constexpr size_t cost_smem(int tc, int ng) {
  return size_t(tc) * ng * 32 * sizeof(T);
}

// Threads per block at most: B16's, 512 in float and 256 in double (64
// registers and a spill under a 512 bound).  The float walk is held to five
// blocks of kBlock per SM (48 registers), the occupancy of one thread per
// point's 44: at 49 an SM held four.
template <typename T>
constexpr int cost_threads() { return sizeof(T) == 4 ? 512 : 256; }

template <typename T, bool WALK>
__global__ void __launch_bounds__(WALK ? kBlock : (sizeof(T) == 4 ? 512 : 256),  // cost_threads<T>()
                                  WALK && sizeof(T) == 4 ? 5 : 1)
cost_kernel(const int16_t* __restrict__ wcam, const T* __restrict__ tw,
            const T* __restrict__ pts, const T* __restrict__ uv,
            const T* __restrict__ mask, T* __restrict__ out, int G, int Tb, int Pc,
            int W, int loss, int tc, int ng) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SlotLane sl = slot_lane(tc, ng, Tb, Pc);
  const int g = sl.g, p = sl.p;
  T* s_part = reinterpret_cast<T*>(smem);
  T* part = s_part + (size_t)(sl.gi * tc + sl.ti) * 32 + sl.lane;
  const T* tw_g = tw + (size_t)g * W * kD;
  const size_t GP = (size_t)G * Pc, pp = (size_t)g * Pc + p;
  const T px = sl.live ? pts[pp] : T(0);
  const T py = sl.live ? pts[GP + pp] : T(0);
  const T pz = sl.live ? pts[2 * GP + pp] : T(0);
  T total[1] = {T(0)};
  for (int c = 0; c < sl.nchunk; ++c) {
    const int t = c * tc + sl.ti;
    const bool real = sl.live && t < Tb;
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    T buf[kD];
    const T* cp = cam_row(tw_g, real ? int(wcam[ts]) : -1, buf);
    const T u_obs = real ? uv[(((size_t)g * 2 + 0) * Tb + t) * Pc + p] : T(0);
    const T v_obs = real ? uv[(((size_t)g * 2 + 1) * Tb + t) * Pc + p] : T(0);
    const T m = real ? mask[ts] : T(0);
    const T x = cp[0] * px + cp[1] * py + cp[2] * pz + cp[9];
    const T y = cp[3] * px + cp[4] * py + cp[5] * pz + cp[10];
    const T z = cp[6] * px + cp[7] * py + cp[8] * pz + cp[11];
    const T iz = T(1) / (fabs(z) < T(1e-12) ? T(1) : z);
    const T mx = x * iz, my = y * iz;
    const T r2 = mx * mx + my * my;
    const T s_rad = T(1) + cp[17] * r2 + cp[18] * r2 * r2;
    const T u = cp[12] * s_rad * mx + cp[16] * s_rad * my + cp[14];
    const T v = cp[13] * s_rad * my + cp[15];
    const T r0 = u - u_obs, r1 = v - v_obs;
    const T s = r0 * r0 + r1 * r1;
    const T val = s * robust_weight<T>(loss, s) * (m * m);
    if constexpr (WALK) {
      total[0] += val;
    } else {
      part[0] = val;
      __syncthreads();
      add_parts(total, s_part, sl, tc, Tb, c);
      if (c + 1 < sl.nchunk) __syncthreads();  // the parts are read before the next chunk's
    }
  }
  if (sl.ti == 0 && sl.live) out[pp] = total[0];
}

// ---------------------------------------------------------------- host --
// B3 at the wrapper's geometry (WALK at tc = 1).
template <typename T, int NP, bool WALK>
int wt_launch(const void* xw_t, const void* wcam, const void* jc, const void* jp,
              void* out, int G, int Tb, int Pc, int W, int tc, int ng, int smem,
              cudaStream_t stream) {
  auto kernel = wt_planes_kernel<T, NP, WALK>;
  dim3 grid, block;
  const int e = slot_launch(kernel, WALK ? kBlock : kCouplingThreads, wt_smem<T>(tc, ng), tc,
                            ng, smem, G, Pc, grid, block);
  if (e) return e;
  kernel<<<grid, block, smem, stream>>>((const T*)xw_t, (const int16_t*)wcam, (const T*)jc,
                                        (const T*)jp, (T*)out, G, Tb, Pc, W, tc, ng);
  return (int)cudaGetLastError();
}

// B4 at the wrapper's geometry (WALK at tc = 1).
template <typename T, bool WALK>
int cost_launch(const void* wcam, const void* tw, const void* pts, const void* uv,
                const void* mask, void* out, int G, int Tb, int Pc, int W, int loss, int tc,
                int ng, int smem, cudaStream_t stream) {
  auto kernel = cost_kernel<T, WALK>;
  dim3 grid, block;
  const int e = slot_launch(kernel, WALK ? kBlock : cost_threads<T>(), cost_smem<T>(tc, ng),
                            tc, ng, smem, G, Pc, grid, block);
  if (e) return e;
  kernel<<<grid, block, smem, stream>>>((const int16_t*)wcam, (const T*)tw, (const T*)pts,
                                        (const T*)uv, (const T*)mask, (T*)out, G, Tb, Pc, W,
                                        loss, tc, ng);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wtt_linearize(int dtype, int np, int terms, const void* wcam, const void* tw,
                  const void* pts, const void* uv, const void* mask,
                  const void* lam, const void* inv_w, void* rows, void* jc,
                  void* jp, void* vinv, void* gpt, void* damp, int G, int Tb,
                  int Pc, int W, int use_sj, int want_od, int loss, int focal,
                  int points, int dist, int pp, int tc, int ng, int smem, void* stream) {
  if (want_od && !use_sj) return kErrOd;
  if (terms != 2 && terms != 3) return kErrTerms;
  if (G == 0 || Pc == 0) return 0;
  const LinFlags f{use_sj, loss, focal, points, dist, pp};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && terms < 3)
    return wtt_linearize_reduced(np, terms, wcam, tw, pts, uv, mask, lam, inv_w, rows, jc,
                                 jp, vinv, gpt, damp, G, Tb, Pc, W, want_od, f, tc, ng, smem,
                                 s);
  NP_DISPATCH(dtype, np,
              (want_od ? lin_launch<T, NP, true, 3>(wcam, tw, pts, uv, mask, lam, inv_w,
                                                    rows, jc, jp, vinv, gpt, damp, G, Tb,
                                                    Pc, W, f, tc, ng, smem, s)
                       : lin_launch<T, NP, false, 3>(wcam, tw, pts, uv, mask, lam, inv_w,
                                                     rows, jc, jp, vinv, gpt, damp, G, Tb,
                                                     Pc, W, f, tc, ng, smem, s)));
}

int wtt_coupling(int dtype, int np, int terms, const void* xw_t, const void* wcam,
                 const void* jc, const void* jp, const void* vinv, void* out,
                 int G, int Tb, int Pc, int W, int tc, int ng, int smem, void* stream) {
  if (terms < 1 || terms > 3) return kErrTerms;
  if (G == 0 || Pc == 0) return 0;
  if (dtype == 0 && terms < 3)
    return wtt_coupling_reduced(np, terms, xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, tc,
                                ng, smem, (cudaStream_t)stream);
  NP_DISPATCH(dtype, np, (coupling_launch<T, NP, 3>(xw_t, wcam, jc, jp, vinv, out, G, Tb,
                                                    Pc, W, tc, ng, smem,
                                                    (cudaStream_t)stream)));
}

// tc, ng, smem: the slot-major geometry (ops/_wtt_common.py slot_geometry
// "wt"; tc = 1 walks each track in one lane: WALK).
int wtt_wt_planes(int dtype, int np, const void* xw_t, const void* wcam,
                  const void* jc, const void* jp, void* out, int G, int Tb,
                  int Pc, int W, int tc, int ng, int smem, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  NP_DISPATCH(dtype, np,
              (tc == 1 ? wt_launch<T, NP, true>(xw_t, wcam, jc, jp, out, G, Tb, Pc, W, tc, ng,
                                                smem, s)
                       : wt_launch<T, NP, false>(xw_t, wcam, jc, jp, out, G, Tb, Pc, W, tc, ng,
                                                 smem, s)));
}

// tc, ng, smem: the slot-major geometry (ops/_wtt_common.py slot_geometry
// "cost"; tc = 1 walks each track in one lane: WALK).
int wtt_cost(int dtype, const void* wcam, const void* tw, const void* pts,
             const void* uv, const void* mask, void* out, int G, int Tb, int Pc,
             int W, int loss, int tc, int ng, int smem, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return tc == 1 ? cost_launch<float, true>(wcam, tw, pts, uv, mask, out, G, Tb, Pc, W, loss,
                                              tc, ng, smem, s)
                   : cost_launch<float, false>(wcam, tw, pts, uv, mask, out, G, Tb, Pc, W,
                                               loss, tc, ng, smem, s);
  if (dtype == 1)
    return tc == 1 ? cost_launch<double, true>(wcam, tw, pts, uv, mask, out, G, Tb, Pc, W,
                                               loss, tc, ng, smem, s)
                   : cost_launch<double, false>(wcam, tw, pts, uv, mask, out, G, Tb, Pc, W,
                                                loss, tc, ng, smem, s);
  return kErrDtype;
}

}  // extern "C"
