// Dense track-table ("tt") bundle-adjustment kernels for Hopper (sm_90a).
//
// Hand-written CUDA C++ counterparts of the five Pallas kernels of the
// fully fused tt engine (tpu3drecon/solvers/ba_tt.py, kernels="full"), all
// in tpu3drecon/ops/pallas/tt_linearize.py:
//
//   tt_cam_normal <- tt_cam_normal_fused (_cam_kernel)       B12
//   tt_coupling   <- tt_coupling_fused   (_coupling_kernel)  B13
//   tt_wt_times   <- tt_wt_times_fused   (_wt_kernel)        B14
//   tt_w_times    <- tt_w_times_fused    (_w_kernel)         B15
//   tt_cost       <- tt_cost_fused       (_cost_kernel)      B16
//
// Layout: one track-length bucket at a time, plane-major with the slot
// axes (Tb, Pb) last: cam_ids (Tb, Pb) int32, mask (Tb, Pb), uv (2, Tb, Pb),
// pts (3, Pb), jc (2np, Tb, Pb), jp (6, Tb, Pb).  The TPU kernels select
// each slot's camera row, and reduce per-slot values into camera rows, with
// MXU dots against a dense {0,1} one-hot tile, because gathers are slow
// there.  Here a slot reads its camera index directly.
//
// B12-B15 are slot-major (slot.cuh slot_lane): a warp holds slot t
// of 32 consecutive point columns, one lane per slot, a block holds `ng`
// such groups as `tc` warps each, and a track longer than tc slots is
// walked in chunks, so a bucket runs on Tb * Pb threads and every slot's
// chain of dependent loads (cam_ids -> mask -> camera row or x row ->
// arithmetic) runs beside the others instead of Tb times in a row.  The
// wrappers compute tc, ng and the shared bytes (ops/_wtt_common.py
// slot_geometry "tt_lin", "tt_coupling", "tt_wt", "tt_w") and the C entries
// check them against tt_lin_smem, tt_coupling_smem, tt_wt_smem and
// tt_w_smem.  Per-point sums (B12's V
// and g_pt, B14's W^T x) cross the warps through shared memory: each lane
// writes its slot's part, and lane p of the group's warp 0 adds the Tb
// parts in slot order t = 0 .. Tb - 1, the order of the plain versions'
// track sums, so they keep their last bits.  Per-camera columns (B12's U|g,
// B13's coupling, B15's W y) go through the warp's row tile (slot.cuh
// tile_put): the lanes are grouped by camera and each (distinct camera,
// column) leaves as one atomic, all lanes at once.  B16 still runs one
// thread per point column, which walks its track.
//
// Padded slots (mask 0) carry cam_ids 0.  They take an all-zero camera row
// (and x row) without reading one, never camera 0's row: the masked
// one-hot gives them an all-zero camera column, so z = 0 -> z_safe = 1 and
// every output of the slot is exactly 0, where camera 0's row could give
// z ~ 0 and inf * 0 = NaN.  They add nothing to any camera row.
//
// Camera rows and x are read from device memory into registers, so any
// camera count runs.  Per-camera reductions go to the zeroed outputs with
// atomics; their summation order varies from run to run.
// B15 alone keeps a second memory mode, a block-shared (C, NP) tile
// flushed once per block: it measured faster at 100 cameras on the largest
// medium bucket and slower at 1024 (PERF.md), and its wrapper picks it
// where the tile has at most 2,048 entries (ops/tt_linearize.py
// memory_mode).
//
// What bounds them on the H100.  B14 streams its jc/jp once (96 B per slot
// at np = 8, 8.35 us per medium pass) and was bound by latency in one
// thread per point: the long-track buckets (Tb 8 and 12) ran on 5,632 and
// 512 threads; slot-major, every slot's loads are in flight at once.  B12
// writes its jc/jp (10.14 us per medium pass) and was bound by the atomics
// of its 44 camera columns per slot (np = 8), sent lane by lane from warps
// of mixed cameras; its row tile sends one atomic per (camera, column) and
// warp-slot.  B13 (36 columns per slot, no Jacobian arithmetic) was bound
// the same way, and by one thread per point on the long-track buckets; it
// takes B12's row tile and grid.  B15 (8 columns per slot) is bound by
// launch and latency, its pass 9x its bytes' bound on the medium buckets.
//
// Built with --fmad=false (ops/_build.py): each kernel's per-element
// outputs match its plain version (ops/tt_linearize.py) to the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "slot.cuh"

using namespace tpu3drecon;

namespace {

// Camera of slot ts, or -1 for a padded slot or a lane past the edge.
template <typename T>
__device__ __forceinline__ int slot_cam(const int* cam_ids, const T* mask,
                                        size_t ts, bool live) {
  return (live && mask[ts] > T(0)) ? cam_ids[ts] : -1;
}

// ---------------------------------------------------------------- B12 ---
// Slot-major, one pass.  Each lane reads its slot's camera row (zeros for
// padding), runs tt_blocks once and writes jc/jp; while the slot is in
// registers it puts its U upper triangle | g columns, in the output's
// column order, into the warp's row tile of its camera (kTile columns, so
// 44 / 65 / 90 columns at np 8 / 10 / 12 flush 2 / 3 / 3 times).  Then its
// V | g_pt parts (9 values) go to the point's summing lane, which adds them
// in slot order.
//
// Shared memory (elements of T, then ints): the (ng, tc, 9, 32) per-slot
// parts, aliased by the warps' (32, kTile + 1) row tiles; the warps' (3, 32)
// tile meta.  A chunk puts its columns first, a barrier orders every warp's
// last flush before the parts are written, and a barrier after the summing
// lanes' reads orders them before the next chunk's columns.  One memory
// mode: a block-shared (C, K) tile (B15's) measured slower on every medium
// bucket and 7.6x slower at C = 1024 (PERF.md).
template <typename T>
constexpr int tt_lin_threads() { return sizeof(T) == 4 ? 512 : 256; }

template <typename T>
constexpr size_t tt_lin_smem(int tc, int ng) {
  const size_t nw = size_t(tc) * ng;
  const size_t parts = nw * 9 * 32, tiles = nw * 32 * (kTile + 1);
  return (parts > tiles ? parts : tiles) * sizeof(T) + nw * 96 * sizeof(int);
}

template <typename T, int NP>
__global__ void __launch_bounds__(sizeof(T) == 4 ? 512 : 256)  // tt_lin_threads<T>()
tt_cam_normal_kernel(const T* __restrict__ table, const int* __restrict__ cam_ids,
                     const T* __restrict__ pts, const T* __restrict__ uv,
                     const T* __restrict__ mask, const T* __restrict__ invw_p,
                     T* __restrict__ jc_out, T* __restrict__ jp_out,
                     T* __restrict__ v6_out, T* __restrict__ gpt_out,
                     T* __restrict__ ug, int C, int Tb, int Pb, LinFlags f, int tc, int ng) {
  constexpr int K = NP * (NP + 1) / 2 + NP;  // U upper triangle | g: ug is (C, K)
  extern __shared__ __align__(16) unsigned char smem[];
  const SlotLane sl = slot_lane(tc, ng, Tb, Pb);
  const int lane = sl.lane, gi = sl.gi, ti = sl.ti, p = sl.p;
  const int nw = tc * ng;
  T* s_a = reinterpret_cast<T*>(smem);  // parts, aliased by the row tiles
  int* s_meta = reinterpret_cast<int*>(s_a + size_t(nw) * 32 * (kTile + 1));  // (nw, 96)

  const T inv_w = *invw_p;
  const size_t TP = (size_t)Tb * Pb;
  const T X = sl.live ? pts[p] : T(0);
  const T Y = sl.live ? pts[(size_t)Pb + p] : T(0);
  const T Z = sl.live ? pts[2 * (size_t)Pb + p] : T(0);
  RowTile<T, kTile> rt{s_a + (size_t)sl.warp * 32 * (kTile + 1), s_meta + sl.warp * 96, ug,
                       size_t(K), 1, 0};
  T acc[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  T* part = s_a + (size_t)(gi * tc + ti) * 9 * 32 + lane;
  for (int c = 0; c < sl.nchunk; ++c) {
    const int t = c * tc + ti;
    const bool real = sl.live && t < Tb;
    const size_t ts = (size_t)t * Pb + p;
    const int cam = slot_cam(cam_ids, mask, ts, real);
    T buf[kD];
    const T* cp = cam_row(table, cam, buf);
    const T m = real ? mask[ts] : T(0);
    const T u_obs = real ? uv[ts] : T(0);
    const T v_obs = real ? uv[TP + ts] : T(0);
    Slot<T, NP> o;
    tt_blocks<T, NP>(cp, X, Y, Z, u_obs, v_obs, m, inv_w, f, o);
    if (real) {
#pragma unroll
      for (int k = 0; k < 2 * NP; ++k) jc_out[k * TP + ts] = o.jc[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) jp_out[k * TP + ts] = o.jp[k];
    }

    // Camera-side columns (ba_tt._u_g_contribs) into the camera's row.
    tile_rows(rt, cam);
    if (rt.nd > 0) put_ug<K, NP, 3>(rt, 0, o.jc, o.jc + NP, o.r0, o.r1);  // warp-uniform
    __syncthreads();  // every row tile is flushed: the parts may overwrite it

    // Point-side parts V | g_pt, summed over t in order.
    put_point_parts(part, o);
    __syncthreads();
    add_parts(acc, s_a, sl, tc, Tb, c);
    if (c + 1 < sl.nchunk) __syncthreads();  // the parts are read before the next tiles
  }
  if (ti == 0 && sl.live) {
#pragma unroll
    for (int k = 0; k < 6; ++k) v6_out[(size_t)k * Pb + p] = acc[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) gpt_out[(size_t)k * Pb + p] = acc[6 + k];
  }
}

// ---------------------------------------------------------------- B13 ---
// Slot-major, B12's camera columns without tt_blocks and without a
// per-point sum (V^-1 is an input): each lane reads its slot's jc/jp (read
// before the camera is known, dropped for padding, whose planes may hold
// NaN), cam_ids / mask and its point's V^-1 (every warp of a group reads
// the same six values, which L1 serves), forms its W and W V^-1 factors
// (slot.cuh w_factors) and puts its n_triu coupling columns into the warp's
// row tile of its camera (36 / 55 / 78 columns at np 8 / 10 / 12 flush 2 / 2
// / 3 times).  The warps never meet at a barrier.  Shared memory: the warps'
// (32, kTile + 1) row tiles and their meta; one memory mode (a block-shared
// (C, n_triu) tile would hold 36,864 entries at C = 1024, and B12's (C, K)
// tile measured slower, PERF.md).
template <typename T>
constexpr size_t tt_coupling_smem(int tc, int ng) {
  const size_t nw = size_t(tc) * ng;
  return nw * 32 * (kTile + 1) * sizeof(T) + nw * 96 * sizeof(int);
}

template <typename T, int NP>
__global__ void __launch_bounds__(sizeof(T) == 4 ? 512 : 256)  // tt_lin_threads<T>()
tt_coupling_kernel(const int* __restrict__ cam_ids, const T* __restrict__ mask,
                   const T* __restrict__ jc, const T* __restrict__ jp,
                   const T* __restrict__ vinv, T* __restrict__ out, int C, int Tb, int Pb,
                   int tc, int ng) {
  constexpr int NT = NP * (NP + 1) / 2;  // out is (C, NT)
  extern __shared__ __align__(16) unsigned char smem[];
  const SlotLane sl = slot_lane(tc, ng, Tb, Pb);
  const int nw = tc * ng;
  T* s_v = reinterpret_cast<T*>(smem);  // (nw, 32, kTile + 1) row tiles
  int* s_meta = reinterpret_cast<int*>(s_v + size_t(nw) * 32 * (kTile + 1));  // (nw, 96)
  const int p = sl.p;
  const size_t TP = (size_t)Tb * Pb;
  T vi[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) vi[k] = sl.live ? vinv[(size_t)k * Pb + p] : T(0);
  RowTile<T, kTile> rt{s_v + (size_t)sl.warp * 32 * (kTile + 1), s_meta + sl.warp * 96, out,
                       size_t(NT), 1, 0};
  for (int c = 0; c < sl.nchunk; ++c) {
    const int t = c * tc + sl.ti;
    if (t >= Tb) break;  // warp-uniform
    const size_t ts = (size_t)t * Pb + p;
    T j[2 * NP], q[6];
#pragma unroll
    for (int k = 0; k < 2 * NP; ++k) j[k] = sl.live ? jc[k * TP + ts] : T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = sl.live ? jp[k * TP + ts] : T(0);
    const int cam = slot_cam(cam_ids, mask, ts, sl.live);
    tile_rows(rt, cam);
    if (rt.nd == 0) continue;  // warp-uniform
    if (cam < 0) {
#pragma unroll
      for (int k = 0; k < 2 * NP; ++k) j[k] = T(0);
#pragma unroll
      for (int k = 0; k < 6; ++k) q[k] = T(0);
    }
    T wl[3][NP], wv[3][NP];
    w_factors(j, j + NP, q, vi, wl, wv);
    put_coupling<NT, NP, 3>(rt, 0, wl, wv);
  }
}

// ---------------------------------------------------------------- B14 ---
// Slot-major, B2's phase 1 (wtt_kernels.cuh coupling_kernel) without y and
// phase 2: each lane reads its slot's cam_ids / mask, jc/jp (read before the
// camera is known, dropped for padding) and the x row of its camera (zeros
// for padding), and forms its part jp[l] s0 + jp[3 + l] s1; lane p of the
// group's warp 0 adds the Tb parts in slot order.  No per-camera output, so
// no atomics and no row tile.  Shared memory: the (ng, tc, 3, 32) parts.
constexpr int kTtWtThreads = 512;

template <typename T>
constexpr size_t tt_wt_smem(int tc, int ng) {
  return size_t(tc) * ng * 3 * 32 * sizeof(T);
}

template <typename T, int NP>
__global__ void __launch_bounds__(kTtWtThreads)
tt_wt_times_kernel(const T* __restrict__ x, const int* __restrict__ cam_ids,
                   const T* __restrict__ mask, const T* __restrict__ jc,
                   const T* __restrict__ jp, T* __restrict__ out, int C, int Tb, int Pb,
                   int tc, int ng) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SlotLane sl = slot_lane(tc, ng, Tb, Pb);
  const int lane = sl.lane, gi = sl.gi, ti = sl.ti, p = sl.p;
  T* s_part = reinterpret_cast<T*>(smem);
  T* part = s_part + (size_t)(gi * tc + ti) * 3 * 32 + lane;
  const size_t TP = (size_t)Tb * Pb;
  T wtx[3] = {T(0), T(0), T(0)};
  for (int c = 0; c < sl.nchunk; ++c) {
    const int t = c * tc + ti;
    const bool real = sl.live && t < Tb;
    const size_t ts = (size_t)t * Pb + p;
    T j[2 * NP], q[6];
#pragma unroll
    for (int k = 0; k < 2 * NP; ++k) j[k] = real ? jc[k * TP + ts] : T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = real ? jp[k * TP + ts] : T(0);
    const int cam = slot_cam(cam_ids, mask, ts, real);
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const T xg = cam >= 0 ? __ldg(x + (size_t)cam * NP + i) : T(0);
      s0 += j[i] * xg;
      s1 += j[NP + i] * xg;
    }
#pragma unroll
    for (int l = 0; l < 3; ++l) part[l * 32] = cam >= 0 ? q[l] * s0 + q[3 + l] * s1 : T(0);
    __syncthreads();
    add_parts(wtx, s_part, sl, tc, Tb, c);
    if (c + 1 < sl.nchunk) __syncthreads();  // the parts are read before the next chunk's
  }
  if (ti == 0 && sl.live) {
#pragma unroll
    for (int l = 0; l < 3; ++l) out[(size_t)l * Pb + p] = wtx[l];
  }
}

// ---------------------------------------------------------------- B15 ---
// Slot-major (slot.cuh slot_lane): a warp holds slot t of 32 consecutive
// point columns, tc warps of a 32-point group walk its track in chunks, ng
// groups share a block.  No per-point sum crosses slots, so the warps are
// independent; each keeps its points' y in registers over the slots it
// walks.  A lane forms z = jc (jp y) of its slot, and the warp's row tile
// groups its lanes by camera (__match_any_sync) and sends one atomic per
// (distinct camera, column): the points of a bucket are sorted by their
// least camera and a track's slots by camera, so the 32 lanes of a slot see
// one camera or a few.  With ST those atomics go to a block-shared (C, NP)
// tile instead, zeroed first and flushed into `out` once per block with one
// global atomic per nonzero entry: it spares the output's few cache lines
// the atomics of every warp, and costs C * NP shared entries to zero and to
// read per block (the wrapper picks it for small camera counts, PERF.md).
constexpr int kTtWThreads = 512;

template <typename T, int NP>
constexpr size_t tt_w_smem(int tc, int ng) {  // the warps' row tiles and meta
  const size_t nw = size_t(tc) * ng;
  return nw * 32 * (NP + 1) * sizeof(T) + nw * 96 * sizeof(int);
}

template <typename T, int NP, bool ST>
__global__ void __launch_bounds__(kTtWThreads)
tt_w_times_kernel(const T* __restrict__ y, const int* __restrict__ cam_ids,
                  const T* __restrict__ mask, const T* __restrict__ jc,
                  const T* __restrict__ jp, T* __restrict__ out, int C, int Tb, int Pb,
                  int tc, int ng) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SlotLane sl = slot_lane(tc, ng, Tb, Pb);
  const int nw = tc * ng;
  T* s_v = reinterpret_cast<T*>(smem);  // (nw, 32, NP + 1) row tiles
  int* s_meta = reinterpret_cast<int*>(s_v + size_t(nw) * 32 * (NP + 1));  // (nw, 96)
  T* s_acc = reinterpret_cast<T*>(s_meta + nw * 96);  // ST: (C, NP)
  if constexpr (ST) {
    for (int i = threadIdx.x; i < C * NP; i += blockDim.x) s_acc[i] = T(0);
    __syncthreads();
  }
  const int p = sl.p;
  const T y0 = sl.live ? y[p] : T(0);
  const T y1 = sl.live ? y[(size_t)Pb + p] : T(0);
  const T y2 = sl.live ? y[2 * (size_t)Pb + p] : T(0);
  const size_t TP = (size_t)Tb * Pb;
  RowTile<T, NP> rt{s_v + (size_t)sl.warp * 32 * (NP + 1), s_meta + sl.warp * 96,
                    ST ? s_acc : out, size_t(NP), 1, 0};
  for (int c = 0; c < sl.nchunk; ++c) {
    const int t = c * tc + sl.ti;
    if (t >= Tb) break;  // warp-uniform
    const size_t ts = (size_t)t * Pb + p;
    const int cam = slot_cam(cam_ids, mask, ts, sl.live);
    T q[6], j[2 * NP];
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = cam >= 0 ? jp[k * TP + ts] : T(0);
#pragma unroll
    for (int k = 0; k < 2 * NP; ++k) j[k] = cam >= 0 ? jc[k * TP + ts] : T(0);
    tile_rows(rt, cam);
    if (rt.nd == 0) continue;  // warp-uniform
    const T s0 = q[0] * y0 + q[1] * y1 + q[2] * y2;
    const T s1 = q[3] * y0 + q[4] * y1 + q[5] * y2;
#pragma unroll
    for (int i = 0; i < NP; ++i) tile_put<NP>(rt, i, j[i] * s0 + j[NP + i] * s1, 0);
  }
  if constexpr (ST) {
    __syncthreads();
    for (int i = threadIdx.x; i < C * NP; i += blockDim.x) {
      const T v = s_acc[i];
      if (v != T(0)) atomicAdd(out + i, v);
    }
  }
}

// ---------------------------------------------------------------- B16 ---
template <typename T>
__global__ void __launch_bounds__(kBlock)
tt_cost_kernel(const T* __restrict__ table, const int* __restrict__ cam_ids,
               const T* __restrict__ pts, const T* __restrict__ uv,
               const T* __restrict__ mask, const T* __restrict__ invw_p,
               T* __restrict__ lane, int C, int Tb, int Pb, int loss) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= Pb) return;
  const T inv_w = *invw_p;
  const size_t TP = (size_t)Tb * Pb;
  const T X = pts[p], Y = pts[(size_t)Pb + p], Z = pts[2 * (size_t)Pb + p];
  // Only the whitened residual of the slot formulas is used; the compiler
  // drops the Jacobian terms.
  const LinFlags f{0, loss, 1, 1, 0, 0};
  T total = T(0);
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = (size_t)t * Pb + p;
    const int c = slot_cam(cam_ids, mask, ts, true);
    T buf[kD];
    Slot<T, 8> o;
    tt_blocks<T, 8>(cam_row(table, c, buf), X, Y, Z, uv[ts], uv[TP + ts], mask[ts],
                    inv_w, f, o);
    const T part = o.r0 * o.r0 + o.r1 * o.r1;
    total += part;
  }
  lane[p] = total;
}

// ---------------------------------------------------------------- host --
// B12 at the wrapper's geometry.
template <typename T, int NP>
int cam_normal_launch(const void* table, const void* cam_ids, const void* pts,
                      const void* uv, const void* mask, const void* inv_w,
                      void* jc, void* jp, void* v6, void* gpt, void* ug, int C,
                      int Tb, int Pb, LinFlags f, int tc, int ng, int smem,
                      cudaStream_t stream) {
  auto kernel = tt_cam_normal_kernel<T, NP>;
  dim3 grid, block;
  const int e = slot_launch(kernel, tt_lin_threads<T>(), tt_lin_smem<T>(tc, ng), tc, ng,
                            smem, 1, Pb, grid, block);
  if (e) return e;
  kernel<<<grid, block, smem, stream>>>(
      (const T*)table, (const int*)cam_ids, (const T*)pts, (const T*)uv,
      (const T*)mask, (const T*)inv_w, (T*)jc, (T*)jp, (T*)v6, (T*)gpt, (T*)ug,
      C, Tb, Pb, f, tc, ng);
  return (int)cudaGetLastError();
}

// B13 at the wrapper's geometry.
template <typename T, int NP>
int coupling_launch(const void* cam_ids, const void* mask, const void* jc,
                    const void* jp, const void* vinv, void* out, int C, int Tb,
                    int Pb, int tc, int ng, int smem, cudaStream_t stream) {
  auto kernel = tt_coupling_kernel<T, NP>;
  dim3 grid, block;
  const int e = slot_launch(kernel, tt_lin_threads<T>(), tt_coupling_smem<T>(tc, ng), tc, ng,
                            smem, 1, Pb, grid, block);
  if (e) return e;
  kernel<<<grid, block, smem, stream>>>((const int*)cam_ids, (const T*)mask, (const T*)jc,
                                        (const T*)jp, (const T*)vinv, (T*)out, C, Tb, Pb, tc,
                                        ng);
  return (int)cudaGetLastError();
}

// B14 at the wrapper's geometry.
template <typename T, int NP>
int wt_times_launch(const void* x, const void* cam_ids, const void* mask,
                    const void* jc, const void* jp, void* out, int C, int Tb,
                    int Pb, int tc, int ng, int smem, cudaStream_t stream) {
  auto kernel = tt_wt_times_kernel<T, NP>;
  dim3 grid, block;
  const int e = slot_launch(kernel, kTtWtThreads, tt_wt_smem<T>(tc, ng), tc, ng, smem, 1,
                            Pb, grid, block);
  if (e) return e;
  kernel<<<grid, block, smem, stream>>>((const T*)x, (const int*)cam_ids, (const T*)mask,
                                        (const T*)jc, (const T*)jp, (T*)out, C, Tb, Pb, tc,
                                        ng);
  return (int)cudaGetLastError();
}

// B15 at the wrapper's geometry; `tile`: the bytes of the block-shared
// (C, NP) tile (ST), 0 for atomics straight into `out`.
template <typename T, int NP, bool ST>
int w_times_launch(const void* y, const void* cam_ids, const void* mask, const void* jc,
                   const void* jp, void* out, int C, int Tb, int Pb, int tc, int ng,
                   int smem, int tile, cudaStream_t stream) {
  auto kernel = tt_w_times_kernel<T, NP, ST>;
  if (size_t(tile) != (ST ? size_t(C) * NP * sizeof(T) : 0)) return kErrGeom;
  dim3 grid, block;
  const int e = slot_launch(kernel, kTtWThreads, tt_w_smem<T, NP>(tc, ng) + tile, tc, ng,
                            smem, 1, Pb, grid, block);
  if (e) return e;
  kernel<<<grid, block, smem, stream>>>((const T*)y, (const int*)cam_ids, (const T*)mask,
                                        (const T*)jc, (const T*)jp, (T*)out, C, Tb, Pb, tc,
                                        ng);
  return (int)cudaGetLastError();
}

template <typename T>
int cost_launch(const void* table, const void* cam_ids, const void* pts,
                const void* uv, const void* mask, const void* inv_w, void* lane,
                int C, int Tb, int Pb, int loss, cudaStream_t stream) {
  tt_cost_kernel<T><<<grid_of(Pb, 1), kBlock, 0, stream>>>(
      (const T*)table, (const int*)cam_ids, (const T*)pts, (const T*)uv,
      (const T*)mask, (const T*)inv_w, (T*)lane, C, Tb, Pb, loss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tc, ng, smem: the slot-major geometry (ops/_wtt_common.py slot_geometry
// "tt_lin").
int tt_cam_normal(int dtype, int np, const void* table, const void* cam_ids,
                  const void* pts, const void* uv, const void* mask,
                  const void* inv_w, void* jc, void* jp, void* v6, void* gpt,
                  void* ug, int C, int Tb, int Pb, int loss, int focal,
                  int points, int dist, int pp, int tc, int ng, int smem, void* stream) {
  if (Pb == 0 || Tb == 0) return 0;
  const LinFlags f{0, loss, focal, points, dist, pp};
  NP_DISPATCH(dtype, np, (cam_normal_launch<T, NP>(table, cam_ids, pts, uv, mask, inv_w, jc,
                                                   jp, v6, gpt, ug, C, Tb, Pb, f, tc, ng, smem,
                                                   (cudaStream_t)stream)));
}

// tc, ng, smem: the slot-major geometry (ops/_wtt_common.py slot_geometry
// "tt_coupling").
int tt_coupling(int dtype, int np, const void* cam_ids, const void* mask,
                const void* jc, const void* jp, const void* vinv, void* out,
                int C, int Tb, int Pb, int tc, int ng, int smem, void* stream) {
  if (Pb == 0 || Tb == 0) return 0;
  NP_DISPATCH(dtype, np, (coupling_launch<T, NP>(cam_ids, mask, jc, jp, vinv, out, C, Tb,
                                                 Pb, tc, ng, smem, (cudaStream_t)stream)));
}

// tc, ng, smem: the slot-major geometry (ops/_wtt_common.py slot_geometry
// "tt_wt").
int tt_wt_times(int dtype, int np, const void* x, const void* cam_ids,
                const void* mask, const void* jc, const void* jp, void* out,
                int C, int Tb, int Pb, int tc, int ng, int smem, void* stream) {
  if (Pb == 0) return 0;
  NP_DISPATCH(dtype, np, (wt_times_launch<T, NP>(x, cam_ids, mask, jc, jp, out, C, Tb, Pb,
                                                 tc, ng, smem, (cudaStream_t)stream)));
}

// tc, ng, smem: the slot-major geometry (ops/_wtt_common.py slot_geometry
// "tt_w"); tile: the bytes of the block-shared (C, NP) tile, 0 for none.
int tt_w_times(int dtype, int np, const void* y, const void* cam_ids,
               const void* mask, const void* jc, const void* jp, void* out,
               int C, int Tb, int Pb, int tc, int ng, int smem, int tile, void* stream) {
  if (Pb == 0 || Tb == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  NP_DISPATCH(dtype, np,
              (tile ? w_times_launch<T, NP, true>(y, cam_ids, mask, jc, jp, out, C, Tb, Pb, tc,
                                                  ng, smem, tile, s)
                    : w_times_launch<T, NP, false>(y, cam_ids, mask, jc, jp, out, C, Tb, Pb,
                                                   tc, ng, smem, tile, s)));
}

int tt_cost(int dtype, const void* table, const void* cam_ids, const void* pts,
            const void* uv, const void* mask, const void* inv_w, void* lane,
            int C, int Tb, int Pb, int loss, void* stream) {
  if (Pb == 0) return 0;
  if (dtype == 0)
    return cost_launch<float>(table, cam_ids, pts, uv, mask, inv_w, lane, C, Tb, Pb, loss,
                              (cudaStream_t)stream);
  if (dtype == 1)
    return cost_launch<double>(table, cam_ids, pts, uv, mask, inv_w, lane, C, Tb, Pb, loss,
                               (cudaStream_t)stream);
  return kErrDtype;
}

}  // extern "C"
