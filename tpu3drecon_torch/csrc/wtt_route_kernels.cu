// Kernels of the wtt engine's unfused and one-hot routes for Hopper (sm_90a).
//
// Hand-written CUDA C++ counterparts of four Pallas kernels
// (tpu3drecon/ops/pallas/):
//
//   wtt_cam_planes       <- wtt_linearize.py:wtt_cam_planes_idx   (_cam_planes_kernel)  B7
//   wtt_contrib          <- wtt_linearize.py:wtt_contrib_rows_idx (_contrib_kernel)     B8
//   wtt_w_rows           <- wtt_matvec.py:wtt_w_rows_idx          (_w_kernel_idx)       B5
//   wtt_coupling_onehot  <- wtt_matvec.py:wtt_coupling_rows_fused (_matvec_kernel)      B6
//
// B7 and B8 are the unfused linearization's two halves around the PyTorch
// Jacobian planes: B7 selects each slot's window camera row (one thread per
// slot, a copy with no reduction: bound by the 19 output planes it writes);
// B8 is kernel B1's pass 2 on its own, reading jc/jp/r/v_inv from device
// memory.  B8 runs slot-major on B1's grid (one lane per track slot, so a
// bucket runs on Tb * Pc threads, not Pc, and every slot's wcam -> jc/jp/r
// loads are in flight at once); its u | g | coupling [| od] columns leave
// through the warp's row tile, one atomic per (distinct row, column), with
// B1's column code (slot.cuh put_ug / put_coupling) and a copy of its od
// step.  In one thread per point it was bound by the long
// buckets' few threads, their serial load chains and per-lane atomics from
// warps of mixed rows.  B5 is kernel B2's phase 2 on its own (W y rows, the
// Schur rhs when the linearization is unfused), one thread per point.
//
// B6 is B2's whole product with each slot's window row taken from the dense
// one-hot column instead of wcam.  It is B2's slot-major kernel itself
// (wtt_kernels.cuh coupling_kernel, included here and instantiated in this
// source at TERMS = 3, so it compiles beside wtt_kernels.cu), with the row
// source OnehotRows: a warp holds slot t of 32 consecutive point columns,
// whose one-hot entries of a window row are 32 contiguous entries, and
// reads its (W, 32) block with vector loads of up to 16 bytes (8 loads per
// lane at int8 and W = 128); each column's first nonzero row is its slot's
// row, and an all-zero column is a padded slot (no row, exact zeros).
// Phases 1 and 2 are B2's: x read from device memory, rows out through the
// warp's row tile, one memory mode.  B6 reads W one-hot entries per slot on
// top of B2's jc/jp stream, so its bound is about twice B2's at int8.
//
// The TPU kernels rebuild one-hot tiles and select or reduce with
// bf16-split MXU dots; none of that carries over.  Every value is the same
// product and sum as the plain versions (ops/wtt_linearize.py,
// ops/wtt_matvec.py); only the order of the atomic window-row sums differs,
// so B5, B6 and B8 vary in the last bits from run to run and B7 is exact.
// Per-slot formulas and the row reduction come from slot.cuh, shared with
// B1-B4 (wtt_kernels.cu).  B5, B6 and B8 reduce into device memory
// directly, as B1 and B2 do.  Every C entry returns cudaGetLastError()
// after its launch, or a negative code of common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "slot.cuh"
#include "wtt_kernels.cuh"

using namespace tpu3drecon;

namespace {

// ---------------------------------------------------------------- B7 ----
// out (G, 19, N) = the window row tw[g, wcam[g, n]] of each slot n, exact
// zeros for padding (-1).
template <typename T>
__global__ void __launch_bounds__(kBlock)
cam_planes_kernel(const int16_t* __restrict__ wcam, const T* __restrict__ tw,
                  T* __restrict__ out, int N, int W) {
  const int g = blockIdx.y;
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= N) return;
  const int w = wcam[(size_t)g * N + n];
  const T* row = tw + ((size_t)g * W + (w >= 0 ? w : 0)) * kD;
  T* o = out + (size_t)g * kD * N + n;
#pragma unroll
  for (int d = 0; d < kD; ++d) o[(size_t)d * N] = w >= 0 ? row[d] : T(0);
}

// ---------------------------------------------------------------- B5 ----
// W y rows (G, NP, W): z = jc (jp y) of every slot reduced into its window
// row; y is (3, G, Pc).
template <typename T, int NP>
__global__ void __launch_bounds__(kBlock)
w_rows_kernel(const T* __restrict__ y, const int16_t* __restrict__ wcam,
              const T* __restrict__ jc, const T* __restrict__ jp,
              T* __restrict__ out, int G, int Tb, int Pc, int W) {
  const int g = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const bool live = p < Pc;
  T* out_g = out + (size_t)g * NP * W;  // (NP, W)
  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;
  const size_t pp = (size_t)g * Pc + p;
  const T y0 = live ? y[pp] : T(0);
  const T y1 = live ? y[GP + pp] : T(0);
  const T y2 = live ? y[2 * GP + pp] : T(0);
  for (int t = 0; t < Tb; ++t) {
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    w_slot<T, NP>(out_g, live ? int(wcam[ts]) : -1, W, jc, jp, ts, GTP, y0, y1, y2);
  }
}

// ---------------------------------------------------------------- B8 ----
// Slot-major, B1's pass 2 on its own (wtt_kernels.cuh lin_kernel): each lane
// reads wcam of its slot and, while the row is read, its jc/jp/r (guarded by
// the slot's existence only; a padded slot's planes, which may hold NaN,
// are then dropped for exact zeros), forms its W and W V^-1 factors with
// SJ, and puts u | g [| coupling] into its window row's row tile in B1's
// column order.  No per-point sum: V^-1 is an input, read by each lane of
// the point.  Without OD the warps never meet at a barrier.
//
// With OD (want_od, wtt_linearize.py:163-190) the np^2 band pair columns
// follow, B1's od step on B8's inputs: od[i * np + j] of window row w sums
// wv(slot t-1)[i] wl(slot t)[j] over the adjacent track slots on rows w and
// w + 1.  A chunk's slots leave their W V^-1 factors and rows in their
// group's (tc + 1, 3 np, 32) and (tc + 1, 32) blocks of s_wv and s_w at
// index ti + 1, and lane ti = 0 puts those of the slot before the chunk at
// index 0, recomputed from its jc/jp (zeros where that slot is padded:
// unlike the planes B1 wrote itself, B8's may hold NaN there); after a
// barrier slot t reads slot t-1's factor.  A padded previous slot (-1)
// forms no pair, so Tb = 1 gives all-zero od columns.  (This step stays a
// copy of B1's: shared, its select raised B1 od's spills.)

// Shared memory of B8 (elements of T, then ints): the warps' (32, kTile + 1)
// row tiles; with OD the (ng, tc + 1, 3 np, 32) W V^-1 factors and (ng, tc +
// 1, 32) window rows of the chunk's slots and the one before it; the warps'
// (3, 32) tile meta.
template <typename T, int NP, bool OD>
constexpr size_t contrib_smem(int tc, int ng) {
  const size_t nw = size_t(tc) * ng;
  const size_t vals = nw * 32 * (kTile + 1) + (OD ? size_t(ng) * (tc + 1) * 3 * NP * 32 : 0);
  const size_t ints = (OD ? size_t(ng) * (tc + 1) * 32 : 0) + nw * 96;
  return vals * sizeof(T) + ints * sizeof(int);
}

template <typename T, int NP, bool SJ, bool OD>
__global__ void __launch_bounds__(sizeof(T) == 4 ? 512 : 256)  // lin_threads<T>()
contrib_kernel(const int16_t* __restrict__ wcam, const T* __restrict__ jc,
               const T* __restrict__ jp, const T* __restrict__ r,
               const T* __restrict__ vinv, T* __restrict__ rows, int G, int Tb, int Pc,
               int W, int tc, int ng) {
  constexpr int NT = NP * (NP + 1) / 2;
  constexpr int K0 = NT + NP + (SJ ? NT : 0);  // u | g [| coupling]
  constexpr int K = K0 + (OD ? NP * NP : 0);
  extern __shared__ __align__(16) unsigned char smem[];
  const SlotLane sl = slot_lane(tc, ng, Tb, Pc);
  const int nw = tc * ng;
  T* s_v = reinterpret_cast<T*>(smem);                  // row tiles
  T* s_wv = s_v + size_t(nw) * 32 * (kTile + 1);        // OD: (ng, tc + 1, 3 NP, 32)
  int* s_w = reinterpret_cast<int*>(s_wv + (OD ? ng * (tc + 1) * 3 * NP * 32 : 0));
  int* s_meta = s_w + (OD ? ng * (tc + 1) * 32 : 0);   // (nw, 96)

  const int lane = sl.lane, gi = sl.gi, ti = sl.ti, g = sl.g, p = sl.p;
  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;
  T vi[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) vi[k] = SJ && sl.live ? vinv[k * GP + (size_t)g * Pc + p] : T(0);
  RowTile<T, kTile> rt{s_v + (size_t)sl.warp * 32 * (kTile + 1), s_meta + sl.warp * 96,
                       rows + (size_t)g * W * K, size_t(K), 1, 0};
  for (int c = 0; c < sl.nchunk; ++c) {
    const int t = c * tc + ti;
    const bool real = sl.live && t < Tb;
    const size_t ts = ((size_t)g * Tb + t) * Pc + p;
    const int w = real ? int(wcam[ts]) : -1;
    T j[2 * NP], q[6];
#pragma unroll
    for (int k = 0; k < 2 * NP; ++k) j[k] = real ? jc[k * GTP + ts] : T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = SJ && real ? jp[k * GTP + ts] : T(0);
    T r0 = real ? r[ts] : T(0);
    T r1 = real ? r[GTP + ts] : T(0);
    if (w < 0) {
#pragma unroll
      for (int k = 0; k < 2 * NP; ++k) j[k] = T(0);
#pragma unroll
      for (int k = 0; k < 6; ++k) q[k] = T(0);
      r0 = r1 = T(0);
    }
    T wl[3][NP], wv[3][NP];
    if constexpr (SJ) w_factors(j, j + NP, q, vi, wl, wv);
    if constexpr (OD) {
      const size_t base = (size_t)gi * (tc + 1);
#pragma unroll
      for (int l = 0; l < 3; ++l)
#pragma unroll
        for (int i = 0; i < NP; ++i)
          s_wv[((base + ti + 1) * 3 * NP + l * NP + i) * 32 + lane] = wv[l][i];
      s_w[(base + ti + 1) * 32 + lane] = w;
      if (ti == 0) {  // the slot before this chunk
        int wp = -1;
        if (c > 0 && sl.live) {
          const size_t tsp = ((size_t)g * Tb + c * tc - 1) * Pc + p;
          wp = int(wcam[tsp]);
          T jcp[2 * NP], jpp[6], wlp[3][NP], wvp[3][NP];
#pragma unroll
          for (int k = 0; k < 2 * NP; ++k) jcp[k] = wp >= 0 ? jc[k * GTP + tsp] : T(0);
#pragma unroll
          for (int k = 0; k < 6; ++k) jpp[k] = wp >= 0 ? jp[k * GTP + tsp] : T(0);
          w_factors(jcp, jcp + NP, jpp, vi, wlp, wvp);
#pragma unroll
          for (int l = 0; l < 3; ++l)
#pragma unroll
            for (int i = 0; i < NP; ++i)
              s_wv[(base * 3 * NP + l * NP + i) * 32 + lane] = wvp[l][i];
        }
        s_w[base * 32 + lane] = wp;
      }
    }
    tile_rows(rt, w);
    if (rt.nd > 0) {  // warp-uniform
      const int col = put_ug<K0, NP, 3>(rt, 0, j, j + NP, r0, r1);
      if constexpr (SJ) put_coupling<K0, NP, 3>(rt, col, wl, wv);
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
                              wvp[(0 * NP + i) * 32] * wl[0][j] +
                                  wvp[(1 * NP + i) * 32] * wl[1][j] +
                                  wvp[(2 * NP + i) * 32] * wl[2][j],
                              K0);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- host --
template <typename T>
int cam_planes_launch(const void* wcam, const void* tw, void* out, int G, int N,
                      int W, cudaStream_t stream) {
  cam_planes_kernel<T><<<grid_of(N, G), kBlock, 0, stream>>>(
      (const int16_t*)wcam, (const T*)tw, (T*)out, N, W);
  return (int)cudaGetLastError();
}

// B8 at the wrapper's geometry.
template <typename T, int NP, bool SJ, bool OD>
int contrib_launch(const void* wcam, const void* jc, const void* jp, const void* r,
                   const void* vinv, void* rows, int G, int Tb, int Pc, int W, int tc, int ng,
                   int smem, cudaStream_t stream) {
  auto kernel = contrib_kernel<T, NP, SJ, OD>;
  dim3 grid, block;
  const int e = slot_launch(kernel, lin_threads<T>(), contrib_smem<T, NP, OD>(tc, ng), tc, ng,
                            smem, G, Pc, grid, block);
  if (e) return e;
  kernel<<<grid, block, smem, stream>>>((const int16_t*)wcam, (const T*)jc, (const T*)jp,
                                        (const T*)r, (const T*)vinv, (T*)rows, G, Tb, Pc, W,
                                        tc, ng);
  return (int)cudaGetLastError();
}

// B8 with od (which needs use_sj: the C entry checks), with use_sj, or with
// neither.
template <typename T, int NP>
int contrib_variant(const void* wcam, const void* jc, const void* jp, const void* r,
                    const void* vinv, void* rows, int G, int Tb, int Pc, int W, int use_sj,
                    int want_od, int tc, int ng, int smem, cudaStream_t stream) {
  if (want_od)
    return contrib_launch<T, NP, true, true>(wcam, jc, jp, r, vinv, rows, G, Tb, Pc, W, tc,
                                             ng, smem, stream);
  if (use_sj)
    return contrib_launch<T, NP, true, false>(wcam, jc, jp, r, vinv, rows, G, Tb, Pc, W, tc,
                                              ng, smem, stream);
  return contrib_launch<T, NP, false, false>(wcam, jc, jp, r, vinv, rows, G, Tb, Pc, W, tc, ng,
                                             smem, stream);
}

template <typename T, int NP>
int w_rows_launch(const void* y, const void* wcam, const void* jc, const void* jp,
                  void* out, int G, int Tb, int Pc, int W, cudaStream_t stream) {
  w_rows_kernel<T, NP><<<grid_of(Pc, G), kBlock, 0, stream>>>(
      (const T*)y, (const int16_t*)wcam, (const T*)jc, (const T*)jp, (T*)out, G,
      Tb, Pc, W);
  return (int)cudaGetLastError();
}

// B6: B2's kernel (wtt_kernels.cuh) with each slot's row decoded from the
// one-hot in `vec`-byte loads; `vec` must be the width that the one-hot's
// alignment allows (onehot_vec), as the wrapper computed it.
template <typename T, typename OH, int NP>
int onehot_launch(const void* xw_t, const void* onehot, const void* jc, const void* jp,
                  const void* vinv, void* out, int G, int Tb, int Pc, int W, int tc,
                  int ng, int smem, int vec, cudaStream_t stream) {
  if (vec != onehot_vec(onehot, Pc, sizeof(OH))) return kErrGeom;
  return coupling_launch_rows<T, NP, 3>(xw_t, OnehotRows<OH>{(const OH*)onehot, Tb, Pc, W, vec},
                                        jc, jp, vinv, out, G, Tb, Pc, W, tc, ng, smem, stream);
}

}  // namespace

extern "C" {

int wtt_cam_planes(int dtype, const void* wcam, const void* tw, void* out, int G,
                   int N, int W, void* stream) {
  if (G == 0 || N == 0) return 0;
  if (dtype == 0)
    return cam_planes_launch<float>(wcam, tw, out, G, N, W, (cudaStream_t)stream);
  if (dtype == 1)
    return cam_planes_launch<double>(wcam, tw, out, G, N, W, (cudaStream_t)stream);
  return kErrDtype;
}

// tc, ng, smem: the slot-major geometry (ops/_wtt_common.py slot_geometry
// "contrib", with want_od).
int wtt_contrib(int dtype, int np, const void* wcam, const void* jc, const void* jp,
                const void* r, const void* vinv, void* rows, int G, int Tb, int Pc,
                int W, int use_sj, int want_od, int tc, int ng, int smem, void* stream) {
  if (want_od && !use_sj) return kErrOd;
  if (G == 0 || Pc == 0) return 0;
  NP_DISPATCH(dtype, np, (contrib_variant<T, NP>(wcam, jc, jp, r, vinv, rows, G, Tb, Pc, W,
                                                 use_sj, want_od, tc, ng, smem,
                                                 (cudaStream_t)stream)));
}

int wtt_w_rows(int dtype, int np, const void* y, const void* wcam, const void* jc,
               const void* jp, void* out, int G, int Tb, int Pc, int W, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  NP_DISPATCH(dtype, np, (w_rows_launch<T, NP>(y, wcam, jc, jp, out, G, Tb, Pc, W,
                                               (cudaStream_t)stream)));
}

// onehot_float: 0 = int8 one-hot, 1 = one-hot in the data's float type.
// tc, ng, smem: the slot-major geometry (ops/_wtt_common.py slot_geometry
// "onehot"); vec: the one-hot vector width (onehot_vector_bytes).
int wtt_coupling_onehot(int dtype, int np, int onehot_float, const void* xw_t,
                        const void* onehot, const void* jc, const void* jp,
                        const void* vinv, void* out, int G, int Tb, int Pc, int W,
                        int tc, int ng, int smem, int vec, void* stream) {
  if (G == 0 || Pc == 0) return 0;
  if (onehot_float != 0 && onehot_float != 1) return kErrDtype;
  const cudaStream_t s = (cudaStream_t)stream;
  NP_DISPATCH(dtype, np,
              (onehot_float ? onehot_launch<T, T, NP>(xw_t, onehot, jc, jp, vinv, out, G, Tb,
                                                      Pc, W, tc, ng, smem, vec, s)
                            : onehot_launch<T, int8_t, NP>(xw_t, onehot, jc, jp, vinv, out,
                                                           G, Tb, Pc, W, tc, ng, smem, vec,
                                                           s)));
}

}  // extern "C"
