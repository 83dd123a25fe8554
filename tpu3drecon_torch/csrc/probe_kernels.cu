// Kernels of the probes in tpu3drecon_torch/experiments/, in a source of their
// own so that the solver's kernels stay as they are.
//
//   probe_coupling     <- experiments/tpu_index_matvec2.py (E1): a copy of
//                         kernel B2's earlier design, one thread per point
//                         column (float, np = 8; wtt_kernels.cuh
//                         coupling_kernel is now slot-major), whose
//                         launch shape and work are template
//                         flags: BS threads per block (128, 256, 512);
//                         GATHER false reads window row 0 for every live
//                         slot (E1's "const" one-hot build: no camera-row
//                         gather, and one row for every atomic); ATOMIC
//                         false sums each thread's z values into registers
//                         and stores them once into a (G, NP, Pc) scratch
//                         instead of reducing them into the window rows.
//                         The last two are timing-only: their outputs are
//                         not B2's.
//   probe_bits_expand  <- experiments/tpu_bits_expand_probe.py (E4): a
//                         (rows, nbytes) uint8 array expanded into (rows,
//                         8 * nbytes) float {0, 1} planes, one thread per
//                         output.  Layout 0 (A, byte-interleaved): output m
//                         is bit m % 8 of byte m / 8.  Layout 1 (B, bit
//                         plane per tile): output j * nbytes + k is bit j of
//                         byte k.  Both are bound by the bytes they write.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "slot.cuh"

using namespace tpu3drecon;

namespace {

constexpr int kProbeNp = 8;

template <int BS, bool GATHER, bool ATOMIC>
__global__ void __launch_bounds__(BS)
probe_coupling_kernel(const float* __restrict__ xw_t, const int16_t* __restrict__ wcam,
                      const float* __restrict__ jc, const float* __restrict__ jp,
                      const float* __restrict__ vinv, float* __restrict__ out, int G,
                      int Tb, int Pc, int W) {
  constexpr int NP = kProbeNp;
  using T = float;
  const int g = blockIdx.y;
  const int p = blockIdx.x * BS + threadIdx.x;
  const bool live = p < Pc;
  const T* xw_g = xw_t + (size_t)g * NP * W;
  const size_t GP = (size_t)G * Pc, GTP = GP * Tb;
  auto row = [&](size_t ts) {
    const int w = live ? int(wcam[ts]) : -1;
    return (!GATHER && w >= 0) ? 0 : w;
  };

  T wtx[3] = {T(0), T(0), T(0)};
  if (live) {
    for (int t = 0; t < Tb; ++t) {
      const size_t ts = ((size_t)g * Tb + t) * Pc + p;
      wt_slot<T, NP>(xw_g, row(ts), W, jc, jp, ts, GTP, wtx);
    }
  }
  T v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = live ? vinv[k * GP + (size_t)g * Pc + p] : T(0);
  const T y0 = v[0] * wtx[0] + v[1] * wtx[1] + v[2] * wtx[2];
  const T y1 = v[1] * wtx[0] + v[3] * wtx[1] + v[4] * wtx[2];
  const T y2 = v[2] * wtx[0] + v[4] * wtx[1] + v[5] * wtx[2];

  if constexpr (ATOMIC) {
    T* out_g = out + (size_t)g * NP * W;  // (NP, W) rows
    for (int t = 0; t < Tb; ++t) {
      const size_t ts = ((size_t)g * Tb + t) * Pc + p;
      w_slot<T, NP>(out_g, row(ts), W, jc, jp, ts, GTP, y0, y1, y2);
    }
  } else {
    if (!live) return;
    T acc[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[i] = T(0);
    for (int t = 0; t < Tb; ++t) {
      const size_t ts = ((size_t)g * Tb + t) * Pc + p;
      if (row(ts) < 0) continue;
      const T s0p = jp[0 * GTP + ts] * y0 + jp[1 * GTP + ts] * y1 + jp[2 * GTP + ts] * y2;
      const T s1p = jp[3 * GTP + ts] * y0 + jp[4 * GTP + ts] * y1 + jp[5 * GTP + ts] * y2;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        acc[i] += jc[i * GTP + ts] * s0p + jc[(NP + i) * GTP + ts] * s1p;
    }
    float* out_g = out + (size_t)g * NP * Pc;  // (NP, Pc) scratch
#pragma unroll
    for (int i = 0; i < NP; ++i) out_g[(size_t)i * Pc + p] = acc[i];
  }
}

template <int BS, bool GATHER, bool ATOMIC>
int probe_launch(const void* xw_t, const void* wcam, const void* jc, const void* jp,
                 const void* vinv, void* out, int G, int Tb, int Pc, int W,
                 cudaStream_t stream) {
  const dim3 grid((Pc + BS - 1) / BS, G);
  probe_coupling_kernel<BS, GATHER, ATOMIC><<<grid, BS, 0, stream>>>(
      (const float*)xw_t, (const int16_t*)wcam, (const float*)jc, (const float*)jp,
      (const float*)vinv, (float*)out, G, Tb, Pc, W);
  return (int)cudaGetLastError();
}

template <int LAYOUT>
__global__ void __launch_bounds__(kBlock)
bits_expand_kernel(const uint8_t* __restrict__ packed, float* __restrict__ out, int rows,
                   int nbytes) {
  const int width = 8 * nbytes;
  const size_t i = (size_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= (size_t)rows * width) return;
  const int r = int(i / width), m = int(i % width);
  const int byte = LAYOUT == 0 ? m / 8 : m % nbytes;
  const int bit = LAYOUT == 0 ? m % 8 : m / nbytes;
  out[i] = float((packed[(size_t)r * nbytes + byte] >> bit) & 1);
}

}  // namespace

extern "C" {

// variant 0: B2's work (threads per block `block`: 128, 256 or 512);
// 1: no camera-row gather; 2: no atomics (both at 256 threads).  float, np = 8.
int probe_coupling(int np, int block, int variant, const void* xw_t, const void* wcam,
                   const void* jc, const void* jp, const void* vinv, void* out, int G,
                   int Tb, int Pc, int W, void* stream) {
  if (np != kProbeNp) return kErrNp;
  if (G == 0 || Pc == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0 && block == 128)
    return probe_launch<128, true, true>(xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, s);
  if (variant == 0 && block == 256)
    return probe_launch<256, true, true>(xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, s);
  if (variant == 0 && block == 512)
    return probe_launch<512, true, true>(xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, s);
  if (variant == 1 && block == 256)
    return probe_launch<256, false, true>(xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, s);
  if (variant == 2 && block == 256)
    return probe_launch<256, true, false>(xw_t, wcam, jc, jp, vinv, out, G, Tb, Pc, W, s);
  return kErrProbe;
}

// layout 0: byte-interleaved (A); 1: bit plane per tile (B).
int probe_bits_expand(int layout, const void* packed, void* out, int rows, int nbytes,
                      void* stream) {
  const size_t n = (size_t)rows * 8 * nbytes;
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock));
  const cudaStream_t s = (cudaStream_t)stream;
  if (layout == 0)
    bits_expand_kernel<0><<<grid, kBlock, 0, s>>>((const uint8_t*)packed, (float*)out, rows,
                                                  nbytes);
  else if (layout == 1)
    bits_expand_kernel<1><<<grid, kBlock, 0, s>>>((const uint8_t*)packed, (float*)out, rows,
                                                  nbytes);
  else
    return kErrProbe;
  return (int)cudaGetLastError();
}

}  // extern "C"
