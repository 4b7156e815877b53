// The measurement probes of tools/ on the H100: copy_f32, cols_view,
// fma_chain and spectrum_probe. Each answers a question the redesign of
// K1, K2 and K3 needs answered (read coalescing, the f32 ceiling, the input
// dtype, cached final norms); the port's tools/ modules drive them.
// Plain twins: dctsvd_tpu_torch/ops/probe_cuda.py::*_plain.
//
// copy_f32 replaces the identity-copy Pallas kernels `copyk` of
// tools/profile_transpose.py::copy_consumer (:45, T2a) and
// tools/profile_view.py::transpose_forced (:70, T6b). Bound by bytes (each
// element read and written once); grid-stride, 16 bytes (float4) per
// thread per step, neighbouring threads on neighbouring addresses.
//
// cols_view replaces tools/profile_transpose.py `gatherk` (:104, the
// pallas_call at :112, T2b), which computes
// swapaxes(x.reshape(r, 8, Wb, 8), -1, -2): the natural planes [P, H, W]
// as the "cols view" [P, Hb, 8(row), 8(col), Wb], in which neighbouring
// blocks sit at neighbouring addresses. It also stands for the relayout
// the T4-T6 probes do outside their kernels (wm_pallas._plane_cols_view,
// tools/exp_widen.py:37). Bound by bytes. One CTA per (plane, block row,
// tile of 128 blocks): a coalesced read of the tile's 8 pixel rows into
// shared memory, then a coalesced write of its [8, 8, 128] slab. Shared
// memory pads one word per block (column j at j + j/8), so the transposing
// read (stride 9 words between threads) is free of bank conflicts; a
// 1024-column f32 tile takes 36 KiB, under the 48 KiB static limit, and
// the ragged last tile of a row (112 of 128 blocks at 1080p) is masked.
//
// fma_chain replaces tools/exp_vpu_roofline.py::_make_kernel (the
// pallas_call at :57, T3): per element, acc <- acc * 1.0000001 + x, as 8
// independent chains (ilp8, the throughput ceiling) or one dependent chain
// (serial, the latency floor). Bound by operations. The unfused instance
// uses __fmul_rn/__fadd_rn and the fused one __fmaf_rn, both immune to
// -fmad=false, so one build gives both the rate of the separate multiplies
// and adds that every kernel here executes and the FMA rate behind the
// published 67 TFLOP/s.
//
// spectrum_probe replaces the probe spectra: tools/exp_relayout.py
// _make_kernel (pallas_call :59, T1: natural-layout planes, relaid inside
// the kernel), exp_widen.py (:40, T4: u8/bf16/f32 cols view),
// exp_cachednorms.py::_make_spectrum_cached (:59, T5: final values from
// the cached norms) and profile_view.py (:44, T6a: f32 cols view, s4). It
// is K1's design (one thread per block, jacobi8 + sort8, an integer
// schedule) with three ways to load the block: kNatStrided reads it by
// stride as K1 does (each thread 8 rows of 32 bytes, 32 bytes apart from
// its neighbour); kNatSmem has the CTA read its 8 pixel rows coalesced into
// shared memory (cols_view's tile) and each thread take its block from
// there; kColsView reads the cols view, where a warp's 32 blocks are 32
// neighbouring elements. Bound by operations (registers cap occupancy, as
// for K1). On the same integer-valued planes every fresh instance computes
// K1's floats in K1's order, so it equals K1 bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "blocks.cuh"
#include "jacobi8.cuh"

namespace dctsvd {

constexpr int kWideThreads = 256;            // copy_f32, cols_view, fma_chain
constexpr int kTileBlocks = kThreads;        // blocks of a block row per CTA
constexpr int kTileCols = kTileBlocks * kB;  // 1024 pixel columns
constexpr int kPadCols = kTileCols + kTileBlocks;

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };
enum ProbeLayout { kNatStrided = 0, kNatSmem = 1, kColsView = 2 };

__global__ void __launch_bounds__(kWideThreads)
    copy_f32_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                    int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWideThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWideThreads +
                   threadIdx.x;
       i < n4; i += stride)
    y[i] = x[i];
}

template <typename In, typename Out>
__device__ __forceinline__ Out convert(In v) {
  return static_cast<Out>(v);
}

template <>
__device__ __forceinline__ __nv_bfloat16 convert<uint8_t, __nv_bfloat16>(
    uint8_t v) {
  return __float2bfloat16(static_cast<float>(v));
}

// The 8 pixel rows of tile blockIdx.y of band blockIdx.x (= p * Hb + by)
// into band[r][j + j / 8], coalesced. Every thread of the CTA calls it.
template <int kNT, typename T>
__device__ __forceinline__ void load_band(const T* __restrict__ x, int w,
                                          T (&band)[kB][kPadCols]) {
  const int wb = w / kB;
  const int ncols = min(kTileBlocks, wb - static_cast<int>(blockIdx.y) *
                                             kTileBlocks) * kB;
  const T* src = x + static_cast<int64_t>(blockIdx.x) * kB * w +
                 static_cast<int64_t>(blockIdx.y) * kTileCols;
  for (int i = threadIdx.x; i < kB * kTileCols; i += kNT) {
    const int r = i / kTileCols, j = i % kTileCols;
    if (j < ncols) band[r][j + j / kB] = src[static_cast<int64_t>(r) * w + j];
  }
  __syncthreads();
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kWideThreads)
    cols_view_kernel(const In* __restrict__ x, Out* __restrict__ y, int w) {
  __shared__ In band[kB][kPadCols];
  load_band<kWideThreads>(x, w, band);
  const int wb = w / kB;
  const int bx0 = blockIdx.y * kTileBlocks;
  const int nb = min(kTileBlocks, wb - bx0);
  Out* dst = y + static_cast<int64_t>(blockIdx.x) * kB * kB * wb + bx0;
  for (int i = threadIdx.x; i < kB * kB * kTileBlocks; i += kWideThreads) {
    const int rc = i / kTileBlocks, b = i % kTileBlocks;  // rc = r * 8 + c
    if (b < nb)
      dst[static_cast<int64_t>(rc) * wb + b] =
          convert<In, Out>(band[rc / kB][b * kB + rc % kB + b]);
  }
}

template <bool kFused>
__device__ __forceinline__ float chain_step(float acc, float x) {
  if constexpr (kFused) {
    return __fmaf_rn(acc, 1.0000001f, x);
  } else {
    return __fadd_rn(__fmul_rn(acc, 1.0000001f), x);
  }
}

// steps: rounds of 8 updates (ilp8) or updates of the one chain (serial).
template <bool kIlp8, bool kFused>
__global__ void __launch_bounds__(kWideThreads)
    fma_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                     int64_t n, int steps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWideThreads +
                    threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float out;
  if constexpr (kIlp8) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = __fmul_rn(xv, 1.0f + 0.0625f * k);
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = chain_step<kFused>(acc[k], xv);
    }
    out = acc[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) out = __fadd_rn(out, acc[k]);
  } else {
    out = xv;
#pragma unroll 8
    for (int s = 0; s < steps; ++s) out = chain_step<kFused>(out, xv);
  }
  y[i] = out;
}

// Element (r, c) of block (p, by, bx) of the cols view [P, Hb, 8, 8, Wb]
// sits at ((p * Hb + by) * 64 + r * 8 + c) * Wb + bx; tid = (p * Hb + by)
// * Wb + bx is the row-major block index.
__device__ __forceinline__ BlockAddr cols_addr(int64_t tid, int wb) {
  const int64_t band = tid / wb;
  BlockAddr a;
  a.base = band * kB * kB * wb + (tid - band * wb);
  a.rs = static_cast<int64_t>(kB) * wb;
  a.cs = wb;
  return a;
}

// At least K1's 5 blocks of 128 threads per SM (96 registers, as ptxas
// gives K1), so that the layouts compare with K1 at equal occupancy.
template <int kLayout, typename T, bool kCached>
__global__ void __launch_bounds__(kThreads, 5)
    spectrum_probe_kernel(const T* __restrict__ x, float* __restrict__ out,
                          int64_t total, int h, int w, int full) {
  const int wb = w / kB;
  float g[kB][kB], unused[kB][kB], s[kB];
  int64_t tid;
  if constexpr (kLayout == kNatSmem) {
    __shared__ T band[kB][kPadCols];
    load_band<kThreads>(x, w, band);
    const int b = threadIdx.x;
    const int bx = blockIdx.y * kTileBlocks + b;
    if (bx >= wb) return;
#pragma unroll
    for (int c = 0; c < kB; ++c) {
#pragma unroll
      for (int r = 0; r < kB; ++r)
        g[c][r] = static_cast<float>(band[r][b * kB + c + b]);
    }
    tid = static_cast<int64_t>(blockIdx.x) * wb + bx;
  } else {
    tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (tid >= total) return;
    const BlockAddr a =
        kLayout == kNatStrided
            ? block_addr(tid, static_cast<int64_t>(h / kB) * wb, 1, h, w)
            : cols_addr(tid, wb);
#pragma unroll
    for (int c = 0; c < kB; ++c) load_col(x, a, c, g[c]);
  }
  jacobi8<false, kCached>(g, unused, full, 0, s);
  sort8<0>(s, unused, unused);
  float* o = out + tid * kB;
#pragma unroll
  for (int j = 0; j < kB; ++j) o[j] = s[j];
}

template <int kLayout, typename T, bool kCached>
static void launch_probe(const void* x, float* out, int planes, int h, int w,
                         int full, cudaStream_t st) {
  const int64_t bands = static_cast<int64_t>(planes) * (h / kB);
  const int wb = w / kB;
  const int64_t total = bands * wb;
  const T* xt = static_cast<const T*>(x);
  if constexpr (kLayout == kNatSmem) {
    const dim3 grid(static_cast<unsigned>(bands),
                    static_cast<unsigned>((wb + kTileBlocks - 1) /
                                          kTileBlocks));
    spectrum_probe_kernel<kLayout, T, kCached><<<grid, kThreads, 0, st>>>(
        xt, out, total, h, w, full);
  } else {
    spectrum_probe_kernel<kLayout, T, kCached>
        <<<grid_for(total), kThreads, 0, st>>>(xt, out, total, h, w, full);
  }
}

}  // namespace dctsvd

using namespace dctsvd;

// x, y: 16-byte aligned f32 of n4 float4s. Returns the cudaError_t of the
// launch.
extern "C" int dctsvd_copy_f32(const void* x, void* y, long long n4,
                               void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n4 + kWideThreads - 1) / kWideThreads;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * 8;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  if (grid > 0)
    copy_f32_kernel<<<grid, kWideThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(y), n4);
  return static_cast<int>(cudaGetLastError());
}

// x: natural planes [P, H, W] (in_kind u8 or f32); y: the cols view
// [P, Hb, 8, 8, Wb] (out_kind u8, bf16 or f32; u8 out only from u8 in).
// bands = P * Hb. Returns the cudaError_t of the launch.
extern "C" int dctsvd_cols_view(const void* x, int in_kind, void* y,
                                int out_kind, int bands, int w,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(bands),
                  static_cast<unsigned>((w / kB + kTileBlocks - 1) /
                                        kTileBlocks));
  const uint8_t* xu = static_cast<const uint8_t*>(x);
  if (in_kind == kU8 && out_kind == kU8)
    cols_view_kernel<uint8_t, uint8_t><<<grid, kWideThreads, 0, st>>>(
        xu, static_cast<uint8_t*>(y), w);
  else if (in_kind == kU8 && out_kind == kBF16)
    cols_view_kernel<uint8_t, __nv_bfloat16><<<grid, kWideThreads, 0, st>>>(
        xu, static_cast<__nv_bfloat16*>(y), w);
  else if (in_kind == kU8 && out_kind == kF32)
    cols_view_kernel<uint8_t, float><<<grid, kWideThreads, 0, st>>>(
        xu, static_cast<float*>(y), w);
  else if (in_kind == kF32 && out_kind == kF32)
    cols_view_kernel<float, float><<<grid, kWideThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), w);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x, y: f32 of n elements; steps as for fma_chain_kernel. Returns the
// cudaError_t of the launch.
extern "C" int dctsvd_fma_chain(const void* x, void* y, long long n,
                                int steps, int ilp8, int fused,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid =
      static_cast<unsigned>((n + kWideThreads - 1) / kWideThreads);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  if (ilp8 && fused)
    fma_chain_kernel<true, true><<<grid, kWideThreads, 0, st>>>(xf, yf, n,
                                                                steps);
  else if (ilp8)
    fma_chain_kernel<true, false><<<grid, kWideThreads, 0, st>>>(xf, yf, n,
                                                                 steps);
  else if (fused)
    fma_chain_kernel<false, true><<<grid, kWideThreads, 0, st>>>(xf, yf, n,
                                                                 steps);
  else
    fma_chain_kernel<false, false><<<grid, kWideThreads, 0, st>>>(xf, yf, n,
                                                                  steps);
  return static_cast<int>(cudaGetLastError());
}

// x: natural f32 planes [P, H, W] (layout kNatStrided / kNatSmem) or a
// cols view [P, H/8, 8, 8, W/8] (kColsView; kind u8, bf16 or f32); out:
// f32 [P, N, 8]; `full` sweeps, 0 allowed (sorted column norms). cached
// (f32 cols view only) takes the final values from the cached norms.
// Returns the cudaError_t of the launch.
extern "C" int dctsvd_spectrum_probe(const void* x, int kind, int layout,
                                     int cached, void* out, int planes,
                                     int h, int w, int full, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (layout == kNatStrided && kind == kF32 && !cached)
    launch_probe<kNatStrided, float, false>(x, o, planes, h, w, full, st);
  else if (layout == kNatSmem && kind == kF32 && !cached)
    launch_probe<kNatSmem, float, false>(x, o, planes, h, w, full, st);
  else if (layout == kColsView && kind == kU8 && !cached)
    launch_probe<kColsView, uint8_t, false>(x, o, planes, h, w, full, st);
  else if (layout == kColsView && kind == kBF16 && !cached)
    launch_probe<kColsView, __nv_bfloat16, false>(x, o, planes, h, w, full,
                                                  st);
  else if (layout == kColsView && kind == kF32 && !cached)
    launch_probe<kColsView, float, false>(x, o, planes, h, w, full, st);
  else if (layout == kColsView && kind == kF32 && cached)
    launch_probe<kColsView, float, true>(x, o, planes, h, w, full, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
