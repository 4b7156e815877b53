// K1 spectrum_blocks, and the C entry points of the blocked watermark
// kernels of the serving path: K1, K2 embed_blocks and K3
// roundtrip_frames_blocks (K2 and K3 are in wm_paint.cuh, their instances
// in wm_paint_k*.cu).
//
// K1 replaces dctsvd_tpu/ops/wm_pallas.py::_make_spectrum_kernel (through
// spectrum_plane_blocks(method='onesided')): values-only one-sided Jacobi
// of every 8x8 pixel block at the replayed schedule, sorted descending.
// Plain twin: dctsvd_tpu_torch/ops/wm_cuda.py::spectrum_blocks_plain.
//
// Design: one thread per block, the block's 64 columns-of-rows in
// registers (jacobi8.cuh), addressed by stride (blocks.cuh), so there is
// no view transpose.
//
// What bounds it on the H100: the f32 operations of the 28 unrolled
// rotations per sweep (-fmad=false), issued by 5 blocks of 128 threads per
// SM (ptxas: 96 registers, no spills), and for channels-last frames the
// uncoalesced 3-byte-stride u8 reads. Staging a band of blocks through
// shared memory for coalesced loads is later work (the probes found it
// slower, PERF.md). chip_smoke.py prints the registers of each build
// (`nvcc -Xptxas -v`).
//
// dctsvd_embed_blocks and dctsvd_roundtrip_blocks take k at run time and
// pick the instance compiled for it; a k outside 1..8 returns
// cudaErrorInvalidValue and launches nothing.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "blocks.cuh"
#include "jacobi8.cuh"
#include "wm_paint_launch.cuh"

namespace dctsvd {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    spectrum_kernel(const T* __restrict__ x, float* __restrict__ out,
                    int64_t total, int64_t n_blk, int chans, int h, int w,
                    int full, int extra) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (tid >= total) return;
  const BlockAddr a = block_addr(tid, n_blk, chans, h, w);
  float g[kB][kB], unused[kB][kB], s[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) load_col(x, a, c, g[c]);
  jacobi8<false>(g, unused, full, extra, s);
  sort8<0>(s, unused, unused);
  float* o = out + tid * kB;
#pragma unroll
  for (int j = 0; j < kB; ++j) o[j] = s[j];
}

// Calls f(std::integral_constant<int, k>) for k in 1..8; false for any
// other k.
template <typename F>
static bool with_k(int k, F&& f) {
  switch (k) {
    case 1: f(std::integral_constant<int, 1>()); return true;
    case 2: f(std::integral_constant<int, 2>()); return true;
    case 3: f(std::integral_constant<int, 3>()); return true;
    case 4: f(std::integral_constant<int, 4>()); return true;
    case 5: f(std::integral_constant<int, 5>()); return true;
    case 6: f(std::integral_constant<int, 6>()); return true;
    case 7: f(std::integral_constant<int, 7>()); return true;
    case 8: f(std::integral_constant<int, 8>()); return true;
    default: return false;
  }
}

}  // namespace dctsvd

using dctsvd::grid_for;
using dctsvd::kThreads;
using dctsvd::PaintLaunch;
using dctsvd::spectrum_kernel;
using dctsvd::with_k;

// x: u8 (x_is_u8) or f32; out: f32 [P, N, 8]. Returns the cudaError_t of
// the launch.
extern "C" int dctsvd_spectrum_blocks(const void* x, int x_is_u8, void* out,
                                      int planes, int chans, int h, int w,
                                      int full, int extra, void* stream) {
  const int64_t n_blk = static_cast<int64_t>(h / 8) * (w / 8);
  const int64_t total = static_cast<int64_t>(planes) * n_blk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (x_is_u8)
    spectrum_kernel<uint8_t><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), o, total, n_blk, chans, h, w, full,
        extra);
  else
    spectrum_kernel<float><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(x), o, total, n_blk, chans, h, w, full,
        extra);
  return static_cast<int>(cudaGetLastError());
}

static PaintLaunch paint_launch(const void* x, const void* sws, int csws,
                                void* y, void* sc, void* scw, int planes,
                                int chans, int h, int w, int full, int extra,
                                void* stream) {
  PaintLaunch p;
  p.x = x;
  p.sws = static_cast<const float*>(sws);
  p.csws = csws;
  p.y = y;
  p.sc = static_cast<float*>(sc);
  p.scw = static_cast<float*>(scw);
  p.n_blk = static_cast<int64_t>(h / 8) * (w / 8);
  p.total = static_cast<int64_t>(planes) * p.n_blk;
  p.chans = chans;
  p.h = h;
  p.w = w;
  p.full = full;
  p.extra = extra;
  p.stream = static_cast<cudaStream_t>(stream);
  return p;
}

// x: u8 or f32 in; sws: f32 [csws, N, 8]; y: u8 (y_is_u8) or f32 in x's
// layout; sc: f32 [P, N, 8]; k in 1..8. Returns the cudaError_t of the
// launch.
extern "C" int dctsvd_embed_blocks(const void* x, int x_is_u8,
                                   const void* sws, int csws, void* y,
                                   int y_is_u8, void* sc, int planes,
                                   int chans, int h, int w, int full,
                                   int extra, int k, void* stream) {
  const PaintLaunch p = paint_launch(x, sws, csws, y, sc, nullptr, planes,
                                     chans, h, w, full, extra, stream);
  const bool ok = with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    if (x_is_u8 && y_is_u8)
      dctsvd::launch_embed<uint8_t, uint8_t, K>(p);
    else if (x_is_u8)
      dctsvd::launch_embed<uint8_t, float, K>(p);
    else if (y_is_u8)
      dctsvd::launch_embed<float, uint8_t, K>(p);
    else
      dctsvd::launch_embed<float, float, K>(p);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x: u8 channels-last frames [L, H, W, C]; sws: f32 [csws, N, 8]; y: u8 in
// x's layout; sc, scw: f32 [P, N, 8]; k in 1..8. Returns the cudaError_t
// of the launch.
extern "C" int dctsvd_roundtrip_blocks(const void* x, const void* sws,
                                       int csws, void* y, void* sc,
                                       void* scw, int planes, int chans,
                                       int h, int w, int full, int extra,
                                       int k, void* stream) {
  const PaintLaunch p = paint_launch(x, sws, csws, y, sc, scw, planes, chans,
                                     h, w, full, extra, stream);
  const bool ok = with_k(k, [&](auto kc) {
    dctsvd::launch_roundtrip<decltype(kc)::value>(p);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
