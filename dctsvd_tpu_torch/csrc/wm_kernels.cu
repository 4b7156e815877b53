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
// registers (jacobi8.cuh), read by stride from the input, so there is no
// view transpose; 5 CTAs of 128 threads per SM (96 registers, no spills).
//
// What bounds it on the H100: the issue of its instructions. Most of a
// block's instructions are the f32 operations of its rotations, which the
// twin's order fixes under -fmad=false; the rest of the time is the
// dependent chain of each rotation (a dot, two rsqrt, the update), which
// 5 CTAs an SM hide only in part. `chip_smoke.py --jacobi-times` counts
// the instructions by class (SASS) and their rate against T3's (PERF.md).
// What the design does about the rest: the first form spent instructions
// on 64-bit divisions and addresses (block_addr) and read its bytes 6
// cache lines a warp load. Now the grid is (blocks of a frame, frames), so
// all index arithmetic is 32-bit within a frame, the channel count is a
// template constant for 1 and 3 channels (its divisions and pixel strides
// become constants), the C channels of one pixel block go to neighbouring
// threads (K2's order, 2-3 lines a warp load), and c^2's rsqrt skips the
// subnormal fix-up (rotation's kNormalIc). Forms measured slower
// (PERF.md): 8-byte row reads with the prmt conversion (their f32
// subtracts and shifts cost more issue than the byte loads they saved;
// only f32 planes read 16-byte rows), 2 lanes a block (more instructions),
// 6 CTAs an SM (spills), the CTA's band staged in shared memory.
// chip_smoke.py prints the registers of each build (`nvcc -Xptxas -v`).
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

// The least CTAs of kThreads threads per SM that K1's __launch_bounds__
// asks for (96 registers).
constexpr int kSpectrumMinBlocks = 5;

// Grid (units / kThreads, frames): frame blockIdx.y holds `units` = n_blk
// * c (block, channel) pairs, c interleaved channels a pixel (c = 1 for
// planes, where a frame is a plane), and the channels of one pixel block
// go to neighbouring threads. Index arithmetic is 32-bit within a frame (a
// frame has fewer than 2^31 elements; the host checks), the frame's offset
// 64-bit; kC = c as a constant (1 or 3) turns the divisions by c and the
// pixel strides into constants.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, kSpectrumMinBlocks)
    spectrum_kernel(const T* __restrict__ x, float* __restrict__ out,
                    int units, int chans, int w, int full, int extra) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= units) return;
  const int c = kC > 0 ? kC : chans;
  const int wb = w / kB;
  const int n = t / c, ch = t - n * c;
  const int by = n / wb, bx = n - by * wb;
  const int64_t frame = blockIdx.y;
  const T* xb = x + frame * units * (kB * kB) + (by * kB * w + bx * kB) * c;
  float g[kB][kB], unused[kB][kB], s[kB];
#pragma unroll
  for (int r = 0; r < kB; ++r) {
    float px[kB];
    load_row<kC>(xb + r * w * c, c, ch, px);
#pragma unroll
    for (int k = 0; k < kB; ++k) g[k][r] = px[k];
  }
  jacobi8<false, false, 1, true>(g, unused, full, extra, s);
  sort8<0>(s, unused, unused);
  float4* o = reinterpret_cast<float4*>(
      out + ((frame * c + ch) * (units / c) + n) * kB);
  o[0] = make_float4(s[0], s[1], s[2], s[3]);
  o[1] = make_float4(s[4], s[5], s[6], s[7]);
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

using dctsvd::launch_frame_grid;
using dctsvd::spectrum_kernel;
using dctsvd::PaintLaunch;
using dctsvd::with_k;

// x: u8 (x_is_u8) or f32, planes / chans frames of [H, W, chans]
// (chans = 1: planes [P, H, W]); out: f32 [P, N, 8]. A frame of 2^31
// elements or more returns cudaErrorInvalidValue and launches nothing.
// Returns the cudaError_t of the launch.
extern "C" int dctsvd_spectrum_blocks(const void* x, int x_is_u8, void* out,
                                      int planes, int chans, int h, int w,
                                      int full, int extra, void* stream) {
  if (static_cast<int64_t>(h) * w * chans >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int f = planes / chans;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_is_u8 && chans == 1)
    launch_frame_grid<uint8_t>(spectrum_kernel<uint8_t, 1>, x, o, f,
                               chans, h, w, full, extra, st);
  else if (x_is_u8 && chans == 3)
    launch_frame_grid<uint8_t>(spectrum_kernel<uint8_t, 3>, x, o, f,
                               chans, h, w, full, extra, st);
  else if (x_is_u8)
    launch_frame_grid<uint8_t>(spectrum_kernel<uint8_t, 0>, x, o, f,
                               chans, h, w, full, extra, st);
  else if (chans == 1 && aligned)
    launch_frame_grid<float>(spectrum_kernel<float, 1>, x, o, f,
                             chans, h, w, full, extra, st);
  else
    launch_frame_grid<float>(spectrum_kernel<float, 0>, x, o, f,
                             chans, h, w, full, extra, st);
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
