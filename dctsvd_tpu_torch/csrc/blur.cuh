// The separable Gaussian core that K14 (unsharp, csrc/enhance.cu) and K15
// (SSIM, csrc/metrics.cu) share: the shift-and-add of
// dctsvd_tpu_torch/ops/enhance.py::gaussian_blur, their plain twins' blur,
// kept byte for byte.
//
// The twin pads x [..., H, W] by reflect-101 (R = ksize / 2 on each side,
// the index gather of reflect_index, so planes smaller than R reflect more
// than once), then
//   y[r][j] = 0, then y += k[i] * xp[r + i][j] for i = 0 .. ksize - 1
//             (the vertical pass first, over the padded width, halo
//             columns included);
//   z[r][c] = 0, then z += k[i] * y[r][c + i] for i = 0 .. ksize - 1,
// each step one f32 product and one f32 sum (separate tensor ops: never an
// FMA). blur_taps is that sum at one output, with __fmul_rn and __fadd_rn
// so that nothing contracts whatever the build flags. The taps are the
// twin's own f32 values (_gauss1d cast to f32 on the host), passed by
// value. The reflect-101 indices: K15 reads its halo row p and column q
// through the twin's reflect_index tables, made on the host as int32 (rows
// [H + 2R], columns [W + 2R]), by blur_src, clamped into the table where a
// tile runs past the plane (those outputs are never written or counted);
// K14 computes them in the kernel (enhance.cu's reflect) and reads no
// table.

#pragma once

#include <cuda_runtime.h>

namespace dctsvd {

constexpr int kBlurMaxTaps = 11;

// The taps of one separable Gaussian (K14: 7 at sigma 1; K15: 11 at 1.5).
struct BlurTaps {
  float k[kBlurMaxTaps];
};

// sum over i = 0 .. kTaps - 1 of taps.k[i] * v(i), from 0 in tap order:
// the twin's accumulation at one output of one pass.
template <int kTaps, typename F>
__device__ __forceinline__ float blur_taps(const BlurTaps& taps, F v) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kTaps; ++i)
    acc = __fadd_rn(acc, __fmul_rn(taps.k[i], v(i)));
  return acc;
}

// The kOut = kN - kTaps + 1 outputs of one pass over kN inputs held in
// registers (a thread's run down a column or along a row): out(o, value)
// with value the blur_taps sum over v[o .. o + kTaps - 1]. Each input is
// read from shared memory once for all the outputs that use it.
template <int kTaps, int kN, typename F>
__device__ __forceinline__ void blur_run(const BlurTaps& taps,
                                         const float (&v)[kN], F out) {
#pragma unroll
  for (int o = 0; o + kTaps <= kN; ++o)
    out(o, blur_taps<kTaps>(taps, [&](int t) { return v[o + t]; }));
}

// The source index of halo position p (0 .. n - 1 + ...) through a reflect
// table of n entries, clamped into it.
__device__ __forceinline__ int blur_src(const int* __restrict__ table, int p,
                                        int n) {
  return __ldg(table + (p < n ? p : n - 1));
}

// Copies n f32 taps from host memory into a BlurTaps (0 past n).
inline BlurTaps blur_taps_of(const float* host, int n) {
  BlurTaps t{};
  for (int i = 0; i < n && i < kBlurMaxTaps; ++i) t.k[i] = host[i];
  return t;
}

}  // namespace dctsvd
