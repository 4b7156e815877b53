// K15 and K16: the embed's quality metrics on the card, SSIM and PSNR.
//
// They replace no pl.pallas_call: in the JAX package both are XLA fusions,
// dctsvd_tpu/ops/metrics.py::ssim (:52, with _gaussian_blur :44, sigma 1.5,
// 11 taps) and psnr (:23), under embed_gray_prepared / embed_color_prepared
// (with_metrics=True) and the parity path. The port ran them as eager op
// chains: SSIM five shift-and-add blurs, each two index gathers and 44
// elementwise launches over [..., H, W + 10] f32 temporaries. Plain twins:
// dctsvd_tpu_torch/ops/metrics_cuda.py::ssim_plain (the eager map, then a
// sum in this file's tile, lane and tree order) and psnr_plain (exact int64
// sums); the wrappers are ops/metrics_cuda.py.
//
// K15 ssim_kernel<T2>: u8 planes x [P, H, W] and planes y of T2 (u8: the
// color embed's gray stego; f32: the gray embed's unclipped marked Y) ->
// a partial sum a (plane, tile) of the SSIM map; ssim_finish_kernel sums a
// plane's partials and divides once by H * W. In the twin's order (f32,
// every product and sum rounded once: __fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, never contracted):
//   x, y as f32 (u8 exactly); the five blurred inputs mu1 = B(x),
//   mu2 = B(y), B(x x), B(y y), B(x y), B the 11-tap sigma 1.5 Gaussian
//   of csrc/blur.cuh (vertical pass first, over the halo's width);
//   mu1^2 = mu1 mu1, mu2^2, mu12 = mu1 mu2; s1 = B(x x) - mu1^2, s2, s12;
//   num = (2 mu12 + c1)(2 s12 + c2);
//   den = ((mu1^2 + mu2^2) + c1)((s1 + s2) + c2) + 1e-12;
//   map = num / den,
// c1, c2 and 1e-12 the f32 values of torch's Python scalars (c1 =
// f32((0.01 * 255)^2), c2 = f32((0.03 * 255)^2)). The sum: a CTA takes a
// kSsimTile x kSsimTile tile, thread (warp w, lane c) its column c at rows
// w, w + 8, w + 16, w + 24 (from 0, in that order; 0 for pixels past the
// plane), then a butterfly of shuffles over the 32 lanes (16, 8, 4, 2, 1),
// then the 8 warps' totals from 0 in warp order: the tile's partial. The
// finish kernel: a CTA of 256 threads a plane, thread t sums partials t,
// t + 256, ... from 0 in order (0 past the last), the same lane butterfly
// and warp order, then one IEEE division by f32(H * W), as jnp.mean
// divides. So the kernel is bit-equal to its twin run on the card.
//
// K16 sq_diff_kernel: u8 pairs [B, n] -> the exact sum of (a - b)^2 an
// image, in integers (at most 65,025 a term): u32 a thread (at most
// kSqDiffPerThread terms), u64 across a CTA's shuffles, one u64 atomic a
// CTA. Integer sums are exact in any order. The wrapper divides by n once
// in f64 and rounds to f32 (the twin's int64 torch ops do the same), then
// runs the twin's sqrt, log10, 1e-12 floor and 99.0 cap on the [B] vector.
//
// What bounds them on the H100. K15: operations. Per pixel the vertical
// pass does 11 taps of 5 products and 5 sums over 42/32 of the tile's
// columns, plus 3 products a halo pixel a tap (x x, y y, x y formed in
// the loop), the horizontal pass 11 taps of 5 and 5, the map about 20:
// about 330 f32 instructions, so issue (132 SMs x 128 lanes at 1980 MHz)
// binds before the 3 bytes to 5 a pixel it reads. K16: bytes (2 n u8 an
// image, read once; 398 MB for 32 color 1080p frames, 0.119 ms).
//
// What the design does about it. K15 reads each input pixel's halo once
// into shared memory (a 42 x 42 halo of x and y as f32, 14 KB), forms the
// five inputs there and keeps the vertical pass's five planes in shared
// memory (5 x 32 x 42 f32, 27 KB; 41 KB a CTA in all, under the 48 KB of
// static shared memory), so the five blurs of a tile cost one read of its
// inputs, where the eager form wrote and read ten f32 temporaries of the
// padded plane a blur. The whole batch is one launch (grid tiles x planes)
// and the finish one more. K16 reads both inputs in 16-byte loads where n
// is a multiple of 16 and both pointers 16-byte aligned (else a byte a
// thread), kSqDiffPerCta bytes of an image a CTA.

#include <cuda_runtime.h>

#include <cstdint>

#include "blur.cuh"

namespace dctsvd {
namespace {

constexpr int kSsimTile = 32;
constexpr int kSsimR = 5;                       // 11 taps
constexpr int kSsimTaps = 2 * kSsimR + 1;
constexpr int kSsimHalo = kSsimTile + 2 * kSsimR;
constexpr int kSsimThreads = 256;
constexpr int kSsimWarps = kSsimThreads / 32;
constexpr int kFinishThreads = 256;
constexpr int kMaxGrid = 65535;                 // planes a launch (grid z)
constexpr unsigned kFull = 0xffffffffu;

constexpr int kSqDiffThreads = 256;
// a thread's u32 sum takes at most 2^32 / 65,025 = 66,051 terms
constexpr int kSqDiffPerThread = 256;
constexpr int64_t kSqDiffPerCta =
    static_cast<int64_t>(kSqDiffPerThread) * kSqDiffThreads;
static_assert(kSqDiffPerThread % 16 == 0, "whole 16-byte loads a thread");
static_assert(static_cast<int64_t>(kSqDiffPerThread) * 65025 < (1ll << 32),
              "a thread's sum fits its u32");

__device__ __forceinline__ float to_f32(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// The SSIM map of one pixel from its five blurred inputs, in the twin's
// order.
__device__ __forceinline__ float ssim_map(float mu1, float mu2, float bxx,
                                          float byy, float bxy, float c1,
                                          float c2) {
  const float mu1_sq = __fmul_rn(mu1, mu1);
  const float mu2_sq = __fmul_rn(mu2, mu2);
  const float mu12 = __fmul_rn(mu1, mu2);
  const float s1 = __fsub_rn(bxx, mu1_sq);
  const float s2 = __fsub_rn(byy, mu2_sq);
  const float s12 = __fsub_rn(bxy, mu12);
  const float num = __fmul_rn(__fadd_rn(__fmul_rn(2.0f, mu12), c1),
                              __fadd_rn(__fmul_rn(2.0f, s12), c2));
  const float den = __fadd_rn(
      __fmul_rn(__fadd_rn(__fadd_rn(mu1_sq, mu2_sq), c1),
                __fadd_rn(__fadd_rn(s1, s2), c2)),
      1e-12f);
  return __fdiv_rn(num, den);
}

// The butterfly over a warp's 32 lanes: every lane ends with the same sum,
// lane i having added lane i ^ o at o = 16, 8, 4, 2, 1.
__device__ __forceinline__ float lane_tree(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The 8 warps' totals (lane_tree in each) from 0 in warp order, to thread 0.
__device__ __forceinline__ float warp_order_sum(float v, float* part) {
  v = lane_tree(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSsimWarps; ++k) s = __fadd_rn(s, part[k]);
  }
  return s;
}

// K15. Grid (column tiles, row tiles, planes of this launch); plane
// blockIdx.z of x and y; partials [P, row tiles, column tiles].
template <typename T2>
__global__ void __launch_bounds__(kSsimThreads)
    ssim_kernel(const uint8_t* __restrict__ x, const T2* __restrict__ y,
                const int* __restrict__ rows, const int* __restrict__ cols,
                int h, int w, BlurTaps taps, float c1, float c2,
                float* __restrict__ partials) {
  __shared__ float xs[kSsimHalo][kSsimHalo];
  __shared__ float ys[kSsimHalo][kSsimHalo];
  __shared__ float vs[5][kSsimTile][kSsimHalo];
  __shared__ float part[kSsimWarps];
  const int tid = threadIdx.x;
  const int64_t plane = blockIdx.z;
  const int64_t base = plane * h * static_cast<int64_t>(w);
  const int ty0 = blockIdx.y * kSsimTile, tx0 = blockIdx.x * kSsimTile;
  const int nr = h + 2 * kSsimR, nc = w + 2 * kSsimR;
  for (int i = tid; i < kSsimHalo * kSsimHalo; i += kSsimThreads) {
    const int r = i / kSsimHalo, c = i - r * kSsimHalo;
    const int64_t src =
        base + static_cast<int64_t>(blur_src(rows, ty0 + r, nr)) * w +
        blur_src(cols, tx0 + c, nc);
    xs[r][c] = to_f32(__ldg(x + src));
    ys[r][c] = to_f32(__ldg(y + src));
  }
  __syncthreads();
  // the vertical pass of the five inputs over the halo's width
  for (int i = tid; i < kSsimTile * kSsimHalo; i += kSsimThreads) {
    const int r = i / kSsimHalo, j = i - r * kSsimHalo;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f, a4 = 0.0f;
#pragma unroll
    for (int t = 0; t < kSsimTaps; ++t) {
      const float k = taps.k[t];
      const float a = xs[r + t][j], b = ys[r + t][j];
      a0 = __fadd_rn(a0, __fmul_rn(k, a));
      a1 = __fadd_rn(a1, __fmul_rn(k, b));
      a2 = __fadd_rn(a2, __fmul_rn(k, __fmul_rn(a, a)));
      a3 = __fadd_rn(a3, __fmul_rn(k, __fmul_rn(b, b)));
      a4 = __fadd_rn(a4, __fmul_rn(k, __fmul_rn(a, b)));
    }
    vs[0][r][j] = a0;
    vs[1][r][j] = a1;
    vs[2][r][j] = a2;
    vs[3][r][j] = a3;
    vs[4][r][j] = a4;
  }
  __syncthreads();
  // the horizontal pass, the map and its sum: column c, rows w + 8 q
  const int c = tid & 31, warp = tid >> 5;
  float acc = 0.0f;
#pragma unroll 1
  for (int q = 0; q < kSsimTile / kSsimWarps; ++q) {
    const int r = warp + kSsimWarps * q;
    float b[5];
#pragma unroll
    for (int ch = 0; ch < 5; ++ch)
      b[ch] = blur_taps<kSsimTaps>(taps,
                                   [&](int t) { return vs[ch][r][c + t]; });
    const float m = ssim_map(b[0], b[1], b[2], b[3], b[4], c1, c2);
    acc = __fadd_rn(acc, (ty0 + r < h && tx0 + c < w) ? m : 0.0f);
  }
  const float s = warp_order_sum(acc, part);
  if (tid == 0)
    partials[(plane * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
}

// K15's finish. Grid (planes); partials [P, n]; out [P] = the plane's sum
// in the fixed order over f32(H * W) (count).
__global__ void __launch_bounds__(kFinishThreads)
    ssim_finish_kernel(const float* __restrict__ partials, int n,
                       float count, float* __restrict__ out) {
  __shared__ float part[kSsimWarps];
  const int64_t plane = blockIdx.x;
  const float* p = partials + plane * n;
  float acc = 0.0f;
  const int steps = (n + kFinishThreads - 1) / kFinishThreads;
  for (int j = 0; j < steps; ++j) {
    const int idx = j * kFinishThreads + threadIdx.x;
    acc = __fadd_rn(acc, idx < n ? __ldg(p + idx) : 0.0f);
  }
  const float s = warp_order_sum(acc, part);
  if (threadIdx.x == 0) out[plane] = __fdiv_rn(s, count);
}

__device__ __forceinline__ uint32_t sq_bytes(uint32_t a, uint32_t b) {
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = static_cast<int>((a >> (8 * k)) & 0xffu) -
                  static_cast<int>((b >> (8 * k)) & 0xffu);
    s += static_cast<uint32_t>(d * d);
  }
  return s;
}

// K16. Grid (chunks of kSqDiffPerCta bytes of an image, images); a, b
// [B, n] u8; sums [B] (zeroed by the wrapper) += the chunk's sum.
// kVector: n a multiple of 16 and a, b 16-byte aligned.
template <bool kVector>
__global__ void __launch_bounds__(kSqDiffThreads)
    sq_diff_kernel(const uint8_t* __restrict__ a,
                   const uint8_t* __restrict__ b, int64_t n,
                   unsigned long long* __restrict__ sums) {
  __shared__ unsigned long long part[kSqDiffThreads / 32];
  const int64_t img = blockIdx.y;
  const int64_t start = blockIdx.x * kSqDiffPerCta;
  const int64_t end = start + kSqDiffPerCta < n ? start + kSqDiffPerCta : n;
  a += img * n;
  b += img * n;
  uint32_t acc = 0;
  if (kVector) {
    for (int64_t i = start + 16 * threadIdx.x; i < end;
         i += 16 * kSqDiffThreads) {
      const uint4 va = __ldg(reinterpret_cast<const uint4*>(a + i));
      const uint4 vb = __ldg(reinterpret_cast<const uint4*>(b + i));
      acc += sq_bytes(va.x, vb.x) + sq_bytes(va.y, vb.y) +
             sq_bytes(va.z, vb.z) + sq_bytes(va.w, vb.w);
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += kSqDiffThreads) {
      const int d = static_cast<int>(__ldg(a + i)) - __ldg(b + i);
      acc += static_cast<uint32_t>(d * d);
    }
  }
  unsigned long long v = acc;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
#pragma unroll
    for (int k = 0; k < kSqDiffThreads / 32; ++k) s += part[k];
    atomicAdd(sums + img, s);
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace
}  // namespace dctsvd

using namespace dctsvd;

// K15. x: u8 planes [planes, h, w]; y: the same of u8 (y_f32 0) or f32
// (y_f32 1); rows [h + 10], cols [w + 10]: int32 reflect tables on the
// device; taps: 11 f32 in host memory; c1, c2: the f32 constants;
// partials: f32 [planes, ceil(h / 32), ceil(w / 32)] scratch; out: f32
// [planes]. Returns the cudaError_t of the launches.
extern "C" int dctsvd_ssim(const void* x, const void* y, int y_f32,
                           const void* rows, const void* cols,
                           const void* taps, float c1, float c2,
                           void* partials, void* out, int planes, int h,
                           int w, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || ceil_div(h, kSsimTile) > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BlurTaps t = blur_taps_of(static_cast<const float*>(taps),
                                  kSsimTaps);
  const int tx = ceil_div(w, kSsimTile), ty = ceil_div(h, kSsimTile);
  const int64_t per_plane = static_cast<int64_t>(h) * w;
  auto* part = static_cast<float*>(partials);
  for (int p0 = 0; p0 < planes; p0 += kMaxGrid) {
    const dim3 grid(tx, ty, planes - p0 < kMaxGrid ? planes - p0 : kMaxGrid);
    if (y_f32)
      ssim_kernel<float><<<grid, kSsimThreads, 0, st>>>(
          static_cast<const uint8_t*>(x) + p0 * per_plane,
          static_cast<const float*>(y) + p0 * per_plane,
          static_cast<const int*>(rows), static_cast<const int*>(cols), h, w,
          t, c1, c2, part + static_cast<int64_t>(p0) * tx * ty);
    else
      ssim_kernel<uint8_t><<<grid, kSsimThreads, 0, st>>>(
          static_cast<const uint8_t*>(x) + p0 * per_plane,
          static_cast<const uint8_t*>(y) + p0 * per_plane,
          static_cast<const int*>(rows), static_cast<const int*>(cols), h, w,
          t, c1, c2, part + static_cast<int64_t>(p0) * tx * ty);
  }
  ssim_finish_kernel<<<planes, kFinishThreads, 0, st>>>(
      part, tx * ty, static_cast<float>(per_plane),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K16. a, b: u8 [images, n]; sums: int64 [images], zeroed, += the exact
// sum of squared differences of each image. vector: n a multiple of 16
// and both pointers 16-byte aligned (ops/metrics_cuda.py::psnr_plan).
extern "C" int dctsvd_sq_diff(const void* a, const void* b, long long n,
                              int images, void* sums, int vector,
                              void* stream) {
  if (images <= 0 || n <= 0 || (vector && n % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (n + kSqDiffPerCta - 1) / kSqDiffPerCta;
  if (chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int i0 = 0; i0 < images; i0 += kMaxGrid) {
    const dim3 grid(static_cast<unsigned>(chunks),
                    images - i0 < kMaxGrid ? images - i0 : kMaxGrid);
    const auto* ai = static_cast<const uint8_t*>(a) + i0 * n;
    const auto* bi = static_cast<const uint8_t*>(b) + i0 * n;
    auto* out = static_cast<unsigned long long*>(sums) + i0;
    if (vector)
      sq_diff_kernel<true><<<grid, kSqDiffThreads, 0, st>>>(ai, bi, n, out);
    else
      sq_diff_kernel<false><<<grid, kSqDiffThreads, 0, st>>>(ai, bi, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
