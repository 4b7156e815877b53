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
// f32((0.01 * 255)^2), c2 = f32((0.03 * 255)^2)). The sum: each
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
// What bounds them on the H100. K15: issue, its f32 instructions and the
// shared-memory traffic that feeds them. Per pixel the vertical pass does
// 11 taps of 5 products and 5 sums and 3 products a halo pixel, the
// horizontal pass 11 taps of 5 and 5, the map about 20: about 250 f32
// instructions, so issue (132 SMs x 128 lanes at 1980 MHz) binds before
// the 3 bytes to 5 a pixel it reads from device memory, and the shared-
// memory traffic (about 110 bytes a pixel at 128 B a clock an SM) comes
// second. K16: bytes (2 n u8 an image, read once; 398 MB for 32 color
// 1080p frames, 0.119 ms).
//
// What the design does about it. A CTA of 256 threads walks a band of 32
// rows of a plane across kWalkBlocks blocks of 64 columns (two sum tiles
// each). For each block it reads the 42 rows of x and y at the block's 64
// new padded columns once into shared memory as f32 (21 KB). The vertical
// pass: every thread (the block's 64 columns x 4 runs of 8 rows, so no
// warp waits at the barrier and each scheduler has two) runs down one
// column for 8 output rows, reads its 18 values of x and of y once into
// registers, forms each product x x, y y, x y once a halo pixel, and sums
// the 11 taps of each output from those registers into the five vertical
// planes (5 x 32 rows x 76 floats, 49 KB); the 10 padded columns before
// the block's new ones are the previous block's last 10, copied over, so
// no column's vertical pass is made twice within a walk. The horizontal
// pass: thread (warp g, lane r) takes row r's 8 outputs at columns 8 g ..
// 8 g + 7 and reads the 20 values it needs from each plane as five
// 16-byte loads (eight lanes' rows on eight distinct bank groups: 76
// floats is 19 16-byte units), so a plane's value is loaded 2.5 times a
// pixel where the one-pixel-a-thread form loaded it 11 times; the map of
// its 8 pixels goes to a 32 x 65 shared tile (over x and y, no longer
// read) and the fixed-order sum reads it back as thread (w, c) of each
// 32 x 32 tile. 70 KB of dynamic shared memory a CTA (opted in), three
// CTAs an SM. The whole batch is one launch (grid walks x row tiles x
// planes) and the finish one more. K16 reads both inputs in 16-byte loads
// where n is a multiple of 16 and both pointers 16-byte aligned (else a
// byte a thread), kSqDiffPerCta bytes of an image a CTA.

#include <cuda_runtime.h>

#include <cstdint>

#include "blur.cuh"

namespace dctsvd {
namespace {

constexpr int kSsimTile = 32;                   // a sum tile: one partial
constexpr int kSsimR = 5;                       // 11 taps
constexpr int kSsimTaps = 2 * kSsimR + 1;
constexpr int kSsimThreads = 256;
constexpr int kSsimWarps = kSsimThreads / 32;
// A CTA walks a row band of kSsimTile rows across kWalkBlocks blocks of
// kBlockW columns (two sum tiles); a block's vertical pass covers the
// kBlockW + 2 R padded columns it needs, of which the last 2 R are the
// next block's first: kept, not computed again.
constexpr int kBlockW = 2 * kSsimTile;          // 64
constexpr int kCarry = 2 * kSsimR;              // 10 columns carried over
constexpr int kWalkBlocks = 8;
constexpr int kHaloH = kSsimTile + 2 * kSsimR;  // 42
// the vertical pass: a thread down one column for kVRows outputs
constexpr int kVRows = 8;
constexpr int kVIn = kVRows + kSsimTaps - 1;    // 18 inputs
constexpr int kVItems = kBlockW * (kSsimTile / kVRows);  // 256: every warp
constexpr int kVPitch = 76;     // a vertical plane's row: 19 16-byte units
// the horizontal pass: a thread along a row for kHCols outputs
constexpr int kHCols = 8;
constexpr int kHIn = 20;        // kHCols + 10, rounded up to 16-byte loads
constexpr int kMapPitch = 65;   // the staged map's row
constexpr int kLoadRows = kSsimThreads / kBlockW;        // 4 row groups
// dynamic shared memory (floats): xs, ys [kHaloH][kBlockW] (a block's new
// columns of x and y; the map [kSsimTile][kMapPitch] over them once the
// vertical pass has read them), vs [5][kSsimTile][kVPitch] (the vertical
// planes at the block's kCarry + kBlockW padded columns), part
// [2][kSsimWarps]
constexpr int kHaloFloats = kHaloH * kBlockW;
constexpr int kVsOffset = 2 * kHaloFloats;
constexpr int kPartOffset = kVsOffset + 5 * kSsimTile * kVPitch;
constexpr int kSsimSmemBytes = 4 * (kPartOffset + 2 * kSsimWarps);
static_assert(kSsimThreads == kSsimWarps * kSsimTile, "a warp a row of 8");
static_assert(kBlockW / kHCols * kSsimTile == kSsimThreads,
              "the horizontal pass: a thread a row segment");
static_assert(kVItems == kSsimThreads, "the vertical pass: every thread");
static_assert(kVsOffset % 4 == 0 && kVPitch % 4 == 0 &&
                  kHCols * (kBlockW / kHCols - 1) + kHIn <= kVPitch &&
                  kCarry + kBlockW <= kVPitch,
              "16-byte loads inside a plane's row");
static_assert(kSsimTile * kMapPitch <= 2 * kHaloFloats, "the map's tile");
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

// One of the vertical pass's five inputs from a halo pixel's x and y: x,
// y, x x, y y, x y.
template <int kCh>
__device__ __forceinline__ float vertical_input(float a, float b) {
  if constexpr (kCh == 0) return a;
  if constexpr (kCh == 1) return b;
  if constexpr (kCh == 2) return __fmul_rn(a, a);
  if constexpr (kCh == 3) return __fmul_rn(b, b);
  return __fmul_rn(a, b);
}

// The vertical pass of input kCh for one thread's run down a column from
// halo row r0: its kVIn values of x and y in registers -> plane kCh's rows
// r0 .. r0 + kVRows - 1 at column vc; each product formed once a halo
// pixel.
template <int kCh>
__device__ __forceinline__ void vertical_run(const BlurTaps& taps,
                                             const float (&xv)[kVIn],
                                             const float (&yv)[kVIn],
                                             float* vs, int r0, int vc) {
  float v[kVIn];
#pragma unroll
  for (int i = 0; i < kVIn; ++i) v[i] = vertical_input<kCh>(xv[i], yv[i]);
  float* out = vs + (kCh * kSsimTile + r0) * kVPitch + vc;
  blur_run<kSsimTaps>(taps, v,
                      [&](int o, float s) { out[o * kVPitch] = s; });
}

// One thread's vertical runs of the five inputs: column j of xs, ys (x
// and y read from shared memory once) from halo row r0 into column vc of
// the planes.
__device__ __forceinline__ void vertical_item(const BlurTaps& taps,
                                              const float* xs,
                                              const float* ys, float* vs,
                                              int r0, int j, int vc) {
  float xv[kVIn], yv[kVIn];
#pragma unroll
  for (int i = 0; i < kVIn; ++i) {
    xv[i] = xs[(r0 + i) * kBlockW + j];
    yv[i] = ys[(r0 + i) * kBlockW + j];
  }
  // x y first, while both are live; x's last use, then y's
  vertical_run<4>(taps, xv, yv, vs, r0, vc);
  vertical_run<2>(taps, xv, yv, vs, r0, vc);
  vertical_run<0>(taps, xv, yv, vs, r0, vc);
  vertical_run<3>(taps, xv, yv, vs, r0, vc);
  vertical_run<1>(taps, xv, yv, vs, r0, vc);
}

// Columns p0 .. p0 + n - 1 of the padded plane's halo rows (row band ty0)
// into xs, ys columns 0 .. n - 1: thread (group g, column q) its column at
// rows g, g + kLoadRows, ..., every load issued before the first store.
template <typename T2>
__device__ __forceinline__ void load_columns(
    const uint8_t* __restrict__ x, const T2* __restrict__ y,
    const int* __restrict__ rows, const int* __restrict__ cols, int64_t base,
    int w, int nr, int nc, int ty0, int p0, int n, float* xs, float* ys) {
  const int q = threadIdx.x % kBlockW, g = threadIdx.x / kBlockW;
  if (q >= n) return;
  constexpr int kRows = (kHaloH + kLoadRows - 1) / kLoadRows;   // 11
  const int sc = blur_src(cols, p0 + q, nc);
  int64_t src[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = g + kLoadRows * i;
    src[i] = base + static_cast<int64_t>(
                        blur_src(rows, ty0 + (p < kHaloH ? p : 0), nr)) * w +
             sc;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = g + kLoadRows * i;
    if (p < kHaloH) {
      xs[p * kBlockW + q] = to_f32(__ldg(x + src[i]));
      ys[p * kBlockW + q] = to_f32(__ldg(y + src[i]));
    }
  }
}

// K15. Grid (walks of kWalkBlocks blocks, row tiles, planes of this
// launch); plane blockIdx.z of x and y; partials [P, row tiles, column
// tiles] (tx column tiles); kSsimSmemBytes of dynamic shared memory.
template <typename T2>
__global__ void __launch_bounds__(kSsimThreads, 3)
    ssim_kernel(const uint8_t* __restrict__ x, const T2* __restrict__ y,
                const int* __restrict__ rows, const int* __restrict__ cols,
                int h, int w, int tx, BlurTaps taps, float c1, float c2,
                float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = smem + kHaloFloats;
  float* vs = smem + kVsOffset;
  float* part = smem + kPartOffset;
  float* ms = smem;                     // the map, once xs, ys are read
  const int tid = threadIdx.x, c = tid & 31, warp = tid >> 5;
  const int64_t plane = blockIdx.z;
  const int64_t base = plane * h * static_cast<int64_t>(w);
  const int ty0 = blockIdx.y * kSsimTile;
  const int nr = h + 2 * kSsimR, nc = w + 2 * kSsimR;
  const int b0 = blockIdx.x * kWalkBlocks;
  const int b1 = min(b0 + kWalkBlocks, (w + kBlockW - 1) / kBlockW);
  // the first block's leading kCarry padded columns, into planes' 0 .. 9
  load_columns(x, y, rows, cols, base, w, nr, nc, ty0, b0 * kBlockW, kCarry,
               xs, ys);
  __syncthreads();
  if (tid < kCarry * (kSsimTile / kVRows))
    vertical_item(taps, xs, ys, vs, (tid / kCarry) * kVRows, tid % kCarry,
                  tid % kCarry);
  __syncthreads();
  for (int b = b0; b < b1; ++b) {
    const int tx0 = b * kBlockW;
    // the block's new padded columns tx0 + 10 .. tx0 + 73: planes' 10 .. 73
    load_columns(x, y, rows, cols, base, w, nr, nc, ty0, tx0 + kCarry,
                 kBlockW, xs, ys);
    __syncthreads();
    if (tid < kVItems)
      vertical_item(taps, xs, ys, vs, (tid / kBlockW) * kVRows,
                    tid % kBlockW, kCarry + tid % kBlockW);
    __syncthreads();
    // the horizontal pass and the map: row r (the lane), columns c0 .. c0+7
    {
      const int r = c, c0 = warp * kHCols;
      float bl[5][kHCols];
#pragma unroll
      for (int ch = 0; ch < 5; ++ch) {
        const float4* row = reinterpret_cast<const float4*>(
            vs + (ch * kSsimTile + r) * kVPitch + c0);
        float v[kHIn];
#pragma unroll
        for (int k = 0; k < kHIn / 4; ++k) {
          const float4 q = row[k];
          v[4 * k] = q.x;
          v[4 * k + 1] = q.y;
          v[4 * k + 2] = q.z;
          v[4 * k + 3] = q.w;
        }
        float u[kHCols + kSsimTaps - 1];  // the 18 of the 20 that it uses
#pragma unroll
        for (int i = 0; i < kHCols + kSsimTaps - 1; ++i) u[i] = v[i];
        blur_run<kSsimTaps>(taps, u,
                            [&](int o, float s) { bl[ch][o] = s; });
      }
      const bool row_in = ty0 + r < h;
#pragma unroll
      for (int o = 0; o < kHCols; ++o) {
        const float m = ssim_map(bl[0][o], bl[1][o], bl[2][o], bl[3][o],
                                 bl[4][o], c1, c2);
        ms[r * kMapPitch + c0 + o] = row_in && tx0 + c0 + o < w ? m : 0.0f;
      }
    }
    __syncthreads();
    // each 32 x 32 tile's sum: thread (warp w, lane c) column c, rows
    // w + 8 q; and the last kCarry columns of the planes to their first
    float acc[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int q = 0; q < kSsimTile / kSsimWarps; ++q)
        acc[t] = __fadd_rn(
            acc[t],
            ms[(warp + kSsimWarps * q) * kMapPitch + kSsimTile * t + c]);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float v = lane_tree(acc[t]);
      if (c == 0) part[t * kSsimWarps + warp] = v;
    }
    for (int i = tid; i < 5 * kSsimTile * kCarry; i += kSsimThreads) {
      const int row = i / kCarry, k = i - row * kCarry;
      vs[row * kVPitch + k] = vs[row * kVPitch + kBlockW + k];
    }
    __syncthreads();
    if (tid < 2) {
      const int col_tile = 2 * b + tid;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kSsimWarps; ++k)
        s = __fadd_rn(s, part[tid * kSsimWarps + k]);
      if (col_tile < tx)
        partials[(plane * gridDim.y + blockIdx.y) * tx + col_tile] = s;
    }
  }
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
  const int walks = ceil_div(ceil_div(w, kBlockW), kWalkBlocks);
  const int64_t per_plane = static_cast<int64_t>(h) * w;
  auto* part = static_cast<float*>(partials);
  // above 48 KB of shared memory a CTA only by the kernel's opt-in
  const cudaError_t opt =
      y_f32 ? cudaFuncSetAttribute(ssim_kernel<float>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSsimSmemBytes)
            : cudaFuncSetAttribute(ssim_kernel<uint8_t>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSsimSmemBytes);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  for (int p0 = 0; p0 < planes; p0 += kMaxGrid) {
    const dim3 grid(walks, ty,
                    planes - p0 < kMaxGrid ? planes - p0 : kMaxGrid);
    if (y_f32)
      ssim_kernel<float><<<grid, kSsimThreads, kSsimSmemBytes, st>>>(
          static_cast<const uint8_t*>(x) + p0 * per_plane,
          static_cast<const float*>(y) + p0 * per_plane,
          static_cast<const int*>(rows), static_cast<const int*>(cols), h, w,
          tx, t, c1, c2, part + static_cast<int64_t>(p0) * tx * ty);
    else
      ssim_kernel<uint8_t><<<grid, kSsimThreads, kSsimSmemBytes, st>>>(
          static_cast<const uint8_t*>(x) + p0 * per_plane,
          static_cast<const uint8_t*>(y) + p0 * per_plane,
          static_cast<const int*>(rows), static_cast<const int*>(cols), h, w,
          tx, t, c1, c2, part + static_cast<int64_t>(p0) * tx * ty);
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
