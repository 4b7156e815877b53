// K10, K11 and K14: the extraction enhancement chain's non-local means,
// CLAHE and unsharp mask on the card.
//
// They replace no pl.pallas_call: in the JAX package all three are XLA
// graphs, nlm_gray_u8 (dctsvd_tpu/ops/enhance.py:189, one jitted lax.scan
// over the 441 offsets of the search window), nlm_color_u8 (:234, three
// such planes of YCrCb), clahe_u8 (:92) and unsharp_u8 (:76, over
// gaussian_blur :45). The port ran them as eager op chains (about 7,000
// launches a plane for NLM, 30 for unsharp). Plain twins: dctsvd_tpu_torch/
// ops/enhance.py::nlm_planes_plain, clahe_luts_plain, clahe_apply_plain and
// unsharp_plain, which follow this file's order of operations step for
// step; the wrappers are dctsvd_tpu_torch/ops/enhance_cuda.py.
//
// K10 nlm_kernel: u8 planes [P, H, W] and an h^2 a plane (gray: h 7, h^2
// 49; color: the Y, Cr and Cb planes of a frame, h^2 9 each) -> u8 planes.
// R is reflect-101 on each axis (period 2(n - 1); every index 0 when
// n = 1), as reflect_index. For each pixel p and offset o in (dy, dx)
// raster order over [-10, 10]^2:
//   D = sum over t in [-3, 3]^2 of (x(c) - x(R(c + o)))^2, c = R(p + t):
//       the JAX package box-filters the squared-difference image with
//       reflected borders, so a window centre is reflected before the
//       offset is added (x(R(R(p + t) + o)), not x(R(p + t + o)));
//   w = exp(-((D / 49) / h^2)), each division one IEEE division;
//   wsum += w, vsum += w * x(R(p + o)), a product then a sum, in offset
//   order; out = rint(vsum / max(wsum, 1e-12)) clamped to [0, 255].
// D is an integer of at most 49 * 255^2 = 3,186,225 < 2^24, summed in
// int32: exact in any order, so only the weights' sums fix the order.
// expf is libdevice's full-precision expf, as torch's exp on the card
// (tests/test_torch_gpu.py holds nlm_weight to torch.exp for every D at
// h^2 9 and 49).
//
// K11 clahe_lut_kernel: a CTA a (plane, tile) of the tiles x tiles grid of
// th x tw tiles (th = ceil(H / tiles), tw = ceil(W / tiles); rows and
// columns past H and W reflected): the tile's 256-bin histogram (a
// sub-histogram a warp, int atomics in shared memory), clipped at `limit`
// with cv2's stepped redistribution of the excess (excess / 256 to every
// bin, then one more to bins 0, step, 2 step, ... while b / step < resid,
// step = max(floor(256 / max(resid, 1)), 1), each division one IEEE
// division), its inclusive cumulative sum and LUT = rint(cdf * scale)
// clamped to [0, 255] as u8 [P, tiles^2, 256]. Every count is an integer
// below 2^24, so the twin's f32 sums are exact in any order.
// K11 clahe_apply_kernel: a thread a pixel: ty = y / th - 0.5 and tx (one
// division each), the four neighbouring tiles (clamped to the grid), the
// weights wy, wx clamped to [0, 1], the four LUT entries at the pixel's
// value and ((1 - wy)((1 - wx) v00 + wx v01) + wy((1 - wx) v10 + wx v11))
// in that order, then rint, clamp and u8.
// Every product, sum and division rounds once (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: never contracted, never a product by a
// reciprocal), so each kernel is bit-equal to its twin run on the card.
//
// K14 unsharp_kernel<C>: u8 planes [P, H, W] (C 1) or channels-last
// frames [P, H, W, 3] (C 3, each channel blurred as its own plane) -> u8:
// round(amount * e + weight * B(e)) clamped to [0, 255], B the separable
// Gaussian of csrc/blur.cuh at sigma 1 (7 taps, both chains' blur),
// byte for byte gaussian_blur's shift-and-add; amount * e, weight * B and
// their sum each one f32 rounding (torch computes the Python scalars as
// f32), rintf as torch.round (half to even).
//
// What bounds them on the H100. K10: the work, not the bytes (one u8 read
// and one u8 write a pixel: 1.2 us for a 1080p plane). The least-work form
// (sliding column and row sums of the squared differences) does about 12
// f32 or int operations and one exp (MUFU) a pixel and offset: at 1080p,
// 914 M pixel-offsets a plane, 0.16 ms of f32 issue and 0.22 ms of the
// SFU's 16 results a clock an SM. The weight itself, two IEEE divisions
// and libdevice's expf, is about 30 SASS instructions, so issue binds
// before the SFU does. K11: bytes and launches (a 1080p plane is 2 MB;
// the LUTs 16 KB a plane). K14: bytes (a u8 read and a u8 write a pixel
// and channel: 12.4 MB, 0.0037 ms, for a 1080p color frame) before its
// 33 f32 operations a pixel and channel; a 1080p frame is one launch of a
// few microseconds.
//
// What the design does about it. K10 forms each offset's window sums by
// separable sliding sums, each squared difference once a cell, where the
// simple form loaded 49 bytes of shared memory a pixel and offset. A CTA
// takes a kNlmTileW x kNlmTileH tile of one plane and stages its reflected
// halo (x(R(g)) for every g within 13 of the tile) in shared memory once.
// Its footprint is the tile +- 3: for each cell g the reflected centre
// R(g) is a halo row and column (a cell past the plane's last row or
// column + 3 serves only pixels past the plane and is clamped), so both
// x(R(g)) and x(R(R(g) + o)) are halo reads. For each offset, in raster
// order: pass 1, an item a thread (kRowItems of them), takes one footprint
// row and kNlmRowRun columns, keeps its cells' centres in registers, forms
// their squared differences (one halo byte each) and the 7-cell row sums
// by a running add and subtract, stored to shared memory; one barrier;
// pass 2, a thread kNlmRun pixels down one column, forms their 7-row sums
// of the row sums the same way and, in the pixels' registers, the weights
// and the two sums. The row sums are double-buffered, so an offset costs
// one barrier. Window sums are integers below 2^24, exact in any order,
// so the weights, wsum and vsum see the same values in the same order as
// the simple form and the twin. The weight is exactly +0.0 from a window
// sum on (expf underflows; the CTA finds that cutoff by bisection over
// nlm_weight, whose values fall with n); adding +0.0 changes neither sum,
// so a warp whose pixels' sums are all at or past it skips the offset's
// weights. What binds K10 now is the weight: its 32 SASS instructions a
// pixel and offset (two IEEE divisions, each with its slow-path check, and
// expf) take 0.87 ms of issue a 1080p plane at 1980 MHz, and their
// dependent chains, 128 registers a thread (16 warps an SM) and the
// barrier an offset keep K10 at about 40 % of that rate. A branch-free
// division, packed centres for more warps and a warp-specialised form
// (pass 1 on warps of its own) measured no faster (PERF.md section 6).
// K11 takes the histogram a tile per CTA (64 CTAs a plane), and the
// interpolation a row segment of 256 pixels per CTA, its LUTs read
// through the L1 cache. K14 takes a 32 x 32 tile of a plane or frame a
// CTA: its halo (tile + R a side, through the twin's reflect tables) read
// once into shared memory as f32, the vertical pass over the halo's width
// into shared memory, the horizontal pass and the epilogue a pixel a
// thread; the eager form wrote and read 2 x 7 f32 temporaries of the
// padded plane, and the color chain two channels-last copies.

#include <cuda_runtime.h>

#include <cstdint>

#include "blur.cuh"

namespace dctsvd {
namespace {

constexpr int kTr = 3;                       // template radius (7 x 7)
constexpr int kSr = 10;                      // search radius (21 x 21)
constexpr int kTaps = 2 * kTr + 1;
constexpr int kHalo = kTr + kSr;             // 13
constexpr float kTemplateArea = static_cast<float>(kTaps * kTaps);
constexpr int kMaxWindowSum = kTaps * kTaps * 255 * 255;   // 3,186,225

// K10's tiling (PERF.md section 6 lists the forms measured): a CTA takes a
// kNlmTileW x kNlmTileH tile of one plane; in pass 2 a thread owns kNlmRun
// pixels down one column, in pass 1 an item kNlmRowRun row sums along one
// footprint row.
constexpr int kNlmTileW = 32;
constexpr int kNlmTileH = 64;
constexpr int kNlmRun = 16;
constexpr int kNlmRowRun = 32;
constexpr int kNlmMinBlocks = 4;
constexpr int kNlmThreads = kNlmTileW * (kNlmTileH / kNlmRun);
constexpr int kFootW = kNlmTileW + 2 * kTr;  // the window centres' footprint
constexpr int kFootH = kNlmTileH + 2 * kTr;
constexpr int kRowCells = kNlmRowRun + 2 * kTr;   // cells a pass-1 item
constexpr int kRowItems = kFootH * (kNlmTileW / kNlmRowRun);
// the staged halo (tile +- 13); a row's bytes are 4 mod 8, so pass 1's
// lanes, on consecutive footprint rows, read distinct shared-memory banks
constexpr int kHaloW = (kNlmTileW + 2 * kHalo + 3) / 8 * 8 + 4;
constexpr int kHaloH = kNlmTileH + 2 * kHalo;
// the row sums [kFootH][kNlmTileW], at an odd row stride (distinct banks
// for pass 1's stores), twice: offset o writes buffer o % 2
constexpr int kSumStride = kNlmTileW + 1;
constexpr int kSumBuf = kFootH * kSumStride;
static_assert(kNlmTileW % kNlmRowRun == 0 && kNlmTileH % kNlmRun == 0,
              "K10's runs must tile its tile");
static_assert(kRowItems <= kNlmThreads, "a pass-1 item a thread at most");
static_assert(kNlmThreads % 32 == 0, "whole warps");

// K14's tile: a CTA of kUnsharpThreads threads takes kUnsharpTile x
// kUnsharpTile output pixels of one plane or frame, all of its channels.
constexpr int kUnsharpTile = 32;
constexpr int kUnsharpThreads = 256;
// Its blur's radius: sigma 1, 7 taps (the only sigma either chain takes).
constexpr int kUnsharpR = 3;

constexpr int kBins = 256;
constexpr int kClaheThreads = 256;           // a bin a thread
constexpr int kClaheWarps = kClaheThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGrid = 65535;              // planes a launch (grid z / y)

// Reflect-101 index of i on an axis of length n (dctsvd_tpu_torch/ops/
// enhance.py::reflect_index).
__device__ __forceinline__ int reflect(int i, int n) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - m;
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(static_cast<int>(fminf(fmaxf(v, 0.0f),
                                                     255.0f)));
}

// The weight of an offset whose window sum of squared differences is n.
__device__ __forceinline__ float nlm_weight(int n, float h2) {
  const float d = __fdiv_rn(static_cast<float>(n), kTemplateArea);
  return expf(-__fdiv_rn(d, h2));
}

// The least window sum whose weight is +0.0 at h2 (kMaxWindowSum + 1 when
// every weight is positive), by bisection over the weights, which are
// non-increasing in n (tests/test_torch_gpu.py checks every n at h^2 9 and
// 49).
__device__ __forceinline__ int nlm_cutoff(float h2) {
  int lo = 0, hi = kMaxWindowSum + 1;
#pragma unroll 1
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (nlm_weight(mid, h2) == 0.0f)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Pass 1 of one offset for one item: the row sums of one footprint row at
// footprint columns col0 .. col0 + kNlmRowRun - 1, each over the squared
// differences of cells col .. col + 6, to dst. c: the cells' centres
// x(R(g)); a cell's shifted value x(R(R(g) + o)) lies at its centre's halo
// offset + off. kContig: no cell is reflected, so the centres' halo
// offsets are base + j; else base (the row's) + ccol[j].
template <bool kContig>
__device__ __forceinline__ void nlm_row_sums(const uint8_t* xs,
                                             const int* ccol, int base,
                                             int off,
                                             const int (&c)[kRowCells],
                                             int* dst) {
  int d2[kRowCells];
#pragma unroll
  for (int j = 0; j < kRowCells; ++j) {
    const int d = c[j] - xs[base + off + (kContig ? j : ccol[j])];
    d2[j] = d * d;
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) sum += d2[j];
  dst[0] = sum;
#pragma unroll
  for (int j = 1; j < kNlmRowRun; ++j) {
    sum += d2[j + kTaps - 1] - d2[j - 1];
    dst[j] = sum;
  }
}

// K10. Grid (column tiles, row tiles, planes of this launch); plane
// plane0 + blockIdx.z of x, h2s [P] f32, out.
__global__ void __launch_bounds__(kNlmThreads, kNlmMinBlocks)
    nlm_kernel(const uint8_t* __restrict__ x, const float* __restrict__ h2s,
               uint8_t* __restrict__ out, int h, int w, int plane0) {
  __shared__ uint8_t xs[kHaloH * kHaloW];
  __shared__ int sums[2 * kSumBuf];
  __shared__ int ccol[kFootW];
  const int tid = threadIdx.x;
  const int64_t plane = plane0 + static_cast<int64_t>(blockIdx.z);
  const int64_t pix = static_cast<int64_t>(h) * w;
  const uint8_t* src = x + plane * pix;
  const int ty0 = blockIdx.y * kNlmTileH, tx0 = blockIdx.x * kNlmTileW;
  for (int i = tid; i < kHaloH * kHaloW; i += kNlmThreads) {
    const int r = i / kHaloW, c = i - r * kHaloW;
    xs[i] = __ldg(src + static_cast<int64_t>(reflect(ty0 - kHalo + r, h)) * w
                  + reflect(tx0 - kHalo + c, w));
  }
  // each footprint column's reflected centre as a halo column; a column
  // past w + 2 serves only pixels past the plane and is clamped into it
  for (int i = tid; i < kFootW; i += kNlmThreads)
    ccol[i] = reflect(min(tx0 - kTr + i, w - 1 + kTr), w) - (tx0 - kHalo);
  __syncthreads();

  // pass 1's item: footprint row `row`, columns col0 ..
  const bool row_item = tid < kRowItems;
  const int row = tid % kFootH, col0 = tid / kFootH * kNlmRowRun;
  const int crow =
      (reflect(min(ty0 - kTr + row, h - 1 + kTr), h) - (ty0 - kHalo)) *
      kHaloW;
  const int gx0 = tx0 - kTr + col0;
  const bool contig = row_item && gx0 >= 0 && gx0 + kRowCells <= w;
  const int base = crow + (contig ? ccol[col0] : 0);
  int c[kRowCells];
#pragma unroll
  for (int j = 0; j < kRowCells; ++j)
    c[j] = row_item ? xs[crow + ccol[col0 + j]] : 0;
  // pass 2's run: column lx, rows ly0 .. ly0 + kNlmRun - 1 of the tile
  const int lx = tid % kNlmTileW, ly0 = tid / kNlmTileW * kNlmRun;
  const int self = (ly0 + kHalo) * kHaloW + lx + kHalo;
  const float h2 = h2s[plane];
  const int cutoff = nlm_cutoff(h2);
  float wsum[kNlmRun], vsum[kNlmRun];
#pragma unroll
  for (int i = 0; i < kNlmRun; ++i) wsum[i] = vsum[i] = 0.0f;

  int buf = 0;
#pragma unroll 1
  for (int dy = -kSr; dy <= kSr; ++dy) {
#pragma unroll 1
    for (int dx = -kSr; dx <= kSr; ++dx) {
      const int off = dy * kHaloW + dx;
      int* rs = sums + buf * kSumBuf;
      if (row_item) {
        int* dst = rs + row * kSumStride + col0;
        if (contig)
          nlm_row_sums<true>(xs, ccol + col0, base, off, c, dst);
        else
          nlm_row_sums<false>(xs, ccol + col0, base, off, c, dst);
      }
      // one barrier an offset: the next offset writes the other buffer,
      // and no thread passes this barrier before all have read this one
      __syncthreads();
      const int* col = rs + ly0 * kSumStride + lx;
      int v[kNlmRun + kTaps - 1];
#pragma unroll
      for (int j = 0; j < kNlmRun + kTaps - 1; ++j) v[j] = col[j * kSumStride];
      int dist[kNlmRun];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) sum += v[j];
      dist[0] = sum;
      int least = sum;
#pragma unroll
      for (int i = 1; i < kNlmRun; ++i) {
        sum += v[i + kTaps - 1] - v[i - 1];
        dist[i] = sum;
        least = min(least, sum);
      }
      // the weights past the cutoff are +0.0: a warp all of whose sums are
      // there skips the offset
      if (__any_sync(kFull, least < cutoff)) {
#pragma unroll
        for (int i = 0; i < kNlmRun; ++i) {
          const float wt = nlm_weight(dist[i], h2);
          wsum[i] = __fadd_rn(wsum[i], wt);
          vsum[i] = __fadd_rn(
              vsum[i],
              __fmul_rn(wt, static_cast<float>(xs[self + i * kHaloW + off])));
        }
      }
      buf ^= 1;
    }
  }
  const int px = tx0 + lx;
#pragma unroll
  for (int i = 0; i < kNlmRun; ++i) {
    const int py = ty0 + ly0 + i;
    if (py < h && px < w)
      out[plane * pix + static_cast<int64_t>(py) * w + px] =
          to_u8(rintf(__fdiv_rn(vsum[i], fmaxf(wsum[i], 1e-12f))));
  }
}

// K14. Grid (column tiles, row tiles, planes of this launch); plane or
// frame plane0 + blockIdx.z of x [P, H, W, kC] u8 (kC 1: planes), out the
// same. rows [H + 2 kR] and cols [W + 2 kR]: the twin's reflect tables
// (kR = kUnsharpR, sigma 1's 7 taps).
// The halo (tile + kR on each side) as f32 in shared memory, the vertical
// pass over its full width into shared memory, then the horizontal pass and
// the epilogue a pixel a thread: round(amount * e + weight * blur) as
// rintf (torch.round: half to even), clamped to [0, 255], u8. Each channel
// of a channels-last frame is blurred as its own plane.
template <int kC>
__global__ void __launch_bounds__(kUnsharpThreads)
    unsharp_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                   const int* __restrict__ rows, const int* __restrict__ cols,
                   int h, int w, BlurTaps taps, float amount, float weight,
                   int plane0) {
  constexpr int kR = kUnsharpR, kTaps = 2 * kR + 1;
  constexpr int kHalo = kUnsharpTile + 2 * kR;
  __shared__ float xs[kC][kHalo][kHalo];
  __shared__ float vs[kC][kUnsharpTile][kHalo];
  const int tid = threadIdx.x;
  const int64_t plane = plane0 + static_cast<int64_t>(blockIdx.z);
  const int64_t base = plane * h * static_cast<int64_t>(w) * kC;
  const int ty0 = blockIdx.y * kUnsharpTile, tx0 = blockIdx.x * kUnsharpTile;
  const int nr = h + 2 * kR, nc = w + 2 * kR;
  for (int i = tid; i < kHalo * kHalo * kC; i += kUnsharpThreads) {
    const int ch = i % kC, p = i / kC;
    const int r = p / kHalo, c = p - r * kHalo;
    const int64_t src =
        static_cast<int64_t>(blur_src(rows, ty0 + r, nr)) * w +
        blur_src(cols, tx0 + c, nc);
    xs[ch][r][c] = static_cast<float>(__ldg(x + base + src * kC + ch));
  }
  __syncthreads();
  for (int i = tid; i < kC * kUnsharpTile * kHalo; i += kUnsharpThreads) {
    const int ch = i / (kUnsharpTile * kHalo);
    const int rem = i - ch * (kUnsharpTile * kHalo);
    const int r = rem / kHalo, j = rem - r * kHalo;
    vs[ch][r][j] =
        blur_taps<kTaps>(taps, [&](int t) { return xs[ch][r + t][j]; });
  }
  __syncthreads();
  for (int i = tid; i < kUnsharpTile * kUnsharpTile; i += kUnsharpThreads) {
    const int r = i / kUnsharpTile, c = i - r * kUnsharpTile;
    const int py = ty0 + r, px = tx0 + c;
    if (py >= h || px >= w) continue;
    uint8_t* o = out + base + (static_cast<int64_t>(py) * w + px) * kC;
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) {
      const float b =
          blur_taps<kTaps>(taps, [&](int t) { return vs[ch][r][c + t]; });
      const float e = xs[ch][r + kR][c + kR];
      o[ch] = to_u8(rintf(__fadd_rn(__fmul_rn(amount, e),
                                    __fmul_rn(weight, b))));
    }
  }
}

// nlm_weight for n = 0 .. count - 1 at one h^2 (the tests' and the smoke's
// exhaustive check of the exp against torch's).
__global__ void nlm_weight_kernel(const float* __restrict__ h2,
                                  float* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = nlm_weight(i, *h2);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// K11's LUTs. Grid (tiles^2, planes of this launch); plane plane0 +
// blockIdx.y; luts [P, tiles^2, 256].
__global__ void __launch_bounds__(kClaheThreads)
    clahe_lut_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ luts,
                     int h, int w, int tiles, int th, int tw, int limit,
                     float scale, int plane0) {
  __shared__ int hist[kClaheWarps][kBins];
  __shared__ int part[kClaheWarps];
  const int64_t plane = plane0 + static_cast<int64_t>(blockIdx.y);
  const int tile = blockIdx.x;
  const int ty = tile / tiles, tx = tile - ty * tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kClaheWarps; ++k) hist[k][b] = 0;
  __syncthreads();
  const uint8_t* src = x + plane * h * static_cast<int64_t>(w);
  for (int r = warp; r < th; r += kClaheWarps) {
    const uint8_t* row =
        src + static_cast<int64_t>(reflect(ty * th + r, h)) * w;
    for (int c = lane; c < tw; c += 32)
      atomicAdd(&hist[warp][__ldg(row + reflect(tx * tw + c, w))], 1);
  }
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int k = 0; k < kClaheWarps; ++k) count += hist[k][b];
  // clip, and the excess over all bins (integers: exact)
  const int clipped = min(count, limit);
  int excess = warp_sum(count - clipped);
  if (lane == 0) part[warp] = excess;
  __syncthreads();
  excess = 0;
#pragma unroll
  for (int k = 0; k < kClaheWarps; ++k) excess += part[k];
  const int batch = excess / kBins;            // floor(excess / 256)
  const float resid = static_cast<float>(excess - batch * kBins);
  const float step =
      fmaxf(floorf(__fdiv_rn(256.0f, fmaxf(resid, 1.0f))), 1.0f);
  const float bf = static_cast<float>(b);
  const bool hit = b % static_cast<int>(step) == 0 &&
                   floorf(__fdiv_rn(bf, step)) < resid;
  int v = clipped + batch + (hit ? 1 : 0);
  // inclusive scan over the 256 bins: a warp's lanes, then the warps'
  // totals
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  __syncthreads();                             // part[] read above
  if (lane == 31) part[warp] = v;
  __syncthreads();
  for (int k = 0; k < warp; ++k) v += part[k];
  const float lut = rintf(__fmul_rn(static_cast<float>(v), scale));
  luts[(plane * tiles * tiles + tile) * kBins + b] = to_u8(lut);
}

// K11's interpolation. Grid (column segments of 256, rows, planes of this
// launch); plane plane0 + blockIdx.z.
__global__ void __launch_bounds__(kClaheThreads)
    clahe_apply_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ luts,
                       uint8_t* __restrict__ out, int h, int w, int tiles,
                       int th, int tw, int plane0) {
  const int64_t plane = plane0 + static_cast<int64_t>(blockIdx.z);
  const int y = blockIdx.y;
  const int c = blockIdx.x * kClaheThreads + threadIdx.x;
  if (c >= w) return;
  const float fy = __fsub_rn(__fdiv_rn(static_cast<float>(y),
                                       static_cast<float>(th)), 0.5f);
  const float fx = __fsub_rn(__fdiv_rn(static_cast<float>(c),
                                       static_cast<float>(tw)), 0.5f);
  const int y0 = min(max(static_cast<int>(floorf(fy)), 0), tiles - 1);
  const int x0 = min(max(static_cast<int>(floorf(fx)), 0), tiles - 1);
  const int y1 = min(y0 + 1, tiles - 1), x1 = min(x0 + 1, tiles - 1);
  const float wy =
      fminf(fmaxf(__fsub_rn(fy, static_cast<float>(y0)), 0.0f), 1.0f);
  const float wx =
      fminf(fmaxf(__fsub_rn(fx, static_cast<float>(x0)), 0.0f), 1.0f);
  const int64_t at = (plane * h + y) * static_cast<int64_t>(w) + c;
  const int v = __ldg(x + at);
  const uint8_t* lut = luts + plane * tiles * tiles * kBins + v;
  const float v00 = __ldg(lut + (y0 * tiles + x0) * kBins);
  const float v01 = __ldg(lut + (y0 * tiles + x1) * kBins);
  const float v10 = __ldg(lut + (y1 * tiles + x0) * kBins);
  const float v11 = __ldg(lut + (y1 * tiles + x1) * kBins);
  const float ux = __fsub_rn(1.0f, wx);
  const float top = __fadd_rn(__fmul_rn(ux, v00), __fmul_rn(wx, v01));
  const float bot = __fadd_rn(__fmul_rn(ux, v10), __fmul_rn(wx, v11));
  const float o = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, wy), top),
                            __fmul_rn(wy, bot));
  out[at] = to_u8(rintf(o));
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace
}  // namespace dctsvd

using namespace dctsvd;

extern "C" int dctsvd_nlm(const void* x, const void* h2, void* out,
                          int planes, int h, int w, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || ceil_div(h, kNlmTileH) > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int p0 = 0; p0 < planes; p0 += kMaxGrid) {
    const dim3 grid(ceil_div(w, kNlmTileW), ceil_div(h, kNlmTileH),
                    planes - p0 < kMaxGrid ? planes - p0 : kMaxGrid);
    nlm_kernel<<<grid, kNlmThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), static_cast<const float*>(h2),
        static_cast<uint8_t*>(out), h, w, p0);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dctsvd_nlm_weights(const void* h2, void* out, int count,
                                  void* stream) {
  if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  nlm_weight_kernel<<<ceil_div(count, 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h2), static_cast<float*>(out), count);
  return static_cast<int>(cudaGetLastError());
}

// limit: the clip limit in counts (the host's max(floor(f32(clip_limit *
// area / 256)), 1)); the LUT scale is the f32 nearest 255 / area, as the
// host's np.float32(255.0 / area).
extern "C" int dctsvd_clahe_luts(const void* x, void* luts, int planes, int h,
                                 int w, int tiles, int limit, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || tiles < 1 ||
      tiles * tiles > kMaxGrid || limit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int th = ceil_div(h, tiles), tw = ceil_div(w, tiles);
  const float scale = static_cast<float>(
      255.0 / (static_cast<double>(th) * static_cast<double>(tw)));
  for (int p0 = 0; p0 < planes; p0 += kMaxGrid) {
    const dim3 grid(tiles * tiles,
                    planes - p0 < kMaxGrid ? planes - p0 : kMaxGrid);
    clahe_lut_kernel<<<grid, kClaheThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), static_cast<uint8_t*>(luts), h, w,
        tiles, th, tw, limit, scale, p0);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dctsvd_clahe_apply(const void* x, const void* luts, void* out,
                                  int planes, int h, int w, int tiles,
                                  void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || tiles < 1 || h > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int th = ceil_div(h, tiles), tw = ceil_div(w, tiles);
  for (int p0 = 0; p0 < planes; p0 += kMaxGrid) {
    const dim3 grid(ceil_div(w, kClaheThreads), h,
                    planes - p0 < kMaxGrid ? planes - p0 : kMaxGrid);
    clahe_apply_kernel<<<grid, kClaheThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(luts),
        static_cast<uint8_t*>(out), h, w, tiles, th, tw, p0);
  }
  return static_cast<int>(cudaGetLastError());
}

// K14. x, out: u8 [planes, h, w, channels] (channels 1 or 3); rows [h +
// 6], cols [w + 6]: int32 reflect tables on the device; taps: sigma 1's 7
// f32 in host memory. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue, and no launch, for another shape).
extern "C" int dctsvd_unsharp(const void* x, void* out, const void* rows,
                              const void* cols, const void* taps,
                              float amount, float weight, int planes, int h,
                              int w, int channels, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || ceil_div(h, kUnsharpTile) > kMaxGrid
      || (channels != 1 && channels != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BlurTaps t =
      blur_taps_of(static_cast<const float*>(taps), 2 * kUnsharpR + 1);
  const auto* xi = static_cast<const uint8_t*>(x);
  auto* xo = static_cast<uint8_t*>(out);
  const auto* ri = static_cast<const int*>(rows);
  const auto* ci = static_cast<const int*>(cols);
  for (int p0 = 0; p0 < planes; p0 += kMaxGrid) {
    const dim3 grid(ceil_div(w, kUnsharpTile), ceil_div(h, kUnsharpTile),
                    planes - p0 < kMaxGrid ? planes - p0 : kMaxGrid);
    if (channels == 1)
      unsharp_kernel<1><<<grid, kUnsharpThreads, 0, st>>>(
          xi, xo, ri, ci, h, w, t, amount, weight, p0);
    else
      unsharp_kernel<3><<<grid, kUnsharpThreads, 0, st>>>(
          xi, xo, ri, ci, h, w, t, amount, weight, p0);
  }
  return static_cast<int>(cudaGetLastError());
}
