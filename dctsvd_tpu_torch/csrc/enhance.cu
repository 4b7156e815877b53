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
// K11 clahe_lut_kernel: for each (plane, tile) of the tiles x tiles grid
// of th x tw tiles (th = ceil(H / tiles), tw = ceil(W / tiles); rows and
// columns past H and W reflected): the tile's 256-bin histogram, clipped
// at `limit`
// with cv2's stepped redistribution of the excess (excess / 256 to every
// bin, then one more to bins 0, step, 2 step, ... while b / step < resid,
// step = max(floor(256 / max(resid, 1)), 1), each division one IEEE
// division), its inclusive cumulative sum and LUT = rint(cdf * scale)
// clamped to [0, 255] as u8 [P, tiles^2, 256]. Every count is an integer
// below 2^24, so the twin's f32 sums are exact in any order.
// K11 clahe_apply_kernel: for each pixel, ty = y / th - 0.5 and tx (one
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
// before the SFU does. K11: bytes (a 1080p plane is 2 MB, 0.6 us; the
// LUTs 16 KB a plane), then latency: the LUT stage's histogram must be
// whole before a tile's clip and scan, and the interpolation's 4 LUT
// reads and about 30 instructions a pixel; both stages are a few
// microseconds, so the host's launches pace a call. K14: its 33 f32
// operations a pixel and channel at one instruction a lane a clock (every
// kernel here is built -fmad=false: 2.1 us a gray 1080p plane at 1980
// MHz) before its bytes (a u8 read and a u8 write a pixel and channel:
// 1.2 us gray, 3.7 us for a color frame).
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
// K11's LUT stage takes a row strip of a tile a CTA (the host's plan picks
// the strips: at least two CTAs an SM, 320 for a 1080p plane where a tile
// a CTA gave 64): its rows in 16-byte loads where a run of 16 columns lies
// inside the plane and on its 16-byte boundary (a byte a load through the
// reflection else), each thread folding runs of equal neighbouring bytes
// before its warp sub-histogram's shared atomic; the strip's counts go to
// the tile's int32 histogram in global memory by one atomic a nonzero
// bin, and the CTA whose ticket is the tile's last (the threadfence
// reduction) reads the whole histogram back by atomicExch, leaving it and
// the ticket zero for the next call, and makes the LUT as before: counts
// are integers, so the LUT's bytes do not depend on the order of the adds.
// The interpolation takes kApplyRows rows of a span of 2,048 columns a
// CTA, a thread 16 pixels of each row (one 16-byte load and store), the
// LUT rows those rows touch staged in shared memory, each column's tiles
// and weights formed once for the rows, the u8 LUT entries and the result
// through 2^23's mantissa (no conversion instruction). dctsvd_clahe
// launches both stages from one host call. K14 is K15's row walk
// (csrc/metrics.cu): a CTA of 128 threads walks a band of 32 rows across
// kUnsharpWalk blocks of 64 columns. A block's 64 new staged columns (16
// past the last block's) are read once as 16-byte runs (48-byte BGR runs
// split into three shared planes by byte permutes), loaded a block ahead
// into registers (the first block's with the walk's carried columns),
// reflect-101 computed in the kernel (no table); the last
// 32 staged and vertical columns of a block are the next one's first,
// copied by the threads that then overwrite them, so no vertical output
// is made twice in a walk. The vertical pass a thread down a column for 16
// outputs from its 22 inputs in registers; the horizontal pass a thread
// along a row for 16 outputs from six float4 loads (rows an odd number of
// 16-byte units apart: no bank conflict), the epilogue's bytes through
// 2^23's mantissa, one 16-byte store a run (three for BGR).

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

// K14's walk: a CTA of kUnsharpThreads threads walks a band of
// kUnsharpRows rows of one plane or frame across kUnsharpWalk blocks of
// kUnsharpBlockW output columns. Its blur's radius: sigma 1, 7 taps (the
// only sigma either chain takes).
constexpr int kUnsharpR = 3;
constexpr int kUnsharpTaps = 2 * kUnsharpR + 1;
constexpr int kUnsharpRows = 32;
constexpr int kUnsharpBlockW = 64;
constexpr int kUnsharpWalk = 2;
// a run: 16 vertical outputs a thread down a column, 16 horizontal outputs
// along a row, the 16 pixels of one 16-byte load or store
constexpr int kURun = 16;
constexpr int kUnsharpThreads = kUnsharpBlockW * (kUnsharpRows / kURun);
constexpr int kUHaloRows = kUnsharpRows + 2 * kUnsharpR;        // 38
constexpr int kUVIn = kURun + kUnsharpTaps - 1;                 // 22
// A block's staged columns: kURun before its outputs, its kUnsharpBlockW,
// kURun after (each side >= kUnsharpR, a whole 16-byte run), so that the
// new columns of every block start on a 16-byte boundary; the last
// 2 kURun are the next block's first, carried over.
constexpr int kUCols = kUnsharpBlockW + 2 * kURun;              // 96
constexpr int kUCarry = 2 * kURun;                              // 32
constexpr int kUChunks = kUnsharpBlockW / kURun;                // 4 a row
// a staged u8 row and a vertical f32 row: an odd number of 16-byte units,
// so that the lanes of a warp on successive rows read distinct banks
constexpr int kUXPitch = (kUCols / 16) % 2 ? kUCols : kUCols + 16;
constexpr int kUVPitch = (kUCols / 4 + 1) % 2 ? kUCols + 4 : kUCols + 8;
constexpr int kUHIn = kURun + 8;  // the horizontal run's 6 float4 loads
constexpr int kUXBytes = kUHaloRows * kUXPitch;                 // a plane
constexpr int kUVBytes = kUnsharpRows * kUVPitch * 4;
template <int kC>
constexpr int unsharp_smem() { return kC * (kUXBytes + kUVBytes); }
constexpr int kULoadItems =           // a block's new runs a thread: 2
    (kUHaloRows * kUChunks + kUnsharpThreads - 1) / kUnsharpThreads;
constexpr int kUCarryItems =          // a walk's carried runs a thread: 1
    (kUHaloRows * 2 + kUnsharpThreads - 1) / kUnsharpThreads;
static_assert(kUChunks * kUnsharpRows == kUnsharpThreads,
              "the horizontal pass: a warp a run of columns, a lane a row");
static_assert(kUnsharpBlockW % kURun == 0 && kUChunks >= 2,
              "whole runs, the last two carried");
static_assert(kUCols + 4 <= kUVPitch && kUCols <= kUXPitch &&
                  kUXBytes % 16 == 0 && kUVPitch % 4 == 0,
              "16-byte units inside a staged row");

constexpr int kBins = 256;
constexpr int kClaheThreads = 256;           // a bin a thread
constexpr int kClaheWarps = kClaheThreads / 32;
// K11's LUT stage: a CTA a row strip of a tile, each thread kLutItems
// chunks of 16 bytes in flight before it folds them into the histogram
constexpr int kLutItems = 2;
// K11's interpolation: a CTA of kApplyThreads threads, each kApplyRun
// pixels of each of kApplyRows rows
constexpr int kApplyThreads = 128;
constexpr int kApplyRun = 16;
constexpr int kApplyRows = 2;
constexpr int kApplyCols = kApplyThreads * kApplyRun;        // 2048
// the LUT rows a band of kApplyRows rows touches: its rows' fy = y / th
// - 0.5 climb at most (kApplyRows - 1) / th <= 1, so their upper tile
// rows differ by at most one, and the last row's lower one is one more
constexpr int kStageRows = 3;
static_assert(kApplyRows <= 2, "kStageRows holds for bands of 2 rows");
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

// 2^23 and its bits: a u8 value v is the float 2^23 + v with v in the low
// byte of its bits, so a byte becomes an exact f32 by one bit operation and
// one sum, and an f32 in [0, 255] becomes its rint (half to even) as the
// low byte of 2^23 + it, by one sum: no conversion instruction.
constexpr float kTwo23 = 8388608.0f;
constexpr uint32_t kTwo23Bits = 0x4b000000u;

// Byte k (0 .. 3) of word v as an exact f32.
template <int k>
__device__ __forceinline__ float byte_f32(uint32_t v) {
  return __fsub_rn(__uint_as_float(__byte_perm(v, kTwo23Bits, 0x7650 | k)),
                   kTwo23);
}

__device__ __forceinline__ float u8_f32(uint32_t b) {
  return __fsub_rn(__uint_as_float(kTwo23Bits | b), kTwo23);
}

// rint(v) clamped to [0, 255] (v not NaN), as 2^23 + it: the byte is the
// low byte of the bits. Equal to clamping rint(v), as the bounds are
// integers and rint is monotone.
__device__ __forceinline__ uint32_t rint_u8_bits(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), kTwo23));
}

// The low bytes of four such words as one word, a's first.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Channel kCh's 4 bytes of 4 BGR pixels (12 bytes: words a, b, c).
template <int kCh>
__device__ __forceinline__ uint32_t split3(uint32_t a, uint32_t b,
                                          uint32_t c) {
  if constexpr (kCh == 0)
    return __byte_perm(__byte_perm(a, b, 0x0630), c, 0x5210);
  else if constexpr (kCh == 1)
    return __byte_perm(__byte_perm(a, b, 0x0741), c, 0x6210);
  else
    return __byte_perm(__byte_perm(a, b, 0x0052), c, 0x7410);
}

// 4 BGR pixels (12 bytes, words 3 m .. 3 m + 2 of out) from word m of each
// channel's plane, p0 (B), p1, p2.
__device__ __forceinline__ void merge3(uint32_t p0, uint32_t p1, uint32_t p2,
                                       uint32_t* out) {
  out[0] = __byte_perm(__byte_perm(p0, p1, 0x1040), p2, 0x3410);
  out[1] = __byte_perm(__byte_perm(p0, p1, 0x6205), p2, 0x3250);
  out[2] = __byte_perm(__byte_perm(p0, p1, 0x0730), p2, 0x7216);
}

// K14's input run: the kC-channel pixels at columns c .. c + 15 of image row
// R(gy) (R reflect-101, as reflect_index, every index 0 when n = 1) of src,
// as the 4 kC words of memory order. One to three 16-byte loads where the
// columns lie inside the row and the address is on its 16-byte boundary;
// else a byte a load, each column through R.
template <int kC>
__device__ __forceinline__ void unsharp_load(const uint8_t* __restrict__ src,
                                             int h, int w, int gy, int c,
                                             uint32_t (&v)[4 * kC]) {
  const uint8_t* row = src + static_cast<int64_t>(reflect(gy, h)) * w * kC;
  if (c >= 0 && c + kURun <= w &&
      (reinterpret_cast<uintptr_t>(row + c * kC) & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(row + c * kC);
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const uint4 t = __ldg(q + k);
      v[4 * k] = t.x;
      v[4 * k + 1] = t.y;
      v[4 * k + 2] = t.z;
      v[4 * k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * kC; ++i) v[i] = 0;
#pragma unroll
    for (int k = 0; k < kURun; ++k) {
      const uint8_t* px = row + reflect(c + k, w) * kC;
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) {
        const int j = k * kC + ch;
        v[j / 4] |= static_cast<uint32_t>(__ldg(px + ch)) << (8 * (j % 4));
      }
    }
  }
}

// One input run into the staged planes: each channel's 16 bytes at staged
// row r, column col (a 16-byte boundary); a BGR run split into its three
// planes.
template <int kC>
__device__ __forceinline__ void unsharp_stage(uint8_t* xs, int r, int col,
                                              const uint32_t (&v)[4 * kC]) {
  uint4* d = reinterpret_cast<uint4*>(xs + r * kUXPitch + col);
  if constexpr (kC == 1) {
    *d = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    constexpr int kPlane = kUXBytes / 16;
    d[0] = make_uint4(split3<0>(v[0], v[1], v[2]), split3<0>(v[3], v[4], v[5]),
                      split3<0>(v[6], v[7], v[8]),
                      split3<0>(v[9], v[10], v[11]));
    d[kPlane] =
        make_uint4(split3<1>(v[0], v[1], v[2]), split3<1>(v[3], v[4], v[5]),
                   split3<1>(v[6], v[7], v[8]), split3<1>(v[9], v[10], v[11]));
    d[2 * kPlane] =
        make_uint4(split3<2>(v[0], v[1], v[2]), split3<2>(v[3], v[4], v[5]),
                   split3<2>(v[6], v[7], v[8]), split3<2>(v[9], v[10], v[11]));
  }
}

// The vertical pass of one run: staged column col of plane ch, its 22 halo
// rows from q * 16 read once into registers, -> the vertical plane's rows
// q * 16 .. q * 16 + 15 at column col.
__device__ __forceinline__ void unsharp_vertical(const BlurTaps& taps,
                                                 const uint8_t* xs, float* vs,
                                                 int ch, int q, int col) {
  const uint8_t* s = xs + ch * kUXBytes + q * kURun * kUXPitch + col;
  float v[kUVIn];
#pragma unroll
  for (int i = 0; i < kUVIn; ++i) v[i] = u8_f32(s[i * kUXPitch]);
  float* d = vs + (ch * kUnsharpRows + q * kURun) * kUVPitch + col;
  blur_run<kUnsharpTaps>(taps, v,
                         [&](int o, float b) { d[o * kUVPitch] = b; });
}

// K14. Grid (walks of kUnsharpWalk blocks, row bands, planes of this
// launch); plane or frame plane0 + blockIdx.z of x [P, H, W, kC] u8 (kC 1:
// planes), out the same; unsharp_smem<kC>() bytes of dynamic shared
// memory: xs [kC][kUHaloRows][kUXPitch] u8 (the band's halo rows at the
// block's kUCols staged columns, image columns 64 b - 16 .. 64 b + 79 of
// block b), then vs [kC][kUnsharpRows][kUVPitch] f32 (their vertical pass).
// A block's outputs: rows y0 .. y0 + 31, columns 64 b .. 64 b + 63; the
// epilogue round(amount * e + weight * blur) as rint (torch.round: half to
// even), clamped to [0, 255], u8.
template <int kC>
__global__ void __launch_bounds__(kUnsharpThreads)
    unsharp_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                   int h, int w, BlurTaps taps, float amount, float weight,
                   int plane0) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs = smem;
  float* vs = reinterpret_cast<float*>(smem + kC * kUXBytes);
  const int tid = threadIdx.x;
  const int64_t plane = plane0 + static_cast<int64_t>(blockIdx.z);
  const int64_t base = plane * h * static_cast<int64_t>(w) * kC;
  const uint8_t* src = x + base;
  const int y0 = blockIdx.y * kUnsharpRows;
  const int b0 = blockIdx.x * kUnsharpWalk;
  const int b1 = min(b0 + kUnsharpWalk,
                     (w + kUnsharpBlockW - 1) / kUnsharpBlockW);
  // a block's new columns (image 64 b + 16 .. 64 b + 79): item i of the
  // thread is halo row r = i / 4, 16-byte run k = i % 4, staged at column
  // 32 + 16 k, loaded a block ahead into registers
  uint32_t pf[kULoadItems][4 * kC];
  auto load_block = [&](int b) {
#pragma unroll
    for (int j = 0; j < kULoadItems; ++j) {
      const int i = tid + j * kUnsharpThreads;
      if (i < kUHaloRows * kUChunks) {
        const int r = i / kUChunks, k = i - r * kUChunks;
        unsharp_load<kC>(src, h, w, y0 - kUnsharpR + r,
                         b * kUnsharpBlockW + kURun + kURun * k, pf[j]);
      }
    }
  };
  // the first block's carried columns (image 64 b0 - 16 .. 64 b0 + 15),
  // staged and passed vertically as a block's last 32 would have been;
  // their loads and the first block's issued together
  {
    uint32_t cv[kUCarryItems][4 * kC];
#pragma unroll
    for (int j = 0; j < kUCarryItems; ++j) {
      const int i = tid + j * kUnsharpThreads;
      if (i < kUHaloRows * 2)
        unsharp_load<kC>(src, h, w, y0 - kUnsharpR + i / 2,
                         b0 * kUnsharpBlockW - kURun + kURun * (i % 2),
                         cv[j]);
    }
    load_block(b0);
#pragma unroll
    for (int j = 0; j < kUCarryItems; ++j) {
      const int i = tid + j * kUnsharpThreads;
      if (i < kUHaloRows * 2)
        unsharp_stage<kC>(xs, i / 2, kURun * (i % 2), cv[j]);
    }
  }
  __syncthreads();
  for (int i = tid; i < kC * kUCarry * 2; i += kUnsharpThreads) {
    const int ch = i / (2 * kUCarry), rem = i - ch * 2 * kUCarry;
    unsharp_vertical(taps, xs, vs, ch, rem / kUCarry, rem % kUCarry);
  }
  // the vertical run of the thread: column 32 + vc, rows from 16 vq
  const int vc = tid % kUnsharpBlockW, vq = tid / kUnsharpBlockW;
  // the horizontal run: row hr (the lane), outputs 16 hs .. 16 hs + 15
  const int hr = tid % 32, hs = tid / 32;
  for (int b = b0; b < b1; ++b) {
    const bool carried = b > b0;
    // the staged columns the last block carries (its 64 .. 95) to 0 .. 31,
    // each by the thread that then overwrites them with a new run
#pragma unroll
    for (int j = 0; j < kULoadItems; ++j) {
      const int i = tid + j * kUnsharpThreads;
      if (i < kUHaloRows * kUChunks) {
        const int r = i / kUChunks, k = i - r * kUChunks;
        if (carried && k >= kUChunks - 2) {
#pragma unroll
          for (int ch = 0; ch < kC; ++ch) {
            uint4* row = reinterpret_cast<uint4*>(xs + ch * kUXBytes +
                                                  r * kUXPitch);
            row[k - kUChunks + 2] = row[k + 2];
          }
        }
        unsharp_stage<kC>(xs, r, kUCarry + kURun * k, pf[j]);
      }
    }
    __syncthreads();
    if (b + 1 < b1) load_block(b + 1);
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) {
      if (carried && vc >= kUnsharpBlockW - kUCarry) {
        // the vertical outputs the last block made at 64 .. 95, to 0 .. 31
        float* col = vs + (ch * kUnsharpRows + vq * kURun) * kUVPitch;
        const int to = vc - (kUnsharpBlockW - kUCarry);
#pragma unroll
        for (int o = 0; o < kURun; ++o)
          col[o * kUVPitch + to] = col[o * kUVPitch + kUCarry + vc];
      }
      unsharp_vertical(taps, xs, vs, ch, vq, kUCarry + vc);
    }
    __syncthreads();
    // the horizontal pass and the epilogue of row hr, outputs 16 hs ..
    {
      const int py = y0 + hr;
      const int px = b * kUnsharpBlockW + kURun * hs;
      uint32_t res[kC][4];
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) {
        // staged columns 12 + 16 hs .. 35 + 16 hs: outputs 16 + 16 hs + o
        // take 13 + 16 hs + o .. 19 + 16 hs + o
        const float4* vrow = reinterpret_cast<const float4*>(
            vs + (ch * kUnsharpRows + hr) * kUVPitch + kURun - 4 + kURun * hs);
        float u[kUHIn];
#pragma unroll
        for (int k = 0; k < kUHIn / 4; ++k) {
          const float4 t = vrow[k];
          u[4 * k] = t.x;
          u[4 * k + 1] = t.y;
          u[4 * k + 2] = t.z;
          u[4 * k + 3] = t.w;
        }
        float in[kUVIn];
#pragma unroll
        for (int i = 0; i < kUVIn; ++i) in[i] = u[i + 1];
        const uint4 ev = *reinterpret_cast<const uint4*>(
            xs + ch * kUXBytes + (hr + kUnsharpR) * kUXPitch + kURun +
            kURun * hs);
        const uint32_t e4[4] = {ev.x, ev.y, ev.z, ev.w};
        uint32_t bits[kURun];
        blur_run<kUnsharpTaps>(taps, in, [&](int o, float bl) {
          const uint32_t ew = e4[o / 4];
          const float e = (o % 4 == 0)   ? byte_f32<0>(ew)
                          : (o % 4 == 1) ? byte_f32<1>(ew)
                          : (o % 4 == 2) ? byte_f32<2>(ew)
                                         : byte_f32<3>(ew);
          bits[o] = rint_u8_bits(
              __fadd_rn(__fmul_rn(amount, e), __fmul_rn(weight, bl)));
        });
#pragma unroll
        for (int m = 0; m < 4; ++m)
          res[ch][m] = pack4(bits[4 * m], bits[4 * m + 1], bits[4 * m + 2],
                             bits[4 * m + 3]);
      }
      uint32_t o[4 * kC];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if constexpr (kC == 1)
          o[m] = res[0][m];
        else
          merge3(res[0][m], res[1][m], res[2][m], o + 3 * m);
      }
      if (py < h && px < w) {
        uint8_t* dst = out + base + (static_cast<int64_t>(py) * w + px) * kC;
        if (px + kURun <= w && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
          for (int k = 0; k < kC; ++k)
            d[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2],
                              o[4 * k + 3]);
        } else {
          const int n = min(kURun, w - px) * kC;
#pragma unroll
          for (int j = 0; j < kURun * kC; ++j)
            if (j < n) dst[j] = static_cast<uint8_t>(o[j / 4] >> (8 * (j % 4)));
        }
      }
    }
    __syncthreads();
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

// Adds the n (1 .. 16) bytes of v (memory order) to the histogram: one
// atomic a run of equal neighbours, so a smooth plane's warps, whose lanes
// mostly hit the same few bins, serialise on fewer of them.
__device__ __forceinline__ void fold16(int* hist, const uint32_t (&v)[4],
                                       int n) {
  uint32_t cur = v[0] & 0xffu;
  int run = 1;
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    const uint32_t b = (v[k / 4] >> (8 * (k % 4))) & 0xffu;
    if (k < n) {
      if (b == cur) {
        ++run;
      } else {
        atomicAdd(hist + cur, run);
        cur = b;
        run = 1;
      }
    }
  }
  atomicAdd(hist + cur, run);
}

// K11's LUTs. Grid (tiles^2 x strips, planes of this launch): CTA (tile t,
// strip s) at blockIdx.x = t strips + s takes the tile's rows s
// strip_rows .. (s + 1) strip_rows - 1 (of th) of plane plane0 +
// blockIdx.y. hist [P, tiles^2, 256] int32 and tickets [P, tiles^2]: zero
// on entry, left zero by the CTA that finishes each tile. luts [P,
// tiles^2, 256].
__global__ void __launch_bounds__(kClaheThreads)
    clahe_lut_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ luts,
                     int* __restrict__ ghist, unsigned* __restrict__ tickets,
                     int h, int w, int tiles, int th, int tw, int strips,
                     int strip_rows, int limit, float scale, int plane0) {
  __shared__ int hist[kClaheWarps][kBins];
  __shared__ int part[kClaheWarps];
  __shared__ bool last;
  const int64_t plane = plane0 + static_cast<int64_t>(blockIdx.y);
  const int tile = blockIdx.x / strips, strip = blockIdx.x - tile * strips;
  const int ty = tile / tiles, tx = tile - ty * tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kClaheWarps; ++k) hist[k][b] = 0;
  __syncthreads();
  const uint8_t* src = x + plane * h * static_cast<int64_t>(w);
  // the strip: rows r0 .. r0 + rows - 1 of the tile, each as runs of 16
  // columns (the last run of a row tw % 16 when tw is not a multiple)
  const int r0 = strip * strip_rows;
  const int rows = max(0, min(strip_rows, th - r0));
  const int runs = (tw + 15) / 16;
  const int items = rows * runs;
  const int gx0 = tx * tw;
  const bool cols_in = gx0 + tw <= w;
  int* my = hist[warp];
  for (int i0 = 0; i0 < items; i0 += kLutItems * kClaheThreads) {
    uint32_t v[kLutItems][4];
    int n[kLutItems];
#pragma unroll
    for (int j = 0; j < kLutItems; ++j) {
      const int i = i0 + j * kClaheThreads + threadIdx.x;
      n[j] = 0;
      v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0;
      if (i < items) {
        const int r = i / runs, c = (i - r * runs) * 16;
        const uint8_t* row =
            src + static_cast<int64_t>(reflect(ty * th + r0 + r, h)) * w;
        n[j] = min(16, tw - c);
        const uint8_t* p = row + gx0 + c;
        if (n[j] == 16 && cols_in &&
            (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
          v[j][0] = q.x;
          v[j][1] = q.y;
          v[j][2] = q.z;
          v[j][3] = q.w;
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k)
            if (k < n[j])
              v[j][k / 4] |= static_cast<uint32_t>(__ldg(
                                 row + reflect(gx0 + c + k, w)))
                             << (8 * (k % 4));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLutItems; ++j)
      if (n[j] > 0) fold16(my, v[j], n[j]);
  }
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int k = 0; k < kClaheWarps; ++k) count += hist[k][b];
  // the strip's counts into the tile's histogram; the last strip's CTA to
  // take its ticket finishes the tile (the threadfence reduction)
  const int64_t slot = plane * tiles * tiles + tile;
  int* gh = ghist + slot * kBins;
  if (count) atomicAdd(gh + b, count);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + slot, 1u) == static_cast<unsigned>(strips - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the tile's counts, read from L2 and left zero; the ticket too
  count = atomicExch(gh + b, 0);
  if (threadIdx.x == 0) tickets[slot] = 0;
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
  luts[slot * kBins + b] = to_u8(lut);
}

// The interpolation's tile rows of image row y: fy = y / th - 0.5 (one
// division), y0 = floor(fy) and y0 + 1 clamped to the grid, the weight wy
// = fy - y0 clamped to [0, 1].
__device__ __forceinline__ void clahe_axis(int y, int th, int tiles, int& t0,
                                           int& t1, float& wt) {
  const float f = __fsub_rn(__fdiv_rn(static_cast<float>(y),
                                      static_cast<float>(th)), 0.5f);
  t0 = min(max(static_cast<int>(floorf(f)), 0), tiles - 1);
  t1 = min(t0 + 1, tiles - 1);
  wt = fminf(fmaxf(__fsub_rn(f, static_cast<float>(t0)), 0.0f), 1.0f);
}

// K11's interpolation. Grid (column spans of kApplyCols, row bands of
// kApplyRows, planes of this launch); plane plane0 + blockIdx.z. Thread t
// takes columns c0 .. c0 + 15 (c0 = span start + 16 t) of each of the
// band's rows: one 16-byte load and store a row where the run lies inside
// the row and on 16-byte boundaries, a byte a load else. The LUT rows
// the band touches (kStageRows at most) are staged in min(tiles,
// kStageRows) x tiles x 256 bytes of dynamic shared memory (6 KB at 8
// tiles; past 48 KB, from 65 tiles, by the launch's opt-in).
__global__ void __launch_bounds__(kApplyThreads)
    clahe_apply_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ luts,
                       uint8_t* __restrict__ out, int h, int w, int tiles,
                       int th, int tw, int plane0) {
  extern __shared__ __align__(16) uint8_t stage[];
  const int64_t plane = plane0 + static_cast<int64_t>(blockIdx.z);
  const int y0 = blockIdx.y * kApplyRows;
  const int nrows = min(kApplyRows, h - y0);
  const int c0 = blockIdx.x * kApplyCols + threadIdx.x * kApplyRun;
  const int n = min(kApplyRun, w - c0);            // pixels of the run
  const int64_t at0 = (plane * h + y0) * static_cast<int64_t>(w) + c0;
  const int tile_bytes = tiles * kBins;
  const uint8_t* plut = luts + plane * tiles * tile_bytes;
  // the band's pixels, every load issued before the LUTs are staged
  uint32_t px[kApplyRows][4];
#pragma unroll
  for (int r = 0; r < kApplyRows; ++r) {
    px[r][0] = px[r][1] = px[r][2] = px[r][3] = 0;
    if (r < nrows && n > 0) {
      const uint8_t* p = x + at0 + static_cast<int64_t>(r) * w;
      if (n == kApplyRun && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        px[r][0] = q.x;
        px[r][1] = q.y;
        px[r][2] = q.z;
        px[r][3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < kApplyRun; ++k)
          if (k < n) px[r][k / 4] |= static_cast<uint32_t>(__ldg(p + k))
                                     << (8 * (k % 4));
      }
    }
  }
  // LUT rows ya .. yb: the first row's upper tile row to the last's lower
  int ya, yb;
  {
    int t0;
    float wt;
    clahe_axis(y0, th, tiles, ya, yb, wt);
    clahe_axis(y0 + nrows - 1, th, tiles, t0, yb, wt);
    if (yb - ya + 1 > kStageRows) __trap();
    const uint8_t* s = plut + ya * tile_bytes;
    const int bytes = (yb - ya + 1) * tile_bytes;
    if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      for (int i = threadIdx.x; i < bytes / 16; i += kApplyThreads)
        reinterpret_cast<uint4*>(stage)[i] =
            __ldg(reinterpret_cast<const uint4*>(s) + i);
    } else {
      for (int i = threadIdx.x; i < bytes; i += kApplyThreads)
        stage[i] = __ldg(s + i);
    }
    __syncthreads();
  }
  if (n <= 0) return;
  // each column's tiles and weight (the same for every row): fx = c / tw
  // - 0.5, one division a pixel
  uint32_t xo[kApplyRun];       // x0 * 256 | x1 * 256 << 16
  float wx[kApplyRun], ux[kApplyRun];
#pragma unroll
  for (int k = 0; k < kApplyRun; ++k) {
    int t0, t1;
    clahe_axis(c0 + k, tw, tiles, t0, t1, wx[k]);
    ux[k] = __fsub_rn(1.0f, wx[k]);
    xo[k] = static_cast<uint32_t>(t0 * kBins) |
            static_cast<uint32_t>(t1 * kBins) << 16;
  }
#pragma unroll
  for (int r = 0; r < kApplyRows; ++r) {
    if (r >= nrows) break;
    int t0, t1;
    float wy;
    clahe_axis(y0 + r, th, tiles, t0, t1, wy);
    const float uy = __fsub_rn(1.0f, wy);
    const uint8_t* l0 = stage + (t0 - ya) * tile_bytes;
    const uint8_t* l1 = stage + (t1 - ya) * tile_bytes;
    uint32_t bits[kApplyRun];
#pragma unroll
    for (int k = 0; k < kApplyRun; ++k) {
      const uint32_t v = (px[r][k / 4] >> (8 * (k % 4))) & 0xffu;
      const uint32_t a = (xo[k] & 0xffffu) + v, c = (xo[k] >> 16) + v;
      const float v00 = u8_f32(l0[a]), v01 = u8_f32(l0[c]);
      const float v10 = u8_f32(l1[a]), v11 = u8_f32(l1[c]);
      const float top = __fadd_rn(__fmul_rn(ux[k], v00),
                                  __fmul_rn(wx[k], v01));
      const float bot = __fadd_rn(__fmul_rn(ux[k], v10),
                                  __fmul_rn(wx[k], v11));
      bits[k] = rint_u8_bits(
          __fadd_rn(__fmul_rn(uy, top), __fmul_rn(wy, bot)));
    }
    uint32_t o[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      o[m] = pack4(bits[4 * m], bits[4 * m + 1], bits[4 * m + 2],
                   bits[4 * m + 3]);
    uint8_t* d = out + at0 + static_cast<int64_t>(r) * w;
    if (n == kApplyRun && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kApplyRun; ++k)
        if (k < n) d[k] = static_cast<uint8_t>(o[k / 4] >> (8 * (k % 4)));
    }
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// K11's shapes: th x tw tiles, their LUT scale (the f32 nearest 255 /
// area, as the host's np.float32(255.0 / area)), rows a strip.
struct ClaheShape {
  int th, tw, strip_rows;
  float scale;
};

// Checks K11's arguments (strips as ops/enhance_cuda.py::clahe_plan gives
// them).
inline bool clahe_shape(int planes, int h, int w, int tiles, int strips,
                        ClaheShape& s) {
  if (planes <= 0 || h <= 0 || w <= 0 || tiles < 1 || tiles > 255)
    return false;
  s.th = ceil_div(h, tiles);
  s.tw = ceil_div(w, tiles);
  if (strips < 1 || strips > s.th ||
      static_cast<int64_t>(tiles) * tiles * strips > 0x7fffffff)
    return false;
  s.strip_rows = ceil_div(s.th, strips);
  s.scale = static_cast<float>(
      255.0 / (static_cast<double>(s.th) * static_cast<double>(s.tw)));
  return true;
}

void launch_clahe_luts(const uint8_t* x, uint8_t* luts, int* hist,
                       unsigned* tickets, int planes, int h, int w, int tiles,
                       int limit, int strips, const ClaheShape& s,
                       cudaStream_t st) {
  for (int p0 = 0; p0 < planes; p0 += kMaxGrid) {
    const dim3 grid(tiles * tiles * strips,
                    planes - p0 < kMaxGrid ? planes - p0 : kMaxGrid);
    clahe_lut_kernel<<<grid, kClaheThreads, 0, st>>>(
        x, luts, hist, tickets, h, w, tiles, s.th, s.tw, strips,
        s.strip_rows, limit, s.scale, p0);
  }
}

cudaError_t launch_clahe_apply(const uint8_t* x, const uint8_t* luts,
                               uint8_t* out, int planes, int h, int w,
                               int tiles, const ClaheShape& s,
                               cudaStream_t st) {
  const int smem = (tiles < kStageRows ? tiles : kStageRows) * tiles * kBins;
  // the staged rows above 48 KB (65 tiles or more; 255 tiles: 195,840 B)
  // only by the kernel's opt-in
  if (smem > 48 * 1024) {
    const cudaError_t opt = cudaFuncSetAttribute(
        clahe_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (opt != cudaSuccess) return opt;
  }
  for (int p0 = 0; p0 < planes; p0 += kMaxGrid) {
    const dim3 grid(ceil_div(w, kApplyCols), ceil_div(h, kApplyRows),
                    planes - p0 < kMaxGrid ? planes - p0 : kMaxGrid);
    clahe_apply_kernel<<<grid, kApplyThreads, smem, st>>>(
        x, luts, out, h, w, tiles, s.th, s.tw, p0);
  }
  return cudaGetLastError();
}

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

// K11. x: u8 planes [planes, h, w]; luts: u8 [planes, tiles^2, 256];
// scratch: the int32 histograms [planes, tiles^2, 256] then the tickets
// [planes, tiles^2], zero on entry and left zero; limit: the clip limit in
// counts (the host's max(floor(f32(clip_limit * area / 256)), 1)); strips:
// row strips a tile (ops/enhance_cuda.py::clahe_plan). Returns the
// cudaError_t of the launches (cudaErrorInvalidValue, and no launch, for
// arguments the kernel does not take).
extern "C" int dctsvd_clahe_luts(const void* x, void* luts, void* scratch,
                                 int planes, int h, int w, int tiles,
                                 int limit, int strips, void* stream) {
  ClaheShape s;
  if (!clahe_shape(planes, h, w, tiles, strips, s) || limit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int* hist = static_cast<int*>(scratch);
  launch_clahe_luts(static_cast<const uint8_t*>(x),
                    static_cast<uint8_t*>(luts), hist,
                    reinterpret_cast<unsigned*>(
                        hist + static_cast<int64_t>(planes) * tiles * tiles *
                                   kBins),
                    planes, h, w, tiles, limit, strips, s,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K11's interpolation of x through luts into out (u8 [planes, h, w]).
extern "C" int dctsvd_clahe_apply(const void* x, const void* luts, void* out,
                                  int planes, int h, int w, int tiles,
                                  void* stream) {
  ClaheShape s;
  if (!clahe_shape(planes, h, w, tiles, 1, s) ||
      ceil_div(h, kApplyRows) > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clahe_apply(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(luts),
      static_cast<uint8_t*>(out), planes, h, w, tiles, s,
      static_cast<cudaStream_t>(stream)));
}

// Both K11 stages in one call, on one stream: the LUTs into luts, then the
// interpolation into out; scratch as dctsvd_clahe_luts'.
extern "C" int dctsvd_clahe(const void* x, void* luts, void* out,
                            void* scratch, int planes, int h, int w,
                            int tiles, int limit, int strips, void* stream) {
  ClaheShape s;
  if (!clahe_shape(planes, h, w, tiles, strips, s) || limit < 1 ||
      ceil_div(h, kApplyRows) > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* hist = static_cast<int*>(scratch);
  const int64_t slots = static_cast<int64_t>(planes) * tiles * tiles;
  launch_clahe_luts(static_cast<const uint8_t*>(x),
                    static_cast<uint8_t*>(luts), hist,
                    reinterpret_cast<unsigned*>(hist + slots * kBins), planes,
                    h, w, tiles, limit, strips, s, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_clahe_apply(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(luts),
      static_cast<uint8_t*>(out), planes, h, w, tiles, s, st));
}

// K14. x, out: u8 [planes, h, w, channels] (channels 1 or 3); taps: sigma
// 1's 7 f32 in host memory. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue, and no launch, for another shape).
extern "C" int dctsvd_unsharp(const void* x, void* out, const void* taps,
                              float amount, float weight, int planes, int h,
                              int w, int channels, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 ||
      ceil_div(h, kUnsharpRows) > kMaxGrid ||
      (channels != 1 && channels != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BlurTaps t = blur_taps_of(static_cast<const float*>(taps),
                                  kUnsharpTaps);
  const auto* xi = static_cast<const uint8_t*>(x);
  auto* xo = static_cast<uint8_t*>(out);
  // the color instance's shared memory above 48 KB only by its opt-in
  if (channels == 3) {
    const cudaError_t opt = cudaFuncSetAttribute(
        unsharp_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        unsharp_smem<3>());
    if (opt != cudaSuccess) return static_cast<int>(opt);
  }
  const int walks = ceil_div(ceil_div(w, kUnsharpBlockW), kUnsharpWalk);
  for (int p0 = 0; p0 < planes; p0 += kMaxGrid) {
    const dim3 grid(walks, ceil_div(h, kUnsharpRows),
                    planes - p0 < kMaxGrid ? planes - p0 : kMaxGrid);
    if (channels == 1)
      unsharp_kernel<1><<<grid, kUnsharpThreads, unsharp_smem<1>(), st>>>(
          xi, xo, h, w, t, amount, weight, p0);
    else
      unsharp_kernel<3><<<grid, kUnsharpThreads, unsharp_smem<3>(), st>>>(
          xi, xo, h, w, t, amount, weight, p0);
  }
  return static_cast<int>(cudaGetLastError());
}
