// The blocked extract tail on the card: K5f, its front stage (the estimator
// and the slot gather, which both tail forms read), K5, the recompute
// form's two passes (extract_color_prepared / extract_gray_prepared with
// recompute=True), and K8, the default form's normaliser (the same two
// passes over the materialised reconstruction).
//
// ---------------------------------------------------------------------------
// K5f tail_front. Replaces the front of the XLA fusion of dctsvd_tpu/models/
// blocked.py::_extract_tail_prepared (:1003-1016: the raw estimate,
// _shrink_sw_hat's elementwise part, the flag column and _permute_slots);
// the JAX package has no pl.pallas_call for it. Plain twin:
// dctsvd_tpu_torch/ops/tail_cuda.py::tail_front_plain.
//
// What it computes. Plane p = (frame, channel c), natural block n, slot
// j = inv_blk[n]; for i < k:
//   raw_i = (s_cw[p, j, i] - sc[p, j, i]) / max(alpha[p], 1e-8);
//   without sw: x[p, n, i] = raw_i;
//   with sw: ref_i = sw[c, j, i], devk_i = |raw_i - ref_i|, dev = their max,
//     w_i = 1 / (1 + (devk_i / scale[c])^2), 0 where raw_i < 0,
//     x[p, n, i] = engage[p] ? max(ref_i + w_i (raw_i - ref_i), 0)
//                            : min(max(raw_i, -0.5 ref_i), 1.5 ref_i),
//     x[p, n, k] = 1 if dev > 2 scale[c] and not engage[p], else 0.
// Each step rounds once, as the twin's one PyTorch op a step does on the
// card; min and max let a NaN through as torch's clamp, maximum, minimum
// and amax do. engage and scale (the presence statistic and the mean of
// sw[..., 0], reductions whose order on the card depends on their shapes)
// come from the caller; nothing here reduces across blocks, so a frame's
// row is the same alone, in a shard or in any batch.
// Output rows are round_up(k + 1, 4) floats (zero past the flag column),
// the layout K5 reads with 16-byte loads.
//
// What bounds it on the H100: bytes. Each thread gathers one 32-byte slot
// row of s_cw and one of sc (one sector each) and writes one output row;
// at 1080p color, batch 32: 2 x 99.5 MB in, 99.5 MB out (sw, 3.1 MB, stays
// in L2), 0.3 GB or 0.09 ms at 3.35 TB/s. What the design does about it:
// a thread a natural block (consecutive threads write consecutive rows),
// each slot row read as two float4 through inv_blk, the planes of a frame
// on the grid's y (32-bit offsets within a plane).
//
// ---------------------------------------------------------------------------
// K5 recon_normalize. Replaces the XLA fusion of dctsvd_tpu/models/
// blocked.py::_normalize_blocks_recompute (reached through
// _extract_tail_prepared(recompute=True)); no pl.pallas_call. Plain twin:
// dctsvd_tpu_torch/ops/tail_cuda.py::recon_normalize_plain.
//
// What it computes. Plane p = (frame f, channel c), block n, its natural-
// order estimates x[p, n, 0..k-1] and, when flagged, the erasure flag
// x[p, n, k] > 0.5; the pixel basis e[c, n, j, 0..63]:
//   y = x0 e0, then y = y + xj ej for j = 1..k-1, each product and sum
//       rounded (the twin's order);
//   pass 1 (window): the plane's min and max over all its pixels, and over
//       the pixels of unflagged blocks (NaN propagates, as torch.amin);
//   between the passes, a plane's (lo, scale, fill): lo, hi = the
//       unflagged window, or the whole one where that is not finite (every
//       block flagged); scale = 255 / max(hi - lo, 1e-12) as one IEEE
//       division; fill = (lo + hi) * 0.5 (without normalize: 0, 1, 0);
//   pass 2 (paint): flagged blocks at fill, (y - lo) * scale; u8 out
//       truncates and saturates to [0, 255] (NaN to 0). Output: channels-
//       last frames [F, H, W, C] or planes [F, C, H, W].
// Without normalize only pass 2 runs.
//
// What bounds it on the H100: neither its bytes nor its instructions
// alone. Its bytes at 1080p color, k = 4, batch 32 (the u8 frames 199 MB,
// the estimates and the basis read once a pass) take 0.16 ms at 3.35 TB/s;
// the twin's f32 work is about 20 operations a pixel over both passes.
// Halving an earlier form's instructions moved its time by 4 % (PERF.md
// §6): each warp waited on its frame's estimates (one load in flight a
// CTA, the 8 warps of a CTA on the same rows), and every CTA's window
// atomics for a frame landed on one cache line, which one L2 slice
// serialised. What the design does about it:
//   - A warp takes one pixel row r of 32 / C' neighbouring blocks (C' = C
//     for frames, the channels of a block on neighbouring lanes; 1 for
//     planes), a CTA the 8 rows of those blocks; each lane keeps the k x 8
//     basis floats of its row in registers and walks its frames: the basis
//     is read once a pass for each CTA.
//   - The estimates come through shared memory, 8 frames at a time, by
//     cp.async, the next chunk in flight while this one is computed (warp
//     w copies its lane's row of frame w: 8 KB a chunk at k = 4).
//   - The window: each lane folds its 8 pixels in registers and stores
//     one float4 (lo, hi, unflagged lo, unflagged hi) a frame in shared
//     memory; every 8 frames warp w folds frame w over the 8 rows, then
//     over its lanes by shuffles, and its channel lanes take one global
//     atomic a slot (order-preserving u32 keys: exact in any order), each
//     slot a cache line of its own.
//   - A tiny kernel turns each plane's window into (lo, scale, fill) once,
//     so the paint reads a float4 a frame instead of decoding and
//     dividing in every lane.
//   - Rows of round_up(k + 1, 4) floats (K5f's layout) read as float4; u8
//     is cvt.rzi.sat (truncate and saturate in one instruction), packed by
//     byte permutes; channels-last rows go through a warp stage written
//     byte-wise and read as 8 bytes a lane; the output, written once, by
//     streaming stores.
//   - A CTA walks a share of the frames (the grid's second factor), so that
//     the grid fills the card in about six waves whatever the batch; the
//     CTAs of one tile are neighbours, so its basis comes from L2.
//   - Offsets within a frame are 32-bit (the host refuses a frame of 2^31
//     elements or more); -fmad=false and the _rn intrinsics keep every
//     rounding the twin's.
//
// ---------------------------------------------------------------------------
// K8 normalize_blocks. Replaces the XLA fusion of dctsvd_tpu/models/
// blocked.py::_normalize_blocks (:869), the clip and cast (:1045-1047) and
// _unblockify_to_frames (:942) or dct.unblockify, reached through
// _extract_tail_prepared(recompute=False) at block-aligned sizes; no
// pl.pallas_call. Plain twin: dctsvd_tpu_torch/ops/tail_cuda.py::
// normalize_blocks_plain.
//
// What it computes: per plane (frame, channel) the min and max over all
// its pixels and over those of unflagged blocks (the erasure flag from
// column k of K5f's rows), each plane's (lo, scale, fill) as K5's (one
// IEEE division), and K5's repaint, cast and stores; each block's 64
// pixels read from the reconstruction that the caller's batched product
// materialised (models/blocked.py::_recon, [m, Fp, 64]: a block's frames
// 256 bytes apart, blocks Fp x 256 bytes apart) instead of rebuilt from
// the estimates. Min and max are exact in any order and the paint is per
// pixel, so both instances give the twin's bytes, a frame the same alone,
// in a shard or in any batch.
//
// Two instances; tail_cuda.norm_plan picks one on the host by shape.
//
// The resident instance (norm_resident_kernel; the 1080p batches, color
// and gray). What bounds it on the H100: bytes, each input read once (at
// 1080p color, batch 32: the reconstruction's 796 MB, the flags' 12 MB
// and the u8 frames' 199 MB, 0.3008 ms at 3.35 TB/s), but not at that
// rate: a frame of the product is a gather of 256-byte pieces 8 KB apart,
// and the instance without normalize (no window, no barrier) moves it at
// about 2.2 TB/s, 0.44-0.45 ms (chip_smoke.py --tail-times,
// k8_color_resident_no_normalize). A frame is 24.9 MB color, 8.3 MB gray;
// the 132 SMs' shared memory holds 30 MB, so a persistent grid of one CTA
// an SM (a cooperative launch: every CTA co-resident, or the launch is
// refused and the wrapper raises) keeps an equal share of each frame's
// blocks (245 or 246 of a 1080p plane's 32,400, every plane of the frame)
// in shared memory from its load to its paint, with a grid barrier a frame
// (a counter a frame in the win scratch) between the window and the paint.
// What the design does about it:
//   - Staging by 16-byte cp.async from all 512 threads, each 8-row block
//     padded to 68 floats so that a quarter-warp's float4 reads of 8
//     neighbouring blocks hit 8 bank groups. 1-D bulk copies (the TMA's)
//     of the same 256-byte pieces were slower.
//   - A ring of chunk slots (norm_plan): where two or three shares fit
//     (gray 1080p: 3 slots of a frame's share), the next frame is folded
//     and arrives at its barrier before this one's is waited on, so the
//     barrier's latency hides behind a fold; where one fits (color 1080p:
//     2 slots of half a share), the next frame's halves load into the
//     slots as this one's paint frees them, and TMA bulk prefetches bring
//     the next frame into L2 once this one has landed, so device memory
//     streams through the fold, the barrier and the paint. A frame whose
//     share fits four times (512x512 gray) takes the two-pass instance.
//   - The fold: the warps split among the planes, each lane folds its
//     (block, pixel row) items with row_window in registers, one shuffle
//     reduction a plane and chunk, and a CTA takes one atomic a slot and
//     plane (K5's order-preserving keys and slots).
//   - After the barrier each CTA decodes its planes' (lo, scale, fill)
//     from the slots itself (plane_params, the params kernel's
//     arithmetic), so no params launch.
//   - The paint: a lane a (block, pixel row), neighbouring lanes on
//     neighbouring blocks, all planes of a pixel row together, so a
//     channels-last row is 24 contiguous elements: three 8-byte (u8) or
//     six 16-byte (f32) streaming stores, each whole.
//   - What the window and the barrier cost is the gap to the instance
//     without normalize (--tail-times, NVIDIA H100 80GB HBM3, 700 W): at
//     32 color frames 0.589-0.599 ms against 0.444-0.458, at 32 gray
//     0.253-0.254 against 0.141-0.144. One color frame fills the shared
//     memory, so its fold, barrier and paint do not overlap the next
//     frame's load into shared memory.
//
// The two-pass instance (norm_window_kernel, norm_paint_kernel; a frame
// whose share does not fit one CTA's shared memory, as a 4K color frame
// or an 8K band, a small frame whose share fits four times, as 512x512
// gray, and calls without normalize, where the paint pass alone reads
// once). What bounds it: the reconstruction read in each pass (at
// 1080p color, batch 32: 2 x 796 MB, which the 50 MB L2 cannot keep
// between them) and the u8 frames written once (199 MB): 0.535 ms at
// 3.35 TB/s. What the design does about it: K5's grid, lanes, fold and
// stores (shared inline helpers), in a window and a paint kernel of its
// own (sharing K5's kernels through a source policy cost K5 5 % of its
// time): each lane loads its 32-byte row of its block for all the chunk's
// 8 frames before it uses one, so a lane has 256 bytes in flight; the 8
// warps of a CTA read the 8 rows of each block, and a block's frames lie
// next to each other in the product's layout, so a CTA's reads of a chunk
// are 2 KB runs. Pass 1 loads through L2 (a batch that fits is read again
// from there), pass 2 as evict-first; the flags come as one 4-byte load a
// lane and frame; a tiny kernel turns the window into (lo, scale, fill).
//
// K8u, K8 with a crop (either instance's kernels with kCrop). Replaces the
// XLA fusion of dctsvd_tpu/models/blocked.py::_masked_normalize (:818)
// with the clip and cast (:1053-1054) and the unblockify and crop before
// it (:1050-1051), reached through _extract_tail_prepared at sizes that
// are not multiples of 8, and through _extract_planes (:622; the request
// extract: api.extract, the CLI, the GUI, payloads) at every size; no
// pl.pallas_call. Plain twin: the same normalize_blocks_plain, given the
// crop. The blocks cover the padded ceil(h / 8) x ceil(w / 8) grid, the
// output is h x w: a pixel at row >= h or column >= w enters no window
// (row_window_crop: a row's first min(8, w - 8 bx) pixels, none below the
// crop) and is not stored. Min and max are exact in any order, so the
// window over the pixels inside the crop is the cropped plane's, and the
// bytes are the twin's.
//   Which instance: tail_cuda.shape_plan gives a crop the plan of its
// padded grid, so the resident instance wherever a frame's share fits as
// at 1080p (1079 x 1917 color and gray, 1366 x 768 color), the two-pass
// one elsewhere (854 x 480 and 1366 x 768 gray, whose shares fit four
// times; 4K; calls without normalize). What bounds each: as without the
// crop, bytes (the product read once, or once a pass).
//   What the crop adds is its stores: a row of an unaligned crop starts
// on no word boundary of the output, and the instances' whole-word stores
// (store_row, store_pixel_row3) need one. So each warp stages the pixel
// rows its lanes paint and stores each contiguous run of them as 16-byte
// words, 4-byte words to and from the first and last 16-byte boundaries,
// and a byte at a time only the partial word at either end, the only
// bytes of a word another warp or CTA writes too (store_run). In the
// resident paint a warp takes its 32 items together: their runs (768
// bytes for color u8 frames, 256 a plane) break only where the items
// cross a pixel row of the chunk or a block row, so each lane works out
// its run from its item's indices, with no warp vote (the division by
// the block row a multiply-high, FastDiv), and the stage is written in
// whole words. In the two-pass paint a warp's row of 10 or 32 blocks is
// one run, which all 32 lanes store. f32 rows fill whole 4-byte words,
// so each lane stores its own as 4- and 16-byte words (store_unit), with
// no stage. The resident ring gives the warps' stages 4,096 bytes a plane
// (res_smem), which leaves 1080p's ring and chunk as they were. The
// resident crop's paint takes longer than the aligned paint (the most on
// gray planes), with this stage or with a realignment by shuffles and no
// stage alike; what holds it is not told apart (PERF.md §7). In the
// two-pass paint, which holds 8 frames' rows in registers at two CTAs an
// SM, the realignment costs more than the element-a-lane stores it
// replaced, whose bytes the L2 merges (PERF.md §6, K8u rows).
//
// chip_smoke.py prints each instance's registers (`nvcc -Xptxas -v`) and
// the resident plan's shared memory; --tail-times times both instances
// and the resident one without normalize.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "blocks.cuh"

namespace dctsvd {
namespace {

constexpr int kTailWarps = kB;               // a warp a pixel row
constexpr int kTailThreads = kTailWarps * 32;
constexpr int kTailChunk = kTailWarps;       // frames staged and folded
constexpr int kWinStride = 32;               // u32 between window slots
constexpr int kFrontThreads = 256;
constexpr int kWaves = 6;                    // CTAs a launch aims at

// Order-preserving u32 key of a float: key(a) < key(b) iff a < b, with
// -0.0 below +0.0. A NaN takes the lowest key in a min slot and the
// highest in a max slot, so it wins the fold as torch.amin / amax let it;
// both decode to NaN.
__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t b = __float_as_uint(v);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ uint32_t key_lo(float v) {
  return v != v ? 0u : key_of(v);
}

__device__ __forceinline__ uint32_t key_hi(float v) {
  return v != v ? 0xffffffffu : key_of(v);
}

__device__ __forceinline__ float float_of(uint32_t u) {
  return __uint_as_float((u >> 31) ? (u ^ 0x80000000u) : ~u);
}

constexpr uint32_t kLoInit = 0xff800000u;    // key_of(+inf)
constexpr uint32_t kHiInit = 0x007fffffu;    // key_of(-inf)

// min and max that return NaN when either input is NaN (torch's amin,
// amax, clamp, maximum and minimum), where fminf / fmaxf would drop it.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Floats a row of estimates: the k estimates, the flag, zero padding to
// 16 bytes.
__host__ __device__ constexpr int est_row(int k) { return (k + 4) / 4 * 4; }

// ---------------------------------------------------------------------------
// K5f
// ---------------------------------------------------------------------------

template <int K, bool kShrink>
__global__ void __launch_bounds__(kFrontThreads)
    tail_front_kernel(const float* __restrict__ s_cw,
                      const float* __restrict__ sc,
                      const int64_t* __restrict__ inv_blk,
                      const float* __restrict__ alpha, int alpha_step,
                      const float* __restrict__ sw,
                      const float* __restrict__ scale,
                      const uint8_t* __restrict__ engage,
                      float* __restrict__ out, int planes, int chans,
                      int n) {
  constexpr int kRow = est_row(K);
  constexpr int kIn = (K + 3) / 4;             // float4 of a slot row read
  const int blk = blockIdx.x * kFrontThreads + threadIdx.x;
  if (blk >= n) return;
  const int64_t j64 = inv_blk[blk];
  const bool ok = j64 >= 0 && j64 < n;
  const int j = ok ? static_cast<int>(j64) : 0;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const int c = p % chans;
    const int64_t row = static_cast<int64_t>(p) * n;
    const float4* s4 = reinterpret_cast<const float4*>(s_cw + (row + j) * kB);
    const float4* c4 = reinterpret_cast<const float4*>(sc + (row + j) * kB);
    float s[4 * kIn], cc[4 * kIn];
#pragma unroll
    for (int q = 0; q < kIn; ++q) {
      const float4 a = s4[q], b = c4[q];
      s[4 * q] = a.x; s[4 * q + 1] = a.y; s[4 * q + 2] = a.z;
      s[4 * q + 3] = a.w;
      cc[4 * q] = b.x; cc[4 * q + 1] = b.y; cc[4 * q + 2] = b.z;
      cc[4 * q + 3] = b.w;
    }
    const float a = max_nan(alpha[static_cast<int64_t>(p) * alpha_step],
                            1e-8f);
    float o[kRow];
#pragma unroll
    for (int i = 0; i < kRow; ++i) o[i] = 0.0f;
    float raw[K];
#pragma unroll
    for (int i = 0; i < K; ++i) raw[i] = __fdiv_rn(__fsub_rn(s[i], cc[i]), a);
    if constexpr (!kShrink) {
#pragma unroll
      for (int i = 0; i < K; ++i) o[i] = raw[i];
    } else {
      const float4* r4 = reinterpret_cast<const float4*>(
          sw + (static_cast<int64_t>(c) * n + j) * kB);
      float ref[4 * kIn];
#pragma unroll
      for (int q = 0; q < kIn; ++q) {
        const float4 v = r4[q];
        ref[4 * q] = v.x; ref[4 * q + 1] = v.y; ref[4 * q + 2] = v.z;
        ref[4 * q + 3] = v.w;
      }
      const float sc_c = scale[c];
      const bool eng = engage[p] != 0;
      float dev = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float d = fabsf(__fsub_rn(raw[i], ref[i]));
        dev = i == 0 ? d : max_nan(dev, d);
        const float q = __fdiv_rn(d, sc_c);
        float w = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(q, q)));
        if (raw[i] < 0.0f) w = 0.0f;
        const float shrunk = max_nan(
            __fadd_rn(ref[i], __fmul_rn(w, __fsub_rn(raw[i], ref[i]))),
            0.0f);
        const float clamped =
            min_nan(max_nan(raw[i], __fmul_rn(-0.5f, ref[i])),
                    __fmul_rn(1.5f, ref[i]));
        o[i] = eng ? shrunk : clamped;
      }
      o[K] = (dev > __fmul_rn(2.0f, sc_c) && !eng) ? 1.0f : 0.0f;
    }
    if (!ok) {                 // not a slot of this plane: a visible row
#pragma unroll
      for (int i = 0; i < kRow; ++i) o[i] = __int_as_float(0x7fffffff);
    }
    float4* d4 = reinterpret_cast<float4*>(out + (row + blk) * kRow);
#pragma unroll
    for (int q = 0; q < kRow / 4; ++q)
      d4[q] = make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  }
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// The largest power of two p with kC * p < 32: the first shuffle offset
// of a fold over the lanes of one channel (lane = block * kC + channel).
__host__ __device__ constexpr int fold_top(int c) {
  int p = 1;
  while (c * p * 2 < 32) p *= 2;
  return p;
}

// Min (kMax false) or max of v over the lanes of this lane's channel;
// lanes 0..kC-1 hold the results. A lane past the warp's end reads its
// own value, which min and max leave unchanged.
template <int kC, bool kMax>
__device__ __forceinline__ float warp_fold(float v) {
#pragma unroll
  for (int p = fold_top(kC); p >= 1; p >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, v, p * kC);
    v = kMax ? max_nan(v, o) : min_nan(v, o);
  }
  return v;
}

// Where a thread sits: the CTA takes blocks g * kG .. g * kG + kG - 1 of
// block row `by` of channel group `cg` and frames fbeg .. fend - 1, warp r
// their pixel row r, and lane (block bxl, channel ci).
template <int kC>
struct TailLane {
  static constexpr int kG = 32 / kC;   // blocks a warp
  int lane, r, g, by, cg, bxl, ci, bx, n, c, fbeg, fend;
  bool active;

  __device__ TailLane(int hb, int wb, int groups, int splits, int fper,
                      int frames) {
    lane = threadIdx.x & 31;
    r = threadIdx.x >> 5;
    const int split = blockIdx.x % splits;
    const int tile = blockIdx.x / splits;
    g = tile % groups;
    const int rest = tile / groups;
    by = rest % hb;
    cg = rest / hb;
    bxl = lane / kC;
    ci = lane - bxl * kC;
    bx = g * kG + bxl;
    active = bxl < kG && bx < wb;
    n = by * wb + bx;
    c = cg * kC + ci;
    fbeg = split * fper;
    fend = min(frames, fbeg + fper);
  }
};

// Row r of the k basis rows of block (c, n): 2 float4 loads a row (the
// host checks 16-byte alignment).
template <int K>
__device__ __forceinline__ void load_basis(const float* __restrict__ eb,
                                           int64_t bstride, int64_t blk,
                                           int r, float (&e)[K][kB]) {
  const float* row = eb + blk * bstride + r * kB;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float4* p = reinterpret_cast<const float4*>(row + j * kB * kB);
    const float4 a = p[0], b = p[1];
    e[j][0] = a.x; e[j][1] = a.y; e[j][2] = a.z; e[j][3] = a.w;
    e[j][4] = b.x; e[j][5] = b.y; e[j][6] = b.z; e[j][7] = b.w;
  }
}

// A block's row of estimates (the k estimates and the flag) as float4.
template <int K>
struct EstRow {
  static constexpr int kVec = est_row(K) / 4;
  float v[4 * kVec];

  // from a chunk stage: piece q of this lane's row at p[q * 32]
  __device__ __forceinline__ void load(const float4* p) {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const float4 a = p[q * 32];
      v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// The estimates of a CTA's 32 lane rows for kTailChunk frames, two chunks
// in flight: float4 piece q of lane l's row of frame fi of buffer b at
// [((b * kTailChunk + fi) * kVec + q) * 32 + l] (a warp's reads of one
// piece are 512 contiguous bytes).
template <int K>
__host__ __device__ constexpr int stage_pieces() {
  return 2 * kTailChunk * EstRow<K>::kVec * 32;
}

template <int K>
__device__ __forceinline__ const float4* staged(const float4* xs, int b,
                                                int fi, int lane) {
  return xs + (b * kTailChunk + fi) * EstRow<K>::kVec * 32 + lane;
}

// Warp w copies its lane's row of frame f + w into buffer b by cp.async
// (nothing past fend), then every thread commits its group.
template <int K>
__device__ __forceinline__ void stage_chunk(float4* xs, int b,
                                            const float* __restrict__ xr,
                                            int64_t xstep, int f, int fend,
                                            int w, int lane, bool active) {
  const int fr = f + w;
  if (active && fr < fend) {
    const float* src = xr + fr * xstep;
    float4* dst = const_cast<float4*>(staged<K>(xs, b, w, lane));
#pragma unroll
    for (int q = 0; q < EstRow<K>::kVec; ++q)
      cp_async16(dst + q * 32, src + 4 * q);
  }
  cp_async_commit();
}

// The 8 pixels of the row: y = x0 e0, then y + xj ej in order of j.
template <int K>
__device__ __forceinline__ void produce(const EstRow<K>& x,
                                        const float (&e)[K][kB],
                                        float (&y)[kB]) {
#pragma unroll
  for (int i = 0; i < kB; ++i) y[i] = __fmul_rn(x.v[0], e[0][i]);
#pragma unroll
  for (int j = 1; j < K; ++j)
#pragma unroll
    for (int i = 0; i < kB; ++i)
      y[i] = __fadd_rn(y[i], __fmul_rn(x.v[j], e[j][i]));
}

// The window's slot s of plane p: a cache line of its own, so that the
// CTAs' atomics on one frame spread over the L2's slices.
__device__ __forceinline__ uint32_t* win_slot(uint32_t* slots, int64_t p,
                                              int s) {
  return slots + (p * 4 + s) * kWinStride;
}

// Fills the slots with the keys of (+inf, -inf); zeroes the resident
// instance's nbar grid barriers bar (none for the two-pass kernels).
__global__ void tail_init_kernel(uint32_t* __restrict__ slots, int n,
                                 unsigned* __restrict__ bar, int nbar) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) *win_slot(slots, t >> 2, t & 3) = (t & 1) ? kHiInit : kLoInit;
  if (t < nbar) bar[t] = 0u;
}

// Pass 1's fold, both sources: warp r folds frame f0 + r of the chunk in
// part (each lane's (lo, hi, unflagged lo, unflagged hi) of each frame and
// row) over the 8 rows, then over its lanes, and its channel lanes take
// one atomic a slot. Slots 0..3 of plane p = f * chans + c: keys of
// (unflagged lo, unflagged hi, lo, hi), filled with the keys of (+inf,
// -inf, +inf, -inf) before the launch.
template <int kC>
__device__ __forceinline__ void fold_window(
    const float4 (*part)[kTailWarps][32], const TailLane<kC>& t, int f0,
    int nf, int chans, int flagged, uint32_t* __restrict__ slots) {
  if (t.r >= nf) return;
  float4 v = part[t.r][0][t.lane];
#pragma unroll
  for (int q = 1; q < kTailWarps; ++q) {
    const float4 u = part[t.r][q][t.lane];
    v.x = min_nan(v.x, u.x);
    v.y = max_nan(v.y, u.y);
    v.z = min_nan(v.z, u.z);
    v.w = max_nan(v.w, u.w);
  }
  v.x = warp_fold<kC, false>(v.x);
  v.y = warp_fold<kC, true>(v.y);
  if (flagged) {
    v.z = warp_fold<kC, false>(v.z);
    v.w = warp_fold<kC, true>(v.w);
  }
  if (t.lane < kC) {
    const int64_t p = static_cast<int64_t>(f0 + t.r) * chans + t.cg * kC +
                      t.lane;
    if (flagged) {
      atomicMin(win_slot(slots, p, 0), key_lo(v.z));
      atomicMax(win_slot(slots, p, 1), key_hi(v.w));
    }
    atomicMin(win_slot(slots, p, 2), key_lo(v.x));
    atomicMax(win_slot(slots, p, 3), key_hi(v.y));
  }
}

// A lane's (lo, hi, unflagged lo, unflagged hi) over its row of 8 pixels.
__device__ __forceinline__ float4 row_window(const float (&y)[kB],
                                             bool bad) {
  const float inf = __int_as_float(0x7f800000);
  float lo = y[0], hi = y[0];
#pragma unroll
  for (int i = 1; i < kB; ++i) {
    lo = min_nan(lo, y[i]);
    hi = max_nan(hi, y[i]);
  }
  return make_float4(lo, hi, bad ? inf : lo, bad ? -inf : hi);
}

// K8u's: the window of the row's first `cols` pixels (0: the row lies
// below the crop, the empty window), min and max from (+inf, -inf), exact
// in any order.
__device__ __forceinline__ float4 row_window_crop(const float (&y)[kB],
                                                  bool bad, int cols) {
  const float inf = __int_as_float(0x7f800000);
  float lo = inf, hi = -inf;
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    if (i < cols) {
      lo = min_nan(lo, y[i]);
      hi = max_nan(hi, y[i]);
    }
  }
  return make_float4(lo, hi, bad ? inf : lo, bad ? -inf : hi);
}

// K8u: the pixels of the lane's row inside an h x w crop (0 when the row
// is below it; the lane's block starts inside it).
template <int kC>
__device__ __forceinline__ int crop_cols(const TailLane<kC>& t, int h,
                                         int w) {
  return t.by * kB + t.r < h ? min(kB, w - t.bx * kB) : 0;
}

// K5's pass 1. Shared memory: the fold's part, then the stage.
constexpr int kPartPieces = kTailChunk * kTailWarps * 32;

template <int K>
__host__ __device__ constexpr int window_smem() {
  return (kPartPieces + stage_pieces<K>()) * 16;
}

template <int K, int kC>
__global__ void __launch_bounds__(kTailThreads, 4)
    tail_window_kernel(const float* __restrict__ x,
                       const float* __restrict__ eb, int64_t bstride,
                       uint32_t* __restrict__ slots, int frames, int chans,
                       int hb, int wb, int groups, int splits, int fper,
                       int flagged) {
  extern __shared__ float4 tail_smem[];
  // (lo, hi, unflagged lo, unflagged hi) of each lane, frame of the chunk
  // and row
  auto part = reinterpret_cast<float4 (*)[kTailWarps][32]>(tail_smem);
  float4* xs = tail_smem + kPartPieces;
  const TailLane<kC> t(hb, wb, groups, splits, fper, frames);
  const int n_blk = hb * wb;
  float e[K][kB];
  if (t.active)
    load_basis<K>(eb, bstride, static_cast<int64_t>(t.c) * n_blk + t.n, t.r,
                  e);
  constexpr int kRow = est_row(K);
  const int64_t xstep = static_cast<int64_t>(chans) * n_blk * kRow;
  const float* xr = x + (static_cast<int64_t>(t.c) * n_blk + t.n) * kRow;
  const float inf = __int_as_float(0x7f800000);
  stage_chunk<K>(xs, 0, xr, xstep, t.fbeg, t.fend, t.r, t.lane, t.active);
  for (int f0 = t.fbeg, b = 0; f0 < t.fend; f0 += kTailChunk, b ^= 1) {
    const int nf = min(kTailChunk, t.fend - f0);
    stage_chunk<K>(xs, b ^ 1, xr, xstep, f0 + kTailChunk, t.fend, t.r,
                   t.lane, t.active);
    cp_async_wait_one();
    __syncthreads();
    for (int fi = 0; fi < nf; ++fi) {
      float4 v = make_float4(inf, -inf, inf, -inf);
      if (t.active) {
        EstRow<K> xv;
        xv.load(staged<K>(xs, b, fi, t.lane));
        float y[kB];
        produce<K>(xv, e, y);
        v = row_window(y, flagged && xv.v[K] > 0.5f);
      }
      part[fi][t.r][t.lane] = v;
    }
    __syncthreads();
    // the next chunk's stage and barrier keep part until every warp has
    // folded
    fold_window<kC>(part, t, f0, nf, chans, flagged, slots);
  }
}

// K8's pixel source: lane (block, row r)'s 32-byte row of the
// reconstruction, frame f at rec + blk * bstride + r * 8 + f * fstride,
// and its flag at x[blk * xrow + f * xstep + xflag] (x null: no flags).
struct RecSrc {
  const float* rec;
  const float* x;
  int64_t bstride, fstride, xrow;
  int xflag;
};

struct RecRows {
  const float* row;     // this lane's row of its block, frame 0
  const float* flag;    // its flag, frame 0 (null: no flags)
  int64_t fstride, xstep;

  template <int kC>
  __device__ __forceinline__ RecRows(const RecSrc& s, const TailLane<kC>& t,
                                     int chans, int n_blk)
      : fstride(s.fstride) {
    const int64_t blk = static_cast<int64_t>(t.c) * n_blk + t.n;
    row = s.rec + blk * s.bstride + t.r * kB;
    flag = s.x ? s.x + blk * s.xrow + s.xflag : nullptr;
    xstep = static_cast<int64_t>(chans) * n_blk * s.xrow;
  }

  // every row of the chunk's frames in flight at once, 32 bytes a frame:
  // pass 1 keeps them in L2 (a small batch is read again from there),
  // pass 2 (kLast) reads them for the last time
  template <bool kLast>
  __device__ __forceinline__ void load(int f0, int nf, bool active,
                                       float (&y)[kTailChunk][kB],
                                       bool (&bad)[kTailChunk]) const {
#pragma unroll
    for (int fi = 0; fi < kTailChunk; ++fi) {
      if (active && fi < nf) {
        const float4* p =
            reinterpret_cast<const float4*>(row + (f0 + fi) * fstride);
        const float4 a = kLast ? __ldcs(p) : __ldg(p);
        const float4 c = kLast ? __ldcs(p + 1) : __ldg(p + 1);
        y[fi][0] = a.x; y[fi][1] = a.y; y[fi][2] = a.z; y[fi][3] = a.w;
        y[fi][4] = c.x; y[fi][5] = c.y; y[fi][6] = c.z; y[fi][7] = c.w;
        bad[fi] = flag != nullptr && __ldg(flag + (f0 + fi) * xstep) > 0.5f;
      }
    }
  }
};

// K8's pass 1: K5's with each row loaded from the reconstruction. kCrop
// (K8u): only the pixels inside the h x w crop enter the window.
template <int kC, bool kCrop>
__global__ void __launch_bounds__(kTailThreads, 2)
    norm_window_kernel(RecSrc s, uint32_t* __restrict__ slots, int frames,
                       int chans, int hb, int wb, int groups, int splits,
                       int fper, int h, int w) {
  __shared__ float4 part[kTailChunk][kTailWarps][32];
  const TailLane<kC> t(hb, wb, groups, splits, fper, frames);
  const RecRows src(s, t, chans, hb * wb);
  const int flagged = s.x != nullptr;
  const float inf = __int_as_float(0x7f800000);
  const int cols = kCrop && t.active ? crop_cols(t, h, w) : kB;
  for (int f0 = t.fbeg; f0 < t.fend; f0 += kTailChunk) {
    const int nf = min(kTailChunk, t.fend - f0);
    float y[kTailChunk][kB];
    bool bad[kTailChunk];
    src.load<false>(f0, nf, t.active, y, bad);
    __syncthreads();    // the last fold read part
#pragma unroll
    for (int fi = 0; fi < kTailChunk; ++fi)
      if (fi < nf)
        part[fi][t.r][t.lane] =
            !t.active ? make_float4(inf, -inf, inf, -inf)
            : kCrop   ? row_window_crop(y[fi], bad[fi], cols)
                      : row_window(y[fi], bad[fi]);
    __syncthreads();
    fold_window<kC>(part, t, f0, nf, chans, flagged, slots);
  }
}

// Plane p's window keys -> (lo, scale, fill, 0): the unflagged window, or
// the whole one where that is not finite; one IEEE division. The slots
// are read from L2 (the resident instance reads them after its grid
// barrier).
__device__ __forceinline__ float4 plane_params(uint32_t* __restrict__ slots,
                                               int64_t p, int flagged) {
  float lo = float_of(__ldcg(win_slot(slots, p, 2)));
  float hi = float_of(__ldcg(win_slot(slots, p, 3)));
  if (flagged) {
    const float glo = float_of(__ldcg(win_slot(slots, p, 0)));
    const float ghi = float_of(__ldcg(win_slot(slots, p, 1)));
    if (isfinite(glo) && isfinite(ghi)) {
      lo = glo;
      hi = ghi;
    }
  }
  const float scale = __fdiv_rn(255.0f, max_nan(__fsub_rn(hi, lo), 1e-12f));
  const float fill = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
  return make_float4(lo, scale, fill, 0.0f);
}

// Between the passes: each plane's window keys -> prm[p].
__global__ void tail_params_kernel(uint32_t* __restrict__ slots,
                                   float4* __restrict__ prm, int planes,
                                   int flagged) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= planes) return;
  prm[p] = plane_params(slots, p, flagged);
}

// u8: truncate toward zero and saturate to [0, 255], NaN to 0 (the twin's
// clamp(0, 255) and cast, and store_val's) in one conversion.
__device__ __forceinline__ uint32_t sat_u8(float v) {
  uint32_t d;
  asm("cvt.rzi.sat.u8.f32 %0, %1;" : "=r"(d) : "f"(v));
  return d;
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The shared memory a warp's channels-last row goes through.
template <int kC>
__host__ __device__ constexpr int stage_elems() {
  return kC > 1 ? TailLane<kC>::kG * kC * kB : 1;
}

// Pass 2's store, both sources: a lane's 8 values of its pixel row at o,
// cast; planes 8 elements a lane, channels-last frames through the warp's
// stage st, its first `live` lanes storing 8 elements each.
template <int kC, typename Out>
__device__ __forceinline__ void store_row(Out* o, const float (&v)[kB],
                                          Out* st, const TailLane<kC>& t,
                                          int live) {
  if constexpr (std::is_same<Out, uint8_t>::value) {
    if constexpr (kC == 1) {
      if (t.active) {
        uint2 wd;
        wd.x = pack4(sat_u8(v[0]), sat_u8(v[1]), sat_u8(v[2]), sat_u8(v[3]));
        wd.y = pack4(sat_u8(v[4]), sat_u8(v[5]), sat_u8(v[6]), sat_u8(v[7]));
        __stcs(reinterpret_cast<uint2*>(o), wd);
      }
    } else {
      if (t.active) {
#pragma unroll
        for (int i = 0; i < kB; ++i)
          st[t.bxl * kC * kB + i * kC + t.ci] =
              static_cast<uint8_t>(sat_u8(v[i]));
      }
      __syncwarp();
      if (t.lane < live)
        __stcs(reinterpret_cast<uint2*>(o),
               *reinterpret_cast<const uint2*>(st + t.lane * kB));
      __syncwarp();
    }
  } else {
    if constexpr (kC == 1) {
      if (t.active) {
        float4* q = reinterpret_cast<float4*>(o);
        __stcs(q, make_float4(v[0], v[1], v[2], v[3]));
        __stcs(q + 1, make_float4(v[4], v[5], v[6], v[7]));
      }
    } else {
      if (t.active) {
#pragma unroll
        for (int i = 0; i < kB; ++i) st[t.bxl * kC * kB + i * kC + t.ci] = v[i];
      }
      __syncwarp();
      if (t.lane < live) {
        const float4* sp = reinterpret_cast<const float4*>(st + t.lane * kB);
        float4* q = reinterpret_cast<float4*>(o);
        __stcs(q, sp[0]);
        __stcs(q + 1, sp[1]);
      }
      __syncwarp();
    }
  }
}

// Where a lane's pixel row of frame 0 goes in the output: warp r's run
// of pixel row by * 8 + r, cg * H * W + (y * W + the first block's column)
// * kC, 8 elements a lane.
template <int kC>
__device__ __forceinline__ int out_seg(const TailLane<kC>& t, int n_blk,
                                       int wb) {
  return t.cg * (n_blk * kB * kB) +
         ((t.by * kB + t.r) * (wb * kB) + t.g * TailLane<kC>::kG * kB) * kC +
         t.lane * kB;
}

// K5's pass 2: (y or fill - lo) * scale with each plane's (lo, scale, fill)
// (prm; null without normalize: (0, 1, 0)), cast and store.
template <int K, int kC, typename Out>
__global__ void __launch_bounds__(kTailThreads)
    tail_paint_kernel(const float* __restrict__ x,
                      const float* __restrict__ eb, int64_t bstride,
                      const float4* __restrict__ prm, Out* __restrict__ out,
                      int frames, int chans, int hb, int wb, int groups,
                      int splits, int fper, int flagged) {
  __shared__ __align__(16) Out stage[kTailWarps][stage_elems<kC>()];
  __shared__ float4 xs[stage_pieces<K>()];
  const TailLane<kC> t(hb, wb, groups, splits, fper, frames);
  const int n_blk = hb * wb;
  float e[K][kB];
  if (t.active)
    load_basis<K>(eb, bstride, static_cast<int64_t>(t.c) * n_blk + t.n, t.r,
                  e);
  constexpr int kRow = est_row(K);
  const int64_t xstep = static_cast<int64_t>(chans) * n_blk * kRow;
  const float* xr = x + (static_cast<int64_t>(t.c) * n_blk + t.n) * kRow;
  const int64_t frame_out = static_cast<int64_t>(n_blk) * kB * kB * chans;
  Out* o = out + t.fbeg * frame_out + out_seg(t, n_blk, wb);
  const float4* pp = prm ? prm + static_cast<int64_t>(t.fbeg) * chans + t.c
                         : nullptr;
  const int live = min(TailLane<kC>::kG, wb - t.g * TailLane<kC>::kG) * kC;
  stage_chunk<K>(xs, 0, xr, xstep, t.fbeg, t.fend, t.r, t.lane, t.active);
  for (int f0 = t.fbeg, b = 0; f0 < t.fend; f0 += kTailChunk, b ^= 1) {
    const int nf = min(kTailChunk, t.fend - f0);
    stage_chunk<K>(xs, b ^ 1, xr, xstep, f0 + kTailChunk, t.fend, t.r,
                   t.lane, t.active);
    cp_async_wait_one();
    __syncthreads();
    for (int fi = 0; fi < nf; ++fi, o += frame_out) {
      const float4 pr = pp ? *pp : make_float4(0.0f, 1.0f, 0.0f, 0.0f);
      if (pp) pp += chans;
      float v[kB];
      if (t.active) {
        EstRow<K> xv;
        xv.load(staged<K>(xs, b, fi, t.lane));
        float y[kB];
        produce<K>(xv, e, y);
        const bool bad = flagged && xv.v[K] > 0.5f;
#pragma unroll
        for (int i = 0; i < kB; ++i)
          v[i] = __fmul_rn(__fsub_rn(bad ? pr.z : y[i], pr.x), pr.y);
      }
      store_row<kC>(o, v, stage[t.r], t, live);
    }
    __syncthreads();   // buffer b is staged again by the next chunk
  }
}

// ---------------------------------------------------------------------------
// K8u's stores, both instances': a row of a crop starts on no word boundary
// of the output, so each is realigned to the output's words.
// ---------------------------------------------------------------------------

// Bytes q .. q + 3 of a stage (aligned words st), shifted out of two words.
__device__ __forceinline__ uint32_t stage_word(const uint32_t* st,
                                               uint32_t q) {
  const uint32_t sh = 8 * (q & 3u), i = q >> 2;
  return __funnelshift_r(st[i], sh ? st[i + 1] : 0u, sh);
}

// Bytes q .. q + 15 of a stage, out of five words (four where aligned).
__device__ __forceinline__ uint4 stage_word16(const uint32_t* st,
                                              uint32_t q) {
  const uint32_t sh = 8 * (q & 3u), i = q >> 2;
  const uint32_t w0 = st[i], w1 = st[i + 1], w2 = st[i + 2], w3 = st[i + 3];
  const uint32_t w4 = sh ? st[i + 4] : 0u;
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// One run of u8 output bytes [x0, x5) from a stage (output byte x is
// stage byte x + from; x counts from base, which is 16-byte aligned),
// stored by lanes k = 0 .. m - 1 (this one is k): 16-byte words, then
// 4-byte words to and from the first and last 16-byte boundaries, then,
// a byte at a time, the partial word at either end, the only bytes of a
// word that another warp or CTA writes too. No warp collective.
__device__ __forceinline__ void store_run(uint8_t* base, const uint8_t* st,
                                          uint32_t x0, uint32_t x5,
                                          uint32_t from, int k, int m) {
  const uint32_t x1 = min((x0 + 3u) & ~3u, x5), e4 = x5 & ~3u;
  const uint32_t x2 = max(x1, min((x0 + 15u) & ~15u, e4));
  const uint32_t x3 = max(x2, x5 & ~15u), x4 = max(x3, e4);
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(st);
  for (uint32_t x = x2 + 16u * k; x < x3; x += 16u * m)
    __stcs(reinterpret_cast<uint4*>(base + x), stage_word16(s32, x + from));
  const int n4 = (x2 - x1) >> 2, words = n4 + ((x4 - x3) >> 2);
  for (int q = k; q < words; q += m) {
    const uint32_t x = q < n4 ? x1 + 4 * q : x3 + 4 * (q - n4);
    __stcs(reinterpret_cast<unsigned*>(base + x), stage_word(s32, x + from));
  }
  if (k == m - 1)
    for (uint32_t x = x0; x < x1; ++x) base[x] = st[x + from];
  if (k == 0)
    for (uint32_t x = x4; x < x5; ++x) base[x] = st[x + from];
}

// A run of u8 units to the output as whole aligned words: the run is
// out[x0 .. x0 + len), its first unit staged at st + a kUnit and the rest
// after it; this lane is its k-th of m.
template <int kUnit>
__device__ __forceinline__ void store_units(uint8_t* out, const uint8_t* st,
                                            int x0, int len, int a, int k,
                                            int m) {
  const uint32_t mis = static_cast<uint32_t>(
      reinterpret_cast<uintptr_t>(out + x0) & 15u);
  store_run(out + x0 - mis, st, mis, mis + len, a * kUnit - mis, k, m);
}

// The f32 form, a lane at a time: its unit of kUnit floats u, the first n
// at p, as 4-byte words up to p's first 16-byte boundary, then 16-byte and
// 4-byte words; each word is the lane's own (f32 elements fill whole
// words), so no stage. kHead: the floats before that boundary.
template <int kUnit, int kHead>
__device__ __forceinline__ void store_unit_from(float* p,
                                                const float (&u)[kUnit]) {
  constexpr int kVec = (kUnit - kHead) / 4;
#pragma unroll
  for (int e = 0; e < kHead; ++e) __stcs(p + e, u[e]);
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const int e = kHead + 4 * q;
    __stcs(reinterpret_cast<float4*>(p + e),
           make_float4(u[e], u[e + 1], u[e + 2], u[e + 3]));
  }
#pragma unroll
  for (int e = kHead + 4 * kVec; e < kUnit; ++e) __stcs(p + e, u[e]);
}

template <int kUnit>
__device__ __forceinline__ void store_unit(float* p, const float (&u)[kUnit],
                                           int n) {
  if (n == kUnit) {
    switch ((reinterpret_cast<uintptr_t>(p) >> 2) & 3) {
      case 0: return store_unit_from<kUnit, 0>(p, u);
      case 1: return store_unit_from<kUnit, 3>(p, u);
      case 2: return store_unit_from<kUnit, 2>(p, u);
      default: return store_unit_from<kUnit, 1>(p, u);
    }
  }
#pragma unroll
  for (int e = 0; e < kUnit; ++e)
    if (e < n) __stcs(p + e, u[e]);
}

// K8u's two-pass store: the warp's blocks of its pixel row staged (block
// g kG + l at st + l kC 8, kC channels interleaved), then stored as one
// run (u8: all 32 lanes, store_run) of `len` elements at frame + x0
// (len 0: the row is below the crop), or (f32) each lane its unit's
// words: (uo, un), its offset in a frame and its elements inside the crop.
template <int kC, typename Out>
__device__ __forceinline__ void store_row_crop(Out* frame,
                                               const float (&v)[kB], Out* st,
                                               const TailLane<kC>& t, int x0,
                                               int len, int uo, int un) {
  constexpr int kUnit = kC * kB;
  if (t.active) {
    if constexpr (std::is_same<Out, uint8_t>::value && kC == 1) {
      *reinterpret_cast<uint2*>(st + t.lane * kB) = make_uint2(
          pack4(sat_u8(v[0]), sat_u8(v[1]), sat_u8(v[2]), sat_u8(v[3])),
          pack4(sat_u8(v[4]), sat_u8(v[5]), sat_u8(v[6]), sat_u8(v[7])));
    } else {
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        if constexpr (std::is_same<Out, uint8_t>::value)
          st[t.bxl * kUnit + i * kC + t.ci] =
              static_cast<uint8_t>(sat_u8(v[i]));
        else
          st[t.bxl * kUnit + i * kC + t.ci] = v[i];
      }
    }
  }
  __syncwarp();
  if constexpr (std::is_same<Out, uint8_t>::value) {
    if (len) {
      const uint32_t mis = static_cast<uint32_t>(
          reinterpret_cast<uintptr_t>(frame + x0) & 15u);
      store_run(frame + x0 - mis, st, mis, mis + len, -mis, t.lane, 32);
    }
  } else if (un) {
    float u[kUnit];
#pragma unroll
    for (int e = 0; e < kUnit; ++e) u[e] = st[t.lane * kUnit + e];
    store_unit<kUnit>(frame + uo, u, un);
  }
  __syncwarp();
}

// K8's pass 2: K5's with each row loaded from the reconstruction. kCrop
// (K8u): only the pixels inside the h x w crop are stored, into frames of
// h x w pixels, each warp's row realigned to the output's words.
template <int kC, typename Out, bool kCrop>
__global__ void __launch_bounds__(kTailThreads)
    norm_paint_kernel(RecSrc s, const float4* __restrict__ prm,
                      Out* __restrict__ out, int frames, int chans, int hb,
                      int wb, int groups, int splits, int fper, int h,
                      int w) {
  __shared__ __align__(16) Out stage[kTailWarps][
      kCrop ? TailLane<kC>::kG * kC * kB : stage_elems<kC>()];
  const TailLane<kC> t(hb, wb, groups, splits, fper, frames);
  const int n_blk = hb * wb;
  const RecRows src(s, t, chans, n_blk);
  const int64_t frame_out =
      kCrop ? static_cast<int64_t>(h) * w * chans
            : static_cast<int64_t>(n_blk) * kB * kB * chans;
  // crop: the warp's run (its pixel row's blocks g kG ..: their offset in
  // a frame and elements inside the crop), and lane l's unit in it (block
  // g kG + l)
  int x0 = 0, len = 0, uo = 0, un = 0;
  if constexpr (kCrop) {
    const int y = t.by * kB + t.r, bx0 = t.g * TailLane<kC>::kG;
    if (y < h) {
      x0 = kC == 1 ? (t.c * h + y) * w + bx0 * kB : (y * w + bx0 * kB) * kC;
      len = min(TailLane<kC>::kG * kB, w - bx0 * kB) * kC;
      un = t.lane < TailLane<kC>::kG
               ? max(0, min(len - t.lane * kC * kB, kC * kB))
               : 0;
      uo = x0 + t.lane * kC * kB;
    }
  }
  Out* o = out + t.fbeg * frame_out + (kCrop ? 0 : out_seg(t, n_blk, wb));
  const float4* pp = prm ? prm + static_cast<int64_t>(t.fbeg) * chans + t.c
                         : nullptr;
  const int live = min(TailLane<kC>::kG, wb - t.g * TailLane<kC>::kG) * kC;
  for (int f0 = t.fbeg; f0 < t.fend; f0 += kTailChunk) {
    const int nf = min(kTailChunk, t.fend - f0);
    float y[kTailChunk][kB];
    bool bad[kTailChunk];
    src.load<true>(f0, nf, t.active, y, bad);
#pragma unroll
    for (int fi = 0; fi < kTailChunk; ++fi) {
      if (fi >= nf) break;
      const float4 pr = pp ? *pp : make_float4(0.0f, 1.0f, 0.0f, 0.0f);
      if (pp) pp += chans;
      float v[kB];
      if (t.active) {
#pragma unroll
        for (int i = 0; i < kB; ++i)
          v[i] = __fmul_rn(__fsub_rn(bad[fi] ? pr.z : y[fi][i], pr.x), pr.y);
      }
      if constexpr (kCrop)
        store_row_crop<kC>(o, v, stage[t.r], t, x0, len, uo, un);
      else
        store_row<kC>(o, v, stage[t.r], t, live);
      o += frame_out;
    }
  }
}

// ---------------------------------------------------------------------------
// K8's resident instance: a persistent grid of one CTA an SM, launched
// cooperatively (every CTA co-resident, or the launch is refused). CTA b
// holds blocks [b N / ctas, (b + 1) N / ctas) of every plane of a frame in
// shared memory from their load to their paint, in chunks of `chunk`
// blocks, each on a ring slot of its own.
// ---------------------------------------------------------------------------

constexpr int kResThreads = 512;
constexpr int kResWarps = kResThreads / 32;
// floats a staged block row set: its 64 pixels and 4 of padding, so that
// the 8 lanes of a quarter-warp, on 8 neighbouring blocks, read 8 bank
// groups
constexpr int kResRow = kB * kB + 4;
constexpr int kResMaxSlots = 3;             // ring slots

// Bytes a ring slot takes: a chunk of `chunk` blocks (a multiple of 4) of
// each of a frame's `chans` planes, then their flags (a float each).
__host__ __device__ constexpr int64_t res_slot_bytes(int chans, int chunk) {
  return int64_t{4} * chans * chunk * (kResRow + 1);
}

// Bytes of a warp's stage for K8u's u8 rows: a pixel row of 32 blocks of
// each of a frame's planes.
constexpr int kResStage = 32 * kB;

// The instance's dynamic shared memory: a frame's planes' (lo, scale,
// fill) and their warps' windows, then the ring, then the warps' stages
// (which only a crop's paint uses; tail_cuda.resident_smem computes the
// same).
__host__ __device__ constexpr int64_t res_smem(int chans, int chunk,
                                               int slots) {
  return int64_t{16} * chans * (kResWarps + 1) +
         slots * res_slot_bytes(chans, chunk) +
         int64_t{kResWarps} * kResStage * chans;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Waits until at most n (0 .. kResMaxSlots - 1) of this thread's newest
// cp.async groups are still in flight (wait_group takes an immediate).
template <int N = 0>
__device__ __forceinline__ void cp_async_wait_newest(int n) {
  if constexpr (N < kResMaxSlots - 1) {
    if (n > N) return cp_async_wait_newest<N + 1>(n);
  }
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A bulk prefetch (the TMA unit's) of `bytes` at p into L2.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// n / d for 0 <= n < 2^31 by a multiply-high with m = ceil(2^32 / d) and
// one correction: the quotient it gives is exact or one too large (n m
// overshoots n 2^32 / d by less than n < 2^32). K8u's items divide by the
// block row and the chunk this way, not by a division each.
struct FastDiv {
  uint32_t d, m;
  __device__ explicit FastDiv(int d_)
      : d(d_), m(d_ > 1 ? 0xffffffffu / d_ + 1 : 0u) {}
  __device__ __forceinline__ int operator()(int n) const {
    if (d == 1) return n;
    const uint32_t q = __umulhi(static_cast<uint32_t>(n), m);
    return static_cast<int>(q - (q * d > static_cast<uint32_t>(n)));
  }
};

__device__ __forceinline__ float4 window_merge(float4 v, float4 u) {
  return make_float4(min_nan(v.x, u.x), max_nan(v.y, u.y), min_nan(v.z, u.z),
                     max_nan(v.w, u.w));
}

struct ResArgs {
  RecSrc s;
  void* out;
  uint32_t* slots;     // the window slots (with normalize)
  unsigned* bar;       // frame f's grid barrier: bar[f] (with normalize)
  int frames, n_blk, wb, ring, chunk, normalize;
  int h, w;            // the output's pixels (kCrop: a crop of the blocks)
};

// Paints the 8 pixels at y with a plane's (lo, scale, fill): the twin's
// (y or fill - lo) * scale, each step rounded once.
__device__ __forceinline__ void paint_row(const float* y, bool bad,
                                          float4 pr, float (&v)[kB]) {
  const float4 a = reinterpret_cast<const float4*>(y)[0];
  const float4 b = reinterpret_cast<const float4*>(y)[1];
  const float u[kB] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < kB; ++i)
    v[i] = __fmul_rn(__fsub_rn(bad ? pr.z : u[i], pr.x), pr.y);
}

// Stores a pixel row of one plane: 8 values as one 8-byte (u8) or two
// 16-byte (f32) streaming stores.
template <typename Out>
__device__ __forceinline__ void store_plane_row(Out* o, const float (&v)[kB]) {
  if constexpr (std::is_same<Out, uint8_t>::value) {
    __stcs(reinterpret_cast<uint2*>(o),
           make_uint2(pack4(sat_u8(v[0]), sat_u8(v[1]), sat_u8(v[2]),
                            sat_u8(v[3])),
                      pack4(sat_u8(v[4]), sat_u8(v[5]), sat_u8(v[6]),
                            sat_u8(v[7]))));
  } else {
    float4* q = reinterpret_cast<float4*>(o);
    __stcs(q, make_float4(v[0], v[1], v[2], v[3]));
    __stcs(q + 1, make_float4(v[4], v[5], v[6], v[7]));
  }
}

// Stores a channels-last pixel row of 3 planes: 24 elements interleaved
// (8-byte aligned for u8, 16 for f32), as three 8-byte or six 16-byte
// streaming stores.
template <typename Out>
__device__ __forceinline__ void store_pixel_row3(Out* o,
                                                 const float (&v)[3][kB]) {
  if constexpr (std::is_same<Out, uint8_t>::value) {
    uint32_t wd[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      uint32_t e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = sat_u8(v[(4 * q + j) % 3][(4 * q + j) / 3]);
      wd[q] = pack4(e[0], e[1], e[2], e[3]);
    }
    uint2* q = reinterpret_cast<uint2*>(o);
    __stcs(q, make_uint2(wd[0], wd[1]));
    __stcs(q + 1, make_uint2(wd[2], wd[3]));
    __stcs(q + 2, make_uint2(wd[4], wd[5]));
  } else {
    float4* q = reinterpret_cast<float4*>(o);
#pragma unroll
    for (int j = 0; j < 6; ++j)
      __stcs(q + j, make_float4(v[(4 * j) % 3][(4 * j) / 3],
                                v[(4 * j + 1) % 3][(4 * j + 1) / 3],
                                v[(4 * j + 2) % 3][(4 * j + 2) / 3],
                                v[(4 * j + 3) % 3][(4 * j + 3) / 3]));
  }
}

// The resident instance: kC planes a frame (1, or 3 as channels-last
// frames with kFrames3, else as planes). The CTA's share of a frame is J
// chunks; chunk s = f J + j sits in ring slot s % ring, loaded by 16-byte
// cp.async copies (its flags by 4-byte ones) as soon as the slot is free.
// A frame: fold the window of each plane chunk by chunk as the chunks land
// (the warps split among the planes, a lane its items: block, pixel row;
// shuffles, then a warp's window in shared memory), one atomic a slot and
// plane, arrive at the frame's grid barrier; wait for it; each plane's
// (lo, scale, fill) from its slots; paint chunk by chunk, each freed slot
// loading the chunk `ring` ahead. Where the ring holds two frames, frame
// f + 1 is folded and arrives before frame f's wait, so the barrier's
// latency hides behind a fold; where it holds one (a color 1080p frame),
// frame f + 1 is prefetched into L2 (TMA bulk prefetches) once frame f
// has landed, so device memory streams through the fold, the barrier and
// the paint. kCrop (K8u): the blocks pad an h x w crop; a pixel outside
// it enters no window and is not stored, and each pixel row a warp paints
// is realigned to the output's words (store_units, store_unit).
template <int kC, bool kFrames3, typename Out, bool kCrop>
__global__ void __launch_bounds__(kResThreads, 1)
    norm_resident_kernel(ResArgs a) {
  extern __shared__ __align__(16) unsigned char res_smem_[];
  const int S = a.ring, CB = a.chunk;
  float4* prm = reinterpret_cast<float4*>(res_smem_);
  float4* red = prm + kC;
  unsigned char* ring = reinterpret_cast<unsigned char*>(red + kC * kResWarps);
  const int64_t slot_bytes = res_slot_bytes(kC, CB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned ctas = gridDim.x;
  const int b0 = static_cast<int>(int64_t{blockIdx.x} * a.n_blk / ctas);
  const int share =
      static_cast<int>(int64_t{blockIdx.x + 1} * a.n_blk / ctas) - b0;
  const int cap = static_cast<int>((a.n_blk + ctas - 1) / ctas);
  const int J = (cap + CB - 1) / CB;                  // chunks a frame
  const int T = a.frames * J;                         // chunks
  const bool flagged = a.s.x != nullptr;
  const bool ahead = S >= 2 * J;
  const float inf = __int_as_float(0x7f800000);
  const int w = a.wb * kB;
  const int64_t plane_px = int64_t{a.n_blk} * kB * kB;
  const FastDiv wb_div(a.wb);              // (kCrop) a block's row

  // chunk s: its slot's rows and flags (plane c, block i of the chunk),
  // its blocks
  auto row = [&](int s, int c, int i) {
    return reinterpret_cast<float*>(ring + (s % S) * slot_bytes) +
           (c * CB + i) * kResRow;
  };
  auto flag = [&](int s, int c, int i) {
    return reinterpret_cast<float*>(ring + (s % S) * slot_bytes) +
           kC * CB * kResRow + c * CB + i;
  };
  auto blocks_of = [&](int j) {
    return max(0, min(CB, share - j * CB));
  };

  // chunk s's copies into its slot, 16 bytes (a flag: 4) a cp.async,
  // every thread taking a share, then this thread's group (empty past the
  // last chunk): with `issued` groups so far, chunk s has landed once the
  // issued - 1 - s newest are all that may still be in flight
  int issued = 0;
  auto issue = [&](int s) {
    if (s < T) {
      const int f = s / J, j = s - f * J, nb = blocks_of(j);
      for (int p = tid; p < kC * nb * 16; p += kResThreads) {
        const int q = p & 15, ci = p >> 4, c = ci / nb, i = ci - c * nb;
        const int n = b0 + j * CB + i;
        cp_async16(row(s, c, i) + 4 * q,
                   a.s.rec + (int64_t{c} * a.n_blk + n) * a.s.bstride +
                       int64_t{f} * a.s.fstride + 4 * q);
      }
      if (flagged)
        for (int p = tid; p < kC * nb; p += kResThreads) {
          const int c = p / nb, i = p - c * nb;
          cp_async4(flag(s, c, i),
                    a.s.x + ((int64_t{f} * kC + c) * a.n_blk + b0 + j * CB +
                             i) * a.s.xrow +
                        a.s.xflag);
        }
    }
    cp_async_commit();
    ++issued;
  };
  auto landed = [&](int s) {
    cp_async_wait_newest(issued - 1 - s);
    __syncthreads();
  };

  auto prefetch = [&](int f) {
    if (f >= a.frames) return;
    for (int p = tid; p < kC * share; p += kResThreads) {
      const int c = p / share, i = p - c * share;
      prefetch_l2(a.s.rec + (int64_t{c} * a.n_blk + b0 + i) * a.s.bstride +
                      int64_t{f} * a.s.fstride,
                  kB * kB * 4);
    }
  };

  // frame f's window: each plane's over the CTA's blocks into its slots,
  // then the arrival at bar[f]
  auto fold = [&](int f) {
    if (lane == 0)
      for (int c = 0; c < kC; ++c)
        red[c * kResWarps + warp] = make_float4(inf, -inf, inf, -inf);
    // the warps split among the planes, kResWarps / kC a plane
    constexpr int wpp = kResWarps / kC;
    const int c = warp / wpp;
    for (int j = 0; j < J; ++j) {
      const int s = f * J + j, nb = blocks_of(j);
      landed(s);
      if (j == J - 1 && S < 2 * J) prefetch(f + 1);
      if (c >= kC) continue;
      float4 v = make_float4(inf, -inf, inf, -inf);
      if constexpr (kCrop) {
        const FastDiv per_row(nb);
        for (int it = (warp % wpp) * 32 + lane; it < nb * kB;
             it += wpp * 32) {
          const int rr = per_row(it), i = it - rr * nb;
          const int n = b0 + j * CB + i, by = wb_div(n), bx = n - by * a.wb;
          const float4* y4 =
              reinterpret_cast<const float4*>(row(s, c, i) + rr * kB);
          const float4 p0 = y4[0], p1 = y4[1];
          const float y[kB] = {p0.x, p0.y, p0.z, p0.w,
                               p1.x, p1.y, p1.z, p1.w};
          const bool bad = flagged && *flag(s, c, i) > 0.5f;
          const int cols =
              by * kB + rr < a.h ? min(kB, a.w - bx * kB) : 0;
          // a row wholly inside the crop (all but the crop's edge) takes
          // the aligned fold
          v = window_merge(v, cols == kB ? row_window(y, bad)
                                         : row_window_crop(y, bad, cols));
        }
      } else {
        for (int it = (warp % wpp) * 32 + lane; it < nb * kB;
             it += wpp * 32) {
          const int rr = it / nb, i = it - rr * nb;
          const float4* y4 =
              reinterpret_cast<const float4*>(row(s, c, i) + rr * kB);
          const float4 p0 = y4[0], p1 = y4[1];
          const float y[kB] = {p0.x, p0.y, p0.z, p0.w,
                               p1.x, p1.y, p1.z, p1.w};
          v = window_merge(v,
                           row_window(y, flagged && *flag(s, c, i) > 0.5f));
        }
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        v = window_merge(v, make_float4(__shfl_xor_sync(~0u, v.x, o),
                                        __shfl_xor_sync(~0u, v.y, o),
                                        __shfl_xor_sync(~0u, v.z, o),
                                        __shfl_xor_sync(~0u, v.w, o)));
      if (lane == 0)
        red[c * kResWarps + warp] = window_merge(red[c * kResWarps + warp], v);
    }
    __syncthreads();
    if (tid < kC) {
      float4 v = red[tid * kResWarps];
      for (int o = 1; o < kResWarps; ++o)
        v = window_merge(v, red[tid * kResWarps + o]);
      const int64_t p = int64_t{f} * kC + tid;
      if (flagged) {
        atomicMin(win_slot(a.slots, p, 0), key_lo(v.z));
        atomicMax(win_slot(a.slots, p, 1), key_hi(v.w));
      }
      atomicMin(win_slot(a.slots, p, 2), key_lo(v.x));
      atomicMax(win_slot(a.slots, p, 3), key_hi(v.y));
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicAdd(&a.bar[f], 1u);
    }
  };

  // frame f's grid barrier, then its planes' params
  auto settle = [&](int f) {
    if (tid == 0) {
      unsigned seen;
      do {
        asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
                     : "=r"(seen)
                     : "l"(&a.bar[f])
                     : "memory");
      } while (seen < ctas);
      __threadfence();
    }
    __syncthreads();
    if (tid < kC)
      prm[tid] = plane_params(a.slots, int64_t{f} * kC + tid, flagged);
    __syncthreads();
  };

  // K8u's paint of chunk s (frame f, its chunk j of nb blocks): the items
  // as the aligned paint takes them, a warp's 32 at a time, so that the
  // warp stores each pixel row's run whole (u8 through its stage)
  auto paint_crop = [&](int f, int s, int j, int nb) {
    constexpr int kU = kFrames3 ? 3 : 1;       // channels a unit interleaves
    Out* out = static_cast<Out*>(a.out);
    const int64_t plane = int64_t{a.h} * a.w;
    uint8_t* st = ring + S * slot_bytes + warp * (kC * kResStage);
    const FastDiv per_row(nb);
    for (int it0 = warp * 32; it0 < nb * kB; it0 += kResThreads) {
      const int it = it0 + lane;
      // the lane's unit, cnt elements at o in a frame, is the k-th of the
      // m units of a run at x0 in a frame, len elements: lanes whose items
      // are neighbouring blocks of one block row and pixel row (only a
      // block row's last block is cut short), first unit lane - k's
      int o = 0, cnt = 0, x0 = 0, len = 0, k = 0, m = 0;
      float v[kC][kB];
      if (it < nb * kB) {
        const int rr = per_row(it), i = it - rr * nb;
        const int n = b0 + j * CB + i, by = wb_div(n), bx = n - by * a.wb;
        const int y = by * kB + rr;
        if (y < a.h) {
          cnt = min(kB, a.w - bx * kB) * kU;
          o = (y * a.w + bx * kB) * kU;
          k = min(lane, min(i, bx));
          const int ahead = min(31 - lane, min(nb - 1 - i, a.wb - 1 - bx));
          m = k + ahead + 1;
          x0 = o - k * kB * kU;
          len = (m - 1) * kB * kU + min(kB, a.w - (bx + ahead) * kB) * kU;
#pragma unroll
          for (int c = 0; c < kC; ++c)
            paint_row(row(s, c, i) + rr * kB,
                      flagged && *flag(s, c, i) > 0.5f,
                      a.normalize ? prm[c]
                                  : make_float4(0.0f, 1.0f, 0.0f, 0.0f),
                      v[c]);
        }
      }
      if constexpr (std::is_same<Out, uint8_t>::value) {
        if (cnt) {                             // whole words into the stage
          if constexpr (kFrames3) {
            uint32_t wd[6];
#pragma unroll
            for (int q = 0; q < 6; ++q) {
              uint32_t e[4];
#pragma unroll
              for (int k = 0; k < 4; ++k)
                e[k] = sat_u8(v[(4 * q + k) % 3][(4 * q + k) / 3]);
              wd[q] = pack4(e[0], e[1], e[2], e[3]);
            }
            uint2* q2 = reinterpret_cast<uint2*>(st + lane * 3 * kB);
            q2[0] = make_uint2(wd[0], wd[1]);
            q2[1] = make_uint2(wd[2], wd[3]);
            q2[2] = make_uint2(wd[4], wd[5]);
          } else {
#pragma unroll
            for (int c = 0; c < kC; ++c)
              *reinterpret_cast<uint2*>(st + c * kResStage + lane * kB) =
                  make_uint2(pack4(sat_u8(v[c][0]), sat_u8(v[c][1]),
                                   sat_u8(v[c][2]), sat_u8(v[c][3])),
                             pack4(sat_u8(v[c][4]), sat_u8(v[c][5]),
                                   sat_u8(v[c][6]), sat_u8(v[c][7])));
          }
        }
        __syncwarp();
        if (cnt) {
          if constexpr (kFrames3) {
            store_units<3 * kB>(out + f * plane * 3, st, x0, len, lane - k,
                                k, m);
          } else {
#pragma unroll
            for (int c = 0; c < kC; ++c)
              store_units<kB>(out + (int64_t{f} * kC + c) * plane,
                              st + c * kResStage, x0, len, lane - k, k, m);
          }
        }
        __syncwarp();                          // the stage is free
      } else if (cnt) {
        if constexpr (kFrames3) {
          float u[3 * kB];
#pragma unroll
          for (int e = 0; e < 3 * kB; ++e) u[e] = v[e % 3][e / 3];
          store_unit<3 * kB>(out + f * plane * 3 + o, u, cnt);
        } else {
#pragma unroll
          for (int c = 0; c < kC; ++c)
            store_unit<kB>(out + (int64_t{f} * kC + c) * plane + o, v[c],
                           cnt);
        }
      }
    }
  };

  // the paint of chunk s (frame f, its chunk j of nb blocks): a thread an
  // item at a time
  auto paint_aligned = [&](int f, int s, int j, int nb) {
    Out* out = static_cast<Out*>(a.out);
    for (int it = tid; it < nb * kB; it += kResThreads) {
      const int rr = it / nb, i = it - rr * nb;
      const int n = b0 + j * CB + i, by = n / a.wb,
                bx = n - by * a.wb;
      const int px = (by * kB + rr) * w + bx * kB;
      float v[kC][kB];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        paint_row(row(s, c, i) + rr * kB,
                  flagged && *flag(s, c, i) > 0.5f,
                  a.normalize ? prm[c]
                              : make_float4(0.0f, 1.0f, 0.0f, 0.0f),
                  v[c]);
      if constexpr (kFrames3) {
        store_pixel_row3(out + (int64_t{f} * plane_px + px) * 3, v);
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c)
          store_plane_row(out + (int64_t{f} * kC + c) * plane_px + px,
                          v[c]);
      }
    }
  };

  auto paint = [&](int f) {
    for (int j = 0; j < J; ++j) {
      const int s = f * J + j, nb = blocks_of(j);
      if (!a.normalize) landed(s);
      if constexpr (kCrop)
        paint_crop(f, s, j, nb);
      else
        paint_aligned(f, s, j, nb);
      __syncthreads();               // slot s is free
      issue(s + S);
    }
  };

  for (int s = 0; s < S; ++s) issue(s);
  if (a.normalize && ahead) fold(0);
  for (int f = 0; f < a.frames; ++f) {
    if (a.normalize) {
      if (!ahead) {
        fold(f);
      } else if (f + 1 < a.frames) {
        fold(f + 1);
      }
      settle(f);
    } else if (S < 2 * J) {
      prefetch(f + 1);
    }
    paint(f);
  }
}

// Calls f(std::integral_constant<int, k>) for k in 1..8; false otherwise.
template <typename F>
bool tail_with_k(int k, F&& f) {
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

struct TailArgs {
  void* out;
  bool out_u8;
  uint32_t* win;
  int frames, chans, hb, wb, groups, flagged, normalize;
  int h, w;            // the output's pixels: the blocks' hb x wb, or less
  bool crop;           // (K8u) where h or w is not a multiple of 8
  unsigned tiles;
  cudaStream_t st;
};

// CTAs of one kernel an SM holds (queried once an instance).
template <typename Kern>
int ctas_per_sm(Kern kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kTailThreads,
                                                    0) != cudaSuccess ||
      n < 1)
    n = 1;
  return n;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n < 1)
      n = 1;
  }
  return n;
}

// Frames a CTA walks: the fewest that give the grid kWaves waves of `per_sm`
// CTAs an SM (all of them where the tiles alone fill that many).
inline int frames_per_cta(const TailArgs& a, int per_sm) {
  const int64_t want = static_cast<int64_t>(kWaves) * sm_count() * per_sm;
  int64_t splits = (want + a.tiles - 1) / a.tiles;
  if (splits > a.frames) splits = a.frames;
  if (splits < 1) splits = 1;
  return static_cast<int>((a.frames + splits - 1) / splits);
}

// The two passes: the init, window and params kernels (with normalize),
// then the paint kernel. per_sm: the paint kernel's CTAs an SM;
// window(grid, splits, fper, slots) and paint(grid, splits, fper, prm)
// launch the source's instances and return their launch error.
template <class Window, class Paint>
cudaError_t launch_tail(const TailArgs& a, int per_sm, Window&& window,
                        Paint&& paint) {
  const int fper = frames_per_cta(a, per_sm);
  const int splits = (a.frames + fper - 1) / fper;
  const unsigned grid = a.tiles * static_cast<unsigned>(splits);
  const float4* prm = nullptr;
  if (a.normalize) {
    // win: the planes' (lo, scale, fill, 0), then their window slots
    const int planes = a.frames * a.chans;
    float4* params = reinterpret_cast<float4*>(a.win);
    uint32_t* slots = a.win + static_cast<int64_t>(planes) * 4;
    tail_init_kernel<<<(planes * 4 + 255) / 256, 256, 0, a.st>>>(
        slots, planes * 4, nullptr, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = window(grid, splits, fper, slots);
    if (err != cudaSuccess) return err;
    tail_params_kernel<<<(planes + 255) / 256, 256, 0, a.st>>>(
        slots, params, planes, a.flagged);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    prm = params;
  }
  return paint(grid, splits, fper, prm);
}

// K5: the two passes rebuilding each row from the estimates x and the
// basis eb.
template <int K, int kC>
cudaError_t launch_rebuild(const TailArgs& a, const float* x, const float* eb,
                           int64_t bstride) {
  static const int per_sm = ctas_per_sm(tail_paint_kernel<K, kC, uint8_t>);
  auto window = [&](unsigned grid, int splits, int fper, uint32_t* slots) {
    constexpr int smem = window_smem<K>();
    cudaError_t err = cudaFuncSetAttribute(
        tail_window_kernel<K, kC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    tail_window_kernel<K, kC><<<grid, kTailThreads, smem, a.st>>>(
        x, eb, bstride, slots, a.frames, a.chans, a.hb, a.wb, a.groups,
        splits, fper, a.flagged);
    return cudaGetLastError();
  };
  auto paint = [&](unsigned grid, int splits, int fper, const float4* prm) {
    if (a.out_u8)
      tail_paint_kernel<K, kC, uint8_t><<<grid, kTailThreads, 0, a.st>>>(
          x, eb, bstride, prm, static_cast<uint8_t*>(a.out), a.frames,
          a.chans, a.hb, a.wb, a.groups, splits, fper, a.flagged);
    else
      tail_paint_kernel<K, kC, float><<<grid, kTailThreads, 0, a.st>>>(
          x, eb, bstride, prm, static_cast<float*>(a.out), a.frames,
          a.chans, a.hb, a.wb, a.groups, splits, fper, a.flagged);
    return cudaGetLastError();
  };
  return launch_tail(a, per_sm, window, paint);
}

// K8: the two passes reading each row from the reconstruction; kCrop:
// K8u's instance, for an output cropped to h x w.
template <int kC, bool kCrop>
cudaError_t launch_rec(const TailArgs& a, const RecSrc& s) {
  static const int per_sm =
      ctas_per_sm(norm_paint_kernel<kC, uint8_t, kCrop>);
  auto window = [&](unsigned grid, int splits, int fper, uint32_t* slots) {
    norm_window_kernel<kC, kCrop><<<grid, kTailThreads, 0, a.st>>>(
        s, slots, a.frames, a.chans, a.hb, a.wb, a.groups, splits, fper,
        a.h, a.w);
    return cudaGetLastError();
  };
  auto paint = [&](unsigned grid, int splits, int fper, const float4* prm) {
    if (a.out_u8)
      norm_paint_kernel<kC, uint8_t, kCrop><<<grid, kTailThreads, 0, a.st>>>(
          s, prm, static_cast<uint8_t*>(a.out), a.frames, a.chans, a.hb,
          a.wb, a.groups, splits, fper, a.h, a.w);
    else
      norm_paint_kernel<kC, float, kCrop><<<grid, kTailThreads, 0, a.st>>>(
          s, prm, static_cast<float*>(a.out), a.frames, a.chans, a.hb, a.wb,
          a.groups, splits, fper, a.h, a.w);
    return cudaGetLastError();
  };
  return launch_tail(a, per_sm, window, paint);
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess)
    return 0;
  return v;
}

template <int kC, bool kFrames3, typename Out, bool kCrop>
cudaError_t launch_resident_as(const ResArgs& ra, int ctas, int smem,
                               cudaStream_t st) {
  auto kern = norm_resident_kernel<kC, kFrames3, Out, kCrop>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ResArgs arg = ra;
  void* args[] = {&arg};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                     dim3(ctas), dim3(kResThreads), args,
                                     smem, st);
}

template <int kC, bool kFrames3, bool kCrop>
cudaError_t launch_resident_out(const ResArgs& ra, bool out_u8, int ctas,
                                int smem, cudaStream_t st) {
  return out_u8 ? launch_resident_as<kC, kFrames3, uint8_t, kCrop>(
                      ra, ctas, smem, st)
                : launch_resident_as<kC, kFrames3, float, kCrop>(ra, ctas,
                                                                 smem, st);
}

// The instance of a's layout (kc: channels on a frame's lanes).
template <bool kCrop>
cudaError_t launch_resident_of(const TailArgs& a, const ResArgs& ra, int kc,
                               int ctas, int smem) {
  return a.chans == 1 ? launch_resident_out<1, false, kCrop>(
                            ra, a.out_u8, ctas, smem, a.st)
         : kc == 3    ? launch_resident_out<3, true, kCrop>(
                            ra, a.out_u8, ctas, smem, a.st)
                      : launch_resident_out<3, false, kCrop>(
                            ra, a.out_u8, ctas, smem, a.st);
}

// K8's resident instance (K8u's where a.crop): the init kernel (with
// normalize), then the cooperative launch of `ctas` CTAs, a ring of `ring`
// slots of `chunk` blocks. cudaErrorInvalidValue for a plan
// outside the instance's bounds (planes a frame other than 1 or 3, a
// chunk not a multiple of 4, fewer slots than a frame's chunks, shared
// memory above the device's limit a CTA); the
// launch's error (cudaErrorCooperativeLaunchTooLarge where the CTAs
// cannot all be resident) is cleared from the runtime's last error and
// returned.
cudaError_t launch_resident(const TailArgs& a, const RecSrc& s, int kc,
                            int ctas, int ring, int chunk) {
  const int n_blk = a.hb * a.wb;
  if (ctas < 1 || ring > kResMaxSlots || chunk < 4 ||
      chunk % 4 || (a.chans != 1 && a.chans != 3))
    return cudaErrorInvalidValue;
  const int cap = (n_blk + ctas - 1) / ctas;
  const int64_t smem = res_smem(a.chans, chunk, ring);
  if (ring < (cap + chunk - 1) / chunk ||
      smem > device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin) ||
      !device_attr(cudaDevAttrCooperativeLaunch))
    return cudaErrorInvalidValue;
  ResArgs ra{s,    a.out, nullptr, nullptr,     a.frames, n_blk,
             a.wb, ring,  chunk,   a.normalize, a.h,      a.w};
  if (a.normalize) {
    // win: the frames' barriers where the two-pass instance keeps the
    // planes' params, then the planes' window slots
    const int planes = a.frames * a.chans;
    ra.bar = a.win;
    ra.slots = a.win + static_cast<int64_t>(planes) * 4;
    tail_init_kernel<<<(planes * 4 + 255) / 256, 256, 0, a.st>>>(
        ra.slots, planes * 4, ra.bar, a.frames);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int bytes = static_cast<int>(smem);
  const cudaError_t err =
      a.crop ? launch_resident_of<true>(a, ra, kc, ctas, bytes)
             : launch_resident_of<false>(a, ra, kc, ctas, bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// The checks and the grid both entry points share: fills a's geometry and
// returns cudaErrorInvalidValue for a shape or scratch outside the
// kernels' bounds, else cudaSuccess (kc: channels on a frame's lanes;
// crop_ok: h and w may be cut short of the blocks, K8u's crop).
inline cudaError_t tail_geometry(TailArgs& a, void* out, int out_is_u8,
                                 void* win, int frames, int chans, int kc,
                                 int h, int w, int normalize, void* stream,
                                 bool crop_ok) {
  const bool crop = h % kB != 0 || w % kB != 0;
  if ((crop && !crop_ok) || h <= 0 || w <= 0 || frames < 0 || chans < 1 ||
      (kc != 1 && kc != 3) || h > (1 << 30) || w > (1 << 30) ||
      static_cast<int64_t>((h + kB - 1) / kB * kB) * ((w + kB - 1) / kB * kB) *
              chans >=
          (int64_t{1} << 31) ||
      reinterpret_cast<uintptr_t>(win) % 16 ||
      static_cast<int64_t>(frames) * chans * 4 * kWinStride >=
          (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  const int hb = (h + kB - 1) / kB, wb = (w + kB - 1) / kB;
  const int kg = 32 / kc;
  const int groups = (wb + kg - 1) / kg;
  const int64_t tiles = static_cast<int64_t>(chans / kc) * hb * groups;
  if (tiles * frames >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  a.out = out;
  a.out_u8 = out_is_u8 != 0;
  a.win = static_cast<uint32_t*>(win);
  a.frames = frames;
  a.chans = chans;
  a.hb = hb;
  a.wb = wb;
  a.groups = groups;
  a.normalize = normalize != 0;
  a.h = h;
  a.w = w;
  a.crop = crop;
  a.tiles = static_cast<unsigned>(tiles);
  a.st = static_cast<cudaStream_t>(stream);
  return cudaSuccess;
}

}  // namespace
}  // namespace dctsvd

// s_cw, sc: f32 [planes, n, 8] contiguous, 16-byte aligned (slot order);
// inv_blk: int64 [n]; alpha: f32, plane p's at alpha[p * alpha_step]
// (alpha_step 0 or 1); with shrink: sw f32 [chans, n, 8] (16-byte
// aligned), scale f32 [chans], engage u8 [planes] (plane p's channel is
// p % chans); out: f32 [planes, n, round_up(k + 1, 4)], 16-byte aligned.
// Launches K5f on `stream`; returns its launch error, or
// cudaErrorInvalidValue, launching nothing, for an input outside these
// bounds.
extern "C" int dctsvd_tail_front(const void* s_cw, const void* sc,
                                 const void* inv_blk, const void* alpha,
                                 int alpha_step, const void* sw,
                                 const void* scale, const void* engage,
                                 void* out, int planes, int chans, int n,
                                 int k, int shrink, void* stream) {
  using namespace dctsvd;
  auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (planes < 0 || n < 0 || chans < 1 || (alpha_step != 0 &&
                                           alpha_step != 1) ||
      misaligned(s_cw) || misaligned(sc) || misaligned(out) ||
      (shrink && (misaligned(sw) || planes % chans != 0)) ||
      static_cast<int64_t>(n) * kB >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (planes == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kFrontThreads - 1) / kFrontThreads,
                  planes < kMaxGridY ? planes : kMaxGridY);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const bool ok = tail_with_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    auto kernel = shrink ? tail_front_kernel<K, true>
                         : tail_front_kernel<K, false>;
    kernel<<<grid, kFrontThreads, 0, st>>>(
        static_cast<const float*>(s_cw), static_cast<const float*>(sc),
        static_cast<const int64_t*>(inv_blk),
        static_cast<const float*>(alpha), alpha_step,
        static_cast<const float*>(sw), static_cast<const float*>(scale),
        static_cast<const uint8_t*>(engage), static_cast<float*>(out),
        planes, chans, n);
    err = cudaGetLastError();
  });
  return static_cast<int>(ok ? err : cudaErrorInvalidValue);
}

// x: f32 [frames, chans, N, round_up(k + 1, 4)] contiguous, 16-byte
// aligned: the k estimates, and in column k the erasure flag when
// kx == k + 1 (kx == k: no flags); eb: f32 basis rows, block (c, n) at
// eb + (c * N + n) * bstride, its k rows of 64 pixels 64 floats apart
// (16-byte aligned, bstride a multiple of 4); out: u8 or f32, channels-last
// frames [frames, h, w, chans] (frames_layout, chans 1 or 3) or planes
// [frames, chans, h, w]; win: u32 scratch of frames * chans * (4 + 4 *
// kWinStride) words, 16-byte aligned, used only with normalize. Launches
// K5's init, window and params kernels (with normalize) and its paint
// kernel on `stream`; returns the first launch's error, or
// cudaErrorInvalidValue, launching nothing, for an input outside these
// bounds or a frame of 2^31 elements or more.
extern "C" int dctsvd_extract_tail(const void* x, int kx, const void* eb,
                                   long long bstride, void* out,
                                   int out_is_u8, void* win, int frames,
                                   int chans, int frames_layout, int h,
                                   int w, int k, int normalize,
                                   void* stream) {
  using namespace dctsvd;
  const int kc = frames_layout ? chans : 1;
  TailArgs a{};
  if ((kx != k && kx != k + 1) || bstride % 4 ||
      reinterpret_cast<uintptr_t>(eb) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      tail_geometry(a, out, out_is_u8, win, frames, chans, kc, h, w,
                    normalize, stream, false) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  a.flagged = kx == k + 1;
  const float* xf = static_cast<const float*>(x);
  const float* ebf = static_cast<const float*>(eb);
  cudaError_t err = cudaErrorInvalidValue;
  const bool ok = tail_with_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    err = kc == 1 ? launch_rebuild<K, 1>(a, xf, ebf, bstride)
                  : launch_rebuild<K, 3>(a, xf, ebf, bstride);
  });
  return static_cast<int>(ok ? err : cudaErrorInvalidValue);
}

// rec: the f32 reconstruction, the 64 pixels of block (c, n) of frame f
// (row-major 8 x 8, contiguous) at rec + (c * N + n) * bstride + f *
// fstride, 16-byte aligned (bstride and fstride multiples of 4); x: null
// (no flags) or f32 rows, the erasure flag of block (f, c, n) at
// x[((f * chans + c) * N + n) * xrow + xflag] (flagged when > 0.5); out,
// win and the rest as dctsvd_extract_tail's, but for h and w: the blocks
// are ceil(h / 8) x ceil(w / 8), and where h or w is not a multiple of 8
// the output is cropped to h x w (K8u: either instance's kCrop kernels).
// ctas 0: launches the two-pass
// instance (the init, window and params kernels with normalize, then the
// paint kernel); ctas > 0: the resident instance (the init kernel with
// normalize, then ctas co-resident CTAs cooperatively, a ring of `ring`
// slots of `chunk` blocks; tail_cuda.norm_plan
// picks them), all on `stream`. Returns the first launch's error, or
// cudaErrorInvalidValue, launching nothing, for an input or plan outside
// these bounds.
extern "C" int dctsvd_normalize_blocks(const void* rec, long long bstride,
                                       long long fstride, const void* x,
                                       long long xrow, int xflag, void* out,
                                       int out_is_u8, void* win, int frames,
                                       int chans, int frames_layout, int h,
                                       int w, int normalize, int ctas,
                                       int ring, int chunk, void* stream) {
  using namespace dctsvd;
  const int kc = frames_layout ? chans : 1;
  TailArgs a{};
  if (bstride < 0 || fstride < 0 || bstride % 4 || fstride % 4 ||
      reinterpret_cast<uintptr_t>(rec) % 16 ||
      (x && (reinterpret_cast<uintptr_t>(x) % 4 || xflag < 0 ||
             xrow <= xflag)) ||
      tail_geometry(a, out, out_is_u8, win, frames, chans, kc, h, w,
                    normalize, stream, true) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const RecSrc src{static_cast<const float*>(rec),
                   static_cast<const float*>(x), bstride, fstride,
                   x ? xrow : 0, xflag};
  a.flagged = x != nullptr;
  if (ctas > 0)
    return static_cast<int>(
        launch_resident(a, src, kc, ctas, ring, chunk));
  if (a.crop)
    return static_cast<int>(kc == 1 ? launch_rec<1, true>(a, src)
                                    : launch_rec<3, true>(a, src));
  return static_cast<int>(kc == 1 ? launch_rec<1, false>(a, src)
                                  : launch_rec<3, false>(a, src));
}

// out: int[3], the device's SMs, the shared memory a CTA may opt into
// (bytes) and whether it takes cooperative launches (K8's plan reads
// them). Returns the first query's error.
extern "C" int dctsvd_device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[3] = {cudaDevAttrMultiProcessorCount,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   cudaDevAttrCooperativeLaunch};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    err = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
  return static_cast<int>(err);
}
