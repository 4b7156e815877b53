// K5 extract_tail: the recompute form of the blocked extract tail, reached
// through extract_color_prepared / extract_gray_prepared(recompute=True).
//
// Replaces the XLA fusion of dctsvd_tpu/models/blocked.py::
// _normalize_blocks_recompute (reached through _extract_tail_prepared(
// recompute=True)); the JAX package has no pl.pallas_call for it.
// Plain twin: dctsvd_tpu_torch/ops/tail_cuda.py::recon_normalize_plain.
//
// What it computes. Plane p = (frame f, channel c), block n, its natural-
// order estimates x[p, n, 0..k-1] and, when the input has k + 1 columns,
// the erasure flag x[p, n, k] > 0.5; the pixel basis e[c, n, j, 0..63]:
//   y = x0 e0, then y = y + xj ej for j = 1..k-1, each product and sum
//       rounded (the twin's order);
//   pass 1 (window): the plane's min and max over all its pixels, and over
//       the pixels of unflagged blocks (NaN propagates, as torch.amin);
//   pass 2 (paint): lo, hi = the unflagged window, or the whole one where
//       that is not finite (every block flagged); scale = 255 / max(hi -
//       lo, 1e-12) as one IEEE division; flagged blocks repainted at
//       (lo + hi) * 0.5 (at 0 without normalize); (y - lo) * scale; u8 out
//       clamps to [0, 255] and truncates. Output: channels-last frames
//       [F, H, W, C] or planes [F, C, H, W].
// Without normalize only pass 2 runs.
//
// What bounds it on the H100: bytes. At 1080p color, k = 4, 32 frames:
// the u8 frames (199 MB), the estimates read once a pass (62 MB each) and
// the basis read once a pass (99.5 MB each), 0.52 GB or 0.156 ms at
// 3.35 TB/s; its f32 work, about 16 operations an output byte, is 0.05 ms
// at 67e12 (0.095 ms at one instruction a lane a clock).
// What the design does about it:
//   - A warp takes one pixel row r of 32 / C' neighbouring blocks (C' = C
//     for frames, the channels of a block on neighbouring lanes; 1 for
//     planes, a channel a warp), a CTA the 8 rows of those blocks, and
//     each lane keeps the k x 8 basis floats of its row in registers and
//     walks every frame: the basis is read once a pass, whatever the
//     batch (the JAX form re-read it once a frame a pass on the TPU).
//     The 8 warps of a CTA read the same estimates, mostly from L1.
//   - The plane window is exact in any order (min and max), so it folds
//     through atomics on an order-preserving u32 key of the float: a warp
//     reduces its lanes of one channel by shuffles, the CTA folds 32
//     frames at a time in shared memory, then one global atomic a slot.
//     No product depends on the batch's shape, so a frame extracts to the
//     same bytes alone, in a shard or in any batch.
//   - Frames: each lane writes its 8 pixels of one channel into a warp
//     stage in shared memory, interleaved, and the warp stores whole pixel
//     rows of its blocks as 8 bytes a lane (240 contiguous bytes a row at
//     C = 3); planes store 8 bytes (u8) or 32 (f32) a lane directly.
//   - Offsets within a frame are 32-bit (the host refuses a frame of 2^31
//     elements or more); -fmad=false and the _rn intrinsics keep every
//     rounding the twin's.
// chip_smoke.py prints each instance's registers (`nvcc -Xptxas -v`).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "blocks.cuh"

namespace dctsvd {
namespace {

constexpr int kTailWarps = kB;               // a warp a pixel row
constexpr int kTailThreads = kTailWarps * 32;
constexpr int kTailChunk = 32;               // frames folded in smem at once

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
// amax and clamp), where fminf / fmaxf would drop it.
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
// block row `by` of channel group `cg`, warp r their pixel row r, and lane
// (block bxl, channel ci).
template <int kC>
struct TailLane {
  static constexpr int kG = 32 / kC;   // blocks a warp
  int lane, r, g, by, cg, bxl, ci, bx, n, c;
  bool active;

  __device__ TailLane(int hb, int wb, int groups) {
    lane = threadIdx.x & 31;
    r = threadIdx.x >> 5;
    g = blockIdx.x % groups;
    const int rest = blockIdx.x / groups;
    by = rest % hb;
    cg = rest / hb;
    bxl = lane / kC;
    ci = lane - bxl * kC;
    bx = g * kG + bxl;
    active = bxl < kG && bx < wb;
    n = by * wb + bx;
    c = cg * kC + ci;
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

// The 8 pixels of the row: y = x0 e0, then y + xj ej in order of j.
template <int K>
__device__ __forceinline__ void produce(const float* __restrict__ xr,
                                        const float (&e)[K][kB],
                                        float (&y)[kB]) {
  float xs[K];
#pragma unroll
  for (int j = 0; j < K; ++j) xs[j] = xr[j];
#pragma unroll
  for (int i = 0; i < kB; ++i) y[i] = __fmul_rn(xs[0], e[0][i]);
#pragma unroll
  for (int j = 1; j < K; ++j)
#pragma unroll
    for (int i = 0; i < kB; ++i)
      y[i] = __fadd_rn(y[i], __fmul_rn(xs[j], e[j][i]));
}

__global__ void tail_init_kernel(uint32_t* __restrict__ win, int slots) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < slots) win[t] = (t & 1) ? kHiInit : kLoInit;
}

// Pass 1. win[p] = keys of (unflagged lo, unflagged hi, lo, hi) of plane
// p = f * chans + c, filled with the keys of (+inf, -inf, +inf, -inf)
// before the launch.
template <int K, int kC>
__global__ void __launch_bounds__(kTailThreads)
    tail_window_kernel(const float* __restrict__ x, int kx,
                       const float* __restrict__ eb, int64_t bstride,
                       uint32_t* __restrict__ win, int frames, int chans,
                       int hb, int wb, int groups, int flagged) {
  __shared__ uint32_t fold[kTailChunk][kC][4];
  const TailLane<kC> t(hb, wb, groups);
  const int n_blk = hb * wb;
  float e[K][kB];
  if (t.active)
    load_basis<K>(eb, bstride, static_cast<int64_t>(t.c) * n_blk + t.n, t.r,
                  e);
  const int64_t xstep = static_cast<int64_t>(chans) * n_blk * kx;
  const float* xp = x + (static_cast<int64_t>(t.c) * n_blk + t.n) * kx;
  const float inf = __int_as_float(0x7f800000);
  for (int f0 = 0; f0 < frames; f0 += kTailChunk) {
    const int nf = min(kTailChunk, frames - f0);
    for (int i = threadIdx.x; i < kTailChunk * kC * 4; i += kTailThreads)
      (&fold[0][0][0])[i] = (i & 1) ? kHiInit : kLoInit;
    __syncthreads();
    for (int fi = 0; fi < nf; ++fi) {
      float lo = inf, hi = -inf, glo = inf, ghi = -inf;
      if (t.active) {
        const float* xr = xp + (f0 + fi) * xstep;
        float y[kB];
        produce<K>(xr, e, y);
        lo = y[0];
        hi = y[0];
#pragma unroll
        for (int i = 1; i < kB; ++i) {
          lo = min_nan(lo, y[i]);
          hi = max_nan(hi, y[i]);
        }
        if (!(flagged && xr[K] > 0.5f)) {
          glo = lo;
          ghi = hi;
        }
      }
      lo = warp_fold<kC, false>(lo);
      hi = warp_fold<kC, true>(hi);
      if (flagged) {
        glo = warp_fold<kC, false>(glo);
        ghi = warp_fold<kC, true>(ghi);
      }
      if (t.lane < kC) {
        uint32_t* s = fold[fi][t.lane];
        if (flagged) {
          atomicMin(s, key_lo(glo));
          atomicMax(s + 1, key_hi(ghi));
        }
        atomicMin(s + 2, key_lo(lo));
        atomicMax(s + 3, key_hi(hi));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nf * kC * 4; i += kTailThreads) {
      const int s = i & 3, q = i >> 2, fi = q / kC, ci = q - fi * kC;
      const uint32_t v = fold[fi][ci][s];
      if (v == ((s & 1) ? kHiInit : kLoInit)) continue;
      uint32_t* dst = win + (static_cast<int64_t>(f0 + fi) * chans +
                             t.cg * kC + ci) * 4 + s;
      if (s & 1)
        atomicMax(dst, v);
      else
        atomicMin(dst, v);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store8(uint8_t* p, const uint8_t (&v)[kB]) {
  uint2 w;
  w.x = v[0] | (v[1] << 8) | (v[2] << 16) |
        (static_cast<uint32_t>(v[3]) << 24);
  w.y = v[4] | (v[5] << 8) | (v[6] << 16) |
        (static_cast<uint32_t>(v[7]) << 24);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kB]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Pass 2: normalise (with the window of pass 1), clamp, cast and store.
template <int K, int kC, typename Out>
__global__ void __launch_bounds__(kTailThreads)
    tail_paint_kernel(const float* __restrict__ x, int kx,
                      const float* __restrict__ eb, int64_t bstride,
                      const uint32_t* __restrict__ win,
                      Out* __restrict__ out, int frames, int chans, int hb,
                      int wb, int groups, int flagged, int normalize) {
  constexpr int kG = TailLane<kC>::kG;
  constexpr int kStage = kC > 1 ? kG * kC * kB : 1;
  __shared__ __align__(16) Out stage[kTailWarps][kStage];
  const TailLane<kC> t(hb, wb, groups);
  const int n_blk = hb * wb;
  const int w = wb * kB;
  float e[K][kB];
  if (t.active)
    load_basis<K>(eb, bstride, static_cast<int64_t>(t.c) * n_blk + t.n, t.r,
                  e);
  const int64_t xstep = static_cast<int64_t>(chans) * n_blk * kx;
  const float* xp = x + (static_cast<int64_t>(t.c) * n_blk + t.n) * kx;
  const int64_t frame_out = static_cast<int64_t>(n_blk) * kB * kB * chans;
  // this warp's run of pixel row by * 8 + r: cg * H * W + (y * W + the
  // first block's column) * kC, 8 elements a lane
  const int seg = t.cg * (n_blk * kB * kB) +
                  ((t.by * kB + t.r) * w + t.g * kG * kB) * kC + t.lane * kB;
  const int live = min(kG, wb - t.g * kG) * kC;   // lanes that store
  for (int f = 0; f < frames; ++f) {
    float lo = 0.0f, scale = 1.0f, mid = 0.0f;
    if (normalize) {
      const uint32_t* wf = win + (static_cast<int64_t>(f) * chans + t.c) * 4;
      const float alo = float_of(wf[2]), ahi = float_of(wf[3]);
      float hi = ahi;
      lo = alo;
      if (flagged) {
        const float glo = float_of(wf[0]), ghi = float_of(wf[1]);
        if (isfinite(glo) && isfinite(ghi)) {
          lo = glo;
          hi = ghi;
        }
      }
      scale = __fdiv_rn(255.0f, max_nan(__fsub_rn(hi, lo), 1e-12f));
      mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
    }
    Out v[kB];
    if (t.active) {
      const float* xr = xp + f * xstep;
      float y[kB];
      produce<K>(xr, e, y);
      const bool bad = flagged && xr[K] > 0.5f;
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        float u = y[i];
        if (bad) u = normalize ? mid : 0.0f;
        if (normalize) u = __fmul_rn(__fsub_rn(u, lo), scale);
        v[i] = store_val<Out>(u);
      }
    }
    Out* o = out + f * frame_out + seg;
    if constexpr (kC == 1) {
      if (t.active) store8(o, v);
    } else {
      Out* st = stage[t.r];
      if (t.active) {
#pragma unroll
        for (int i = 0; i < kB; ++i)
          st[t.bxl * kC * kB + i * kC + t.ci] = v[i];
      }
      __syncwarp();
      if (t.lane < live) {
        Out u[kB];
#pragma unroll
        for (int i = 0; i < kB; ++i) u[i] = st[t.lane * kB + i];
        store8(o, u);
      }
      __syncwarp();
    }
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
  const float* x;
  int kx;
  const float* eb;
  int64_t bstride;
  void* out;
  bool out_u8;
  uint32_t* win;
  int frames, chans, hb, wb, groups, flagged, normalize;
  unsigned grid;
  cudaStream_t st;
};

template <int K, int kC>
cudaError_t launch_tail(const TailArgs& a) {
  if (a.normalize) {
    const int slots = a.frames * a.chans * 4;
    tail_init_kernel<<<(slots + 255) / 256, 256, 0, a.st>>>(a.win, slots);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    tail_window_kernel<K, kC><<<a.grid, kTailThreads, 0, a.st>>>(
        a.x, a.kx, a.eb, a.bstride, a.win, a.frames, a.chans, a.hb, a.wb,
        a.groups, a.flagged);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.out_u8)
    tail_paint_kernel<K, kC, uint8_t><<<a.grid, kTailThreads, 0, a.st>>>(
        a.x, a.kx, a.eb, a.bstride, a.win, static_cast<uint8_t*>(a.out),
        a.frames, a.chans, a.hb, a.wb, a.groups, a.flagged, a.normalize);
  else
    tail_paint_kernel<K, kC, float><<<a.grid, kTailThreads, 0, a.st>>>(
        a.x, a.kx, a.eb, a.bstride, a.win, static_cast<float*>(a.out),
        a.frames, a.chans, a.hb, a.wb, a.groups, a.flagged, a.normalize);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dctsvd

// x: f32 [frames, chans, N, kx] contiguous, kx = k (no erasure flags) or
// k + 1 (the flag in column k); eb: f32 basis rows, block (c, n) at
// eb + (c * N + n) * bstride, its k rows of 64 pixels 64 floats apart
// (16-byte aligned, bstride a multiple of 4); out: u8 or f32, channels-last
// frames [frames, h, w, chans] (frames_layout, chans 1 or 3) or planes
// [frames, chans, h, w]; win: u32 [frames * chans, 4] scratch, used only
// with normalize. Launches the init and window kernels (with normalize)
// and the paint kernel on `stream`; returns the first launch's error, or
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
  if (h % kB || w % kB || h <= 0 || w <= 0 || frames < 0 || chans < 1 ||
      (kc != 1 && kc != 3) || (kx != k && kx != k + 1) || bstride % 4 ||
      reinterpret_cast<uintptr_t>(eb) % 16 ||
      static_cast<int64_t>(h) * w * chans >= (int64_t{1} << 31) ||
      static_cast<int64_t>(frames) * chans * 4 >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hb = h / kB, wb = w / kB;
  const int kg = 32 / kc;
  const int groups = (wb + kg - 1) / kg;
  const int64_t grid = static_cast<int64_t>(chans / kc) * hb * groups;
  if (grid >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  TailArgs a{static_cast<const float*>(x), kx, static_cast<const float*>(eb),
             bstride, out, out_is_u8 != 0, static_cast<uint32_t*>(win),
             frames, chans, hb, wb, groups, kx == k + 1, normalize != 0,
             static_cast<unsigned>(grid), static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  const bool ok = tail_with_k(k, [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    err = kc == 1 ? launch_tail<K, 1>(a) : launch_tail<K, 3>(a);
  });
  return static_cast<int>(ok ? err : cudaErrorInvalidValue);
}
