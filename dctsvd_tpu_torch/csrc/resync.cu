// Detect resync's search on the card: K12, the stack of rolled copies of
// one frame that a search chunk scores (roll_stack), and K13, the bilinear
// counter-rotation of one frame about its center (derotate).
//
// They replace no pl.pallas_call: in the JAX package each is an XLA fusion,
// K12 the jax.vmap(jnp.roll) of _detect_shift_chunk
// (dctsvd_tpu/models/blocked.py:1381), K13 _derotate (:1310, over
// jax.scipy.ndimage.map_coordinates(order=1, mode='constant') at :1333).
// Plain twins: dctsvd_tpu_torch/ops/resync_cuda.py::roll_stack_plain (one
// advanced-indexing gather) and ::derotate_plain (four index_selects with
// int64 flat indices, the weights, wheres and the rounding).
//
// K12: out[s, r, c, ch] = img[(r - dy_s) mod H, (c - dx_s) mod W, ch] for
// an [S, 2] int64 shift tensor read on the device (torch.roll's sense;
// the moduli non-negative, as torch.remainder gives them; any |d|). A
// frame is [H, W, C] of 1- or 4-byte elements (u8 BGR frames, u8 or f32
// planes with C = 1). Nothing is computed: the kernel is a copy, and equal
// to its twin byte for byte.
//   Bound: bytes, the frame read once and the stack written once: a chunk
//   of 64 u8 1080p color frames 404,352,000 B (0.1207 ms at 3.35 TB/s), of
//   64 f32 luma planes 539,136,000 B (0.1609 ms).
//   Design: output row r of roll s is source row (r - dy) mod H rotated by
//   dx·C elements, so a CTA copies one output row as at most two
//   contiguous runs. The vector instance (row bytes a multiple of 16, both
//   pointers on 16-byte boundaries) gives each thread 16 output bytes: it
//   loads the source's aligned 32-bit words covering them (five, or four
//   where the run starts on a word) and realigns them with funnel shifts,
//   or byte by byte for the one group a row whose run wraps; it stores the
//   16 bytes with one streaming (evict-first) store, since the stack is
//   read once, by K1, and is 8 times L2. The frame itself (6.2 MB in u8
//   color, 8.3 MB in f32) stays in L2 across a chunk's S copies. Other
//   shapes take the scalar instance, an element a thread. The shifts are
//   read by each CTA from the device: no host copy, no sync.
//
// K13: the inverse warp of cv2.getRotationMatrix2D((w/2, h/2), a, 1) +
// warpAffine, bilinear, zeros outside, as the twin computes it, each IEEE
// f32 operation in the twin's order (the build contracts no multiply-add,
// -fmad=false, so each rounds as the twin's separate torch ops do):
//   xx = col - w/2, yy = row - h/2;
//   src_x = (c·xx + s·yy) + w/2, src_y = ((-s)·xx + c·yy) + h/2;
//   per axis: lower = floor(src), upper weight u = src - lower, the lower
//   tap's weight 1 - u;
//   out = ((t00 + t01) + t10) + t11, t_ab = (wy_a·wx_b)·(valid ? v : 0);
//   integer inputs: rintf (half to even, torch.round), then [0, 255].
// One launch takes A angles of F frames: output slice z = a·F + f is frame
// f counter-rotated by angle a, whose (cos, sin) is row a of an [A, 2]
// tensor on the device, the twin's own values (ops/resync_cuda.py::
// rotation_cs and rotation_cs_batch: deg2rad, cos and sin of f32 tensors),
// so the kernel does no trigonometry and the host never waits. At angle 0
// (c = 1, s = 0) every pixel is its own lower tap with weight 1, so
// derotate(x, 0) is x.
//   Bound: bytes, the frame read once (it stays in the 50 MB L2 across the
//   angles: 6.2 MB a u8 color 1080p frame, 8.3 MB an f32 plane, 33 MB at
//   2160x3840) and the A slices written once: 20 color 1080p angles
//   130,636,800 B (0.0390 ms at 3.35 TB/s), 20 f32 1080p planes
//   174,182,400 B (0.0520 ms), 20 f32 2160x3840 planes 696,729,600 B
//   (0.2080 ms). One angle at 1080p is smaller than a launch's cost: the
//   resync search makes all of a scan's angles in one launch.
//   Design: a thread computes kRotPix neighbouring output pixels of a row,
//   all C channels (a CTA 32 x 8 threads, 128 x 8 pixels), with the row's
//   products s·yy and c·yy formed once. A pixel whose four taps lie inside
//   the frame (all but a border for the small angles the search tries)
//   takes one address and no selects. u8 taps become f32 by a byte into
//   2^23's mantissa and one exact subtraction, and u8 results leave as the
//   low byte of clamp(v) + 2^23 (round half to even; equal to rintf then
//   the clamp for every f32 v), both on the full-rate pipes instead of the
//   quarter-rate conversions. The vector instance (W a multiple of
//   kRotPix, the output 16-byte aligned: derotate_plan) stores a thread's
//   4·C elements whole: a 4-byte word (u8 planes), three words (u8 BGR: 12
//   bytes), 16 bytes (u8 with 4 channels) or C float4s (f32); the scalar
//   instance stores element by element, guarded at the row's end. (Lanes
//   on neighbouring pixels, 32 apart in a thread, with plain stores,
//   measured the same on color frames, 7 % faster on 1080p f32 planes and
//   8 % slower at 2160x3840; evict-first stores measured no faster.) Its
//   share of the byte bound and its SASS are in PERF.md, section 6.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace dctsvd {

constexpr int kRollThreads = 128;
constexpr int kRotTileX = 32;    // K13: threads along a row
constexpr int kRotTileY = 8;
constexpr int kRotPix = 4;       // output pixels a thread (ops/resync_cuda.py
                                 // ROT_PIXELS)
constexpr int kMaxGridZ = 65535;  // output slices a launch of K13

// x mod m in [0, m) for any int64 x (m > 0).
__device__ __forceinline__ int64_t mod_nonneg(int64_t x, int64_t m) {
  const int64_t r = x % m;
  return r < 0 ? r + m : r;
}

// K12, vector instance. CTA blockIdx.x is output row s·h + r; a row is len
// bytes (a multiple of 16), shift (dx mod w)·bpp bytes; img and out on
// 16-byte boundaries.
__global__ void __launch_bounds__(kRollThreads)
    roll_rows_vector(const uint8_t* __restrict__ img,
                     const long long* __restrict__ shifts,
                     uint8_t* __restrict__ out, int h, int w, int bpp) {
  const int64_t row = blockIdx.x;
  const int64_t s = row / h;
  const int r = static_cast<int>(row - s * h);
  const int sr = static_cast<int>(mod_nonneg(r - mod_nonneg(shifts[2 * s], h),
                                             h));
  const int len = w * bpp;
  const int sh = static_cast<int>(mod_nonneg(shifts[2 * s + 1], w)) * bpp;
  const uint8_t* src = img + static_cast<int64_t>(sr) * len;
  const uint32_t* src_w = reinterpret_cast<const uint32_t*>(src);
  uint4* dst = reinterpret_cast<uint4*>(out + row * len);
  for (int g = threadIdx.x; g < len / 16; g += kRollThreads) {
    int k0 = 16 * g - sh;
    if (k0 < 0) k0 += len;
    uint32_t o[4];
    if (k0 + 16 <= len) {
      const int w0 = k0 >> 2;
      const int off = (k0 & 3) * 8;
      uint32_t a[5];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = __ldg(src_w + w0 + i);
      a[4] = off ? __ldg(src_w + w0 + 4) : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = __funnelshift_r(a[i], a[i + 1], off);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t v = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          int k = k0 + 4 * i + b;
          if (k >= len) k -= len;
          v |= static_cast<uint32_t>(__ldg(src + k)) << (8 * b);
        }
        o[i] = v;
      }
    }
    __stcs(dst + g, make_uint4(o[0], o[1], o[2], o[3]));
  }
}

// K12, scalar instance: an element a thread; a row is w·c elements of T.
template <typename T>
__global__ void __launch_bounds__(kRollThreads)
    roll_rows_scalar(const T* __restrict__ img,
                     const long long* __restrict__ shifts,
                     T* __restrict__ out, int h, int w, int c) {
  const int64_t row = blockIdx.x;
  const int64_t s = row / h;
  const int r = static_cast<int>(row - s * h);
  const int sr = static_cast<int>(mod_nonneg(r - mod_nonneg(shifts[2 * s], h),
                                             h));
  const int len = w * c;
  const int sh = static_cast<int>(mod_nonneg(shifts[2 * s + 1], w)) * c;
  const T* src = img + static_cast<int64_t>(sr) * len;
  T* dst = out + row * len;
  for (int j = threadIdx.x; j < len; j += kRollThreads) {
    int k = j - sh;
    if (k < 0) k += len;
    __stcs(dst + j, __ldg(src + k));
  }
}

// An f32 tap from its element: u8 through 2^23's mantissa (exact).
__device__ __forceinline__ float tap_f32(uint8_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}
__device__ __forceinline__ float tap_f32(float v) { return v; }

// torch.round (half to even), clamp(0, 255), .to(uint8) as the low byte of
// the result: for every f32 v, clamping first and rounding by the addition
// of 2^23 (round to nearest even at ulp 1) gives rintf's then the clamp's
// value (NaN and -0 go to 0 either way).
__device__ __forceinline__ uint32_t u8_bits(float v) {
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), 8388608.0f));
}

// One output pixel of K13 at column col: acc[ch] in the twin's order.
// s_yy = s·yy, c_yy = c·yy of the pixel's row; ns = -s.
template <typename T, int C>
__device__ __forceinline__ void derotate_pixel(const T* __restrict__ img,
                                               float c, float ns, float s_yy,
                                               float c_yy, float cx, float cy,
                                               int col, int h, int w,
                                               float (&acc)[C]) {
  const float xx = __fsub_rn(static_cast<float>(col), cx);
  const float src_x = __fadd_rn(__fadd_rn(__fmul_rn(c, xx), s_yy), cx);
  const float src_y = __fadd_rn(__fadd_rn(__fmul_rn(ns, xx), c_yy), cy);
  const float ly = floorf(src_y), lx = floorf(src_x);
  const float uy = __fsub_rn(src_y, ly), ux = __fsub_rn(src_x, lx);
  const float wy[2] = {__fsub_rn(1.0f, uy), uy};
  const float wx[2] = {__fsub_rn(1.0f, ux), ux};
  const int y0 = static_cast<int>(ly), x0 = static_cast<int>(lx);
  if (x0 >= 0 && x0 < w - 1 && y0 >= 0 && y0 < h - 1) {
    // all four taps inside: one address, no selects
    const T* p0 = img + (static_cast<int64_t>(y0) * w + x0) * C;
    const T* p1 = p0 + static_cast<int64_t>(w) * C;
    const float w00 = __fmul_rn(wy[0], wx[0]), w01 = __fmul_rn(wy[0], wx[1]);
    const float w10 = __fmul_rn(wy[1], wx[0]), w11 = __fmul_rn(wy[1], wx[1]);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      float s = __fmul_rn(w00, tap_f32(__ldg(p0 + ch)));
      s = __fadd_rn(s, __fmul_rn(w01, tap_f32(__ldg(p0 + C + ch))));
      s = __fadd_rn(s, __fmul_rn(w10, tap_f32(__ldg(p1 + ch))));
      acc[ch] = __fadd_rn(s, __fmul_rn(w11, tap_f32(__ldg(p1 + C + ch))));
    }
    return;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int iy = y0 + a, ix = x0 + b;
      const bool valid = iy >= 0 && iy < h && ix >= 0 && ix < w;
      const float wgt = __fmul_rn(wy[a], wx[b]);
      const T* px = img + (static_cast<int64_t>(valid ? iy : 0) * w +
                           (valid ? ix : 0)) * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float v = valid ? tap_f32(__ldg(px + ch)) : 0.0f;
        const float t = __fmul_rn(wgt, v);
        acc[ch] = (a == 0 && b == 0) ? t : __fadd_rn(acc[ch], t);
      }
    }
  }
}

// A thread's kRotPix·C results to the output: whole (kVec) or element by
// element up to the row's end (n pixels of the group lie in the row).
template <int C, bool kVec>
__device__ __forceinline__ void store_group(float* po,
                                            const float (&acc)[kRotPix][C],
                                            int n) {
  if constexpr (kVec) {
    const float* e = &acc[0][0];
#pragma unroll
    for (int i = 0; i < C; ++i)
      reinterpret_cast<float4*>(po)[i] =
          make_float4(e[4 * i], e[4 * i + 1], e[4 * i + 2], e[4 * i + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kRotPix; ++k)
      if (k < n)
#pragma unroll
        for (int ch = 0; ch < C; ++ch) po[k * C + ch] = acc[k][ch];
  }
}

template <int C, bool kVec>
__device__ __forceinline__ void store_group(uint8_t* po,
                                            const float (&acc)[kRotPix][C],
                                            int n) {
  uint32_t b[kRotPix * C];
#pragma unroll
  for (int k = 0; k < kRotPix; ++k)
#pragma unroll
    for (int ch = 0; ch < C; ++ch) b[k * C + ch] = u8_bits(acc[k][ch]);
  if constexpr (kVec) {
    // 4·C bytes: C words, each four results' low bytes
    uint32_t word[C];
#pragma unroll
    for (int i = 0; i < C; ++i)
      word[i] = __byte_perm(__byte_perm(b[4 * i], b[4 * i + 1], 0x0040),
                            __byte_perm(b[4 * i + 2], b[4 * i + 3], 0x0040),
                            0x5410);
    if constexpr (C == 4) {
      *reinterpret_cast<uint4*>(po) =
          make_uint4(word[0], word[1], word[2], word[3]);
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i) reinterpret_cast<uint32_t*>(po)[i] = word[i];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRotPix; ++k)
      if (k < n)
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          po[k * C + ch] = static_cast<uint8_t>(b[k * C + ch] & 0xffu);
  }
}

// K13. Output slice z = z0 + blockIdx.z of [h, w, C] elements of T is frame
// z mod frames of img counter-rotated by angle z / frames; cs [A, 2] =
// (cos, sin) of each angle.
template <typename T, int C, bool kVec>
__global__ void __launch_bounds__(kRotTileX* kRotTileY)
    derotate_kernel(const T* __restrict__ img, const float* __restrict__ cs,
                    T* __restrict__ out, int z0, int frames, int h, int w) {
  const int col0 = (blockIdx.x * kRotTileX + threadIdx.x) * kRotPix;
  const int row = blockIdx.y * kRotTileY + threadIdx.y;
  if (col0 >= w || row >= h) return;
  const int z = z0 + static_cast<int>(blockIdx.z);
  const int angle = z / frames;
  const int64_t frame = static_cast<int64_t>(h) * w * C;
  img += (z - angle * frames) * frame;
  out += z * frame;
  const float c = __ldg(cs + 2 * angle), s = __ldg(cs + 2 * angle + 1);
  const float cx = w * 0.5f, cy = h * 0.5f;
  const float yy = __fsub_rn(static_cast<float>(row), cy);
  const float s_yy = __fmul_rn(s, yy), c_yy = __fmul_rn(c, yy);
  float acc[kRotPix][C];
#pragma unroll
  for (int k = 0; k < kRotPix; ++k)
    derotate_pixel<T, C>(img, c, -s, s_yy, c_yy, cx, cy, col0 + k, h, w,
                         acc[k]);
  store_group<C, kVec>(out + (static_cast<int64_t>(row) * w + col0) * C, acc,
                       w - col0);
}

template <typename T, int C>
static void launch_derotate(const void* img, const void* cs, void* out,
                            int slices, int frames, int h, int w, bool vec,
                            cudaStream_t st) {
  const dim3 block(kRotTileX, kRotTileY);
  const int per_cta = kRotTileX * kRotPix;
  for (int z0 = 0; z0 < slices; z0 += kMaxGridZ) {
    const dim3 grid((w + per_cta - 1) / per_cta,
                    (h + kRotTileY - 1) / kRotTileY,
                    static_cast<unsigned>(std::min(slices - z0, kMaxGridZ)));
    if (vec)
      derotate_kernel<T, C, true><<<grid, block, 0, st>>>(
          static_cast<const T*>(img), static_cast<const float*>(cs),
          static_cast<T*>(out), z0, frames, h, w);
    else
      derotate_kernel<T, C, false><<<grid, block, 0, st>>>(
          static_cast<const T*>(img), static_cast<const float*>(cs),
          static_cast<T*>(out), z0, frames, h, w);
  }
}

template <typename T>
static void launch_derotate_c(const void* img, const void* cs, void* out,
                              int slices, int frames, int h, int w, int c,
                              int vector, cudaStream_t st) {
  const bool v = vector != 0;
  if (c == 1) launch_derotate<T, 1>(img, cs, out, slices, frames, h, w, v, st);
  if (c == 3) launch_derotate<T, 3>(img, cs, out, slices, frames, h, w, v, st);
  if (c == 4) launch_derotate<T, 4>(img, cs, out, slices, frames, h, w, v, st);
}

}  // namespace dctsvd

using namespace dctsvd;

// img: one frame [h, w, c] of esize-byte elements (1: u8, 4: f32);
// shifts: int64 [s, 2] (dy, dx) on the device; out: [s, h, w, c].
// vector: ops/resync_cuda.py::roll_plan (row bytes a multiple of 16, img
// and out on 16-byte boundaries). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue, and no launch, for a shape the kernel does not
// take).
extern "C" int dctsvd_roll_stack(const void* img, const void* shifts,
                                 void* out, int s, int h, int w, int c,
                                 int esize, int vector, void* stream) {
  const int64_t rows = static_cast<int64_t>(s) * h;
  const int64_t len = static_cast<int64_t>(w) * c * esize;
  if (s <= 0 || h <= 0 || w <= 0 || c <= 0 || rows >= (1ll << 31) ||
      len >= (1ll << 31) || (esize != 1 && esize != 4) ||
      (vector && len % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* sh = static_cast<const long long*>(shifts);
  const unsigned grid = static_cast<unsigned>(rows);
  if (vector)
    roll_rows_vector<<<grid, kRollThreads, 0, st>>>(
        static_cast<const uint8_t*>(img), sh, static_cast<uint8_t*>(out), h,
        w, c * esize);
  else if (esize == 1)
    roll_rows_scalar<uint8_t><<<grid, kRollThreads, 0, st>>>(
        static_cast<const uint8_t*>(img), sh, static_cast<uint8_t*>(out), h,
        w, c);
  else
    roll_rows_scalar<float><<<grid, kRollThreads, 0, st>>>(
        static_cast<const float*>(img), sh, static_cast<float*>(out), h, w,
        c);
  return static_cast<int>(cudaGetLastError());
}

// img: [frames, h, w, c] u8 (u8 1) or f32 (u8 0), c in {1, 3, 4}; cs: f32
// [angles, 2], (cos, sin) of each angle on the device; out: [angles,
// frames, h, w, c]. vector: ops/resync_cuda.py::derotate_plan (w a
// multiple of kRotPix, out on a 16-byte boundary). Returns the cudaError_t
// of the launch (cudaErrorInvalidValue, and no launch, for another c or an
// empty or oversized frame or batch).
extern "C" int dctsvd_derotate(const void* img, const void* cs, void* out,
                               int angles, int frames, int h, int w, int c,
                               int u8, int vector, void* stream) {
  const int64_t slices = static_cast<int64_t>(angles) * frames;
  if (angles <= 0 || frames <= 0 || h <= 0 || w <= 0 ||
      static_cast<int64_t>(h) * w * c >= (1ll << 31) ||
      slices >= (1ll << 31) || (c != 1 && c != 3 && c != 4) ||
      (vector && w % kRotPix != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(slices);
  if (u8)
    launch_derotate_c<uint8_t>(img, cs, out, n, frames, h, w, c, vector, st);
  else
    launch_derotate_c<float>(img, cs, out, n, frames, h, w, c, vector, st);
  return static_cast<int>(cudaGetLastError());
}
