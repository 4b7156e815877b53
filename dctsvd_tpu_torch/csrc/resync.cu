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
// c and s are the twin's own (ops/resync_cuda.py::rotation_cs: deg2rad,
// cos and sin of an f32 tensor on the device), read through a pointer:
// the kernel does no trigonometry and the host never waits. At angle 0
// (c = 1, s = 0) every pixel is its own lower tap with weight 1, so
// derotate(x, 0) is x.
//   Bound: bytes, the frame read and written once: 12,441,600 B for a
//   1080p u8 color frame (0.0037 ms), 16,588,800 B for a 1080p f32 plane
//   (0.0050 ms), 66,355,200 B for a 2160×3840 f32 plane (0.0198 ms). At
//   1080p a launch costs more than that: the kernel is launch-bound there.
//   Design: a thread computes one output pixel, all C channels; a CTA is
//   a 32 × 8 tile, so a warp's taps lie on one or two source rows for the
//   small angles the search tries. Plain loads and stores: the source
//   and the result (which the chunks' K12 reads next) fit in L2.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace dctsvd {

constexpr int kRollThreads = 128;
constexpr int kRotTileX = 32;
constexpr int kRotTileY = 8;
constexpr int kMaxGridZ = 65535;  // frames a launch of K13

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

template <typename T>
__device__ __forceinline__ T to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}

// torch.round (half to even), clamp(0, 255), .to(uint8).
template <>
__device__ __forceinline__ uint8_t to_out<uint8_t>(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

// K13. Frame blockIdx.z of [h, w, C] elements of T; cs = (cos, sin).
template <typename T, int C>
__global__ void __launch_bounds__(kRotTileX* kRotTileY)
    derotate_kernel(const T* __restrict__ img, const float* __restrict__ cs,
                    T* __restrict__ out, int h, int w) {
  const int col = blockIdx.x * kRotTileX + threadIdx.x;
  const int row = blockIdx.y * kRotTileY + threadIdx.y;
  if (col >= w || row >= h) return;
  const int64_t frame = static_cast<int64_t>(h) * w * C;
  img += blockIdx.z * frame;
  out += blockIdx.z * frame;
  const float c = __ldg(cs), s = __ldg(cs + 1);
  const float cx = w * 0.5f, cy = h * 0.5f;
  const float xx = static_cast<float>(col) - cx;
  const float yy = static_cast<float>(row) - cy;
  float src_x = c * xx;
  src_x = src_x + s * yy;
  src_x = src_x + cx;
  float src_y = (-s) * xx;
  src_y = src_y + c * yy;
  src_y = src_y + cy;
  const float ly = floorf(src_y), lx = floorf(src_x);
  const float uy = src_y - ly, ux = src_x - lx;
  const float wy[2] = {1.0f - uy, uy};
  const float wx[2] = {1.0f - ux, ux};
  const int y0 = static_cast<int>(ly), x0 = static_cast<int>(lx);
  float acc[C];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int iy = y0 + a, ix = x0 + b;
      const bool valid = iy >= 0 && iy < h && ix >= 0 && ix < w;
      const float wgt = wy[a] * wx[b];
      const T* px = img + (static_cast<int64_t>(valid ? iy : 0) * w +
                           (valid ? ix : 0)) * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float v = valid ? static_cast<float>(__ldg(px + ch)) : 0.0f;
        const float t = wgt * v;
        acc[ch] = (a == 0 && b == 0) ? t : acc[ch] + t;
      }
    }
  }
  T* po = out + (static_cast<int64_t>(row) * w + col) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) po[ch] = to_out<T>(acc[ch]);
}

template <typename T, int C>
static void launch_derotate(const void* img, const void* cs, void* out,
                            int frames, int h, int w, cudaStream_t st) {
  const int64_t frame = static_cast<int64_t>(h) * w * C;
  const dim3 block(kRotTileX, kRotTileY);
  for (int f0 = 0; f0 < frames; f0 += kMaxGridZ) {
    const dim3 grid((w + kRotTileX - 1) / kRotTileX,
                    (h + kRotTileY - 1) / kRotTileY,
                    static_cast<unsigned>(std::min(frames - f0, kMaxGridZ)));
    derotate_kernel<T, C><<<grid, block, 0, st>>>(
        static_cast<const T*>(img) + f0 * frame,
        static_cast<const float*>(cs), static_cast<T*>(out) + f0 * frame, h,
        w);
  }
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

// img, out: [frames, h, w, c] u8 (u8 1) or f32 (u8 0), c in {1, 3, 4};
// cs: f32 (cos, sin) of the angle on the device. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue, and no launch, for another c or an
// empty or oversized frame).
extern "C" int dctsvd_derotate(const void* img, const void* cs, void* out,
                               int frames, int h, int w, int c, int u8,
                               void* stream) {
  if (frames <= 0 || h <= 0 || w <= 0 ||
      static_cast<int64_t>(h) * w * c >= (1ll << 31) ||
      (c != 1 && c != 3 && c != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u8) {
    if (c == 1) launch_derotate<uint8_t, 1>(img, cs, out, frames, h, w, st);
    if (c == 3) launch_derotate<uint8_t, 3>(img, cs, out, frames, h, w, st);
    if (c == 4) launch_derotate<uint8_t, 4>(img, cs, out, frames, h, w, st);
  } else {
    if (c == 1) launch_derotate<float, 1>(img, cs, out, frames, h, w, st);
    if (c == 3) launch_derotate<float, 3>(img, cs, out, frames, h, w, st);
    if (c == 4) launch_derotate<float, 4>(img, cs, out, frames, h, w, st);
  }
  return static_cast<int>(cudaGetLastError());
}
