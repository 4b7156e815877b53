// The color conversions on the card: K6, the luma plane of a BGR frame
// (luma_f32's Y as f32, bgr_to_gray's gray as u8), K7, the stego frame from
// a marked Y plane and the cover's chroma (replace_luma), and K17, the
// color NLM's YCrCb pair (BGR frames to planar YCrCb planes and back).
//
// They replace no pl.pallas_call: in the JAX package the three functions
// of K6 and K7 (dctsvd_tpu/ops/color.py:55-83, over bgr_to_ycrcb and
// ycrcb_to_bgr) are one XLA fusion inside the jitted embed_gray_prepared
// (dctsvd_tpu/models/blocked.py:415-429) and the gray extract and detect;
// K17's pair (bgr_to_ycrcb :31, ycrcb_to_bgr :42) is fused around
// nlm_color_u8 (dctsvd_tpu/ops/enhance.py:234).
// Plain twins: dctsvd_tpu_torch/ops/color.py::*_plain, chains of int32
// PyTorch ops (about 10 passes over an int32 plane for luma_f32, 30 and a
// stack, a cat and two clamps for replace_luma; K17's the channels-last
// pair with the planar layout's movedim copy).
//
// What they compute, per pixel (b, g, r) of a u8 BGR frame, all in exact
// integer arithmetic with cv2's fixed-point descales, d(x, s) =
// (x + 2^(s-1)) >> s, an arithmetic (flooring) shift of a signed int32:
//   K6 luma:  Y = clamp(d(4899 r + 9617 g + 1868 b, 14), 0, 255), as f32;
//   K6 gray:  g = clamp(d(9798 r + 19235 g + 3735 b, 15), 0, 255), as u8;
//   K7:       Y as above (unclamped, as the twin's Cr and Cb read it),
//             Cr = clamp(d((r - Y) 11682 + 128 * 2^14, 14), 0, 255),
//             Cb = clamp(d((b - Y) 9241 + 128 * 2^14, 14), 0, 255) (the
//             twin's stack(...).clamp before the inverse);
//             y = Y' clamped to [0, 255] and truncated to u8 (the twin's
//             clamp and astype: truncation, NaN to 0) in one
//             cvt.rzi.sat.u8.f32, as K5's paint pass casts;
//             with cr = Cr - 128, cb = Cb - 128:
//             r' = y + d(22987 cr, 14), g' = y + d(-11698 cr - 5636 cb, 14)
//             (both negative terms inside one flooring shift), b' = y +
//             d(29049 cb, 14), each clamped to [0, 255], out as u8 BGR.
//   K17:      forward (Y, Cr, Cb) as in K7's first line, each clamped,
//             to three planes; inverse r', g', b' as in K7's last from
//             the planes' (Y, Cr, Cb), to channels-last BGR.
// Nothing rounds: each kernel is bit-equal to its twin and to the JAX
// package.
//
// What bounds them on the H100: bytes. A pixel moves 7 bytes through K6's
// luma (3 in, 4 out), 4 through its gray (3 in, 1 out), 10 through K7
// (4 + 3 in, 3 out) and 6 each way through K17 (12.4 MB, 0.0037 ms, a
// 1080p frame): at 128 1080p frames (265.4 M pixels) 0.555, 0.317 and
// 0.792 ms at 3.35 TB/s. K7's ~35 integer instructions a pixel would take
// ~0.56 ms there on 132 SMs x 64 INT32 lanes at 1980 MHz, near its bytes,
// so its issue bound is read from its SASS beside them.
//
// What the design does about it. A thread takes 4 pixels: their 12 bytes
// in as three 32-bit words (K17's inverse: one word of each plane), out
// as one float4 of Y, one u32 of gray, one u32 to each plane (K17's
// forward) or three u32 of BGR, so a warp reads 384 and writes up to 512 contiguous
// bytes. The grid is (4-pixel groups of a frame, frames), as K1's
// launch_frame_grid: 32-bit offsets inside a frame, the frame's base in
// 64 bits, so a batch of more than 2^31 bytes (270 1080p frames of f32 Y)
// needs nothing more. Stores stream (__stcs): with plain stores the output's
// dirty lines fill L2 and the next wave's loads wait behind their
// write-back (K2r, K5). Frames whose pixel count is not a multiple of 4,
// and pointers off the 4-byte (u8 words) or 16-byte (float4) alignment
// the vector path needs, take the scalar path, a pixel a thread; the
// host decides (ops/color_cuda.py::color_plan).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace dctsvd {

constexpr int kColorThreads = 256;
constexpr int kColorMaxGridY = 65535;  // frames a launch

__device__ __forceinline__ int descale(int x, int shift) {
  return (x + (1 << (shift - 1))) >> shift;
}

__device__ __forceinline__ int clamp_u8(int v) { return min(max(v, 0), 255); }

// K6's luma (14-bit Y) or gray (15-bit) of one pixel, in [0, 255].
template <bool kGray>
__device__ __forceinline__ int luma_of(int b, int g, int r) {
  return kGray ? clamp_u8(descale(r * 9798 + g * 19235 + b * 3735, 15))
               : clamp_u8(descale(r * 4899 + g * 9617 + b * 1868, 14));
}

// u8: truncate toward zero and saturate to [0, 255], NaN to 0 (the twin's
// clamp(0, 255) and cast) in one conversion.
__device__ __forceinline__ int sat_u8(float v) {
  uint32_t d;
  asm("cvt.rzi.sat.u8.f32 %0, %1;" : "=r"(d) : "f"(v));
  return static_cast<int>(d);
}

// bgr_to_ycrcb of one pixel: Y | Cr << 8 | Cb << 16, each clamped to
// [0, 255]; Cr and Cb from the unclamped Y, as the twin computes them.
__device__ __forceinline__ uint32_t ycrcb_pixel(int b, int g, int r) {
  const int y = descale(r * 4899 + g * 9617 + b * 1868, 14);
  const int cr = clamp_u8(descale((r - y) * 11682 + (128 << 14), 14));
  const int cb = clamp_u8(descale((b - y) * 9241 + (128 << 14), 14));
  return static_cast<uint32_t>(clamp_u8(y) | cr << 8 | cb << 16);
}

// ycrcb_to_bgr of one pixel (y, cr, cb in [0, 255]): b' | g' << 8 | r' << 16.
__device__ __forceinline__ uint32_t bgr_pixel(int y, int cr, int cb) {
  cr -= 128;
  cb -= 128;
  const int ro = clamp_u8(y + descale(cr * 22987, 14));
  const int go = clamp_u8(y + descale(cr * -11698 + cb * -5636, 14));
  const int bo = clamp_u8(y + descale(cb * 29049, 14));
  return static_cast<uint32_t>(bo | go << 8 | ro << 16);
}

// K7 on one pixel: (b', g', r') packed as b' | g' << 8 | r' << 16.
__device__ __forceinline__ uint32_t replace_pixel(float y_new, int b, int g,
                                                  int r) {
  const uint32_t ycc = ycrcb_pixel(b, g, r);
  return bgr_pixel(sat_u8(y_new), (ycc >> 8) & 0xffu, ycc >> 16);
}

__device__ __forceinline__ int byte_of(const uint32_t (&w)[3], int k) {
  return static_cast<int>((w[k >> 2] >> (8 * (k & 3))) & 0xffu);
}

__device__ __forceinline__ void store4(float* p, int a, int b, int c, int d) {
  __stcs(reinterpret_cast<float4*>(p),
         make_float4(static_cast<float>(a), static_cast<float>(b),
                     static_cast<float>(c), static_cast<float>(d)));
}

__device__ __forceinline__ void store4(uint8_t* p, int a, int b, int c,
                                       int d) {
  __stcs(reinterpret_cast<unsigned int*>(p),
         static_cast<unsigned int>(a | b << 8 | c << 16 | d << 24));
}

// K6. Frame blockIdx.y of pix pixels; kVector: thread i takes pixels
// 4i .. 4i + 3 (pix a multiple of 4, x 4-byte and y 16-byte (f32) or
// 4-byte (u8) aligned); else thread i takes pixel i.
template <typename Out, bool kGray, bool kVector>
__global__ void __launch_bounds__(kColorThreads)
    luma_kernel(const uint8_t* __restrict__ x, Out* __restrict__ y,
                int pix) {
  const int i = blockIdx.x * kColorThreads + threadIdx.x;
  const int64_t f = blockIdx.y;
  x += f * pix * 3;
  y += f * pix;
  if (kVector) {
    if (i >= pix / 4) return;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(x) + 3 * i;
    const uint32_t w[3] = {__ldg(src), __ldg(src + 1), __ldg(src + 2)};
    int v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      v[p] = luma_of<kGray>(byte_of(w, 3 * p), byte_of(w, 3 * p + 1),
                            byte_of(w, 3 * p + 2));
    store4(y + 4 * i, v[0], v[1], v[2], v[3]);
  } else {
    if (i >= pix) return;
    const uint8_t* px = x + 3 * i;
    y[i] = static_cast<Out>(luma_of<kGray>(px[0], px[1], px[2]));
  }
}

// K7. Frame blockIdx.y of pix pixels: marked Y y_new [pix] f32, cover
// x [pix, 3] u8, stego out [pix, 3] u8. kVector: thread i takes pixels
// 4i .. 4i + 3 (pix a multiple of 4, y_new 16-byte and x, out 4-byte
// aligned); else thread i takes pixel i.
template <bool kVector>
__global__ void __launch_bounds__(kColorThreads)
    replace_luma_kernel(const float* __restrict__ y_new,
                        const uint8_t* __restrict__ x,
                        uint8_t* __restrict__ out, int pix) {
  const int i = blockIdx.x * kColorThreads + threadIdx.x;
  const int64_t f = blockIdx.y;
  y_new += f * pix;
  x += f * pix * 3;
  out += f * pix * 3;
  if (kVector) {
    if (i >= pix / 4) return;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(x) + 3 * i;
    const uint32_t w[3] = {__ldg(src), __ldg(src + 1), __ldg(src + 2)};
    const float4 yq = __ldg(reinterpret_cast<const float4*>(y_new) + i);
    const float ys[4] = {yq.x, yq.y, yq.z, yq.w};
    uint32_t o[3] = {0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t bgr = replace_pixel(ys[p], byte_of(w, 3 * p),
                                         byte_of(w, 3 * p + 1),
                                         byte_of(w, 3 * p + 2));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int k = 3 * p + c;
        o[k >> 2] |= ((bgr >> (8 * c)) & 0xffu) << (8 * (k & 3));
      }
    }
    unsigned int* dst = reinterpret_cast<unsigned int*>(out) + 3 * i;
    __stcs(dst, o[0]);
    __stcs(dst + 1, o[1]);
    __stcs(dst + 2, o[2]);
  } else {
    if (i >= pix) return;
    const uint8_t* px = x + 3 * i;
    const uint32_t bgr = replace_pixel(y_new[i], px[0], px[1], px[2]);
    uint8_t* po = out + 3 * i;
    po[0] = static_cast<uint8_t>(bgr);
    po[1] = static_cast<uint8_t>(bgr >> 8);
    po[2] = static_cast<uint8_t>(bgr >> 16);
  }
}

// K17, forward. Frame blockIdx.y of pix pixels: BGR x [pix, 3] u8 ->
// planar YCrCb out [3, pix] u8. kVector: thread i takes pixels 4i .. 4i + 3
// (pix a multiple of 4, x and out 4-byte aligned): three words in, one word
// to each plane; else thread i takes pixel i.
template <bool kVector>
__global__ void __launch_bounds__(kColorThreads)
    ycrcb_planes_kernel(const uint8_t* __restrict__ x,
                        uint8_t* __restrict__ out, int pix) {
  const int i = blockIdx.x * kColorThreads + threadIdx.x;
  const int64_t f = blockIdx.y;
  x += f * pix * 3;
  out += f * pix * 3;
  if (kVector) {
    if (i >= pix / 4) return;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(x) + 3 * i;
    const uint32_t w[3] = {__ldg(src), __ldg(src + 1), __ldg(src + 2)};
    uint32_t o[3] = {0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t ycc = ycrcb_pixel(byte_of(w, 3 * p),
                                       byte_of(w, 3 * p + 1),
                                       byte_of(w, 3 * p + 2));
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c] |= ((ycc >> (8 * c)) & 0xffu) << (8 * p);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      __stcs(reinterpret_cast<unsigned int*>(out + c * pix) + i, o[c]);
  } else {
    if (i >= pix) return;
    const uint8_t* px = x + 3 * i;
    const uint32_t ycc = ycrcb_pixel(px[0], px[1], px[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[c * pix + i] = static_cast<uint8_t>(ycc >> (8 * c));
  }
}

// K17, inverse. Frame blockIdx.y: planar YCrCb p [3, pix] u8 -> BGR out
// [pix, 3] u8. kVector: thread i takes pixels 4i .. 4i + 3 (pix a multiple
// of 4, p and out 4-byte aligned): a word from each plane, three words
// out; else thread i takes pixel i.
template <bool kVector>
__global__ void __launch_bounds__(kColorThreads)
    ycrcb_bgr_kernel(const uint8_t* __restrict__ p, uint8_t* __restrict__ out,
                     int pix) {
  const int i = blockIdx.x * kColorThreads + threadIdx.x;
  const int64_t f = blockIdx.y;
  p += f * pix * 3;
  out += f * pix * 3;
  if (kVector) {
    if (i >= pix / 4) return;
    uint32_t w[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      w[c] = __ldg(reinterpret_cast<const uint32_t*>(p + c * pix) + i);
    uint32_t o[3] = {0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t bgr = bgr_pixel((w[0] >> (8 * q)) & 0xffu,
                                     (w[1] >> (8 * q)) & 0xffu,
                                     (w[2] >> (8 * q)) & 0xffu);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int k = 3 * q + c;
        o[k >> 2] |= ((bgr >> (8 * c)) & 0xffu) << (8 * (k & 3));
      }
    }
    unsigned int* dst = reinterpret_cast<unsigned int*>(out) + 3 * i;
    __stcs(dst, o[0]);
    __stcs(dst + 1, o[1]);
    __stcs(dst + 2, o[2]);
  } else {
    if (i >= pix) return;
    const uint32_t bgr = bgr_pixel(p[i], p[pix + i], p[2 * pix + i]);
    uint8_t* po = out + 3 * i;
    po[0] = static_cast<uint8_t>(bgr);
    po[1] = static_cast<uint8_t>(bgr >> 8);
    po[2] = static_cast<uint8_t>(bgr >> 16);
  }
}

// A frame's offsets are 32-bit: its BGR bytes (3 pix) must stay under 2^31.
inline bool frame_ok(int frames, int pix) {
  return frames >= 0 && pix > 0 &&
         static_cast<int64_t>(pix) * 3 < (1ll << 31);
}

template <typename Out, bool kGray>
static void launch_luma(const void* x, void* y, int frames, int pix,
                        int vector, int grid, cudaStream_t st) {
  const int64_t in_frame = static_cast<int64_t>(pix) * 3;
  for (int f0 = 0; f0 < frames; f0 += kColorMaxGridY) {
    const dim3 g(static_cast<unsigned>(grid),
                 static_cast<unsigned>(std::min(frames - f0,
                                                kColorMaxGridY)));
    const uint8_t* xf = static_cast<const uint8_t*>(x) + f0 * in_frame;
    Out* yf = static_cast<Out*>(y) + static_cast<int64_t>(f0) * pix;
    if (vector)
      luma_kernel<Out, kGray, true>
          <<<g, kColorThreads, 0, st>>>(xf, yf, pix);
    else
      luma_kernel<Out, kGray, false>
          <<<g, kColorThreads, 0, st>>>(xf, yf, pix);
  }
}

}  // namespace dctsvd

using namespace dctsvd;

// x: u8 BGR frames [frames, pix, 3]; y: f32 Y (gray 0: luma_f32) or u8
// gray (gray 1: bgr_to_gray) [frames, pix]. vector and grid: from
// ops/color_cuda.py::color_plan. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue, and no launch, for a frame of 2^31 bytes or
// more).
extern "C" int dctsvd_luma(const void* x, void* y, int gray, int frames,
                           int pix, int vector, int grid, void* stream) {
  if (!frame_ok(frames, pix) || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gray)
    launch_luma<uint8_t, true>(x, y, frames, pix, vector, grid, st);
  else
    launch_luma<float, false>(x, y, frames, pix, vector, grid, st);
  return static_cast<int>(cudaGetLastError());
}

// y: f32 marked Y [frames, pix]; x: u8 BGR cover [frames, pix, 3]; out:
// u8 BGR stego [frames, pix, 3]. vector and grid: from
// ops/color_cuda.py::color_plan. Returns the cudaError_t of the launch.
extern "C" int dctsvd_replace_luma(const void* y, const void* x, void* out,
                                   int frames, int pix, int vector,
                                   int grid, void* stream) {
  if (!frame_ok(frames, pix) || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t in_frame = static_cast<int64_t>(pix) * 3;
  for (int f0 = 0; f0 < frames; f0 += kColorMaxGridY) {
    const dim3 g(static_cast<unsigned>(grid),
                 static_cast<unsigned>(std::min(frames - f0,
                                                kColorMaxGridY)));
    const float* yf = static_cast<const float*>(y) +
                      static_cast<int64_t>(f0) * pix;
    const uint8_t* xf = static_cast<const uint8_t*>(x) + f0 * in_frame;
    uint8_t* of = static_cast<uint8_t*>(out) + f0 * in_frame;
    if (vector)
      replace_luma_kernel<true>
          <<<g, kColorThreads, 0, st>>>(yf, xf, of, pix);
    else
      replace_luma_kernel<false>
          <<<g, kColorThreads, 0, st>>>(yf, xf, of, pix);
  }
  return static_cast<int>(cudaGetLastError());
}

// K17. inverse 0: x u8 BGR [frames, pix, 3] -> out planar YCrCb [frames,
// 3, pix]; inverse 1: x planar YCrCb -> out BGR. vector and grid: from
// ops/color_cuda.py::color_plan. Returns the cudaError_t of the launch.
extern "C" int dctsvd_ycrcb(const void* x, void* out, int inverse,
                            int frames, int pix, int vector, int grid,
                            void* stream) {
  if (!frame_ok(frames, pix) || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t frame = static_cast<int64_t>(pix) * 3;
  for (int f0 = 0; f0 < frames; f0 += kColorMaxGridY) {
    const dim3 g(static_cast<unsigned>(grid),
                 static_cast<unsigned>(std::min(frames - f0,
                                                kColorMaxGridY)));
    const uint8_t* xf = static_cast<const uint8_t*>(x) + f0 * frame;
    uint8_t* of = static_cast<uint8_t*>(out) + f0 * frame;
    if (inverse && vector)
      ycrcb_bgr_kernel<true><<<g, kColorThreads, 0, st>>>(xf, of, pix);
    else if (inverse)
      ycrcb_bgr_kernel<false><<<g, kColorThreads, 0, st>>>(xf, of, pix);
    else if (vector)
      ycrcb_planes_kernel<true><<<g, kColorThreads, 0, st>>>(xf, of, pix);
    else
      ycrcb_planes_kernel<false><<<g, kColorThreads, 0, st>>>(xf, of, pix);
  }
  return static_cast<int>(cudaGetLastError());
}
