// Block addressing, row loads and stores shared by the blocked watermark
// kernels (wm_kernels.cu: K1, K2, K3; wm_variants.cu: K2r, K1g), the
// spectrum probe (probes.cu), and the cp.async helpers and stage layout of
// the kernels that stage blocks in shared memory (svd8.cu: K4;
// wm_variants.cu: K2r; probes.cu: the spectrum probe's staged read).
//
// The kernels read u8 or f32 planes [P, H, W], or u8/f32 channels-last
// frames [L, H, W, C] (plane p = l*C + c), straight from device memory by
// stride; the row-major block index of plane p is n = by*Wb + bx, and
// neighbouring threads take neighbouring blocks of a block row. K2 and K3
// address a block from its global index (block_addr, 64-bit); K1, K1g, K2r
// and the spectrum probe from (blocks of a frame, frames) with 32-bit
// offsets in a frame (load_row).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "jacobi8.cuh"

namespace dctsvd {

constexpr int kThreads = 128;

struct BlockAddr {
  int64_t base;  // element offset of pixel (0, 0) of the block
  int64_t rs;    // row stride (elements)
  int cs;        // column stride (elements) = channels per pixel
};

__device__ __forceinline__ BlockAddr block_addr(int64_t tid, int64_t n_blk,
                                                int chans, int h, int w) {
  const int wb = w / kB;
  const int64_t p = tid / n_blk;
  const int64_t n = tid - p * n_blk;
  const int64_t by = n / wb, bx = n - by * wb;
  BlockAddr a;
  a.rs = static_cast<int64_t>(w) * chans;
  a.cs = chans;
  a.base = (p / chans) * static_cast<int64_t>(h) * a.rs + (p % chans) +
           by * kB * a.rs + bx * kB * chans;
  return a;
}

// The watermark row of block tid: sws[(p % csws), n, :].
__device__ __forceinline__ const float* sws_row(const float* sws, int csws,
                                                int64_t tid, int64_t n_blk) {
  const int64_t p = tid / n_blk;
  const int64_t n = tid - p * n_blk;
  return sws + ((p % csws) * n_blk + n) * kB;
}

template <typename Out>
__device__ __forceinline__ Out store_val(float y);

template <>
__device__ __forceinline__ float store_val<float>(float y) {
  return y;
}

// wm_pallas.py clip + truncate: clip(y, 0, 255).astype(int32).astype(uint8)
template <>
__device__ __forceinline__ uint8_t store_val<uint8_t>(float y) {
  return static_cast<uint8_t>(static_cast<int>(fminf(fmaxf(y, 0.0f), 255.0f)));
}

// A load that kStream marks as read once (ld.global.cs: evict first), or
// a plain one.
template <bool kStream, typename T>
__device__ __forceinline__ T load_once(const T* __restrict__ p) {
  if constexpr (kStream)
    return __ldcs(p);
  else
    return *p;
}

// Row r of channel ch of an 8x8 pixel block, its 8 pixels as floats; row
// points at channel 0 of the row's first pixel. f32 planes (kC = 1, rows
// 16-byte aligned) read two 16-byte words; every other layout reads each
// pixel by itself at stride kC (c when kC = 0), u8 converted by I2F.
// kStream reads them as streamed once (load_once).
template <int kC, bool kStream = false, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int c,
                                         int ch, float (&px)[kB]) {
  if constexpr (kC == 1 && sizeof(T) == 4) {
    const float4* p = reinterpret_cast<const float4*>(row);
    const float4 a = load_once<kStream>(p), b = load_once<kStream>(p + 1);
    px[0] = a.x; px[1] = a.y; px[2] = a.z; px[3] = a.w;
    px[4] = b.x; px[5] = b.y; px[6] = b.z; px[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kB; ++k)
      px[k] = static_cast<float>(
          load_once<kStream>(row + (kC > 0 ? kC : c) * k + ch));
  }
}

// A 16-byte copy from device to shared memory that bypasses the
// registers (cp.async), and the wait for all of a thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The same copy with an L2 evict-first hint, for bytes read once.
__device__ __forceinline__ void cp_async16_once(void* dst, const void* src) {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(policy));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "l"(policy)
      : "memory");
}

// The float4 slot of 16-byte piece q of block j in a warp's stage of
// blocks with c channels a pixel (K2r, the spectrum probe's staged read):
// a block is 16 c pieces, pixel row r its pieces 2 c r .. 2 c r + 2 c - 1,
// in the input's interleaved order. The XOR by a permutation of j % 8
// keeps q in its aligned group of 8 pieces and sends a quarter-warp's 8
// accesses to 8 distinct bank groups, both where 8 threads each touch
// piece q of their own neighbouring blocks and where they touch the two
// pieces of one row of 4 neighbouring blocks (the copies in and out of
// f32 planes).
__device__ __forceinline__ int warp_slot(int j, int q, int c) {
  return j * 16 * c + (q ^ (((j & 3) << 1) | ((j >> 2) & 1)));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
}

// gridDim.y's limit: frames a launch of a (blocks of a frame, frames) grid.
constexpr int kMaxGridY = 65535;

// A kernel of the (units / kThreads, frames) grid, K1 and K1g: (x, out,
// units, chans, w, full, extra); frame blockIdx.y holds units = n_blk *
// chans threads, and out is f32 [frames * chans, n_blk, 8].
template <typename T>
using FrameGridKernel = void (*)(const T*, float*, int, int, int, int, int);

template <typename T>
inline void launch_frame_grid(FrameGridKernel<T> kernel, const void* x,
                              float* out, int frames, int chans, int h,
                              int w, int full, int extra, cudaStream_t st) {
  const int units = (h / kB) * (w / kB) * chans;
  const int64_t frame_elems = static_cast<int64_t>(units) * kB * kB;
  const int64_t frame_out = static_cast<int64_t>(units) * kB;
  const unsigned gx = static_cast<unsigned>((units + kThreads - 1) /
                                            kThreads);
  for (int f0 = 0; f0 < frames; f0 += kMaxGridY) {
    const unsigned gy = static_cast<unsigned>(std::min(frames - f0,
                                                       kMaxGridY));
    kernel<<<dim3(gx, gy), kThreads, 0, st>>>(
        static_cast<const T*>(x) + f0 * frame_elems, out + f0 * frame_out,
        units, chans, w, full, extra);
  }
}

}  // namespace dctsvd
