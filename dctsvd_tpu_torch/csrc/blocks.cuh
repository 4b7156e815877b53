// Block addressing and stores shared by the blocked watermark kernels
// (wm_kernels.cu: K1, K2, K3; wm_variants.cu: K2r, K1g) and the spectrum
// probe (probes.cu).
//
// One thread per 8x8 block. The kernels read u8 or f32 planes [P, H, W],
// or u8/f32 channels-last frames [L, H, W, C] (plane p = l*C + c), straight
// from device memory by stride; the row-major block index of plane p is
// n = by*Wb + bx, and neighbouring threads take neighbouring blocks of a
// block row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
__device__ __forceinline__ void load_col(const T* __restrict__ x,
                                         const BlockAddr& a, int c,
                                         float (&col)[kB]) {
#pragma unroll
  for (int r = 0; r < kB; ++r)
    col[r] = static_cast<float>(x[a.base + r * a.rs + c * a.cs]);
}

// bf16 holds 0..255 exactly, so a bf16 view of u8 pixels loads the same
// floats as the u8 one.
__device__ __forceinline__ void load_col(const __nv_bfloat16* __restrict__ x,
                                         const BlockAddr& a, int c,
                                         float (&col)[kB]) {
#pragma unroll
  for (int r = 0; r < kB; ++r)
    col[r] = __bfloat162float(x[a.base + r * a.rs + c * a.cs]);
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

inline unsigned grid_for(int64_t total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

}  // namespace dctsvd
