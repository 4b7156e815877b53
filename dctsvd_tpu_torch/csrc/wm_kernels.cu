// K1 spectrum_blocks, K2 embed_blocks and K3 roundtrip_frames_blocks: the
// blocked watermark kernels of the serving path.
//
// K1 replaces dctsvd_tpu/ops/wm_pallas.py::_make_spectrum_kernel (through
// spectrum_plane_blocks(method='onesided')): values-only one-sided Jacobi
// of every 8x8 pixel block at the replayed schedule, sorted descending.
// K2 replaces wm_pallas.py::_make_embed_kernel_delta (through
// embed_plane_blocks(variant='delta')): Jacobi without V, sorted raw
// columns g_j = s_j u_j, then the rank-k V-free paint of
// wm_pallas._paint_cols on the UN-rotated input columns, optional clip and
// truncation to u8, plus the sorted cover spectrum sc.
// K3 replaces wm_pallas.py::_make_embed_verify_kernel (through
// roundtrip_frames_blocks): K2's paint with u8 output, then K1 on the
// rounded block while it is still on chip, giving (stego, sc, s_cw).
// K2 and K3 call one paint function (paint_block), as the Pallas kernels
// share _paint_cols, so the two cannot drift apart.
// Plain twins: dctsvd_tpu_torch/ops/wm_cuda.py::*_plain.
//
// Design: one thread per block, the block's 64 columns-of-rows in
// registers (jacobi8.cuh), addressed by stride (blocks.cuh), so there is
// no view transpose; K2 and K3 write their output in the input's layout.
// K2 keeps only g in registers through the sweeps and re-reads the input
// block (from L1/L2) for the paint, which needs the un-rotated columns.
// K3's contract is that s_cw equals K1 on the returned stego bit for bit:
// its second Jacobi starts from float(u8) of the rounded bytes, exactly as
// K1's load_col does, and runs the same code. The rounded block is staged
// as bytes in shared memory (64 B per thread, 8 KiB per 128-thread block,
// each thread reading back only its own bytes, so no barrier): holding it
// as 64 more floats would have to live beside g and the paint's
// coefficients at K2's 254 registers, and re-reading the stego from
// global memory would depend on the load not taking the non-coherent
// read-only path. Once the paint has finished, g, vv and coef are dead and
// the second Jacobi reuses g's registers.
//
// What bounds them on the H100: registers per thread (the 64-float block
// plus 8 norms through 28 unrolled rotations of ~30 flops each; K2 and K3
// also hold up to 8x8 paint coefficients), which caps occupancy, and for
// channels-last frames the uncoalesced 3-byte-stride u8 reads. With
// -fmad=false, ptxas gives K1 96 registers, K2 254-255 (at the 255 cap)
// and K3 251 plus its 8 KiB of shared memory, all without spills; K2 and
// K3 therefore run at most 2 blocks of 128 threads per SM, and K3's second
// Jacobi runs at that occupancy where K1 alone runs 5 blocks, which makes
// K3 slower than K2 and K1 apart. Staging a band of blocks through shared
// memory for coalesced loads, and cutting K2's and K3's registers, is
// later work. chip_smoke.py prints the counts of each build
// (`nvcc -Xptxas -v`).

#include <cuda_runtime.h>

#include <cstdint>

#include "blocks.cuh"
#include "jacobi8.cuh"

namespace dctsvd {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    spectrum_kernel(const T* __restrict__ x, float* __restrict__ out,
                    int64_t total, int64_t n_blk, int chans, int h, int w,
                    int full, int extra) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (tid >= total) return;
  const BlockAddr a = block_addr(tid, n_blk, chans, h, w);
  float g[kB][kB], unused[kB][kB], s[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) load_col(x, a, c, g[c]);
  jacobi8<false>(g, unused, full, extra, s);
  sort8<0>(s, unused, unused);
  float* o = out + tid * kB;
#pragma unroll
  for (int j = 0; j < kB; ++j) o[j] = s[j];
}

// wm_pallas._paint_cols on one block: with the sorted raw columns g and
// singular values s, V[j][c] = (X^T g_j)_c from the UN-rotated input
// columns (re-read from x), then
//   y_c = x_c + sum_{j<k} g_j (sw_j rsqrt(|X^T g_j|^2 + s0^2 s_j^2 1e-10
//                                         + 1e-30) rsqrt(s_j^2 + 1e-30)
//                              V[j][c]).
// Calls emit(r, c, y) once for each pixel, column by column.
template <typename T, typename Emit>
__device__ __forceinline__ void paint_block(const T* __restrict__ x,
                                            const BlockAddr& a,
                                            const float (&g)[kB][kB],
                                            const float (&s)[kB],
                                            const float* __restrict__ sw,
                                            int k, Emit emit) {
  float vv[kB][kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) {
    float xc[kB];
    load_col(x, a, c, xc);
#pragma unroll
    for (int j = 0; j < kB; ++j)
      if (j < k) vv[j][c] = dot8(xc, g[j]);
  }
  const float s0sq = s[0] * s[0];
  float coef[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    if (j < k) {
      const float nj = s[j] * s[j];
      float nrm2 = vv[j][0] * vv[j][0];
#pragma unroll
      for (int c = 1; c < kB; ++c) nrm2 = nrm2 + vv[j][c] * vv[j][c];
      coef[j] = sw[j] * rsqrtf(nrm2 + s0sq * nj * 1e-10f + 1e-30f) *
                rsqrtf(nj + 1e-30f);
    }
  }
#pragma unroll
  for (int c = 0; c < kB; ++c) {
    float xc[kB];
    load_col(x, a, c, xc);
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      float acc = xc[r];
#pragma unroll
      for (int j = 0; j < kB; ++j)
        if (j < k) acc = acc + g[j][r] * (coef[j] * vv[j][c]);
      emit(r, c, acc);
    }
  }
}

template <typename T, typename Out>
__global__ void __launch_bounds__(kThreads)
    embed_kernel(const T* __restrict__ x, const float* __restrict__ sws,
                 int csws, Out* __restrict__ y, float* __restrict__ sc,
                 int64_t total, int64_t n_blk, int chans, int h, int w,
                 int full, int extra, int k) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (tid >= total) return;
  const BlockAddr a = block_addr(tid, n_blk, chans, h, w);
  float g[kB][kB], unused[kB][kB], s[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) load_col(x, a, c, g[c]);
  jacobi8<false>(g, unused, full, extra, s);
  sort8<1>(s, g, unused);

  float* o = sc + tid * kB;
#pragma unroll
  for (int j = 0; j < kB; ++j) o[j] = s[j];

  paint_block(x, a, g, s, sws_row(sws, csws, tid, n_blk), k,
              [&](int r, int c, float acc) {
                y[a.base + r * a.rs + c * a.cs] = store_val<Out>(acc);
              });
}

__global__ void __launch_bounds__(kThreads)
    roundtrip_kernel(const uint8_t* __restrict__ x,
                     const float* __restrict__ sws, int csws,
                     uint8_t* __restrict__ y, float* __restrict__ sc,
                     float* __restrict__ scw, int64_t total, int64_t n_blk,
                     int chans, int h, int w, int full, int extra, int k) {
  // stage[r * 8 + c][thread]: neighbouring threads on neighbouring bytes
  __shared__ uint8_t stage[kB * kB][kThreads];
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (tid >= total) return;
  const BlockAddr a = block_addr(tid, n_blk, chans, h, w);
  float g[kB][kB], unused[kB][kB], s[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) load_col(x, a, c, g[c]);
  jacobi8<false>(g, unused, full, extra, s);
  sort8<1>(s, g, unused);

  float* o = sc + tid * kB;
#pragma unroll
  for (int j = 0; j < kB; ++j) o[j] = s[j];

  paint_block(x, a, g, s, sws_row(sws, csws, tid, n_blk), k,
              [&](int r, int c, float acc) {
                const uint8_t b = store_val<uint8_t>(acc);
                y[a.base + r * a.rs + c * a.cs] = b;
                stage[r * kB + c][threadIdx.x] = b;
              });

  // the verification spectrum: K1 on the rounded bytes
#pragma unroll
  for (int c = 0; c < kB; ++c) {
#pragma unroll
    for (int r = 0; r < kB; ++r)
      g[c][r] = static_cast<float>(stage[r * kB + c][threadIdx.x]);
  }
  jacobi8<false>(g, unused, full, extra, s);
  sort8<0>(s, unused, unused);
  float* ow = scw + tid * kB;
#pragma unroll
  for (int j = 0; j < kB; ++j) ow[j] = s[j];
}

}  // namespace dctsvd

using dctsvd::embed_kernel;
using dctsvd::grid_for;
using dctsvd::kThreads;
using dctsvd::roundtrip_kernel;
using dctsvd::spectrum_kernel;

// x: u8 (x_is_u8) or f32; out: f32 [P, N, 8]. Returns the cudaError_t of
// the launch.
extern "C" int dctsvd_spectrum_blocks(const void* x, int x_is_u8, void* out,
                                      int planes, int chans, int h, int w,
                                      int full, int extra, void* stream) {
  const int64_t n_blk = static_cast<int64_t>(h / 8) * (w / 8);
  const int64_t total = static_cast<int64_t>(planes) * n_blk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (x_is_u8)
    spectrum_kernel<uint8_t><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), o, total, n_blk, chans, h, w, full,
        extra);
  else
    spectrum_kernel<float><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(x), o, total, n_blk, chans, h, w, full,
        extra);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static void launch_embed(const T* x, const float* sws, int csws, void* y,
                         int y_is_u8, float* sc, int64_t total, int64_t n_blk,
                         int chans, int h, int w, int full, int extra, int k,
                         cudaStream_t st) {
  if (y_is_u8)
    embed_kernel<T, uint8_t><<<grid_for(total), kThreads, 0, st>>>(
        x, sws, csws, static_cast<uint8_t*>(y), sc, total, n_blk, chans, h,
        w, full, extra, k);
  else
    embed_kernel<T, float><<<grid_for(total), kThreads, 0, st>>>(
        x, sws, csws, static_cast<float*>(y), sc, total, n_blk, chans, h, w,
        full, extra, k);
}

// x: u8 or f32 in; sws: f32 [csws, N, 8]; y: u8 (y_is_u8) or f32 in x's
// layout; sc: f32 [P, N, 8]. Returns the cudaError_t of the launch.
extern "C" int dctsvd_embed_blocks(const void* x, int x_is_u8,
                                   const void* sws, int csws, void* y,
                                   int y_is_u8, void* sc, int planes,
                                   int chans, int h, int w, int full,
                                   int extra, int k, void* stream) {
  const int64_t n_blk = static_cast<int64_t>(h / 8) * (w / 8);
  const int64_t total = static_cast<int64_t>(planes) * n_blk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(sws);
  float* o = static_cast<float*>(sc);
  if (x_is_u8)
    launch_embed(static_cast<const uint8_t*>(x), s, csws, y, y_is_u8, o,
                 total, n_blk, chans, h, w, full, extra, k, st);
  else
    launch_embed(static_cast<const float*>(x), s, csws, y, y_is_u8, o, total,
                 n_blk, chans, h, w, full, extra, k, st);
  return static_cast<int>(cudaGetLastError());
}

// x: u8 channels-last frames [L, H, W, C]; sws: f32 [csws, N, 8]; y: u8 in
// x's layout; sc, scw: f32 [P, N, 8]. Returns the cudaError_t of the
// launch.
extern "C" int dctsvd_roundtrip_blocks(const void* x, const void* sws,
                                       int csws, void* y, void* sc,
                                       void* scw, int planes, int chans,
                                       int h, int w, int full, int extra,
                                       int k, void* stream) {
  const int64_t n_blk = static_cast<int64_t>(h / 8) * (w / 8);
  const int64_t total = static_cast<int64_t>(planes) * n_blk;
  roundtrip_kernel<<<grid_for(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(sws), csws,
      static_cast<uint8_t*>(y), static_cast<float*>(sc),
      static_cast<float*>(scw), total, n_blk, chans, h, w, full, extra, k);
  return static_cast<int>(cudaGetLastError());
}
