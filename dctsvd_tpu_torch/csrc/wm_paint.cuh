// K2 embed_blocks and K3 roundtrip_frames_blocks: the blocked embed and
// embed+verify kernels, templated on k, the number of painted components.
//
// K2 replaces dctsvd_tpu/ops/wm_pallas.py::_make_embed_kernel_delta
// (through embed_plane_blocks(variant='delta')): Jacobi without V, sorted
// raw columns g_j = s_j u_j, then the rank-k V-free paint of
// wm_pallas._paint_cols on the UN-rotated input columns, optional clip and
// truncation to u8, plus the sorted cover spectrum sc.
// K3 replaces wm_pallas.py::_make_embed_verify_kernel (through
// roundtrip_frames_blocks): K2's paint with u8 output, then K1 on the
// rounded block while it is still on chip, giving (stego, sc, s_cw).
// K2 and K3 call one paint function (paint_block), as the Pallas kernels
// share _paint_cols, so the two cannot drift apart.
// Plain twins: dctsvd_tpu_torch/ops/wm_cuda.py::embed_blocks_plain and
// ::roundtrip_frames_blocks_plain.
//
// What bounds them on the H100: registers, through the latency of the
// Jacobi, and the byte accesses to channels-last frames. Each pair
// rotation is a dependent chain (a dot of two columns, two rsqrt, the
// column update) that only other warps hide, and a thread holding a whole
// block holds 64 floats and 8 norms through it: K1 needs 96 registers for
// that (5 blocks of 128 threads per SM). With k a run-time int the paint
// also kept all of g, 8x8 projections and 8 coefficients live, and the
// first load's 64 pixel addresses were shared with the paint's re-reads
// and stores, so K2 and K3 took 251-255 registers (2 blocks per SM).
//
// What the design does:
// - k is a template parameter, as it is a closure constant of the Pallas
//   kernels, so after the sort only g[0..K) and K coefficients stay live;
//   each projection V[j][c] is computed again in the second pass instead
//   of being held.
// - The input block is staged in shared memory as it is loaded (64 / L
//   values per lane, stage[i * 8 + c][thread], each lane reading back only
//   its own, so no barrier), and the paint reads it from there; the store
//   addresses come from an opaque copy of the block's offset, so no pixel
//   address lives across the Jacobi. K3 overwrites the stage with its
//   rounded bytes as it paints and runs the second Jacobi on float(u8) of
//   them, as K1 does on the stego.
// - A block may be split over L = 2 neighbouring lanes (jacobi8.cuh's
//   dot_cols): lane `half` holds rows half, half + 2, half + 4, half + 6
//   of every column, 32 floats of g, and a column dot ends in one
//   __shfl_xor_sync in sum_rows8's own halving order, so both lanes hold
//   the same bits. Both compute every angle, norm, sort decision and paint
//   coefficient from those dots, and each updates, paints and stores its
//   own rows: about a quarter more operations per block, half of g.
// - In channels-last frames the C channels of one pixel block go to
//   neighbouring lanes (plane_block), so a warp's bytes of one pixel lie in
//   one span instead of C.
// - __launch_bounds__ sets the lanes' registers, and the settings differ
//   by k (embed_lanes, kEmbedMinBlocks, kRoundtripLanes,
//   roundtrip_min_blocks, as measured in PERF.md): K2 takes 4 blocks of
//   128 threads per SM (128 registers) on 1 lane a block to k = 5 and on 2
//   from k = 6, where one lane spilled up to 1 KB; K3 takes 2 lanes at 8
//   blocks (64 registers, 1024 lanes per SM) to k = 6 and at 6 (80) from
//   k = 7.
// Every output value is computed by the twins' operations in the twins'
// order (-fmad=false, rsqrtf/sqrtf, the clip-and-truncate store), so K2
// and K3 equal their twins bit for bit, and K3's s_cw equals K1 on its
// stego. chip_smoke.py prints each instance's registers and spills (`nvcc
// -Xptxas -v`).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "blocks.cuh"
#include "jacobi8.cuh"
#include "wm_paint_launch.cuh"

namespace dctsvd {

// Lanes per 8x8 block of K2 and of K3, and the least CTAs of kThreads
// lanes per SM that __launch_bounds__ asks for, at k: the settings
// measured fastest at each k (PERF.md).
__host__ __device__ constexpr int embed_lanes(int k) { return k <= 5 ? 1 : 2; }
constexpr int kEmbedMinBlocks = 4;
constexpr int kRoundtripLanes = 2;
__host__ __device__ constexpr int roundtrip_min_blocks(int k) {
  return k <= 6 ? 8 : 6;
}

// Launch order t of the 8x8 block this lane works on (L lanes a block).
template <int L>
__device__ __forceinline__ int64_t block_of_lane() {
  return static_cast<int64_t>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
}

// Launch order t -> the plane-major block index p * n_blk + n: in
// channels-last frames the C channels of one pixel block go to
// neighbouring blocks of the launch, so that a warp's bytes of one pixel
// lie in one span and not C spans 8 C bytes apart.
__device__ __forceinline__ int64_t plane_block(int64_t t, int64_t n_blk,
                                               int chans) {
  const int64_t rest = t / chans;
  const int64_t l = rest / n_blk;
  return (l * chans + (t - rest * chans)) * n_blk + (rest - l * n_blk);
}

// Loads the lane's rows of the block (lane `half` holds rows half + L i,
// i < 8 / L, of every column) into g, and stages them as they are in
// shared memory, stage[i * 8 + c][thread], for the paint to read back.
template <int L, typename T>
__device__ __forceinline__ void load_block(const T* __restrict__ x,
                                           const BlockAddr& a, int half,
                                           T (&stage)[kB * kB / L][kThreads],
                                           float (&g)[kB][kB / L]) {
#pragma unroll
  for (int c = 0; c < kB; ++c) {
#pragma unroll
    for (int i = 0; i < kB / L; ++i) {
      const T v = x[a.base + (half + L * i) * a.rs + c * a.cs];
      stage[i * kB + c][threadIdx.x] = v;
      g[c][i] = static_cast<float>(v);
    }
  }
}

// v, which the compiler can no longer see through: addresses computed from
// it are computed where they are used, instead of being shared with the
// first load's and held in registers across the Jacobi.
__device__ __forceinline__ int64_t opaque(int64_t v) {
  asm volatile("" : "+l"(v));
  return v;
}

// wm_pallas._paint_cols on one block: with the sorted raw columns g and
// singular values s, V[j][c] = (X^T g_j)_c from the UN-rotated input
// columns (read back from the stage; each V[j][c] is computed in the
// first pass for the norms and again in the second, rather than held in
// 8 K registers), then
//   y_c = x_c + sum_{j<K} g_j (sw_j rsqrt(|X^T g_j|^2 + s0^2 s_j^2 1e-10
//                                         + 1e-30) rsqrt(s_j^2 + 1e-30)
//                              V[j][c]).
// Calls emit(i, c, y) once for each of the lane's pixels (row half + L i),
// column by column, after column c of the stage has been read for the
// last time. Reads only g[0..K) and s[0..K).
template <int K, int L, typename T, typename Emit>
__device__ __forceinline__ void paint_block(
    const T (&stage)[kB * kB / L][kThreads], const float (&g)[kB][kB / L],
    const float (&s)[kB], const float* __restrict__ sw, Emit emit) {
  float nrm2[K];
#pragma unroll
  for (int c = 0; c < kB; ++c) {
    float xc[kB / L];
#pragma unroll
    for (int i = 0; i < kB / L; ++i)
      xc[i] = static_cast<float>(stage[i * kB + c][threadIdx.x]);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float v = dot_cols<L>(xc, g[j]);
      if (c == 0)
        nrm2[j] = v * v;
      else
        nrm2[j] = nrm2[j] + v * v;
    }
  }
  const float s0sq = s[0] * s[0];
  float coef[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float nj = s[j] * s[j];
    coef[j] = sw[j] * rsqrtf(nrm2[j] + s0sq * nj * 1e-10f + 1e-30f) *
              rsqrtf(nj + 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < kB; ++c) {
    float xc[kB / L];
#pragma unroll
    for (int i = 0; i < kB / L; ++i)
      xc[i] = static_cast<float>(stage[i * kB + c][threadIdx.x]);
    float wc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) wc[j] = coef[j] * dot_cols<L>(xc, g[j]);
#pragma unroll
    for (int i = 0; i < kB / L; ++i) {
      float acc = xc[i];
#pragma unroll
      for (int j = 0; j < K; ++j) acc = acc + g[j][i] * wc[j];
      emit(i, c, acc);
    }
  }
}

template <typename T, typename Out, int K>
__global__ void __launch_bounds__(kThreads, kEmbedMinBlocks)
    embed_kernel(const T* __restrict__ x, const float* __restrict__ sws,
                 int csws, Out* __restrict__ y, float* __restrict__ sc,
                 int64_t total, int64_t n_blk, int chans, int h, int w,
                 int full, int extra) {
  constexpr int L = embed_lanes(K), R = kB / L;
  __shared__ T stage[R * kB][kThreads];
  const int64_t t = block_of_lane<L>();
  const int half = threadIdx.x % L;
  if (t >= total) return;   // both lanes of a block, so no shuffle waits
  const int64_t tid = plane_block(t, n_blk, chans);
  const BlockAddr a = block_addr(tid, n_blk, chans, h, w);
  float g[kB][R], unused[kB][R], s[kB];
  load_block<L>(x, a, half, stage, g);
  jacobi8<false, false, L>(g, unused, full, extra, s);
  sort8<1, L>(s, g, unused);

  float* o = sc + tid * kB + half * R;
#pragma unroll
  for (int j = 0; j < R; ++j) o[j] = s[half * R + j];

  Out* yb = y + opaque(a.base);
  paint_block<K, L>(stage, g, s, sws_row(sws, csws, tid, n_blk),
                    [&](int i, int c, float acc) {
                      yb[(half + L * i) * a.rs + c * a.cs] =
                          store_val<Out>(acc);
                    });
}

template <int K>
__global__ void __launch_bounds__(kThreads, roundtrip_min_blocks(K))
    roundtrip_kernel(const uint8_t* __restrict__ x,
                     const float* __restrict__ sws, int csws,
                     uint8_t* __restrict__ y, float* __restrict__ sc,
                     float* __restrict__ scw, int64_t total, int64_t n_blk,
                     int chans, int h, int w, int full, int extra) {
  constexpr int L = kRoundtripLanes, R = kB / L;
  // the input block, then, pixel by pixel, the rounded stego block
  __shared__ uint8_t stage[R * kB][kThreads];
  const int64_t t = block_of_lane<L>();
  const int half = threadIdx.x % L;
  if (t >= total) return;
  const int64_t tid = plane_block(t, n_blk, chans);
  const BlockAddr a = block_addr(tid, n_blk, chans, h, w);
  float g[kB][R], unused[kB][R], s[kB];
  load_block<L>(x, a, half, stage, g);
  jacobi8<false, false, L>(g, unused, full, extra, s);
  sort8<1, L>(s, g, unused);

  float* o = sc + tid * kB + half * R;
#pragma unroll
  for (int j = 0; j < R; ++j) o[j] = s[half * R + j];

  uint8_t* yb = y + opaque(a.base);
  paint_block<K, L>(stage, g, s, sws_row(sws, csws, tid, n_blk),
                    [&](int i, int c, float acc) {
                      const uint8_t b = store_val<uint8_t>(acc);
                      yb[(half + L * i) * a.rs + c * a.cs] = b;
                      stage[i * kB + c][threadIdx.x] = b;
                    });

  // the verification spectrum: K1 on the rounded bytes
#pragma unroll
  for (int c = 0; c < kB; ++c) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      g[c][i] = static_cast<float>(stage[i * kB + c][threadIdx.x]);
  }
  jacobi8<false, false, L>(g, unused, full, extra, s);
  sort8<0, L>(s, unused, unused);
  float* ow = scw + tid * kB + half * R;
#pragma unroll
  for (int j = 0; j < R; ++j) ow[j] = s[half * R + j];
}

// CTAs of kThreads lanes for `total` blocks of L lanes each.
template <int L>
unsigned paint_grid(int64_t total) {
  constexpr int per_cta = kThreads / L;
  return static_cast<unsigned>((total + per_cta - 1) / per_cta);
}

template <typename T, typename Out, int K>
void launch_embed(const PaintLaunch& p) {
  constexpr int L = embed_lanes(K);
  embed_kernel<T, Out, K>
      <<<paint_grid<L>(p.total), kThreads, 0, p.stream>>>(
          static_cast<const T*>(p.x), p.sws, p.csws, static_cast<Out*>(p.y),
          p.sc, p.total, p.n_blk, p.chans, p.h, p.w, p.full, p.extra);
}

template <int K>
void launch_roundtrip(const PaintLaunch& p) {
  roundtrip_kernel<K>
      <<<paint_grid<kRoundtripLanes>(p.total), kThreads, 0, p.stream>>>(
          static_cast<const uint8_t*>(p.x), p.sws, p.csws,
          static_cast<uint8_t*>(p.y), p.sc, p.scw, p.total, p.n_blk,
          p.chans, p.h, p.w, p.full, p.extra);
}

}  // namespace dctsvd

// The K2 instances (every input and output type) and the K3 instance of
// one k.
#define DCTSVD_PAINT_INSTANCES(K)                                          \
  template void dctsvd::launch_embed<uint8_t, uint8_t, K>(                \
      const dctsvd::PaintLaunch&);                                         \
  template void dctsvd::launch_embed<uint8_t, float, K>(                  \
      const dctsvd::PaintLaunch&);                                         \
  template void dctsvd::launch_embed<float, uint8_t, K>(                  \
      const dctsvd::PaintLaunch&);                                         \
  template void dctsvd::launch_embed<float, float, K>(                    \
      const dctsvd::PaintLaunch&);                                         \
  template void dctsvd::launch_roundtrip<K>(const dctsvd::PaintLaunch&);
