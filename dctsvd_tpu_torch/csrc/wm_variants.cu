// K2r embed_blocks_recon and K1g spectrum_blocks_gram: the other two
// kernel bodies behind the blocked embed and spectrum wrappers, reached
// through embed_blocks(variant='recon') and spectrum_blocks(method='gram').
//
// K2r replaces dctsvd_tpu/ops/wm_pallas.py::_make_embed_kernel (through
// embed_plane_blocks(variant='recon')): Jacobi with U and V on the pixel
// block, u_j = g_j / max(s_j, 1e-30), u, s and v sorted together, then
// column k of the marked block is sum_j u_j (S'_j V[k][j]) with
// S' = s + sws, summed over j = 0..7 in order; f32 output plus sc.
// K1g replaces wm_pallas.py::_make_spectrum_gram_kernel (through
// spectrum_plane_blocks(method='gram')): the 36 entries a_ij = x_i . x_j
// of the Gram matrix X^T X, two-sided Jacobi on them with the same cyclic
// pair prefix and rotation() as K0 (a_pq set to 0 exactly), then
// sqrt(max(a_ii, 0)), sorted.
// Plain twins: dctsvd_tpu_torch/ops/wm_cuda.py::embed_blocks_recon_plain
// and ::spectrum_blocks_gram_plain. Every value is computed by the twin's
// operations in the twin's order (-fmad=false), so both kernels equal
// their twins run on the card bit for bit.
//
// What bounded K2r: its memory path, as K4's did. One thread a block
// addressed by 64-bit divisions (blocks.cuh block_addr), and neighbouring
// threads read and wrote blocks 32 bytes apart (f32 planes), so each of a
// thread's 64 loads and 64 f32 stores was a warp access over 32 sectors;
// the f32 output is half of its bytes. K1g was K1's first form: 64-bit
// block_addr, c^2's rsqrt with the subnormal fix-up.
// What the design does: K1's (blocks of a frame, frames) grid with 32-bit
// offsets in a frame (the host checks that a frame has fewer than 2^31
// elements), the channel count a template constant for 1 and 3 (any other
// count in a generic instance; K2r takes up to 32). Each K2r warp takes
// 32 / C whole pixel blocks, the C channels of a block on neighbouring
// lanes (C = 3: 10 blocks, lanes 30 and 31 idle), and stages them in 8 KiB
// of shared memory of its own (K4's warp stage): f32 planes come in by
// cp.async as 16-byte pieces of whole pixel rows, u8 pixels as K1 reads
// them (a byte a load, channels on neighbouring lanes); each thread writes
// its reconstructed 64 floats to the stage, and the warp stores whole
// pixel rows of its blocks as 16-byte pieces, each store filling its
// sectors. Only __syncwarp orders the stage, so no barrier spans warps.
// The pixels are read once and the output written once: loads carry an L2
// evict-first hint and the stores are streaming (st.global.cs), because
// with plain stores the output's dirty lines filled L2 and the next wave's
// loads waited behind their write-back. sws and sc move as two float4s a
// thread; c^2's rsqrt skips the subnormal fix-up (rotation's kNormalIc).
// What bounds it now: the issue of its instructions (the compute alone is
// most of its time) at 12 warps an SM: g and V are 128 floats, so 168
// registers with a few spilled at 6 CTAs of 2 warps, the L1 carveout all
// shared memory so that the stages never bound the CTAs. Forms measured
// slower (PERF.md): a persistent grid prefetching each warp's next group
// into a second stage (its loop spilled at 168 registers), 8 warps an SM
// (255 registers), the sort as a permutation through the stage; CTAs of
// 1 or 4 warps changed nothing.
// chip_smoke.py prints the registers of each instance (`nvcc -Xptxas -v`)
// and `--jacobi-times` their SASS mix and rate against T3's.
//
// K1g takes K1's grid, row loads (load_row: 16-byte rows for f32 planes,
// read once) and rotation; it is bound by issue, as K1 is. After the Gram
// matrix is formed only its 36 scalars stay live: 80 registers give 6
// CTAs an SM without spills (7 and 8 spilled and ran slower). Forming the
// Gram matrix row by row would keep fewer values live but change the
// summation order of the twin's _sum_rows(x_i * x_j).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "blocks.cuh"
#include "jacobi8.cuh"

namespace dctsvd {

// K2r: warps a CTA, and the least CTAs an SM its __launch_bounds__ asks
// for (168 registers).
constexpr int kReconWarps = 2;
constexpr int kReconThreads = kReconWarps * 32;
constexpr int kReconMinBlocks = 6;
// K1g: the least CTAs of kThreads threads an SM (80 registers).
constexpr int kGramMinBlocks = 6;

// Grid (warps of a frame / kReconWarps, frames); frame frame0 + blockIdx.y
// is [H, W, c] (c = 1: a plane) and holds n_blk pixel blocks, plane
// frame * c + ch takes sws[plane % csws].
template <typename T, int kC>
__global__ void __launch_bounds__(kReconThreads, kReconMinBlocks)
    embed_recon_kernel(const T* __restrict__ x, const float* __restrict__ sws,
                       int csws, float* __restrict__ y,
                       float* __restrict__ sc, int n_blk, int chans, int w,
                       int frame0, int full, int extra) {
  __shared__ __align__(16) float4 stage[kReconWarps][32 * 16];
  const int c = kC > 0 ? kC : chans;
  const int nb = 32 / c;  // pixel blocks a warp
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = (blockIdx.x * kReconWarps + warp) * nb;
  if (n0 >= n_blk) return;  // the whole warp
  const int nw = min(nb, n_blk - n0);  // the warp's blocks in the frame
  const int j = lane / c, ch = lane - j * c;
  const bool live = j < nw;
  const int n = live ? n0 + j : n0;  // idle lanes compute on block n0
  const int wb = w / kB, rs = w * c;
  const int by = n / wb, bx = n - by * wb;
  const int base = by * kB * rs + bx * kB * c;  // pixel (0, 0), channel 0
  const int64_t frame = static_cast<int64_t>(frame0) + blockIdx.y;
  const int64_t off = frame * n_blk * (kB * kB) * c;
  x += off;
  y += off;
  float4* st = stage[warp];
  float g[kB][kB], v[kB][kB], s[kB];
  if constexpr (kC == 1 && sizeof(T) == 4) {
    // piece 32 m + lane: row m / 2 of block lane / 2 + 16 (m % 2), half
    // lane % 2; blocks past the frame's end are zeros
    const int jl = lane / 2, half = lane % 2;
    const int b_lo = __shfl_sync(~0u, base, jl);
    const int b_hi = __shfl_sync(~0u, base, jl + 16);
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int jj = jl + 16 * (m % 2), r = m / 2;
      float4* dst = st + warp_slot(jj, 2 * r + half, 1);
      if (jj < nw)
        cp_async16_once(dst, x + (m % 2 ? b_hi : b_lo) + r * w + 4 * half);
      else
        *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    cp_async_wait_all();
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      const float4 lo = st[warp_slot(lane, 2 * r, 1)];
      const float4 hi = st[warp_slot(lane, 2 * r + 1, 1)];
      g[0][r] = lo.x; g[1][r] = lo.y; g[2][r] = lo.z; g[3][r] = lo.w;
      g[4][r] = hi.x; g[5][r] = hi.y; g[6][r] = hi.z; g[7][r] = hi.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      float px[kB];
      load_row<kC, true>(x + base + r * rs, c, ch, px);
#pragma unroll
      for (int k = 0; k < kB; ++k) g[k][r] = px[k];
    }
  }
#pragma unroll
  for (int i = 0; i < kB; ++i) {
#pragma unroll
    for (int r = 0; r < kB; ++r) v[i][r] = (i == r) ? 1.0f : 0.0f;
  }
  jacobi8<true, false, 1, true>(g, v, full, extra, s);
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const float d = fmaxf(s[i], 1e-30f);
#pragma unroll
    for (int r = 0; r < kB; ++r) g[i][r] = g[i][r] / d;
  }
  sort8<2>(s, g, v);

  const int64_t plane = frame * c + ch;
  if (live) {
    float4* o = reinterpret_cast<float4*>(sc + (plane * n_blk + n) * kB);
    __stcs(o, make_float4(s[0], s[1], s[2], s[3]));
    __stcs(o + 1, make_float4(s[4], s[5], s[6], s[7]));
  }
  const float4* sw4 = reinterpret_cast<const float4*>(
      sws + ((plane % csws) * n_blk + n) * kB);
  const float4 swa = sw4[0], swb = sw4[1];
  const float sw[kB] = {swa.x, swa.y, swa.z, swa.w,
                        swb.x, swb.y, swb.z, swb.w};
  // V[k][j] scaled by S'_j in place, then pixel (r, k) of
  // C' = U diag(S') V^T is sum_j u_j[r] (S'_j V[k][j])
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const float s2 = s[i] + sw[i];
#pragma unroll
    for (int k = 0; k < kB; ++k) v[i][k] = s2 * v[i][k];
  }
  float* stf = reinterpret_cast<float*>(st);
#pragma unroll
  for (int r = 0; r < kB; ++r) {
    float yr[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      float acc = g[0][r] * v[0][k];
#pragma unroll
      for (int i = 1; i < kB; ++i) acc = acc + g[i][r] * v[i][k];
      yr[k] = acc;
    }
    if (!live) continue;
    if constexpr (kC == 1) {
      st[warp_slot(lane, 2 * r, 1)] =
          make_float4(yr[0], yr[1], yr[2], yr[3]);
      st[warp_slot(lane, 2 * r + 1, 1)] =
          make_float4(yr[4], yr[5], yr[6], yr[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int e = (r * kB + k) * c + ch;  // float e of block j
        stf[4 * warp_slot(j, e / 4, c) + e % 4] = yr[k];
      }
    }
  }
  __syncwarp();
  // piece 32 m + lane of the warp's pixel rows: row r, block jj, piece p
  const int row_pieces = nb * 2 * c;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int gi = lane + 32 * m;
    const int r = gi / row_pieces, k = gi - r * row_pieces;
    const int jj = k / (2 * c), p = k - jj * 2 * c;
    const int bj = __shfl_sync(~0u, base, jj * c);
    if (r < kB && jj < nw)
      __stcs(reinterpret_cast<float4*>(y + bj + r * rs) + p,
             st[warp_slot(jj, r * 2 * c + p, c)]);
  }
}

// Index of the Gram entry (i, j), i <= j, in the row-major upper triangle.
__host__ __device__ constexpr int gram_idx(int i, int j) {
  return i <= j ? i * kB - i * (i - 1) / 2 + (j - i)
                : j * kB - j * (j - 1) / 2 + (i - j);
}
constexpr int kGram = kB * (kB + 1) / 2;

__device__ __forceinline__ void gram_rotate(float (&a)[kGram], int p,
                                            int q) {
  const float app = a[gram_idx(p, p)], aqq = a[gram_idx(q, q)];
  const float apq = a[gram_idx(p, q)];
  float c, s, t;
  rotation<true>(app, aqq, apq, c, s, t);
#pragma unroll
  for (int r = 0; r < kB; ++r) {
    if (r == p || r == q) continue;
    const int kp = gram_idx(r, p), kq = gram_idx(r, q);
    const float arp = a[kp], arq = a[kq];
    a[kp] = c * arp - s * arq;
    a[kq] = s * arp + c * arq;
  }
  a[gram_idx(p, p)] = app - t * apq;
  a[gram_idx(q, q)] = aqq + t * apq;
  a[gram_idx(p, q)] = 0.0f;  // annihilated exactly
}

// K1's grid: (units / kThreads, frames), units = n_blk * c (block,
// channel) pairs a frame, the channels of one pixel block on
// neighbouring threads.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, kGramMinBlocks)
    spectrum_gram_kernel(const T* __restrict__ x, float* __restrict__ out,
                         int units, int chans, int w, int full, int extra) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= units) return;
  const int c = kC > 0 ? kC : chans;
  const int wb = w / kB;
  const int n = t / c, ch = t - n * c;
  const int by = n / wb, bx = n - by * wb;
  const int64_t frame = blockIdx.y;
  const T* xb = x + frame * units * (kB * kB) + (by * kB * w + bx * kB) * c;
  float a[kGram];
  {
    float xc[kB][kB];
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      float px[kB];
      load_row<kC, true>(xb + r * w * c, c, ch, px);
#pragma unroll
      for (int k = 0; k < kB; ++k) xc[k][r] = px[k];
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
#pragma unroll
      for (int j = i; j < kB; ++j) a[gram_idx(i, j)] = dot8(xc[i], xc[j]);
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < full; ++sweep) {
#pragma unroll
    for (int p = 0; p < kB - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < kB; ++q) gram_rotate(a, p, q);
    }
  }
  if (extra > 0) {
#pragma unroll
    for (int p = 0; p < kB - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < kB; ++q) {
        // pair index in cyclic-by-rows order, as in jacobi8
        const int idx = p * (2 * kB - p - 1) / 2 + (q - p - 1);
        if (idx < extra) gram_rotate(a, p, q);
      }
    }
  }
  float s[kB], unused[kB][kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) s[i] = sqrtf(fmaxf(a[gram_idx(i, i)], 0.0f));
  sort8<0>(s, unused, unused);
  float4* o = reinterpret_cast<float4*>(
      out + ((frame * c + ch) * (units / c) + n) * kB);
  o[0] = make_float4(s[0], s[1], s[2], s[3]);
  o[1] = make_float4(s[4], s[5], s[6], s[7]);
}

template <typename T, int kC>
static void launch_recon(const void* x, const float* sws, int csws, float* y,
                         float* sc, int frames, int chans, int h, int w,
                         int full, int extra, cudaStream_t st) {
  const int n_blk = (h / kB) * (w / kB);
  const int warps = (n_blk + 32 / chans - 1) / (32 / chans);
  const unsigned gx =
      static_cast<unsigned>((warps + kReconWarps - 1) / kReconWarps);
  // all of the SM's unified L1 that can be shared memory: 6 CTAs' stages
  // (96 KiB) exceed the smaller carveouts
  cudaFuncSetAttribute(embed_recon_kernel<T, kC>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  for (int f0 = 0; f0 < frames; f0 += kMaxGridY) {
    const unsigned gy = static_cast<unsigned>(std::min(frames - f0,
                                                       kMaxGridY));
    embed_recon_kernel<T, kC><<<dim3(gx, gy), kReconThreads, 0, st>>>(
        static_cast<const T*>(x), sws, csws, y, sc, n_blk, chans, w, f0,
        full, extra);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace dctsvd

using dctsvd::aligned16;
using dctsvd::launch_frame_grid;
using dctsvd::spectrum_gram_kernel;
using dctsvd::launch_recon;

// x: u8 (x_is_u8) or f32, planes / chans frames of [H, W, chans]
// (chans = 1: planes [P, H, W]); sws: f32 [csws, N, 8]; y: f32 in x's
// layout; sc: f32 [P, N, 8]; sws, y and sc 16-byte aligned. A frame of
// 2^31 elements or more, more than 32 channels, or a misaligned sws, y or
// sc returns cudaErrorInvalidValue and launches nothing. Returns the
// cudaError_t of the launch.
extern "C" int dctsvd_embed_recon_blocks(const void* x, int x_is_u8,
                                         const void* sws, int csws, void* y,
                                         void* sc, int planes, int chans,
                                         int h, int w, int full, int extra,
                                         void* stream) {
  if (static_cast<int64_t>(h) * w * chans >= (int64_t{1} << 31) ||
      chans < 1 || chans > 32 || !aligned16(sws) || !aligned16(y) ||
      !aligned16(sc))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(sws);
  float* yo = static_cast<float*>(y);
  float* o = static_cast<float*>(sc);
  const int f = planes / chans;
  if (x_is_u8 && chans == 1)
    launch_recon<uint8_t, 1>(x, s, csws, yo, o, f, chans, h, w, full, extra,
                             st);
  else if (x_is_u8 && chans == 3)
    launch_recon<uint8_t, 3>(x, s, csws, yo, o, f, chans, h, w, full, extra,
                             st);
  else if (x_is_u8)
    launch_recon<uint8_t, 0>(x, s, csws, yo, o, f, chans, h, w, full, extra,
                             st);
  else if (chans == 1 && aligned16(x))
    launch_recon<float, 1>(x, s, csws, yo, o, f, chans, h, w, full, extra,
                           st);
  else
    launch_recon<float, 0>(x, s, csws, yo, o, f, chans, h, w, full, extra,
                           st);
  return static_cast<int>(cudaGetLastError());
}

// x: u8 (x_is_u8) or f32, planes / chans frames of [H, W, chans]
// (chans = 1: planes [P, H, W]); out: f32 [P, N, 8]. A frame of 2^31
// elements or more returns cudaErrorInvalidValue and launches nothing.
// Returns the cudaError_t of the launch.
extern "C" int dctsvd_spectrum_gram_blocks(const void* x, int x_is_u8,
                                           void* out, int planes, int chans,
                                           int h, int w, int full, int extra,
                                           void* stream) {
  if (static_cast<int64_t>(h) * w * chans >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int f = planes / chans;
  if (x_is_u8 && chans == 1)
    launch_frame_grid<uint8_t>(spectrum_gram_kernel<uint8_t, 1>, x, o, f,
                               chans, h, w, full, extra, st);
  else if (x_is_u8 && chans == 3)
    launch_frame_grid<uint8_t>(spectrum_gram_kernel<uint8_t, 3>, x, o, f,
                               chans, h, w, full, extra, st);
  else if (x_is_u8)
    launch_frame_grid<uint8_t>(spectrum_gram_kernel<uint8_t, 0>, x, o, f,
                               chans, h, w, full, extra, st);
  else if (chans == 1 && aligned16(x))
    launch_frame_grid<float>(spectrum_gram_kernel<float, 1>, x, o, f,
                             chans, h, w, full, extra, st);
  else
    launch_frame_grid<float>(spectrum_gram_kernel<float, 0>, x, o, f,
                             chans, h, w, full, extra, st);
  return static_cast<int>(cudaGetLastError());
}
