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
// and ::spectrum_blocks_gram_plain.
//
// Design: one thread per block with K1/K2's strided addressing
// (blocks.cuh). K2r carries g and V (128 floats) through the sweeps as K4
// does, then writes the block column by column. K1g forms the Gram matrix
// from the loaded columns, after which only its 36 scalars stay live.
//
// What bounds them on the H100: K2r, like K4 with U/V, is bound by
// registers (the 128 floats of g and V; ptxas gives 181-183 with
// -fmad=false, no spills, so at most 2 blocks of 128 threads per SM) and
// by its f32 output (4 bytes per pixel written where K2 writes 1). K1g
// carries 36 scalars instead of 64 plus 8 norms (80 registers) and each
// rotation costs 12 updates of the other entries plus the angle, about 55
// operations per pair against K1's 82.

#include <cuda_runtime.h>

#include <cstdint>

#include "blocks.cuh"
#include "jacobi8.cuh"

namespace dctsvd {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    embed_recon_kernel(const T* __restrict__ x, const float* __restrict__ sws,
                       int csws, float* __restrict__ y,
                       float* __restrict__ sc, int64_t total, int64_t n_blk,
                       int chans, int h, int w, int full, int extra) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (tid >= total) return;
  const BlockAddr a = block_addr(tid, n_blk, chans, h, w);
  float g[kB][kB], v[kB][kB], s[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) load_col(x, a, c, g[c]);
#pragma unroll
  for (int i = 0; i < kB; ++i) {
#pragma unroll
    for (int r = 0; r < kB; ++r) v[i][r] = (i == r) ? 1.0f : 0.0f;
  }
  jacobi8<true>(g, v, full, extra, s);
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const float d = fmaxf(s[i], 1e-30f);
#pragma unroll
    for (int r = 0; r < kB; ++r) g[i][r] = g[i][r] / d;
  }
  sort8<2>(s, g, v);

  float* o = sc + tid * kB;
#pragma unroll
  for (int j = 0; j < kB; ++j) o[j] = s[j];

  const float* sw = sws_row(sws, csws, tid, n_blk);
  float s2[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) s2[j] = s[j] + sw[j];
  // C' = U diag(S') V^T: column c = sum_j u_j (S'_j V[c][j])
#pragma unroll
  for (int c = 0; c < kB; ++c) {
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      float acc = g[0][r] * (s2[0] * v[0][c]);
#pragma unroll
      for (int j = 1; j < kB; ++j) acc = acc + g[j][r] * (s2[j] * v[j][c]);
      y[a.base + r * a.rs + c * a.cs] = acc;
    }
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
  rotation(app, aqq, apq, c, s, t);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    spectrum_gram_kernel(const T* __restrict__ x, float* __restrict__ out,
                         int64_t total, int64_t n_blk, int chans, int h,
                         int w, int full, int extra) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (tid >= total) return;
  const BlockAddr addr = block_addr(tid, n_blk, chans, h, w);
  float a[kGram];
  {
    float xc[kB][kB];
#pragma unroll
    for (int c = 0; c < kB; ++c) load_col(x, addr, c, xc[c]);
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
  float* o = out + tid * kB;
#pragma unroll
  for (int j = 0; j < kB; ++j) o[j] = s[j];
}

}  // namespace dctsvd

using dctsvd::embed_recon_kernel;
using dctsvd::grid_for;
using dctsvd::kThreads;
using dctsvd::spectrum_gram_kernel;

// x: u8 (x_is_u8) or f32 in; sws: f32 [csws, N, 8]; y: f32 in x's layout;
// sc: f32 [P, N, 8]. Returns the cudaError_t of the launch.
extern "C" int dctsvd_embed_recon_blocks(const void* x, int x_is_u8,
                                         const void* sws, int csws, void* y,
                                         void* sc, int planes, int chans,
                                         int h, int w, int full, int extra,
                                         void* stream) {
  const int64_t n_blk = static_cast<int64_t>(h / 8) * (w / 8);
  const int64_t total = static_cast<int64_t>(planes) * n_blk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(sws);
  float* yo = static_cast<float*>(y);
  float* o = static_cast<float*>(sc);
  if (x_is_u8)
    embed_recon_kernel<uint8_t><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), s, csws, yo, o, total, n_blk, chans,
        h, w, full, extra);
  else
    embed_recon_kernel<float><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(x), s, csws, yo, o, total, n_blk, chans, h,
        w, full, extra);
  return static_cast<int>(cudaGetLastError());
}

// x: u8 (x_is_u8) or f32; out: f32 [P, N, 8]. Returns the cudaError_t of
// the launch.
extern "C" int dctsvd_spectrum_gram_blocks(const void* x, int x_is_u8,
                                           void* out, int planes, int chans,
                                           int h, int w, int full, int extra,
                                           void* stream) {
  const int64_t n_blk = static_cast<int64_t>(h / 8) * (w / 8);
  const int64_t total = static_cast<int64_t>(planes) * n_blk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (x_is_u8)
    spectrum_gram_kernel<uint8_t><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(x), o, total, n_blk, chans, h, w, full,
        extra);
  else
    spectrum_gram_kernel<float><<<grid_for(total), kThreads, 0, st>>>(
        static_cast<const float*>(x), o, total, n_blk, chans, h, w, full,
        extra);
  return static_cast<int>(cudaGetLastError());
}
