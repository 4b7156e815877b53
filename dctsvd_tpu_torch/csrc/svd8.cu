// K4 jacobi_svd8: batched one-sided Jacobi SVD of 8x8 f32 blocks.
//
// Replaces dctsvd_tpu/ops/svd_pallas.py::_make_kernel (through
// jacobi_svd_pallas, reached from ops/svd.jacobi_svd for n == 8 with
// sorting): U, S, Vt sorted descending, or S alone. Plain twin:
// dctsvd_tpu_torch/ops/svd_cuda.py::jacobi_svd8_plain.
//
// Input [B, 8, 8] row-major (a[b][row][col]); outputs U [B, 8, 8]
// (U[b][row][j]), S [B, 8], Vt [B, 8, 8] (Vt[b][j][:] = v_j). One thread
// a block: its columns g[col][row] and, with U/V, the V columns stay in
// registers through the unrolled sweeps (jacobi8.cuh). U = g / max(s,
// 1e-30) before the sort, as the Pallas kernel does, an IEEE division as
// in the twin.
//
// What bounded it: the memory path. Neighbouring threads read and wrote
// their blocks 256 bytes apart, so every warp access of the 64 loads and
// 128 stores a thread made touched 32 lines.
// What the design does: each warp stages its 32 blocks (8 KiB) in shared
// memory. cp.async brings them in as coalesced 16-byte pieces and each
// thread reads its block back as 16 float4s; U, then Vt, go out the same
// way, 512 contiguous bytes a warp store. The 16-byte slots are
// XOR-swizzled per block (stage_slot), so that the 8 threads a
// quarter-warp serves hit 8 distinct bank groups. Only __syncwarp orders
// the stage: no CTA barrier, and no global address is held across the
// sweeps.
// What bounds it now: the issue of its instructions and their latency:
// about 255 registers give 2 CTAs of 128 threads (8 warps) per SM. Two
// lanes a block (K3's dot_cols split, 128 registers, 4 CTAs) issued
// nearly twice the instructions and ran slower (PERF.md). c^2's rsqrt
// skips the subnormal fix-up (rotation's kNormalIc).
// Every value is computed by the twin's operations in the twin's order
// (-fmad=false), so U, S and Vt equal the twin run on the card bit for
// bit. chip_smoke.py prints the registers of each instance (`nvcc -Xptxas
// -v`), and `--jacobi-times` times K4 with its SASS mix.

#include <cuda_runtime.h>

#include <cstdint>

#include "blocks.cuh"
#include "jacobi8.cuh"

namespace dctsvd {

constexpr int kSvdThreads = 128;
constexpr int kSvdWarps = kSvdThreads / 32;

// The shared-memory slot of 16-byte piece q (0..15: row q / 2, columns
// 4 (q % 2) ..) of block j of a warp's stage. A 16-byte access is served
// a quarter-warp at a time; its 8 threads read or write one q of 8
// neighbouring blocks, which the XOR by j % 8 puts in 8 distinct bank
// groups. The copies in and out touch 8 pieces of one block.
__device__ __forceinline__ int stage_slot(int j, int q) {
  return j * 16 + (q ^ (j & 7));
}

// The warp's stage out to dst, its first nw blocks: piece lane + 32 m of
// the warp's run.
__device__ __forceinline__ void copy_out(const float4* stage,
                                         float4* __restrict__ dst, int nw,
                                         int lane) {
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int gi = lane + 32 * m;
    if (gi < nw * 16) dst[gi] = stage[stage_slot(gi / 16, gi % 16)];
  }
}

template <bool kUV>
__global__ void __launch_bounds__(kSvdThreads)
    svd8_kernel(const float4* __restrict__ a, float* __restrict__ u,
                float* __restrict__ s_out, float* __restrict__ vt,
                int64_t nb, int full, int extra) {
  __shared__ __align__(16) float4 stage[kSvdWarps][32 * 16];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t b0 =
      (static_cast<int64_t>(blockIdx.x) * kSvdWarps + warp) * 32;
  if (b0 >= nb) return;  // the whole warp
  const int nw = nb - b0 < 32 ? static_cast<int>(nb - b0) : 32;
  float4* st = stage[warp];

  // blocks past the end are zeros: computed, never stored
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int gi = lane + 32 * m;
    float4* dst = st + stage_slot(gi / 16, gi % 16);
    if (gi < nw * 16)
      cp_async16(dst, a + b0 * 16 + gi);
    else
      *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  cp_async_wait_all();
  __syncwarp();
  float g[kB][kB], v[kB][kB], s[kB];
#pragma unroll
  for (int r = 0; r < kB; ++r) {
    const float4 lo = st[stage_slot(lane, 2 * r)];
    const float4 hi = st[stage_slot(lane, 2 * r + 1)];
    g[0][r] = lo.x; g[1][r] = lo.y; g[2][r] = lo.z; g[3][r] = lo.w;
    g[4][r] = hi.x; g[5][r] = hi.y; g[6][r] = hi.z; g[7][r] = hi.w;
  }
  if constexpr (kUV) {
#pragma unroll
    for (int c = 0; c < kB; ++c) {
#pragma unroll
      for (int r = 0; r < kB; ++r) v[c][r] = (c == r) ? 1.0f : 0.0f;
    }
  }
  jacobi8<kUV, false, 1, true>(g, v, full, extra, s);
  if constexpr (kUV) {
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      const float d = fmaxf(s[c], 1e-30f);
#pragma unroll
      for (int r = 0; r < kB; ++r) g[c][r] = g[c][r] / d;
    }
    sort8<2>(s, g, v);
    // U row r = (g[0][r] .. g[7][r]); then Vt row c = V column c = v[c]
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      st[stage_slot(lane, 2 * r)] =
          make_float4(g[0][r], g[1][r], g[2][r], g[3][r]);
      st[stage_slot(lane, 2 * r + 1)] =
          make_float4(g[4][r], g[5][r], g[6][r], g[7][r]);
    }
    __syncwarp();
    copy_out(st, reinterpret_cast<float4*>(u) + b0 * 16, nw, lane);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kB; ++c) {
      st[stage_slot(lane, 2 * c)] =
          make_float4(v[c][0], v[c][1], v[c][2], v[c][3]);
      st[stage_slot(lane, 2 * c + 1)] =
          make_float4(v[c][4], v[c][5], v[c][6], v[c][7]);
    }
    __syncwarp();
    copy_out(st, reinterpret_cast<float4*>(vt) + b0 * 16, nw, lane);
  } else {
    sort8<0>(s, g, v);
  }
  if (lane < nw) {
    float4* sb = reinterpret_cast<float4*>(s_out + (b0 + lane) * kB);
    sb[0] = make_float4(s[0], s[1], s[2], s[3]);
    sb[1] = make_float4(s[4], s[5], s[6], s[7]);
  }
}

}  // namespace dctsvd

// a: f32 [nb, 8, 8], 16-byte aligned; u, vt: f32 [nb, 8, 8] (ignored
// unless compute_uv); s: f32 [nb, 8]. Returns the cudaError_t of the
// launch.
extern "C" int dctsvd_svd8(const void* a, void* u, void* s, void* vt,
                           long long nb, int full, int extra, int compute_uv,
                           void* stream) {
  using dctsvd::kSvdThreads;
  const unsigned grid =
      static_cast<unsigned>((nb + kSvdThreads - 1) / kSvdThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* a4 = static_cast<const float4*>(a);
  if (compute_uv)
    dctsvd::svd8_kernel<true><<<grid, kSvdThreads, 0, st>>>(
        a4, static_cast<float*>(u), static_cast<float*>(s),
        static_cast<float*>(vt), nb, full, extra);
  else
    dctsvd::svd8_kernel<false><<<grid, kSvdThreads, 0, st>>>(
        a4, nullptr, static_cast<float*>(s), nullptr, nb, full, extra);
  return static_cast<int>(cudaGetLastError());
}
