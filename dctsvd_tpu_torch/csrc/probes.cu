// The measurement probes of tools/ on the H100: copy_f32, cols_view,
// fma_chain and spectrum_probe. Each answers a question the redesign of
// K1, K2 and K3 needs answered (read coalescing, the f32 ceiling, the input
// dtype, cached final norms); the port's tools/ modules drive them.
// Plain twins: dctsvd_tpu_torch/ops/probe_cuda.py::*_plain.
//
// copy_f32 replaces the identity-copy Pallas kernels `copyk` of
// tools/profile_transpose.py::copy_consumer (:45, T2a) and
// tools/profile_view.py::transpose_forced (:70, T6b). Bound by bytes (each
// element read and written once, 1.59 GB at 96 1080p planes, far past the
// 50 MB L2). One 16-byte load and store a thread, one CTA a 4 KiB chunk,
// and a grid that covers the array once, so the card walks it front to
// back and its CTAs keep every SM full. On the H100 this form ties
// PyTorch's copy_ (PERF.md §6); deeper streams of 2-16 float4s a
// thread, streaming cache hints, a grid capped at the resident CTAs, and a
// persistent CTA per SM running a ring of cp.async.bulk copies on an
// mbarrier were each slower.
//
// cols_view replaces tools/profile_transpose.py `gatherk` (:104, the
// pallas_call at :112, T2b), which computes
// swapaxes(x.reshape(r, 8, Wb, 8), -1, -2): the natural planes [P, H, W]
// as the "cols view" [P, Hb, 8(row), 8(col), Wb], in which neighbouring
// blocks sit at neighbouring addresses. It also stands for the relayout
// the T4-T6 probes do outside their kernels (wm_pallas._plane_cols_view,
// tools/exp_widen.py:37). Bound by bytes. Each pixel row is its own
// [Wb, 8] -> [8, Wb] transpose: pixel row R (= p * H + y) lands in output
// rows R * 8 + c, c = 0..7, each Wb long. So the input is read as a flat
// run of 128-byte chunks (4 f32 or 16 u8 blocks of one pixel row). Each
// warp works alone on tiles of 32 chunks (4 KiB): 8 coalesced 16-byte
// cp.async copies a thread into shared memory with an XOR swizzle (piece
// q of chunk k at slot q ^ (k % 8)), two buffers a warp so that the next
// tile is in flight while this one is stored, and no __syncthreads. A
// thread then takes 16 / sizeof(Out) blocks of one chunk (a whole chunk;
// u8 -> bf16 half of one in each of 2 passes, u8 -> f32 a quarter in each
// of 4), reads them from shared memory free of bank conflicts, converts
// in registers, and writes pixel c of its blocks as one 16-byte store to
// output row c: a warp's store is up to 512 contiguous bytes. A partial
// last tile is masked. Where a row or a pointer is not 16-byte aligned (Wb
// not a multiple of the blocks a chunk holds, or a view at an odd offset),
// the wrapper takes the scalar kernel: one thread per output element, in
// output order.
//
// fma_chain replaces tools/exp_vpu_roofline.py::_make_kernel (the
// pallas_call at :57, T3): per element, acc <- acc * 1.0000001 + x, as 8
// independent chains (ilp8, the throughput ceiling) or one dependent chain
// (serial, the latency floor). The unfused instance uses
// __fmul_rn/__fadd_rn and the fused one __fmaf_rn, both immune to
// -fmad=false, so one build gives both the rate of the separate multiplies
// and adds that every kernel here executes and the FMA rate behind the
// published 67 TFLOP/s. What bounds it: the rate of its f32
// instructions. The unfused chain spends an FMUL and an FADD an update, so
// its ceiling is half the published rate: 132 SMs x 128 lanes x the SM
// clock, in instructions. The first form ran the steps as a run-time loop
// unrolled by 4 (3 branch and counter instructions every 64 f32 ones) on
// 64-bit indices. Now the step counts of the tool's two lengths (ilp8 16
// and 64 rounds, serial 128 and 512 updates) are template constants, so
// their chains unroll fully into nothing but FMUL/FADD or FFMA between
// the load and the store; any other length runs the loop in an instance
// of its own. Indices are 32-bit (the host refuses 2^31 elements or more).
//
// spectrum_probe replaces the probe spectra: tools/exp_relayout.py
// _make_kernel (pallas_call :59, T1: natural-layout planes, relaid inside
// the kernel), exp_widen.py (:40, T4: u8/bf16/f32 cols view),
// exp_cachednorms.py::_make_spectrum_cached (:59, T5: final values from
// the cached norms) and profile_view.py (:44, T6a: f32 cols view, s4).
// It is K1's design, one thread a block with jacobi8 + sort8 at an
// integer schedule, with three ways to read the block. What bounds it on
// the H100: the rate of its f32 instructions, as for K1 (s2 and more; the
// twin's order fixes them under -fmad=false), and the bytes at s0. The
// first form was K1's before K1's redesign: a 1-D grid with 64-bit block
// indices, the rsqrt of c^2 with rsqrtf's subnormal fix-up, scalar loads,
// and a CTA-wide band in shared memory behind a __syncthreads. Now every
// instance runs on K1's grid, (blocks of a plane, planes) through
// launch_frame_grid, with 32-bit offsets in a plane (the host refuses a
// plane of 2^31 elements or more), K1's rotation (jacobi8's kNormalIc:
// the same bits, three instructions fewer a pair) and K1's two float4
// stores. kNatStrided reads its block by stride as K1 does: two 16-byte
// loads a pixel row where the plane is 16-byte aligned, a float a load
// where it is not (its own instance). kNatSmem stages: each warp copies
// its 32 blocks' pixel rows (8 KiB) into a slice of shared memory of its
// own with 16-byte cp.async, in K2r's swizzled layout (blocks.cuh
// warp_slot), and waits on its own copies and a __syncwarp, so no warp
// waits for another; a block keeps its own address, so a warp's blocks may
// straddle block rows, and blocks past the plane's end stage nothing. 4
// warps x 8 KiB a CTA with the carveout all shared memory leave 5 CTAs an
// SM, K1's occupancy; it needs a 16-byte aligned plane. kColsView reads
// the cols view, where a warp's 32 blocks are 32 neighbouring elements of
// each of its 64 rows, a coalesced load per pixel. On the same
// integer-valued planes every fresh instance computes K1's floats in K1's
// order, so it equals K1 bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "blocks.cuh"
#include "jacobi8.cuh"

namespace dctsvd {

constexpr int kWideThreads = 256;  // copy_f32, cols_view (scalar), fma_chain
// The least CTAs of kThreads threads an SM of the spectrum probe: K1's
// (kSpectrumMinBlocks), so that the layouts compare at equal occupancy.
constexpr int kProbeMinBlocks = 5;

enum DType { kU8 = 0, kBF16 = 1, kF32 = 2 };
enum ProbeLayout { kNatStrided = 0, kNatSmem = 1, kColsView = 2 };

// One float4 a thread and one CTA a 4 KiB chunk, the grid over the whole
// array (copy_f32_grid): the last CTA masks the tail.
__global__ void __launch_bounds__(kWideThreads)
    copy_f32_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                    int64_t n4) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWideThreads +
                    threadIdx.x;
  if (i < n4) y[i] = x[i];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename In, typename Out>
__device__ __forceinline__ Out convert(In v) {
  return static_cast<Out>(v);
}

template <>
__device__ __forceinline__ __nv_bfloat16 convert<uint8_t, __nv_bfloat16>(
    uint8_t v) {
  return __float2bfloat16(static_cast<float>(v));
}

constexpr int kViewWarps = 4;                 // cols_view: warps a CTA,
constexpr int kViewThreads = kViewWarps * 32;  // and CTAs an SM
constexpr int kViewBlocks = 6;

// Word k (0..3) of a 16-byte piece; k is a constant after unrolling.
__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// u8 -> f32 of byte k of w, exactly: 2^23 + b as float bits, less 2^23.
__device__ __forceinline__ float byte_f32(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + k)),
                   8388608.0f);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// A thread's part of a chunk, v (its pieces in order), to output rows
// dst + c * wb, c = 0..7, one 16-byte store each. f32 -> f32: float 8j +
// c of the chunk is pixel c of block j (4 blocks), so output row c takes
// word c of blocks 0..3.
__device__ __forceinline__ void store_part(const uint4 (&v)[8],
                                           float* __restrict__ dst, int wb,
                                           float) {
#pragma unroll
  for (int c = 0; c < kB; ++c, dst += wb) {
    uint4 o;
    o.x = word(v[c / 4], c % 4);
    o.y = word(v[2 + c / 4], c % 4);
    o.z = word(v[4 + c / 4], c % 4);
    o.w = word(v[6 + c / 4], c % 4);
    __stcs(reinterpret_cast<uint4*>(dst), o);
  }
}

// u8 in: byte 8j + c is pixel c of block j; word 2j + c / 4 holds it at
// byte c % 4.
template <int N>
__device__ __forceinline__ uint32_t u8_word(const uint4 (&v)[N], int i) {
  return word(v[i / 4], i % 4);
}

// u8 -> u8 (16 blocks): a 4x4 byte transpose of the words of blocks
// 4m..4m+3 (half h = c / 4) gives word m of output rows 4h..4h+3.
__device__ __forceinline__ void store_part(const uint4 (&v)[8],
                                           uint8_t* __restrict__ dst, int wb,
                                           uint8_t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t o[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t a = u8_word(v, 8 * m + h), b = u8_word(v, 8 * m + 2 + h),
                     c = u8_word(v, 8 * m + 4 + h),
                     d = u8_word(v, 8 * m + 6 + h);
      const uint32_t ab0 = __byte_perm(a, b, 0x5140),
                     ab1 = __byte_perm(a, b, 0x7362),
                     cd0 = __byte_perm(c, d, 0x5140),
                     cd1 = __byte_perm(c, d, 0x7362);
      o[0][m] = __byte_perm(ab0, cd0, 0x5410);
      o[1][m] = __byte_perm(ab0, cd0, 0x7632);
      o[2][m] = __byte_perm(ab1, cd1, 0x5410);
      o[3][m] = __byte_perm(ab1, cd1, 0x7632);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e, dst += wb)
      __stcs(reinterpret_cast<uint4*>(dst),
             make_uint4(o[e][0], o[e][1], o[e][2], o[e][3]));
  }
}

// u8 -> bf16 (8 blocks, half a chunk).
__device__ __forceinline__ void store_part(const uint4 (&v)[4],
                                           __nv_bfloat16* __restrict__ dst,
                                           int wb, uint8_t) {
#pragma unroll
  for (int c = 0; c < kB; ++c, dst += wb) {
    uint32_t o[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      o[m] = bf16x2_bits(byte_f32(u8_word(v, 4 * m + c / 4), c % 4),
                         byte_f32(u8_word(v, 4 * m + 2 + c / 4), c % 4));
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(o[0], o[1], o[2], o[3]));
  }
}

// u8 -> f32 (4 blocks, a quarter of a chunk).
__device__ __forceinline__ void store_part(const uint4 (&v)[2],
                                           float* __restrict__ dst, int wb,
                                           uint8_t) {
#pragma unroll
  for (int c = 0; c < kB; ++c, dst += wb)
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(byte_f32(u8_word(v, c / 4), c % 4),
                       byte_f32(u8_word(v, 2 + c / 4), c % 4),
                       byte_f32(u8_word(v, 4 + c / 4), c % 4),
                       byte_f32(u8_word(v, 6 + c / 4), c % 4)));
}

// The vector path: `chunks` 128-byte chunks of x, `cpr` of them a pixel
// row; y the cols view with rows of wb elements. Warp tile t covers chunks
// 32t .. 32t + 31; the warps of the grid stride over the tiles, each with
// two 4 KiB buffers: cp.async brings tile i + 1 (no registers held) while
// tile i is stored. A thread stores 16 bytes an output row: 16 /
// sizeof(Out) blocks, a whole chunk or (u8 -> bf16, f32) a half or a
// quarter of one in each of 2 or 4 passes over the tile. 6 CTAs of 4 warps
// an SM (32 KiB of shared memory each; at most 85 registers).
template <typename In, typename Out>
__global__ void __launch_bounds__(kViewThreads, kViewBlocks)
    cols_view_kernel(const uint4* __restrict__ x, Out* __restrict__ y,
                     int64_t chunks, int cpr, int wb) {
  constexpr int kChunkBlocks = 128 / (kB * static_cast<int>(sizeof(In)));
  constexpr int kPasses = sizeof(Out) / sizeof(In);
  constexpr int kPieces = 8 / kPasses;
  constexpr int kBlocks = 16 / sizeof(Out);
  __shared__ __align__(16) uint4 stage[kViewWarps][2][32 * 8];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kViewWarps * 32;
  auto fetch = [&](int64_t c0, uint4* s) {
    const int n = static_cast<int>(chunks - c0 < 32 ? chunks - c0 : 32);
    const uint4* src = x + c0 * 8;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = 4 * u + lane / 8;  // piece 32u + lane of the tile
      if (k < n)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         smem_addr(s + 8 * k + ((lane % 8) ^ (k % 8)))),
                     "l"(src + 32 * u + lane)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  int buf = 0;
  int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kViewWarps + warp) * 32;
  if (c0 < chunks) fetch(c0, stage[warp][0]);
  for (; c0 < chunks; c0 += stride, buf ^= 1) {
    if (c0 + stride < chunks) {
      fetch(c0 + stride, stage[warp][buf ^ 1]);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();
    const uint4* s = stage[warp][buf];
    const int n = static_cast<int>(chunks - c0 < 32 ? chunks - c0 : 32);
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int k = pass * (32 / kPasses) + lane / kPasses;
      const int part = lane % kPasses;
      if (k < n) {
        uint4 v[kPieces];
#pragma unroll
        for (int i = 0; i < kPieces; ++i)
          v[i] = s[8 * k + ((part * kPieces + i) ^ (k % 8))];
        const int64_t g = c0 + k, row = g / cpr;
        store_part(v,
                   y + row * kB * wb + (g - row * cpr) * kChunkBlocks +
                       part * kBlocks,
                   wb, In());
      }
    }
    __syncwarp();
  }
}

// The scalar path: output element o = (R * 8 + c) * wb + bx takes pixel
// (R, 8 * bx + c); any alignment.
template <typename In, typename Out>
__global__ void __launch_bounds__(kWideThreads)
    cols_view_scalar_kernel(const In* __restrict__ x, Out* __restrict__ y,
                            int64_t n, int wb) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWideThreads;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * kWideThreads +
                   threadIdx.x;
       o < n; o += stride) {
    const int64_t rc = o / wb;
    const int64_t bx = o - rc * wb;
    y[o] = convert<In, Out>(x[((rc / kB) * wb + bx) * kB + rc % kB]);
  }
}

template <bool kFused>
__device__ __forceinline__ float chain_step(float acc, float x) {
  if constexpr (kFused) {
    return __fmaf_rn(acc, 1.0000001f, x);
  } else {
    return __fadd_rn(__fmul_rn(acc, 1.0000001f), x);
  }
}

// steps: rounds of 8 updates (ilp8) or updates of the one chain (serial);
// kSteps > 0 fixes it at compile time (the loop unrolls fully), 0 reads
// `steps`.
template <bool kIlp8, bool kFused, int kSteps>
__global__ void __launch_bounds__(kWideThreads)
    fma_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                     int n, int steps) {
  const int i = blockIdx.x * kWideThreads + threadIdx.x;
  if (i >= n) return;
  if constexpr (kSteps > 0) steps = kSteps;
  const float xv = x[i];
  float out;
  if constexpr (kIlp8) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = __fmul_rn(xv, 1.0f + 0.0625f * k);
#pragma unroll(kSteps > 0 ? kSteps : 4)
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = chain_step<kFused>(acc[k], xv);
    }
    out = acc[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) out = __fadd_rn(out, acc[k]);
  } else {
    out = xv;
#pragma unroll(kSteps > 0 ? kSteps : 8)
    for (int s = 0; s < steps; ++s) out = chain_step<kFused>(out, xv);
  }
  y[i] = out;
}

template <bool kIlp8, bool kFused>
static void launch_chain(const float* x, float* y, int n, int steps,
                         cudaStream_t st) {
  // the tool's lengths (tools/exp_vpu_roofline.py N_OPS = 256, 1024)
  constexpr int kShort = kIlp8 ? 16 : 128, kLong = kIlp8 ? 64 : 512;
  const unsigned grid =
      static_cast<unsigned>((n + kWideThreads - 1) / kWideThreads);
  if (steps == kShort)
    fma_chain_kernel<kIlp8, kFused, kShort>
        <<<grid, kWideThreads, 0, st>>>(x, y, n, steps);
  else if (steps == kLong)
    fma_chain_kernel<kIlp8, kFused, kLong>
        <<<grid, kWideThreads, 0, st>>>(x, y, n, steps);
  else
    fma_chain_kernel<kIlp8, kFused, 0>
        <<<grid, kWideThreads, 0, st>>>(x, y, n, steps);
}

// cp.async of a 16-byte piece to shared address dst when pred holds, as
// one predicated instruction (no branch around it).
__device__ __forceinline__ void cp_async16_if(uint32_t dst, const void* src,
                                              bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(dst),
      "l"(src), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) {
  return static_cast<float>(v);
}
// bf16 holds 0..255 exactly, so a bf16 view of u8 pixels loads the same
// floats as the u8 one.
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Grid (units / kThreads, planes), units = Hb * Wb blocks a plane (the
// FrameGridKernel signature: chans is 1 and extra 0, the schedule is
// `full` whole sweeps). Block n = by * Wb + bx of plane blockIdx.y:
// kNatStrided and kNatSmem read f32 planes [P, H, W] (kRow: load_row's
// kC, 1 for 16-byte rows, 0 for a float a load), kColsView the cols view
// [P, Hb, 8, 8, Wb], element (r, c) of the block at ((by * 64 + r * 8 + c)
// * Wb + bx) in its plane. out: f32 [P, units, 8], sorted descending.
template <int kLayout, typename T, bool kCached, int kRow>
__global__ void __launch_bounds__(kThreads, kProbeMinBlocks)
    spectrum_probe_kernel(const T* __restrict__ x, float* __restrict__ out,
                          int units, int, int w, int full, int) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int wb = w / kB;
  const int64_t plane = blockIdx.y;
  x += plane * units * (kB * kB);
  const int by = t / wb, bx = t - by * wb;
  float g[kB][kB], unused[kB][kB], s[kB];
  if constexpr (kLayout == kNatSmem) {
    static_assert(sizeof(T) == 4, "the staged read takes f32 planes");
    __shared__ __align__(16) float4 stage[kThreads / 32][32 * 16];
    const int lane = threadIdx.x % 32;
    const int n0 = t - lane;
    if (n0 >= units) return;  // the whole warp
    const int nw = min(32, units - n0);  // the warp's blocks in the plane
    float4* st = stage[threadIdx.x / 32];
    // the lane copies half lane % 2 of each pixel row r of blocks lane / 2
    // and lane / 2 + 16, so 16 lanes read 512 bytes of one pixel row where
    // their blocks share a block row. Piece 2 r + half of block j sits at
    // warp_slot(j, 2 r + half, 1) = 16 j + (2 r ^ q), q = half ^ (the
    // slot's XOR for j), which is the same for j and j + 16: one XOR and
    // one add a copy, predicated, no branch
    const int base = by * kB * w + bx * kB;
    const int jl = lane / 2, half = lane % 2;
    const float* src_lo = x + __shfl_sync(~0u, base, jl) + 4 * half;
    const float* src_hi = x + __shfl_sync(~0u, base, jl + 16) + 4 * half;
    const int q = warp_slot(jl, half, 1) - 16 * jl;
    const uint32_t s_lo = smem_addr(st + 16 * jl);
    const uint32_t s_hi = s_lo + 16 * 16 * sizeof(float4);
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      const uint32_t piece = ((2 * r) ^ q) * sizeof(float4);
      cp_async16_if(s_lo + piece, src_lo + r * w, jl < nw);
      cp_async16_if(s_hi + piece, src_hi + r * w, jl + 16 < nw);
    }
    cp_async_wait_all();
    __syncwarp();
    if (lane >= nw) return;
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      const float4 lo = st[warp_slot(lane, 2 * r, 1)];
      const float4 hi = st[warp_slot(lane, 2 * r + 1, 1)];
      g[0][r] = lo.x; g[1][r] = lo.y; g[2][r] = lo.z; g[3][r] = lo.w;
      g[4][r] = hi.x; g[5][r] = hi.y; g[6][r] = hi.z; g[7][r] = hi.w;
    }
  } else if constexpr (kLayout == kNatStrided) {
    if (t >= units) return;
    const T* xb = x + by * kB * w + bx * kB;
#pragma unroll
    for (int r = 0; r < kB; ++r) {
      float px[kB];
      load_row<kRow>(xb + r * w, 1, 0, px);
#pragma unroll
      for (int k = 0; k < kB; ++k) g[k][r] = px[k];
    }
  } else {
    if (t >= units) return;
    const T* xb = x + by * kB * kB * wb + bx;
#pragma unroll
    for (int r = 0; r < kB; ++r) {
#pragma unroll
      for (int c = 0; c < kB; ++c) g[c][r] = to_f32(xb[(r * kB + c) * wb]);
    }
  }
  jacobi8<false, kCached, 1, true>(g, unused, full, 0, s);
  sort8<0>(s, unused, unused);
  float4* o = reinterpret_cast<float4*>(out + (plane * units + t) * kB);
  o[0] = make_float4(s[0], s[1], s[2], s[3]);
  o[1] = make_float4(s[4], s[5], s[6], s[7]);
}

template <int kLayout, typename T, bool kCached, int kRow = 1>
static void launch_probe(const void* x, float* out, int planes, int h, int w,
                         int full, cudaStream_t st) {
  if constexpr (kLayout == kNatSmem) {
    // all of the SM's unified L1 that can be shared memory: 5 CTAs' stages
    // (160 KiB) exceed the smaller carveouts
    cudaFuncSetAttribute(spectrum_probe_kernel<kLayout, T, kCached, kRow>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
  }
  launch_frame_grid<T>(spectrum_probe_kernel<kLayout, T, kCached, kRow>, x,
                       out, planes, 1, h, w, full, 0, st);
}

}  // namespace dctsvd

using namespace dctsvd;

// x, y: 16-byte aligned f32 of n4 float4s; grid: from
// ops/probe_cuda.py::copy_f32_grid. Returns the cudaError_t of the launch.
extern "C" int dctsvd_copy_f32(const void* x, void* y, long long n4,
                               int grid, void* stream) {
  copy_f32_kernel<<<grid, kWideThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n4);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename Out>
static void launch_cols_view(const void* x, void* y, int64_t rows, int w,
                             int vector, int grid, cudaStream_t st) {
  const int wb = w / kB;
  if (!vector) {
    cols_view_scalar_kernel<In, Out><<<grid, kWideThreads, 0, st>>>(
        static_cast<const In*>(x), static_cast<Out*>(y), rows * w, wb);
    return;
  }
  constexpr int kChunkBlocks = 128 / (kB * static_cast<int>(sizeof(In)));
  cudaFuncSetAttribute(cols_view_kernel<In, Out>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cols_view_kernel<In, Out><<<grid, kViewThreads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<Out*>(y),
      rows * wb / kChunkBlocks, wb / kChunkBlocks, wb);
}

// x: natural planes [P, H, W] (in_kind u8 or f32); y: the cols view
// [P, Hb, 8, 8, Wb] (out_kind u8, bf16 or f32; u8 out only from u8 in).
// rows = P * H. vector and grid: from ops/probe_cuda.py::cols_view_plan
// (vector needs x and y 16-byte aligned and Wb a multiple of the blocks
// of a 128-byte chunk: 4 f32, 16 u8). Returns the cudaError_t of the
// launch.
extern "C" int dctsvd_cols_view(const void* x, int in_kind, void* y,
                                int out_kind, long long rows, int w,
                                int vector, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_kind == kU8 && out_kind == kU8)
    launch_cols_view<uint8_t, uint8_t>(x, y, rows, w, vector, grid, st);
  else if (in_kind == kU8 && out_kind == kBF16)
    launch_cols_view<uint8_t, __nv_bfloat16>(x, y, rows, w, vector, grid,
                                             st);
  else if (in_kind == kU8 && out_kind == kF32)
    launch_cols_view<uint8_t, float>(x, y, rows, w, vector, grid, st);
  else if (in_kind == kF32 && out_kind == kF32)
    launch_cols_view<float, float>(x, y, rows, w, vector, grid, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x, y: f32 of n elements, n < 2^31; steps as for fma_chain_kernel.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue, and no
// launch, for n out of range).
extern "C" int dctsvd_fma_chain(const void* x, void* y, long long n,
                                int steps, int ilp8, int fused,
                                void* stream) {
  if (n < 0 || n >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const int ni = static_cast<int>(n);
  if (ilp8 && fused)
    launch_chain<true, true>(xf, yf, ni, steps, st);
  else if (ilp8)
    launch_chain<true, false>(xf, yf, ni, steps, st);
  else if (fused)
    launch_chain<false, true>(xf, yf, ni, steps, st);
  else
    launch_chain<false, false>(xf, yf, ni, steps, st);
  return static_cast<int>(cudaGetLastError());
}

// x: natural f32 planes [P, H, W] (layout kNatStrided / kNatSmem) or a
// cols view [P, H/8, 8, 8, W/8] (kColsView; kind u8, bf16 or f32); out:
// f32 [P, N, 8], 16-byte aligned; `full` sweeps, 0 allowed (sorted column
// norms). cached (f32 cols view only) takes the final values from the
// cached norms. kNatStrided reads a plane that is not 16-byte aligned a
// float a load; kNatSmem refuses it. A plane of 2^31 elements or more, a
// misaligned out, or a kind, layout and cached that no instance takes
// return cudaErrorInvalidValue and launch nothing. Returns the
// cudaError_t of the launch.
extern "C" int dctsvd_spectrum_probe(const void* x, int kind, int layout,
                                     int cached, void* out, int planes,
                                     int h, int w, int full, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (static_cast<int64_t>(h) * w >= (int64_t{1} << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (layout == kNatStrided && kind == kF32 && !cached && aligned)
    launch_probe<kNatStrided, float, false>(x, o, planes, h, w, full, st);
  else if (layout == kNatStrided && kind == kF32 && !cached)
    launch_probe<kNatStrided, float, false, 0>(x, o, planes, h, w, full, st);
  else if (layout == kNatSmem && kind == kF32 && !cached && aligned)
    launch_probe<kNatSmem, float, false>(x, o, planes, h, w, full, st);
  else if (layout == kColsView && kind == kU8 && !cached)
    launch_probe<kColsView, uint8_t, false>(x, o, planes, h, w, full, st);
  else if (layout == kColsView && kind == kBF16 && !cached)
    launch_probe<kColsView, __nv_bfloat16, false>(x, o, planes, h, w, full,
                                                  st);
  else if (layout == kColsView && kind == kF32 && !cached)
    launch_probe<kColsView, float, false>(x, o, planes, h, w, full, st);
  else if (layout == kColsView && kind == kF32 && cached)
    launch_probe<kColsView, float, true>(x, o, planes, h, w, full, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
