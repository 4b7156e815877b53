// K18: the extract tail's presence statistic on the card, presence.
//
// Replaces the reduction inside the XLA fusion of dctsvd_tpu/models/
// blocked.py::_shrink_sw_hat (:767-792: metrics.nc over the block groups,
// the sort, the quarter order statistic and the knee), which the port ran
// as about twenty eager ops (models/blocked.py::_engaged); the JAX package
// has no pl.pallas_call for it. Its decision feeds K5f (extract_tail.cu) in
// every extract that has the watermark's Sw. Plain twin:
// dctsvd_tpu_torch/ops/tail_cuda.py::presence_plain, which follows this
// file's order of operations step for step.
//
// What it computes. Plane p = (frame f, channel c), its N blocks in slot
// order: b[n] = (s_cw[p, n, 0] - sc[p, n, 0]) / max(alpha[p], 1e-8), column
// 0 of the raw estimate (a caller that holds the estimate itself passes
// sc = 0 and alpha = 1: (x - 0) / 1 is x exactly), and a[n] = sw[c, n, 0].
// gsz = max(1, N / 16), ng = N / gsz (16..31 groups, or N where N < 16);
// group g is the blocks [g gsz, (g + 1) gsz), and the blocks past ng gsz
// are in none. Per (plane, group):
//   pass 1: the sums of a and of b; the means a_ = sum / gsz, b_ likewise;
//   pass 2: the sums of (a - a_)^2, (b - b_)^2 and (a - a_)(b - b_);
//   rho = sab / (sqrt(saa) sqrt(sbb) + 1e-8), metrics.nc's Pearson.
// Then per plane rho0, the group value of rank ng - m in ascending order
// (m = ceil(ng / 4): the m-th largest), ranked as torch.sort ranks (NaN
// after every number), and engage = rho0 >= knee, the knee 0.20 +
// 1.8 / sqrt(gsz) as the twin computes it on the host (an f32 value).
//
// Order. One CTA of 256 threads a (group, plane). Thread t takes the
// group's blocks j = t, t + 256, ... in turn, adding into its own sums;
// the CTA then adds its 256 partials in a fixed tree (a warp's 32 lanes at
// shuffle offsets 16, 8, 4, 2, 1, then the 8 warp sums at 4, 2, 1): K9's
// order (detect.cu). Every difference, product, sum, square root and
// division rounds once (-fmad=false and the _rn intrinsics), so rho is
// bit-equal to the twin run on the card, and a frame's decision is the same
// alone, in a shard or in any batch. The selection is a second, tiny
// kernel: a warp a plane, lane i a group's rho (ng <= 31), each lane
// counting the lanes that sort before it (ties by index); the lane of rank
// ng - m writes rho0 and the decision.
//
// What bounds it on the H100: bytes. Each value read is one float of a
// 32-byte block row (one sector) of s_cw and of sc, plus sw's rows, which
// the frames share and which stay in L2: at 32 color 1080p frames (96
// planes of 32,400 blocks) 2 x 96 x 32,400 x 32 B + 3 x 32,400 x 32 B =
// 202 MB, 0.060 ms at 3.35 TB/s. What the design does about it: a group of
// at most 256 * kPresRows blocks (1080p's 2,025) is resident, each thread
// issuing the loads of all its rows before any sum and keeping its (a, b)
// pairs in registers for pass 2, so the group is read once and the 1,536
// CTAs of 32 color frames (16 groups of 96 planes) fill the card; a larger
// group (4K's 8,100) reads its rows again in pass 2, mostly from L2. On an
// H100 at 700 W (chip_smoke.py's presence row) the two kernels take 0.076
// ms of device time at 32 color frames (79 % of the bound) and 0.277 ms at
// 128 (86 %); a call through the wrapper takes 0.16 ms at 32, paced by the
// host's launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace dctsvd {
namespace {

constexpr int kPresThreads = 256;
constexpr int kPresWarps = kPresThreads / 32;
constexpr int kPresRows = 8;            // rows of 256 blocks a thread keeps
constexpr int kSelectWarps = 4;         // planes a selection CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The CTA's sums of v[0..N) over its threads, in the fixed tree; every
// thread gets them back in v.
template <int N>
__device__ __forceinline__ void cta_sums(float (&v)[N],
                                         float (*red)[kPresWarps],
                                         float* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = __fadd_rn(v[i], __shfl_down_sync(kFull, v[i], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i][warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float x = lane < kPresWarps ? red[i][lane] : 0.0f;
#pragma unroll
      for (int o = kPresWarps / 2; o > 0; o >>= 1)
        x = __fadd_rn(x, __shfl_down_sync(kFull, x, o));
      if (lane == 0) total[i] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = total[i];
}

struct PresArgs {
  const float* s;          // s_cw: column 0 of a row
  int64_t s_fs, s_cs, s_rs;
  const float* q;          // sc likewise
  int64_t q_fs, q_cs, q_rs;
  const float* alpha;      // plane p's at alpha[p * alpha_step]
  int alpha_step;
  const float* sw;
  int64_t w_cs, w_rs;
  int chans, gsz, ng;
};

// Block n's (a, b) of plane (f, c).
__device__ __forceinline__ void pair(const PresArgs& a, int64_t f, int c,
                                     int64_t n, float den, float& av,
                                     float& bv) {
  av = __ldg(a.sw + c * a.w_cs + n * a.w_rs);
  const float s = __ldg(a.s + f * a.s_fs + c * a.s_cs + n * a.s_rs);
  const float q = __ldg(a.q + f * a.q_fs + c * a.q_cs + n * a.q_rs);
  bv = __fdiv_rn(__fsub_rn(s, q), den);
}

// One CTA a (group g, plane p): blockIdx.x = p * ng + g, its Pearson to
// rho[blockIdx.x]. kResident: the group has at most kPresThreads *
// kPresRows blocks, each thread loads all its pairs before pass 1 and keeps
// them for pass 2; else pass 2 loads them again.
template <bool kResident>
__global__ void __launch_bounds__(kPresThreads)
    presence_group_kernel(PresArgs a, float* __restrict__ rho) {
  __shared__ float red[3][kPresWarps];
  __shared__ float total[3];
  constexpr int kRows = kResident ? kPresRows : 1;
  const int64_t cta = blockIdx.x;
  const int g = static_cast<int>(cta % a.ng);
  const int64_t p = cta / a.ng;
  const int c = static_cast<int>(p % a.chans);
  const int64_t f = p / a.chans;
  const int64_t n0 = static_cast<int64_t>(g) * a.gsz;
  const int m = a.gsz;
  const float den = max_nan(__ldg(a.alpha + p * a.alpha_step), 1e-8f);

  // pass 1: the sums of a and b
  float v[2] = {0.0f, 0.0f};
  float ar[kRows], br[kRows];
  if constexpr (kResident) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = threadIdx.x + r * kPresThreads;
      if (j < m) pair(a, f, c, n0 + j, den, ar[r], br[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = threadIdx.x + r * kPresThreads;
      if (j < m) {
        v[0] = __fadd_rn(v[0], ar[r]);
        v[1] = __fadd_rn(v[1], br[r]);
      }
    }
  } else {
    for (int j = threadIdx.x; j < m; j += kPresThreads) {
      pair(a, f, c, n0 + j, den, ar[0], br[0]);
      v[0] = __fadd_rn(v[0], ar[0]);
      v[1] = __fadd_rn(v[1], br[0]);
    }
  }
  cta_sums<2>(v, red, total);
  const float cnt = static_cast<float>(m);
  const float ma = __fdiv_rn(v[0], cnt), mb = __fdiv_rn(v[1], cnt);

  // pass 2: the centred sums
  float u[3] = {0.0f, 0.0f, 0.0f};
  auto centred = [&](float av, float bv) {
    const float da = __fsub_rn(av, ma), db = __fsub_rn(bv, mb);
    u[0] = __fadd_rn(u[0], __fmul_rn(da, da));
    u[1] = __fadd_rn(u[1], __fmul_rn(db, db));
    u[2] = __fadd_rn(u[2], __fmul_rn(da, db));
  };
  if constexpr (kResident) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (threadIdx.x + r * kPresThreads < m) centred(ar[r], br[r]);
  } else {
    for (int j = threadIdx.x; j < m; j += kPresThreads) {
      pair(a, f, c, n0 + j, den, ar[0], br[0]);
      centred(ar[0], br[0]);
    }
  }
  cta_sums<3>(u, red, total);
  if (threadIdx.x == 0)
    rho[cta] = __fdiv_rn(
        u[2],
        __fadd_rn(__fmul_rn(__fsqrt_rn(u[0]), __fsqrt_rn(u[1])), 1e-8f));
}

// torch.sort's order: NaN after every number.
__device__ __forceinline__ bool sorts_before(float a, float b) {
  return a < b || (isnan(b) && !isnan(a));
}

// A warp a plane, lane i its group i's rho (ng <= 31): the value of rank
// `rank` in torch.sort's order (ties by index) to rho0[p], and rho0 >= knee
// to engage[p].
__global__ void __launch_bounds__(kSelectWarps * 32)
    presence_select_kernel(const float* __restrict__ rho,
                           float* __restrict__ rho0,
                           uint8_t* __restrict__ engage, int64_t planes,
                           int ng, int rank, float knee) {
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kSelectWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= planes) return;                     // the whole warp
  const float x = lane < ng ? rho[p * ng + lane] : 0.0f;
  int r = 0;
  for (int j = 0; j < 32; ++j) {
    const float y = __shfl_sync(kFull, x, j);
    if (j < ng)
      r += sorts_before(y, x) ||
           (j < lane && !sorts_before(x, y) && !sorts_before(y, x));
  }
  if (lane < ng && r == rank) {
    rho0[p] = x;
    engage[p] = x >= knee ? 1 : 0;
  }
}

}  // namespace
}  // namespace dctsvd

using namespace dctsvd;

// s: f32, column 0 of block n of plane (f, c) at s[f s_fs + c s_cs + n s_rs]
// (the stego spectrum); q: sc likewise (any stride may be 0); alpha: f32,
// plane p's at alpha[p * alpha_step] (alpha_step 0 or 1); sw: column 0 of
// block n of channel c at sw[c w_cs + n w_rs]; planes = frames * chans;
// n: blocks a plane. Writes rho0 f32 [planes] and engage u8 [planes],
// using rho f32 [planes * ng] as scratch (ng the groups of n blocks); knee:
// the decision's threshold. Returns the first launch's error, or
// cudaErrorInvalidValue, launching nothing, for an input outside these
// bounds.
extern "C" int dctsvd_presence(const void* s, long long s_fs,
                               long long s_cs, long long s_rs, const void* q,
                               long long q_fs, long long q_cs,
                               long long q_rs, const void* alpha,
                               int alpha_step, const void* sw,
                               long long w_cs, long long w_rs, void* rho,
                               void* rho0, void* engage, long long planes,
                               int chans, int n, float knee, void* stream) {
  if (planes < 0 || chans < 1 || n < 1 || planes % chans != 0 ||
      q == nullptr || alpha == nullptr ||
      (alpha_step != 0 && alpha_step != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gsz = n / 16 > 1 ? n / 16 : 1;
  const int ng = n / gsz;
  const int64_t ctas = planes * ng;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (planes == 0) return static_cast<int>(cudaSuccess);
  const PresArgs a{static_cast<const float*>(s), s_fs, s_cs, s_rs,
                   static_cast<const float*>(q), q_fs, q_cs, q_rs,
                   static_cast<const float*>(alpha), alpha_step,
                   static_cast<const float*>(sw), w_cs, w_rs, chans, gsz, ng};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rho);
  const unsigned grid = static_cast<unsigned>(ctas);
  const bool resident = gsz <= kPresThreads * kPresRows;
  if (resident)
    presence_group_kernel<true><<<grid, kPresThreads, 0, st>>>(a, r);
  else
    presence_group_kernel<false><<<grid, kPresThreads, 0, st>>>(a, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = (ng + 3) / 4;
  presence_select_kernel<<<static_cast<unsigned>(
                               (planes + kSelectWarps - 1) / kSelectWarps),
                           kSelectWarps * 32, 0, st>>>(
      r, static_cast<float*>(rho0), static_cast<uint8_t*>(engage), planes,
      ng, ng - m, knee);
  return static_cast<int>(cudaGetLastError());
}
