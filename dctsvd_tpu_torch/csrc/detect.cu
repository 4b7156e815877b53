// K9: the blocked detect statistic on the card, band_scores.
//
// Replaces the XLA fusion of dctsvd_tpu/models/blocked.py::_band_nc (:1191),
// with band_scale_damp (:1130), band_presence_damp (:1154), the rectified
// estimate of detect_gray / detect_color (:1254-1255, :1273-1274), the
// median (:1230) and detect_color's channel mean; the JAX package has no
// pl.pallas_call for it. Plain twin: dctsvd_tpu_torch/ops/
// detect_cuda.py::band_scores_plain, which follows this file's order of
// operations step for step.
//
// What it computes. Plane p = (frame f, channel c) of the stego and cover
// spectra s_cw, sc [F, C, N, 8] (any frame and channel strides, sc's frame
// stride may be 0) and the watermark's sw [C, N, 8]; the block grid is
// hb x wb (N = hb * wb, row-major), cut as to_bands cuts it: g = max(1,
// min(grid, hb, wb)) (from the caller), gh = hb / g, gw = wb / g, band
// (i, j) the block rows [i gh, (i + 1) gh) and columns [j gw, (j + 1) gw),
// m = gh gw blocks (blocks past g gh or g gw are dropped). Over the m k
// values of a band, a = sw, b = max(s_cw - sc, 0) / max(alpha, 1e-8) (the
// estimate, taken in the load and never stored):
//   pass 1: sums of a, b, a a, b b, and of a, b over column 0 alone;
//           the means a_, b_ = sum / (m k) and a0_, b0_ = sum / m;
//   pass 2: sums of (a - a_)^2, (b - b_)^2, (a - a_)(b - b_) and the same
//           three over column 0 with a0_, b0_;
//   nc = sab / (sqrt(saa) sqrt(sbb) + 1e-8); rho0 likewise over column 0;
//   r = sqrt(sum b b) / (sqrt(sum a a) + 1e-8);
//   over = max(0, log2(max(r, 1e-9))); scale = 1 / (1 + (over over)(over over));
//   knee = 0.05 + 1.3 / sqrt(m); presence = clamp((rho0 - knee) / 0.30, 0, 1);
//   score = (nc scale) presence, written to bands[f, c, band].
// Then, unless the caller wants the band scores alone (parallel/plane.py
// gathers the bands of every shard), per frame: each plane's median of its
// g^2 scores (the mean of the two middle values for an even count, NaN
// sorted last, as torch.sort), and the mean over the planes,
// ((m0 + m1) + m2) / C in color.
//
// Order. One CTA of 256 threads a (band, plane, frame). Thread t walks
// the band's blocks j = t, t + 256, ... (block j at row j / gw, column
// j % gw of the band) and within a block columns 0..k-1, adding into its
// own sums; the CTA then adds its 256 partials in a fixed tree, a warp's
// 32 lanes at shuffle offsets 16, 8, 4, 2, 1, then the 8 warp sums at
// offsets 4, 2, 1. Every product, sum, square root and division rounds
// once (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn: never contracted,
// never a product by a reciprocal); log2f is libdevice's, as torch's
// log2; min and max let a NaN through, as torch's clamp. So the score is
// bit-equal to the twin run on the card, and a frame's score is the same
// alone, in a shard or in any batch. The centred sums are taken in a
// second pass, not as sum(ab) - m k a_ b_, which cancels when the means
// are large against the spread. The median is a second, tiny kernel: a
// CTA a frame, a thread a band score, each finding its rank in its plane;
// the two middle ranks meet in shared memory.
//
// What bounds it on the H100: bytes. Each value read is one float of a
// 32-byte block row (one sector) of s_cw and of sc; sw is shared by the
// frames and stays in L2. At detect's 128 gray 1080p frames (hb 135,
// wb 240, g 4, 31,680 of 32,400 blocks in the bands) 2 x 128 x 31,680 x
// 32 B = 259.5 MB: 0.077 ms at 3.35 TB/s.
//
// What the design does about it. The values reach the registers in as
// few loads as the rows allow, and the sums see them in the order above.
// A row's first k values are one 16-byte load (two for k > 4) of s_cw, of
// sc and of sw each, where the pointers and strides keep every row on a
// 16-byte boundary (the vector instance; a scalar instance loads 4 bytes
// at a time; ops/detect_cuda.py::band_plan picks). A band of at most 256 *
// kBandRows blocks (1080p's 1,980) is resident: each thread issues the
// loads of all its rows before any sum, so they are in flight together,
// and keeps its estimates (and for k <= 4 sw's values) in registers, so
// pass 2 reads no memory and divides no more. A larger band (4K's 8,040,
// an 8K plane shard's 32,160) walks its rows twice, pass 2 mostly from
// L2, with the same row loads; nothing is staged in shared memory. Three
// CTAs an SM (kBandMinBlocks: 80 registers) keep more rows in flight than
// two at 90 registers did (12 % faster in color at 128 frames; PERF.md
// section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace dctsvd {
namespace {

constexpr int kBandThreads = 256;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kSums = 6;                 // sums a pass reduces
constexpr int kBandRows = 8;             // rows of 256 blocks a thread keeps
constexpr int kBandMinBlocks = 3;        // CTAs an SM (at most 85 registers)
constexpr int kMedianThreads = 64;
constexpr unsigned kFull = 0xffffffffu;

// min and max that return NaN when either input is NaN (torch's clamp),
// where fminf / fmaxf would drop it.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The CTA's sums of v[0..kSums) over its threads, in the fixed tree; every
// thread gets them back in v.
__device__ __forceinline__ void cta_sums(float (&v)[kSums],
                                         float (*red)[kBandWarps],
                                         float* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kSums; ++i)
      v[i] = __fadd_rn(v[i], __shfl_down_sync(kFull, v[i], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) red[i][warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      float x = lane < kBandWarps ? red[i][lane] : 0.0f;
#pragma unroll
      for (int o = kBandWarps / 2; o > 0; o >>= 1)
        x = __fadd_rn(x, __shfl_down_sync(kFull, x, o));
      if (lane == 0) total[i] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSums; ++i) v[i] = total[i];
}

// sx / (sqrt(sxx) sqrt(syy) + 1e-8): metrics.nc on the centred sums.
__device__ __forceinline__ float nc_of(float sxy, float sxx, float syy) {
  return __fdiv_rn(
      sxy, __fadd_rn(__fmul_rn(__fsqrt_rn(sxx), __fsqrt_rn(syy)), 1e-8f));
}

// A block row's first K values at p: one 16-byte load for K <= 4, two for
// K <= 8 (kVec: p on a 16-byte boundary), else K 4-byte loads.
template <int K, bool kVec>
__device__ __forceinline__ void load_row(const float* p, float (&v)[K]) {
  if constexpr (kVec) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = K > 4 ? __ldg(reinterpret_cast<const float4*>(p + 4))
                            : lo;
    const float all[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = all[i];
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = __ldg(p + i);
  }
}

// The estimate max(s - q, 0) / den of a block row.
template <int K>
__device__ __forceinline__ void estimate(const float (&s)[K],
                                         const float (&q)[K], float den,
                                         float (&b)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    b[i] = __fdiv_rn(max_nan(__fsub_rn(s[i], q[i]), 0.0f), den);
}

// Pass 1's sums of one block row: a, b, a a, b b, and a, b over column 0.
template <int K>
__device__ __forceinline__ void raw_sums(const float (&a)[K],
                                         const float (&b)[K],
                                         float (&v)[kSums]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[0] = __fadd_rn(v[0], a[i]);
    v[1] = __fadd_rn(v[1], b[i]);
    v[2] = __fadd_rn(v[2], __fmul_rn(a[i], a[i]));
    v[3] = __fadd_rn(v[3], __fmul_rn(b[i], b[i]));
    if (i == 0) {
      v[4] = __fadd_rn(v[4], a[i]);
      v[5] = __fadd_rn(v[5], b[i]);
    }
  }
}

// Pass 2's sums of one block row: the centred squares and products over
// all K columns (means ma, mb) and over column 0 (ma0, mb0).
template <int K>
__device__ __forceinline__ void centred_sums(const float (&a)[K],
                                             const float (&b)[K], float ma,
                                             float mb, float ma0, float mb0,
                                             float (&u)[kSums]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float da = __fsub_rn(a[i], ma), db = __fsub_rn(b[i], mb);
    u[0] = __fadd_rn(u[0], __fmul_rn(da, da));
    u[1] = __fadd_rn(u[1], __fmul_rn(db, db));
    u[2] = __fadd_rn(u[2], __fmul_rn(da, db));
    if (i == 0) {
      const float da0 = __fsub_rn(a[i], ma0), db0 = __fsub_rn(b[i], mb0);
      u[3] = __fadd_rn(u[3], __fmul_rn(da0, da0));
      u[4] = __fadd_rn(u[4], __fmul_rn(db0, db0));
      u[5] = __fadd_rn(u[5], __fmul_rn(da0, db0));
    }
  }
}

// One CTA a (band, plane, frame): blockIdx.x = (f * planes + c) * g^2 +
// band, its score to bands[blockIdx.x]. kVec: every row on a 16-byte
// boundary (see load_row). kResident: the band has at most kBandThreads *
// kBandRows blocks, so a thread loads all its rows of s_cw and sc (and,
// for K <= 4, of sw) before pass 1 and keeps its estimates (and sw's
// values) in registers for pass 2; for K > 4 sw's rows (shared by the
// frames, in L2) are read in each pass; else pass 2 reads the band again
// and recomputes the estimates.
template <int K, bool kVec, bool kResident>
__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
    band_kernel(const float* __restrict__ s_cw, int64_t s_fs, int64_t s_cs,
                const float* __restrict__ sc, int64_t c_fs, int64_t c_cs,
                const float* __restrict__ sw, int64_t w_cs,
                const float* __restrict__ alpha, float* __restrict__ bands,
                int planes, int wb, int g, int gh, int gw) {
  __shared__ float red[kSums][kBandWarps];
  __shared__ float total[kSums];
  constexpr bool kKeepA = kResident && K <= 4;
  constexpr int kRows = kResident ? kBandRows : 1;
  const int nb = g * g;
  const int64_t cta = blockIdx.x;
  const int band = static_cast<int>(cta % nb);
  const int64_t pl = cta / nb;
  const int c = static_cast<int>(pl % planes);
  const int64_t f = pl / planes;
  const float* s = s_cw + f * s_fs + c * s_cs;
  const float* q = sc + f * c_fs + c * c_cs;
  const float* w = sw + c * w_cs;
  const int row0 = (band / g) * gh;
  const int col0 = (band % g) * gw;
  const int m = gh * gw;
  const float den = max_nan(__ldg(alpha), 1e-8f);
  // block j's offset: row row0 + j / gw, column col0 + j % gw of the grid
  auto offset = [&](int j) {
    return (static_cast<int64_t>(row0 + j / gw) * wb + col0 + j % gw) * 8;
  };

  // pass 1: sum a, sum b, sum a a, sum b b, and a, b over column 0
  float v[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ar[kKeepA ? kRows : 1][K], br[kRows][K];
  if constexpr (kResident) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = threadIdx.x + r * kBandThreads;
      if (j < m) {
        const int64_t off = offset(j);
        float sv[K], qv[K];
        if constexpr (kKeepA) load_row<K, kVec>(w + off, ar[r]);
        load_row<K, kVec>(s + off, sv);
        load_row<K, kVec>(q + off, qv);
        estimate<K>(sv, qv, den, br[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = threadIdx.x + r * kBandThreads;
      if (j < m) {
        if constexpr (!kKeepA) load_row<K, kVec>(w + offset(j), ar[0]);
        raw_sums<K>(ar[kKeepA ? r : 0], br[r], v);
      }
    }
  } else {
    for (int j = threadIdx.x; j < m; j += kBandThreads) {
      const int64_t off = offset(j);
      float sv[K], qv[K];
      load_row<K, kVec>(w + off, ar[0]);
      load_row<K, kVec>(s + off, sv);
      load_row<K, kVec>(q + off, qv);
      estimate<K>(sv, qv, den, br[0]);
      raw_sums<K>(ar[0], br[0], v);
    }
  }
  cta_sums(v, red, total);
  const float n_all = static_cast<float>(m * K);
  const float n0 = static_cast<float>(m);
  const float ma = __fdiv_rn(v[0], n_all), mb = __fdiv_rn(v[1], n_all);
  const float ma0 = __fdiv_rn(v[4], n0), mb0 = __fdiv_rn(v[5], n0);
  const float raa = v[2], rbb = v[3];

  // pass 2: the centred sums, over all k columns and over column 0
  float u[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kResident) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = threadIdx.x + r * kBandThreads;
      if (j < m) {
        if constexpr (!kKeepA) load_row<K, kVec>(w + offset(j), ar[0]);
        centred_sums<K>(ar[kKeepA ? r : 0], br[r], ma, mb, ma0, mb0, u);
      }
    }
  } else {
    for (int j = threadIdx.x; j < m; j += kBandThreads) {
      const int64_t off = offset(j);
      float sv[K], qv[K];
      load_row<K, kVec>(w + off, ar[0]);
      load_row<K, kVec>(s + off, sv);
      load_row<K, kVec>(q + off, qv);
      estimate<K>(sv, qv, den, br[0]);
      centred_sums<K>(ar[0], br[0], ma, mb, ma0, mb0, u);
    }
  }
  cta_sums(u, red, total);
  if (threadIdx.x != 0) return;
  const float nc = nc_of(u[2], u[0], u[1]);
  const float r =
      __fdiv_rn(__fsqrt_rn(rbb), __fadd_rn(__fsqrt_rn(raa), 1e-8f));
  const float over = max_nan(log2f(max_nan(r, 1e-9f)), 0.0f);
  const float o2 = __fmul_rn(over, over);
  const float scale = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(o2, o2)));
  const float knee = __fadd_rn(0.05f, __fdiv_rn(1.3f, __fsqrt_rn(n0)));
  const float rho0 = nc_of(u[5], u[3], u[4]);
  const float presence =
      min_nan(max_nan(__fdiv_rn(__fsub_rn(rho0, knee), 0.30f), 0.0f), 1.0f);
  bands[cta] = __fmul_rn(__fmul_rn(nc, scale), presence);
}

// torch.sort's order: NaN after every number.
__device__ __forceinline__ bool sorts_before(float a, float b) {
  return a < b || (isnan(b) && !isnan(a));
}

// One CTA a frame, a thread a (plane, band) score: the scores of ranks
// nb/2 - 1 and nb/2 in their plane's order (torch.sort's: NaN last, ties
// by index) land in shared memory; thread 0 then takes each plane's median
// and the planes' mean, summed in order and divided once.
__global__ void __launch_bounds__(kMedianThreads)
    band_median_kernel(const float* __restrict__ bands,
                       float* __restrict__ out, int planes, int nb) {
  extern __shared__ float mid[];  // [planes][2]: ranks nb/2 - 1 and nb/2
  const float* x = bands + static_cast<int64_t>(blockIdx.x) * planes * nb;
  for (int t = threadIdx.x; t < planes * nb; t += kMedianThreads) {
    const float* xc = x + (t / nb) * nb;
    const int i = t % nb;
    const float xi = xc[i];
    int rank = 0;
    for (int j = 0; j < nb; ++j) {
      const float xj = xc[j];
      rank += sorts_before(xj, xi) ||
              (j < i && !sorts_before(xi, xj) && !sorts_before(xj, xi));
    }
    const int slot = rank - (nb / 2 - 1);
    if (slot == 0 || slot == 1) mid[2 * (t / nb) + slot] = xi;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float sum = 0.0f;
  for (int c = 0; c < planes; ++c) {
    const float hi = mid[2 * c + 1];
    const float med =
        nb % 2 ? hi : __fmul_rn(__fadd_rn(mid[2 * c], hi), 0.5f);
    sum = c ? __fadd_rn(sum, med) : med;
  }
  out[blockIdx.x] = __fdiv_rn(sum, static_cast<float>(planes));
}

template <int K>
void launch_band(const float* s_cw, int64_t s_fs, int64_t s_cs,
                 const float* sc, int64_t c_fs, int64_t c_cs,
                 const float* sw, int64_t w_cs, const float* alpha,
                 float* bands, int64_t ctas, int planes, int wb, int g,
                 int gh, int gw, bool vec, bool resident, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(ctas);
#define DCTSVD_BAND_LAUNCH(V, R)                                             \
  band_kernel<K, V, R><<<grid, kBandThreads, 0, st>>>(                       \
      s_cw, s_fs, s_cs, sc, c_fs, c_cs, sw, w_cs, alpha, bands, planes, wb,  \
      g, gh, gw)
  if (vec && resident)
    DCTSVD_BAND_LAUNCH(true, true);
  else if (vec)
    DCTSVD_BAND_LAUNCH(true, false);
  else if (resident)
    DCTSVD_BAND_LAUNCH(false, true);
  else
    DCTSVD_BAND_LAUNCH(false, false);
#undef DCTSVD_BAND_LAUNCH
}

}  // namespace
}  // namespace dctsvd

using namespace dctsvd;

// s_cw, sc: f32 [frames, planes, hb * wb, 8] at the given frame and plane
// strides (elements; rows of 8 contiguous floats), sc's frame stride may be
// 0; sw: f32 [planes, hb * wb, 8] at plane stride w_cs; alpha: one f32 on
// the card; g: the band grid (1 <= g <= min(hb, wb)); k: 1..8. vector and
// resident: the instance (dctsvd_tpu_torch/ops/detect_cuda.py::band_plan):
// vector needs the three pointers on 16-byte boundaries and every stride a
// multiple of 4; resident needs a band of at most 256 * kBandRows blocks.
// Writes the band scores bands [frames, planes, g * g] and, when out is
// not null, the frame scores out [frames]. Returns the cudaError_t of the
// launches.
extern "C" int dctsvd_band_scores(const void* s_cw, long long s_fs,
                                  long long s_cs, const void* sc,
                                  long long c_fs, long long c_cs,
                                  const void* sw, long long w_cs,
                                  const void* alpha, void* bands, void* out,
                                  int frames, int planes, int hb, int wb,
                                  int g, int k, int vector, int resident,
                                  void* stream) {
  if (frames <= 0 || planes <= 0 || g < 1 || g > hb || g > wb || k < 1 ||
      k > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ctas = static_cast<int64_t>(frames) * planes * g * g;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int gh = hb / g, gw = wb / g;
  if (resident && static_cast<int64_t>(gh) * gw >
                      static_cast<int64_t>(kBandThreads) * kBandRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vector && ((reinterpret_cast<uintptr_t>(s_cw) |
                  reinterpret_cast<uintptr_t>(sc) |
                  reinterpret_cast<uintptr_t>(sw)) % 16 != 0 ||
                 (s_fs | s_cs | c_fs | c_cs | w_cs) % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(s_cw);
  const float* q = static_cast<const float*>(sc);
  const float* w = static_cast<const float*>(sw);
  const float* a = static_cast<const float*>(alpha);
  float* b = static_cast<float*>(bands);
  switch (k) {
#define DCTSVD_BAND_CASE(KK)                                                 \
  case KK:                                                                   \
    launch_band<KK>(s, s_fs, s_cs, q, c_fs, c_cs, w, w_cs, a, b, ctas,       \
                    planes, wb, g, gh, gw, vector, resident, st);            \
    break;
    DCTSVD_BAND_CASE(1)
    DCTSVD_BAND_CASE(2)
    DCTSVD_BAND_CASE(3)
    DCTSVD_BAND_CASE(4)
    DCTSVD_BAND_CASE(5)
    DCTSVD_BAND_CASE(6)
    DCTSVD_BAND_CASE(7)
    DCTSVD_BAND_CASE(8)
#undef DCTSVD_BAND_CASE
  }
  if (out != nullptr)
    band_median_kernel<<<frames, kMedianThreads,
                         2 * planes * sizeof(float), st>>>(
        b, static_cast<float*>(out), planes, g * g);
  return static_cast<int>(cudaGetLastError());
}
