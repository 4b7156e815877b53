// The launchers of K2 (embed_kernel) and K3 (roundtrip_kernel), one per
// compile-time k. wm_paint.cuh defines them; each wm_paint_k*.cu
// instantiates those of its k values, so the instances compile in parallel
// nvcc processes, and wm_kernels.cu's C entry points pick one by k.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dctsvd {

struct PaintLaunch {
  const void* x;     // u8 or f32 input in its own layout
  const float* sws;  // f32 [csws, N, 8]
  int csws;
  void* y;           // u8 or f32 output in x's layout
  float* sc;         // f32 [P, N, 8]
  float* scw;        // f32 [P, N, 8], K3 only
  int64_t total;     // P * N blocks
  int64_t n_blk;     // N blocks per plane
  int chans, h, w, full, extra;
  cudaStream_t stream;
};

// T: input element type, Out: output element type (uint8_t or float).
template <typename T, typename Out, int K>
void launch_embed(const PaintLaunch& p);

// u8 channels-last frames in and out.
template <int K>
void launch_roundtrip(const PaintLaunch& p);

}  // namespace dctsvd
