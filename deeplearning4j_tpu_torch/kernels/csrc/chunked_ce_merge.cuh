// The last step of K3f (the chunked cross-entropy forward), shared by its
// two kernels (chunked_ce.cu and chunked_ce_wgmma.cu): each vocab split
// leaves partial (m, l, correct) per row, and ce_merge_kernel merges them
// into lse and the mean loss in a fixed order, so the loss is the same from
// run to run (no atomics).
//
// part is (3, splits, n) f32: the running max m (in logit units), the sum
// l of exp(logit - m) over the split's columns, and the target's logit
// where the split holds it (0 elsewhere).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// (m, l) of two parts of one row's online softmax, merged into the first
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mx = fmaxf(m, m2);
  l = mx == -INFINITY ? 0.0f : l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

// lse of each row from its splits' partials, and the mean of lse - correct
// over the rows: one block, each thread's rows in a fixed order, then a
// fixed tree, so the loss is the same from run to run
__global__ void __launch_bounds__(1024) ce_merge_kernel(const float* part,
                                                        int splits, int n,
                                                        float* lse,
                                                        float* loss) {
  __shared__ float warp_sums[32];
  const long long plane = (long long)splits * n;
  float acc = 0.0f;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float m = -INFINITY, l = 0.0f, c = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const long long at = (long long)s * n + r;
      merge(m, l, part[at], part[plane + at]);
      c += part[2 * plane + at];
    }
    const float v = m + logf(l);
    lse[r] = v;
    acc += v - c;
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < (int)(blockDim.x >> 5) ? warp_sums[threadIdx.x] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x == 0) loss[0] = acc / (float)n;
  }
}

// The merge on the stream after the splits' kernel.
cudaError_t launch_merge(const float* part, int splits, int n, float* lse,
                         float* loss, cudaStream_t s) {
  ce_merge_kernel<<<1, 1024, 0, s>>>(part, splits, n, lse, loss);
  return cudaGetLastError();
}

}  // namespace
