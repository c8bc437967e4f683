// The cross-block sums of the single-latent statistics passes, shared by
// fused_cavi_stats.cu (kernel 1) and fused_variants.cu (kernels 8-9).
//
// CUDA blocks run in parallel and in no order, so each block writes its
// partial s1 [M] and S2 [M, M] to scratch, and sum_partials adds the
// partials in block order: deterministic, no atomics.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s1 = sum_b s1_part[b], S2 = sum_b s2_part[b], in block order; one
// thread per output entry, M + M^2 of them.
__global__ void sum_partials(const float* __restrict__ s1_part, const float* __restrict__ s2_part,
                             float* __restrict__ s1, float* __restrict__ s2, int nb, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) {
    float acc = 0.0f;
    for (int b = 0; b < nb; ++b) acc += s1_part[(size_t)b * M + i];
    s1[i] = acc;
  } else if (i < M + M * M) {
    const int j = i - M;
    float acc = 0.0f;
    for (int b = 0; b < nb; ++b) acc += s2_part[(size_t)b * M * M + j];
    s2[j] = acc;
  }
}

// sum_partials over nb blocks' partials on stream st; the CUDA error of
// the launch
inline int launch_sum_partials(const float* s1_part, const float* s2_part, float* s1, float* s2,
                               int nb, int M, cudaStream_t st) {
  const int total = M + M * M;
  sum_partials<<<(total + 255) / 256, 256, 0, st>>>(s1_part, s2_part, s1, s2, nb, M);
  return (int)cudaGetLastError();
}

}  // namespace
