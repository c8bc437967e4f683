// Device code that the batched pair (batched_pair.cu: kernels 4-5) and the
// single-latent split pair (kappa_single.cu: kernels 6-7) share:
//   * the row tile's gram in shared memory, formed over feature chunks
//     (gram_tile), and the register-tiled product of that tile with an
//     [M, M] matrix streamed from device memory (L2) through a [KC, NP]
//     panel (panel_product): kappa = Knm K^-1 in kernels 4 and 6, kappa Sigma
//     in kernel 4 (full FP32 FMA: kappa = Knm K^-1 cancels by cond(Kmm));
//   * through stats_tc.cuh, the statistics s1 = kappa^T g and
//     S2 = kappa^T diag(theta) kappa of kernels 5 and 7 (3xTF32 tensor-core
//     tiles; that file says why they may use the tensor cores).
// See batched_pair.cu for what bounds kernels 4 and 6 on an H100 and why
// they are built so.  Everything is in an anonymous namespace: each source
// that includes this header compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gram.cuh"
#include "stats_tc.cuh"

namespace {

// ------------------------------------------------ gram tile and panel product
constexpr int RM = 8;    // output rows per thread
constexpr int NP = 256;  // columns of a panel: 64 threads x 4
constexpr int KC = 16;   // depth of a panel
constexpr int DC = 8;    // features staged per gram pass
// params layout (ops/cuda_kernels.py::_multi_params): jitter, rho, lambda,
// var [L], ls [L, D]
constexpr int P_JITT = 0, P_VAR = 3;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr int km_threads(int tb) { return tb / RM * (NP / 4); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// G [TB, mk] = the kind's gram of the row tile x[row0 : row0 + nrows] / ls
// against zl / ls [M, D], zero past nrows and M.  r2 = sum_d (x_d - z_d)^2 is
// accumulated over feature chunks of DC, staged in xs [TB, DC] and
// zs [M, DC + 1] (shared memory the caller reuses afterwards).  Ends without
// a barrier after the last write to G.
template <int KIND, int TB>
__device__ __forceinline__ void gram_tile(const float* __restrict__ x, const float* __restrict__ zl,
                                          const float* __restrict__ ls, float var, float* G, float* xs,
                                          float* zs, int row0, int nrows, int D, int M, int mk) {
  constexpr int T = km_threads(TB);
  const int tid = threadIdx.x;
  for (int i = tid; i < TB * mk; i += T) G[i] = 0.0f;
  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = min(DC, D - d0);
    __syncthreads();
    for (int i = tid; i < TB * DC; i += T) {
      const int t = i / DC, dd = i % DC;
      xs[i] = (t < nrows && dd < dc) ? x[(size_t)(row0 + t) * D + d0 + dd] / ls[d0 + dd] : 0.0f;
    }
    for (int i = tid; i < M * DC; i += T) {
      const int m = i / DC, dd = i % DC;
      zs[m * (DC + 1) + dd] = dd < dc ? zl[(size_t)m * D + d0 + dd] / ls[d0 + dd] : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < TB * M; i += T) {
      const int t = i / M, m = i % M;
      float r2 = G[t * mk + m];
      for (int dd = 0; dd < dc; ++dd) {
        const float df = xs[t * DC + dd] - zs[m * (DC + 1) + dd];
        r2 = fmaf(df, df, r2);
      }
      G[t * mk + m] = r2;
    }
  }
  __syncthreads();
  for (int i = tid; i < TB * M; i += T) {
    const int t = i / M, m = i % M;
    G[t * mk + m] = t < nrows ? gram_from_r2<KIND>(G[t * mk + m], var) : 0.0f;
  }
}

// Loads the [KC, NP] panel of Bm [M, M] at rows k0, columns c0 into
// registers (zeros past M): PER entries a thread, consecutive threads on
// consecutive columns.
template <int T, int PER>
__device__ __forceinline__ void load_panel(const float* __restrict__ Bm, int M, int k0, int c0,
                                           float (&pre)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * T;
    const int k = k0 + e / NP, col = c0 + e % NP;
    pre[i] = (k < M && col < M) ? __ldg(Bm + (size_t)k * M + col) : 0.0f;
  }
}

// acc[r][j] = sum_k A[ty*RM + r, k] Bm[k, c0 + 4 tx + j]: A [TB, mk] in
// shared memory (zero past M), Bm [M, M] row-major in device memory,
// streamed through the panel P.  Begins with a barrier; ends with P free
// only after a barrier.
template <int TB>
__device__ __forceinline__ void panel_product(const float* __restrict__ A, int mk,
                                              const float* __restrict__ Bm, int M, int c0,
                                              float* P, float (&acc)[RM][4]) {
  constexpr int T = km_threads(TB);
  constexpr int PER = KC * NP / T;
  const int tx = threadIdx.x % 64, ty = threadIdx.x / 64;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
  float pre[PER];
  load_panel<T, PER>(Bm, M, 0, c0, pre);
  const float4* P4 = reinterpret_cast<const float4*>(P);
  for (int k0 = 0; k0 < mk; k0 += KC) {
    __syncthreads();  // every thread is done with the previous panel
#pragma unroll
    for (int i = 0; i < PER; ++i) P[threadIdx.x + i * T] = pre[i];
    __syncthreads();
    if (k0 + KC < mk) load_panel<T, PER>(Bm, M, k0 + KC, c0, pre);  // in flight meanwhile
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = P4[(kk + q) * (NP / 4) + tx];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(A + (size_t)(ty * RM + r) * mk + k0 + kk);
        acc[r][0] = fmaf(a.w, b[3].x, fmaf(a.z, b[2].x, fmaf(a.y, b[1].x, fmaf(a.x, b[0].x, acc[r][0]))));
        acc[r][1] = fmaf(a.w, b[3].y, fmaf(a.z, b[2].y, fmaf(a.y, b[1].y, fmaf(a.x, b[0].y, acc[r][1]))));
        acc[r][2] = fmaf(a.w, b[3].z, fmaf(a.z, b[2].z, fmaf(a.y, b[1].z, fmaf(a.x, b[0].z, acc[r][2]))));
        acc[r][3] = fmaf(a.w, b[3].w, fmaf(a.z, b[2].w, fmaf(a.y, b[1].w, fmaf(a.x, b[0].w, acc[r][3]))));
      }
    }
  }
}

// Sums each thread's per-row partials v[r] over the 64 threads of its row
// group: a warp shuffle, then one slot per warp in out [2, TB].
template <int TB>
__device__ __forceinline__ void row_sums(const float (&v)[RM], float* out) {
  const int lane = threadIdx.x % 32, half = (threadIdx.x % 64) / 32, ty = threadIdx.x / 64;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float s = warp_sum(v[r]);
    if (lane == 0) out[half * TB + ty * RM + r] = s;
  }
}

}  // namespace
