// Device code that the batched pair (batched_pair.cu: kernels 4-5) and the
// single-latent split pair (kappa_single.cu: kernels 6-7) share:
//   * the row tile's gram in shared memory, formed over feature chunks
//     (gram_tile), and the register-tiled product of that tile with an
//     [M, M] matrix streamed from device memory (L2) through a [KC, NP]
//     panel (panel_product): kappa = Knm K^-1 in kernels 4 and 6, kappa Sigma
//     in kernel 4;
//   * kernel 5's statistics s1 = kappa^T g, S2 = kappa^T diag(theta) kappa
//     (stats_batched, then sum_chunks), which kernel 7 runs with one latent.
// See batched_pair.cu for what bounds these on an H100 and why they are
// built so.  Everything is in an anonymous namespace: each source that
// includes this header compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gram.cuh"

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

// ---------------------------------------------------------- the statistics
constexpr int ST = 128;  // edge of an output tile of S2
constexpr int SKB = 8;   // rows staged per step
constexpr int S_THREADS = 256;
constexpr int S_PER = SKB * ST / S_THREADS;  // entries of each operand a thread stages

// the t-th tile (ti <= tj) of the upper triangle of an nt x nt grid, row by row
__device__ __forceinline__ void upper_tile(int t, int nt, int& ti, int& tj) {
  ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  tj = ti + t;
}

// Loads SKB rows from row b (zeros past b1 and M): theta kappa of tile ti's
// columns into pa, kappa of tile tj's into pb, and g into pg; consecutive
// threads on consecutive columns.
__device__ __forceinline__ void load_rows(const float* __restrict__ kl, const float* __restrict__ gl,
                                          const float* __restrict__ thl, int b, int b1, int M,
                                          int m0, int n0, float (&pa)[S_PER], float (&pb)[S_PER],
                                          float& pg) {
#pragma unroll
  for (int i = 0; i < S_PER; ++i) {
    const int e = threadIdx.x + i * S_THREADS;
    const int row = b + e / ST, c = e % ST;
    const bool ok = row < b1;
    const float th = ok ? __ldg(thl + row) : 0.0f;
    pa[i] = (ok && m0 + c < M) ? __ldg(kl + (size_t)row * M + m0 + c) * th : 0.0f;
    pb[i] = (ok && n0 + c < M) ? __ldg(kl + (size_t)row * M + n0 + c) : 0.0f;
  }
  if (threadIdx.x < SKB) pg = b + threadIdx.x < b1 ? __ldg(gl + b + threadIdx.x) : 0.0f;
}

__device__ __forceinline__ void fma4x4(float (&acc)[8][8], int r0, int c0, float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r0 + r][c0 + j] = fmaf(av[r], bv[j], acc[r0 + r][c0 + j]);
}

// grid (upper tiles, chunks, L): the partial S2 tile (and, on a diagonal
// tile, the partial s1 of its columns) of one chunk of rows.  Thread
// (tx, ty) = (tid % 16, tid / 16) holds rows 4 ty + {0..3} and 64 + 4 ty +
// {0..3}, columns 4 tx + {0..3} and 64 + 4 tx + {0..3} of the tile, so
// each 16-byte shared load feeds 16 FMAs; two shared stages, so one
// barrier a step.
__global__ void __launch_bounds__(S_THREADS, 2)
stats_batched(const float* __restrict__ kappa, const float* __restrict__ g,
              const float* __restrict__ theta, float* __restrict__ s1_part,
              float* __restrict__ s2_part, int B, int M, int rows_per_chunk) {
  __shared__ __align__(16) float As[2][SKB][ST];  // theta kappa, tile ti's columns
  __shared__ __align__(16) float Bs[2][SKB][ST];  // kappa, tile tj's columns
  __shared__ float gs[2][SKB];
  const int nt = (M + ST - 1) / ST;
  int ti, tj;
  upper_tile(blockIdx.x, nt, ti, tj);
  const int chunk = blockIdx.y, nchunks = gridDim.y, l = blockIdx.z;
  const int m0 = ti * ST, n0 = tj * ST;
  const int b0 = chunk * rows_per_chunk, b1 = min(B, b0 + rows_per_chunk);
  const float* kl = kappa + (size_t)l * B * M;
  const float* gl = g + (size_t)l * B;
  const float* thl = theta + (size_t)l * B;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool diag = ti == tj;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
  float s1acc = 0.0f;
  float pa[S_PER], pb[S_PER], pg = 0.0f;
  load_rows(kl, gl, thl, b0, b1, M, m0, n0, pa, pb, pg);
  int stage = 0;
  for (int b = b0; b < b1; b += SKB, stage ^= 1) {
    // stage `stage` was last read two steps ago, before the last barrier
#pragma unroll
    for (int i = 0; i < S_PER; ++i) {
      const int e = tid + i * S_THREADS;
      As[stage][e / ST][e % ST] = pa[i];
      Bs[stage][e / ST][e % ST] = pb[i];
    }
    if (tid < SKB) gs[stage][tid] = pg;
    __syncthreads();
    if (b + SKB < b1) load_rows(kl, gl, thl, b + SKB, b1, M, m0, n0, pa, pb, pg);
#pragma unroll
    for (int k = 0; k < SKB; ++k) {
      const float4* a4 = reinterpret_cast<const float4*>(As[stage][k]);
      const float4* b4 = reinterpret_cast<const float4*>(Bs[stage][k]);
      const float4 a0 = a4[ty], a1 = a4[16 + ty], c0 = b4[tx], c1 = b4[16 + tx];
      fma4x4(acc, 0, 0, a0, c0);
      fma4x4(acc, 0, 4, a0, c1);
      fma4x4(acc, 4, 0, a1, c0);
      fma4x4(acc, 4, 4, a1, c1);
    }
    if (diag && tid < ST)
      for (int k = 0; k < SKB; ++k) s1acc = fmaf(Bs[stage][k][tid], gs[stage][k], s1acc);
  }

  const size_t part = (size_t)l * nchunks + chunk;
  float* out = s2_part + part * M * M;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < M) out[(size_t)m * M + n] = acc[r][j];
    }
  }
  if (diag && tid < ST && m0 + tid < M) s1_part[part * M + m0 + tid] = s1acc;
}

// s1 and S2 of every latent: the chunk partials added in chunk order;
// S2[m, n] and S2[n, m] both from the upper-triangle entry
__global__ void sum_chunks(const float* __restrict__ s1_part, const float* __restrict__ s2_part,
                           float* __restrict__ s1, float* __restrict__ s2, int M, int L,
                           int nchunks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n1 = (size_t)L * M, mm = (size_t)M * M;
  if (i < n1) {
    const size_t l = i / M, m = i % M;
    float acc = 0.0f;
    for (int c = 0; c < nchunks; ++c) acc += s1_part[(l * nchunks + c) * M + m];
    s1[i] = acc;
  } else if (i < n1 + L * mm) {
    const size_t j = i - n1, l = j / mm, e = j % mm;
    const size_t m = e / M, n = e % M;
    const size_t lo = m < n ? m : n, hi = m < n ? n : m;
    float acc = 0.0f;
    for (int c = 0; c < nchunks; ++c) acc += s2_part[(l * nchunks + c) * mm + lo * M + hi];
    s2[j] = acc;
  }
}

// Both launches of the statistics of L latents; returns the CUDA error.
int launch_stats(const float* kappa, const float* g, const float* theta, float* s1_part,
                 float* s2_part, float* s1, float* s2, int B, int M, int L, int nchunks,
                 int rows_per_chunk, cudaStream_t st) {
  const int nt = (M + ST - 1) / ST;
  stats_batched<<<dim3(nt * (nt + 1) / 2, nchunks, L), S_THREADS, 0, st>>>(
      kappa, g, theta, s1_part, s2_part, B, M, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)L * (M + (size_t)M * M);
  sum_chunks<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(s1_part, s2_part, s1, s2, M, L,
                                                              nchunks);
  return (int)cudaGetLastError();
}

}  // namespace
