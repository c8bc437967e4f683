// The batched multi-latent pair for Hopper (sm_90a): the large-M tier of
// the CAVI step, for any number of latents L (one included).
//
// Replaces, in agp_tpu/ops/pallas_kernels.py:
//   * fused_kappa_moments_batched (:361, pallas_call at :419, body
//     _kappa_moments_batched_kernel): kappa_moments_batched below.  For
//     latent l and minibatch row t:
//       gram    Knm[t, m]  = k_l(|x_t/ls_l - z_lm/ls_l|^2)   (gram.cuh)
//       kappa   kappa[t,:] = Knm[t,:] K_l^-1
//       Ktilde  kt[t]      = max(var_l + jitter - sum_m kappa[t,m] Knm[t,m], 1e-12)
//       moments mf[l,t]    = kappa[t,:] mu_l
//               vf[l,t]    = max(kt[t] + kappa[t,:] Sigma_l kappa[t,:]^T, 1e-12)
//     and writes kappa [L, B, M] row-major (the layout the JAX function
//     returns), mf and vf [L, B].
//   * cavi_stats_batched (:486, pallas_call at :503, body
//     _stats_batched_kernel): stats_batched below.  s1[l] = kappa[l]^T g[l],
//     S2[l] = kappa[l]^T diag(theta[l]) kappa[l].
// Between the two the caller runs the likelihood's E-step, which may couple
// the latents (logistic-softmax, heteroscedastic); that is why kappa goes
// through device memory.
//
// What bounds them on an H100: FMAs.  Per row and latent kernel 4 does
// 2 M^2 FMAs (kappa = Knm K^-1 and kappa Sigma) and kernel 5 M (M+1)/2 (the
// upper triangle of S2), against 4 M bytes of kappa written and read back;
// 34 G + 8.6 G FMAs at B=65,536, M=512, about 1.3 ms at the card's FP32
// peak, against 0.08 ms for the kappa round trip at 3.35 TB/s.  The
// operands K^-1 and Sigma (1 MB each per latent at M=512) and kappa come
// from L2, not from device memory, so the design is about feeding the FMA
// units from shared memory:
// * The TPU kernels keep K^-1 and Sigma resident in VMEM.  A Hopper block
//   has 227 KB of shared memory, so kernel 4 streams them through a
//   [16, 256] panel (16 KB) instead, prefetched into registers one panel
//   ahead of the one in use, and keeps resident only its row tile's gram
//   and kappa ([TB, M] each, TB = 32 rows, or 16 when M is too large for
//   32: up to M = 1,680 on an H100).
// * Both kernels are register-tiled products: in kernel 4 each thread holds
//   an 8 x 4 block of the output, so one 16-byte shared load feeds 32 FMAs;
//   in kernel 5 an 8 x 8 block of a 128 x 128 output tile of S2 (16 FMAs a
//   load), with two shared stages so that a step takes one barrier.
// * Kernel 4's row reductions (Ktilde, mf, vf) ride in the products'
//   epilogues and are summed by warp shuffles in a fixed order.
// * The TPU grid accumulates S2 in one resident block over the batch.
//   CUDA blocks run in parallel, so kernel 5 gives each block one output
//   tile (upper triangle only: S2 is symmetric) and one chunk of rows; the
//   chunk partials, a few per latent, are added in chunk order by a second
//   launch: deterministic, no atomics.  The caller sizes the chunks so
//   that every block of the grid is resident at once (one wave of equal
//   blocks, from the occupancy API); their number does not grow with B.
// * The ragged edges are masked here, from B and M; nothing is padded on
//   the host.  The gram is the direct sum_d (x_d - z_d)^2 over feature
//   chunks of 8 (any D), the kind a template parameter.
// * FP32 FMA throughout, no TF32 and no tensor cores: kappa = Knm K^-1
//   cancels by cond(Kmm).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gram.cuh"

namespace {

// ---------------------------------------------------------------- kernel 4
constexpr int RM = 8;    // output rows per thread
constexpr int NP = 256;  // columns of a panel: 64 threads x 4
constexpr int KC = 16;   // depth of a panel
constexpr int DC = 8;    // features staged per gram pass
// params layout (ops/cuda_kernels.py::_multi_params): jitter, rho, lambda,
// var [L], ls [L, D]
constexpr int P_JITT = 0, P_VAR = 3;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr int km_threads(int tb) { return tb / RM * (NP / 4); }

// G and kappa [tb, mk], the panel [KC, NP], the row sums [6, tb]
size_t km_smem(int M, int tb) {
  const size_t mk = round_up(M, KC);
  return sizeof(float) * (2 * (size_t)tb * mk + (size_t)KC * NP + 6 * (size_t)tb);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
// streamed through the panel P.  Ends with P free only after a barrier.
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

template <int KIND, int TB>
__global__ void __launch_bounds__(TB / RM * (NP / 4))
kappa_moments_batched(const float* __restrict__ x, const float* __restrict__ z,
                      const float* __restrict__ kinv, const float* __restrict__ mu,
                      const float* __restrict__ sigma, const float* __restrict__ params,
                      float* __restrict__ kappa, float* __restrict__ mf_out,
                      float* __restrict__ vf_out, int B, int D, int M, int L) {
  constexpr int T = km_threads(TB);
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int mk = round_up(M, KC);
  float* G = sm;               // [TB, mk]  gram (first |x - z|^2), zero past M
  float* Kp = G + TB * mk;     // [TB, mk]  kappa; z / ls chunks while the gram forms
  float* P = Kp + TB * mk;     // [KC, NP]  panel; x / ls chunks while the gram forms
  float* red = P + KC * NP;    // [6, TB]   row sums: Ktilde, mf, vf, two slots each

  const int l = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 64, ty = tid / 64;
  const int row0 = blockIdx.x * TB;
  const int nrows = min(TB, B - row0);
  const float jitt = params[P_JITT], var = params[P_VAR + l];
  const float* ls = params + P_VAR + L + (size_t)l * D;
  const float* zl = z + (size_t)l * M * D;
  const size_t mm = (size_t)l * M * M;

  // gram: r2 accumulated over feature chunks, then the kind's formula
  for (int i = tid; i < TB * mk; i += T) G[i] = 0.0f;
  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dc = min(DC, D - d0);
    float* xs = P;   // [TB, DC]
    float* zs = Kp;  // [M, DC + 1]
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
  // (panel_product begins with a barrier)

  // kappa = G K^-1, panel by panel; Ktilde's and mf's row sums in the epilogue
  float kq[RM], mq[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) kq[r] = mq[r] = 0.0f;
  for (int c0 = 0; c0 < M; c0 += NP) {
    float acc[RM][4];
    panel_product<TB>(G, mk, kinv + mm, M, c0, P, acc);
    const int cb = c0 + 4 * tx;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ty * RM + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cb + j < M) {
          kq[r] = fmaf(acc[r][j], G[row * mk + cb + j], kq[r]);
          mq[r] = fmaf(acc[r][j], __ldg(mu + (size_t)l * M + cb + j), mq[r]);
        }
      }
      // columns past M hold zeros (the panel is zero there)
      if (cb < mk)
        *reinterpret_cast<float4*>(Kp + row * mk + cb) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  row_sums<TB>(kq, red);
  row_sums<TB>(mq, red + 2 * TB);
  __syncthreads();

  // kappa out, coalesced along the rows of [L, B, M]
  float* kl = kappa + ((size_t)l * B + row0) * M;
  for (int i = tid; i < nrows * M; i += T) kl[i] = Kp[(i / M) * mk + i % M];

  // kappa Sigma, contracted with kappa in the epilogue
  float vq[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) vq[r] = 0.0f;
  for (int c0 = 0; c0 < M; c0 += NP) {
    float acc[RM][4];
    panel_product<TB>(Kp, mk, sigma + mm, M, c0, P, acc);
    const int cb = c0 + 4 * tx;
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cb + j < M) vq[r] = fmaf(acc[r][j], Kp[(ty * RM + r) * mk + cb + j], vq[r]);
  }
  row_sums<TB>(vq, red + 4 * TB);
  __syncthreads();

  for (int t = tid; t < nrows; t += T) {
    const float kt = fmaxf(var + jitt - (red[t] + red[TB + t]), 1e-12f);
    const size_t r = (size_t)l * B + row0 + t;
    mf_out[r] = red[2 * TB + t] + red[3 * TB + t];
    vf_out[r] = fmaxf(kt + (red[4 * TB + t] + red[5 * TB + t]), 1e-12f);
  }
}

template <int KIND, int TB>
int launch_kappa_moments(const float* x, const float* z, const float* kinv, const float* mu,
                         const float* sigma, const float* params, float* kappa, float* mf,
                         float* vf, int B, int D, int M, int L, cudaStream_t st) {
  const size_t smem = km_smem(M, TB);
  cudaError_t err = cudaFuncSetAttribute(kappa_moments_batched<KIND, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kappa_moments_batched<KIND, TB><<<dim3((B + TB - 1) / TB, L), km_threads(TB), smem, st>>>(
      x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M, L);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- kernel 5
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

}  // namespace

extern "C" {

size_t agp_kappa_moments_smem_bytes(int M, int tile_rows) { return km_smem(M, tile_rows); }

int agp_cavi_stats_tile(void) { return ST; }

// resident blocks of kernel 5 on one SM of the current device (0 on error)
int agp_cavi_stats_blocks_per_sm(void) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stats_batched, S_THREADS, 0) != cudaSuccess)
    return 0;
  return n;
}

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], z [L, M, D], kinv [L, M, M], mu [L, M], sigma [L, M, M],
// params [3 + L + L D] = (jitter, unused, unused, var [L], ls [L, D]);
// outputs kappa [L, B, M], mf, vf [L, B].  kind: a GramKind code;
// tile_rows: 32 or 16 (agp_kappa_moments_smem_bytes must fit the card).
// Returns the CUDA error of the launch (cudaErrorInvalidValue for an
// unknown kind or tile).
int agp_fused_kappa_moments_batched(const float* x, const float* z, const float* kinv,
                                    const float* mu, const float* sigma, const float* params,
                                    float* kappa, float* mf, float* vf, int B, int D, int M,
                                    int L, int kind, int tile_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kind(kind, [&](auto k) {
    constexpr int KIND = decltype(k)::value;
    if (tile_rows == 32)
      return launch_kappa_moments<KIND, 32>(x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M,
                                            L, st);
    if (tile_rows == 16)
      return launch_kappa_moments<KIND, 16>(x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M,
                                            L, st);
    return (int)cudaErrorInvalidValue;
  });
}

// kappa [L, B, M], g and theta [L, B]; outputs s1 [L, M], s2 [L, M, M];
// scratch s1_part [L, nchunks, M], s2_part [L, nchunks, M, M], with
// nchunks = ceil(B / rows_per_chunk).  Returns the CUDA error of the
// launches.
int agp_cavi_stats_batched(const float* kappa, const float* g, const float* theta, float* s1_part,
                           float* s2_part, float* s1, float* s2, int B, int M, int L, int nchunks,
                           int rows_per_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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

}  // extern "C"
