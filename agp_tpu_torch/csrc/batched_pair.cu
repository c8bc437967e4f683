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
//     _stats_batched_kernel): s1[l] = kappa[l]^T g[l], S2[l] =
//     kappa[l]^T diag(theta[l]) kappa[l], by the 3xTF32 tensor-core tiles
//     of stats_tc.cuh (stats_tc, then sum_tiles), which kernel 7 runs with
//     one latent; that file says what bounds them and why S2 may take the
//     tensor cores.
// Between the two the caller runs the likelihood's E-step, which may couple
// the latents (logistic-softmax, heteroscedastic); that is why kappa goes
// through device memory.  The gram tile and the panel product live in
// pair_core.cuh, which the single-latent split pair (kappa_single.cu)
// shares.
//
// What bounds kernel 4 on an H100: FMAs.  Per row and latent it does
// 2 M^2 FMAs (kappa = Knm K^-1 and kappa Sigma) against 4 M bytes of kappa
// written: 34 G FMAs at B=65,536, M=512, about 1 ms at the card's FP32
// peak, against 0.04 ms for writing kappa at 3.35 TB/s.  The operands K^-1
// and Sigma (1 MB each per latent at M=512) come from L2, not from device
// memory, so the design is about feeding the FMA units from shared memory:
// * The TPU kernel keeps K^-1 and Sigma resident in VMEM.  A Hopper block
//   has 227 KB of shared memory, so kernel 4 streams them through a
//   [16, 256] panel (16 KB) instead, prefetched into registers one panel
//   ahead of the one in use, and keeps resident only its row tile's gram
//   and kappa ([TB, M] each, TB = 32 rows, or 16 when M is too large for
//   32: up to M = 1,680 on an H100).
// * A register-tiled product: each thread holds an 8 x 4 block of the
//   output, so one 16-byte shared load feeds 32 FMAs.
// * The row reductions (Ktilde, mf, vf) ride in the products' epilogues
//   and are summed by warp shuffles in a fixed order.
// * The ragged edges are masked here, from B and M; nothing is padded on
//   the host.  The gram is the direct sum_d (x_d - z_d)^2 over feature
//   chunks of 8 (any D), the kind a template parameter.
// * Kernel 4 is FP32 FMA throughout, no TF32 and no tensor cores:
//   kappa = Knm K^-1 cancels by cond(Kmm).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "pair_core.cuh"

namespace {

// ---------------------------------------------------------------- kernel 4
// G and kappa [tb, mk], the panel [KC, NP], the row sums [6, tb]
size_t km_smem(int M, int tb) {
  const size_t mk = round_up(M, KC);
  return sizeof(float) * (2 * (size_t)tb * mk + (size_t)KC * NP + 6 * (size_t)tb);
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

  // gram: r2 accumulated over feature chunks, then the kind's formula; the
  // chunks of x / ls and z / ls are staged in P and Kp
  gram_tile<KIND, TB>(x, zl, ls, var, G, P, Kp, row0, nrows, D, M, mk);
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

}  // namespace

extern "C" {

size_t agp_kappa_moments_smem_bytes(int M, int tile_rows) { return km_smem(M, tile_rows); }

// edge of kernels 5 and 7's output tiles
int agp_cavi_stats_tile(void) { return TILE; }

// resident blocks of kernels 5 and 7 on one SM of the current device (0 on
// error)
int agp_cavi_stats_blocks_per_sm(void) { return stats_blocks_per_sm(); }

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

// kappa [L, B, M], g and theta [L, B]; outputs s1 [L, M], s2 [L, M, M]
// (exactly symmetric); scratch s1_part [L, nchunks, M], s2_part
// [L, nchunks, M, M], with nchunks = ceil(B / rows_per_chunk).  Returns the
// CUDA error of the launches.
int agp_cavi_stats_batched(const float* kappa, const float* g, const float* theta, float* s1_part,
                           float* s2_part, float* s1, float* s2, int B, int M, int L, int nchunks,
                           int rows_per_chunk, void* stream) {
  return launch_stats(kappa, g, theta, s1_part, s2_part, s1, s2, B, M, L, nchunks, rows_per_chunk,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
