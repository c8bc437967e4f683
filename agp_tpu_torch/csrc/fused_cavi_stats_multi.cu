// Fused multi-latent CAVI statistics for Hopper (sm_90a): the four
// stationary gram kinds (gram.cuh) with per-latent ARD lengthscales, and
// two E-steps:
//   * logistic-softmax multiclass (K latents), replacing
//     agp_tpu/ops/pallas_kernels.py, fused_cavi_stats_multiclass and its
//     body _cavi_fused_mc_kernel, with its digamma _digamma_psi;
//   * heteroscedastic regression (2 latents: f the mean, g the
//     log-precision), replacing fused_cavi_stats_het and its body
//     _cavi_fused_het_kernel.
//
// They compute the same functions.  For latent l and minibatch row t:
//   gram     Knm[t, m] = k_l(|x_t/ls_l - z_lm/ls_l|^2), rbf or matern12/32/52
//   kappa    kappa[t,:] = Knm[t,:] K_l^-1
//   moments  mf[l,t] = kappa[t,:] mu_l
//            vf[l,t] = max(max(var_l + jitter - kappa.Knm, 1e-12) + kappa Sigma_l kappa^T, 1e-12)
//   E-step   per row, coupling the latents (see estep_* below)
//   stats    s1_l = kappa^T (rho gmu_l),  S2_l = kappa^T diag(rho gs_l) kappa
// kappa never leaves shared memory.
//
// Design, against the TPU kernels.  The TPU kernel keeps ALL latents'
// K^-1 and Sigma resident (16 MB of VMEM); at K=10, M=64 that is 2 x 160 KB,
// more than a Hopper block's 227 KB of shared memory.  So the work is split
// by latent, into four launches on the caller's stream:
//   1. latent_moments  grid (B/TB, L): one (row tile, latent) per block,
//      with Z_l, K_l^-1, Sigma_l, mu_l and the [TB, M] gram and kappa tiles
//      in shared memory; writes mf, vf [L, B] (8 L B bytes of traffic);
//   2. estep_*         one thread per row: the coupled E-step from mf, vf;
//      writes the local variables and the statistic weights rho gmu,
//      rho gs [L, B];
//   3. latent_stats    grid (B/TB, L): recomputes the gram and kappa of
//      its (row tile, latent), and writes that block's partial s1 [M] and
//      S2 [M, M];
//   4. sum_partials    adds the partials in block order: deterministic, no
//      atomics.
// Splitting by latent also fills the card: L B/TB blocks (320 at K=10,
// B=2048) where one block per row tile would give B/TB = 32 on 132 SMs.
// Shared memory does not depend on L.  The price is recomputing the gram
// and kappa once (pass 3) and the [L, B] round trips, small beside the
// partial sums.
// * The ragged last tile is masked here, from B: rows past B load as zeros,
//   get zero weight and write nothing.  Nothing is padded on the host.
// * FP32 FMA throughout, no TF32.  The gram is the direct sum_d (x_d - z_d)^2;
//   kappa = Knm K^-1 is a full-FP32 dot (K^-1 = L^-T L^-1 formed by the
//   wrapper at full FP32).
// * The gram kind is a template parameter of passes 1 and 3, which both
//   form the gram through gram_kappa<KIND>: one instantiation per kind, the
//   same in both passes.
// * Scalars (jitter, rho, lambda, the L variances, the [L, D] lengthscales)
//   come in one device buffer; the host never reads them.
//
// What bounds it on an H100: per row and latent ~4 M^2 FMAs from shared
// memory (kappa and kappa Sigma in pass 1, kappa and S2 in pass 3) against
// ~4 (D + 2) bytes read: FP32 issue and shared-memory bandwidth, not device
// memory.  Shared memory per block: 4 (TB D + M (D|1) + 2 M^2 + M + 2 TB M
// + 2 TB) bytes in pass 1 (70 KB at M=64, D=10; 214 KB at M=128, D=20).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gram.cuh"

namespace {

constexpr int TB = 64;  // minibatch rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ESTEP_THREADS = 256;
// params layout
constexpr int P_JITT = 0, P_RHO = 1, P_LAM = 2, P_VAR = 3;  // then var [L], ls [L, D]
constexpr float LOG2F = 0.6931471805599453f;

__host__ __device__ inline int z_stride(int D) { return D | 1; }

// fused_fits in ops/cuda_kernels.py copies moments_smem (the larger of the
// two) and TB, so that the CPU and the card dispatch alike: change both
// together (chip_smoke.py's check_fused_fits holds them against each other)
size_t moments_smem(int D, int M) {
  return sizeof(float) * ((size_t)TB * D + (size_t)M * z_stride(D) + 2 * (size_t)M * M + M +
                          2 * (size_t)TB * M + 2 * TB);
}

size_t stats_smem(int D, int M) {
  return sizeof(float) * ((size_t)TB * D + (size_t)M * z_stride(D) + (size_t)M * M +
                          2 * (size_t)TB * M + 2 * TB);
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// log(cosh(c)) without overflow
__device__ inline float logcoshf(float c) {
  c = fabsf(c);
  return c + log1pf(expf(-2.0f * c)) - LOG2F;
}

// the reference's in-kernel digamma: 5 recurrence shifts psi(x) = psi(x+1)
// - 1/x up to x >= 6, then the asymptotic series (~1e-9 absolute for
// x >= 1; alpha >= 1 always)
__device__ inline float digammaf_pos(float x) {
  float res = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (x < 6.0f) {
      res -= 1.0f / x;
      x += 1.0f;
    }
  }
  const float inv = 1.0f / x;
  const float inv2 = inv * inv;
  return res + logf(x) - 0.5f * inv -
         inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f));
}

// Stage row tile `row0` of x and latent k's Z, both divided by the latent's
// lengthscales, then gram -> G and kappa = G K^-1 -> Kp.  Rows past B are
// zeros.  Ends synchronised.
template <int KIND>
__device__ void gram_kappa(const float* __restrict__ x, const float* __restrict__ z,
                           const float* __restrict__ kinv, const float* __restrict__ ls,
                           float var, float* xs, float* zs, float* ki, float* G, float* Kp,
                           int row0, int nrows, int D, int M) {
  const int tid = threadIdx.x;
  const int Dz = z_stride(D);
  for (int i = tid; i < TB * D; i += THREADS) {
    const int t = i / D;
    xs[i] = t < nrows ? x[(size_t)row0 * D + i] / ls[i % D] : 0.0f;
  }
  for (int i = tid; i < M * D; i += THREADS) zs[(i / D) * Dz + i % D] = z[i] / ls[i % D];
  for (int i = tid; i < M * M; i += THREADS) ki[i] = kinv[i];
  __syncthreads();

  for (int i = tid; i < TB * M; i += THREADS) {
    const float* xr = xs + (i / M) * D;
    const float* zr = zs + (i % M) * Dz;
    float r2 = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float df = xr[d] - zr[d];
      r2 = fmaf(df, df, r2);
    }
    G[i] = gram_from_r2<KIND>(r2, var);
  }
  __syncthreads();

  for (int i = tid; i < TB * M; i += THREADS) {
    const float* gr = G + (i / M) * M;
    const int n = i % M;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) acc = fmaf(gr[m], ki[m * M + n], acc);
    Kp[i] = acc;
  }
  __syncthreads();
}

// pass 1: mf, vf [L, B]
template <int KIND>
__global__ void __launch_bounds__(THREADS)
latent_moments(const float* __restrict__ x, const float* __restrict__ z,
               const float* __restrict__ kinv, const float* __restrict__ mu,
               const float* __restrict__ sigma, const float* __restrict__ params,
               float* __restrict__ mf_out, float* __restrict__ vf_out, int B, int D, int M,
               int L) {
  extern __shared__ float sm[];
  const int k = blockIdx.y;
  float* xs = sm;                    // [TB, D]
  float* zs = xs + TB * D;           // [M, Dz]
  float* ki = zs + M * z_stride(D);  // [M, M]  K^-1
  float* sg = ki + M * M;            // [M, M]  Sigma
  float* mus = sg + M * M;           // [M]
  float* G = mus + M;                // [TB, M] gram, later kappa Sigma
  float* Kp = G + TB * M;            // [TB, M] kappa
  float* kt = Kp + TB * M;           // [TB]    Ktilde
  float* mfs = kt + TB;              // [TB]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * TB;
  const int nrows = min(TB, B - row0);
  const float jitt = params[P_JITT];
  const float var = params[P_VAR + k];
  const float* ls = params + P_VAR + L + (size_t)k * D;
  const size_t mm = (size_t)k * M * M;

  for (int i = tid; i < M * M; i += THREADS) sg[i] = sigma[mm + i];
  for (int i = tid; i < M; i += THREADS) mus[i] = mu[(size_t)k * M + i];
  gram_kappa<KIND>(x, z + (size_t)k * M * D, kinv + mm, ls, var, xs, zs, ki, G, Kp, row0, nrows,
                   D, M);

  for (int t = warp; t < TB; t += WARPS) {
    float q = 0.0f, m1 = 0.0f;
    for (int n = lane; n < M; n += 32) {
      const float kp = Kp[t * M + n];
      q = fmaf(kp, G[t * M + n], q);
      m1 = fmaf(kp, mus[n], m1);
    }
    q = warp_sum(q);
    m1 = warp_sum(m1);
    if (lane == 0) {
      kt[t] = fmaxf(var + jitt - q, 1e-12f);
      mfs[t] = m1;
    }
  }
  __syncthreads();

  for (int i = tid; i < TB * M; i += THREADS) {
    const float* kr = Kp + (i / M) * M;
    const int n = i % M;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) acc = fmaf(kr[m], sg[m * M + n], acc);
    G[i] = acc;
  }
  __syncthreads();

  for (int t = warp; t < nrows; t += WARPS) {
    float q = 0.0f;
    for (int n = lane; n < M; n += 32) q = fmaf(G[t * M + n], Kp[t * M + n], q);
    q = warp_sum(q);
    if (lane == 0) {
      const size_t r = (size_t)k * B + row0 + t;
      mf_out[r] = mfs[t];
      vf_out[r] = fmaxf(kt[t] + q, 1e-12f);
    }
  }
}

// pass 2, logistic-softmax, one thread per row; y one-hot [B, K]:
//   c_k = sqrt(mf_k^2 + vf_k)
//   twice: gamma_k = e^psi(alpha) e^{-mf_k/2} / (2 beta cosh(c_k/2)),
//          alpha = 1 + sum_k gamma_k
//   theta_k = (y_k + gamma_k) tanh(c_k/2) / (2 c_k)
//   weights rho (y_k - gamma_k)/2 and rho theta_k/2
// gamma_k is e_round * expcosh_k, so the first round needs only the sum
// of expcosh over the classes and the classes are read twice, not held.
__global__ void __launch_bounds__(ESTEP_THREADS)
estep_multiclass(const float* __restrict__ mf, const float* __restrict__ vf,
                 const float* __restrict__ y, const float* __restrict__ alpha0,
                 const float* __restrict__ beta0, const float* __restrict__ params,
                 float* __restrict__ c_out, float* __restrict__ theta_out,
                 float* __restrict__ gamma_out, float* __restrict__ alpha_out,
                 float* __restrict__ wg, float* __restrict__ ws, int B, int K) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const float rho = params[P_RHO];
  float s = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float m = mf[(size_t)k * B + r];
    const float c = sqrtf(m * m + vf[(size_t)k * B + r]);
    s += expf(-m / 2.0f - logcoshf(c / 2.0f));
  }
  const float two_beta = 2.0f * beta0[r];
  const float alpha1 = 1.0f + expf(digammaf_pos(alpha0[r])) / two_beta * s;
  const float e2 = expf(digammaf_pos(alpha1));
  float gsum = 0.0f;
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * B + r;
    const float m = mf[i];
    const float c = sqrtf(m * m + vf[i]);
    const float g = e2 * expf(-m / 2.0f - logcoshf(c / 2.0f)) / two_beta;
    const float yk = y[(size_t)r * K + k];
    const float th = (yk + g) * tanhf(c / 2.0f) / (2.0f * c);
    gsum += g;
    c_out[i] = c;
    theta_out[i] = th;
    gamma_out[i] = g;
    wg[i] = rho * ((yk - g) / 2.0f);
    ws[i] = rho * (th / 2.0f);
  }
  alpha_out[r] = 1.0f + gsum;
}

// pass 2, heteroscedastic, one thread per row, with the OLD lambda:
//   phi = ((mf - y)^2 + vf)/2, c = sqrt(mg^2 + vg),
//   sigg = e^{-mg/2} / (2 cosh(c/2)), gamma = lam phi sigg,
//   theta = (1/2 + gamma) tanh(c/2) / (2c)
//   weights f: rho y sigg/2, rho sigg/2 (the caller multiplies both by the
//   NEW lambda, a batch-wide quantity); g: rho (1/2 - gamma)/2, rho theta/2
__global__ void __launch_bounds__(ESTEP_THREADS)
estep_het(const float* __restrict__ mf, const float* __restrict__ vf,
          const float* __restrict__ y, const float* __restrict__ params,
          float* __restrict__ c_out, float* __restrict__ phi_out,
          float* __restrict__ gamma_out, float* __restrict__ theta_out,
          float* __restrict__ sigg_out, float* __restrict__ wg, float* __restrict__ ws,
          int B) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const float rho = params[P_RHO], lam = params[P_LAM];
  const float yr = y[r];
  const float df = mf[r] - yr;
  const float phi = (df * df + vf[r]) / 2.0f;
  const float mg = mf[B + r];
  const float c = sqrtf(mg * mg + vf[B + r]);
  const float sigg = expf(-mg / 2.0f - logcoshf(c / 2.0f)) / 2.0f;
  const float gamma = lam * phi * sigg;
  const float theta = (0.5f + gamma) * tanhf(c / 2.0f) / (2.0f * c);
  c_out[r] = c;
  phi_out[r] = phi;
  gamma_out[r] = gamma;
  theta_out[r] = theta;
  sigg_out[r] = sigg;
  wg[r] = rho * (yr * sigg / 2.0f);
  ws[r] = rho * (sigg / 2.0f);
  wg[B + r] = rho * ((0.5f - gamma) / 2.0f);
  ws[B + r] = rho * (theta / 2.0f);
}

// pass 3: this block's partial s1 [M] and S2 [M, M] of latent k
template <int KIND>
__global__ void __launch_bounds__(THREADS)
latent_stats(const float* __restrict__ x, const float* __restrict__ z,
             const float* __restrict__ kinv, const float* __restrict__ params,
             const float* __restrict__ wg, const float* __restrict__ ws,
             float* __restrict__ s1_part, float* __restrict__ s2_part, int B, int D, int M,
             int L) {
  extern __shared__ float sm[];
  const int k = blockIdx.y;
  const int nb = gridDim.x;
  float* xs = sm;                    // [TB, D]
  float* zs = xs + TB * D;           // [M, Dz]
  float* ki = zs + M * z_stride(D);  // [M, M]
  float* G = ki + M * M;             // [TB, M]
  float* Kp = G + TB * M;            // [TB, M]
  float* wgs = Kp + TB * M;          // [TB]
  float* wss = wgs + TB;             // [TB]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TB;
  const int nrows = min(TB, B - row0);
  for (int t = tid; t < TB; t += THREADS) {
    wgs[t] = t < nrows ? wg[(size_t)k * B + row0 + t] : 0.0f;
    wss[t] = t < nrows ? ws[(size_t)k * B + row0 + t] : 0.0f;
  }
  gram_kappa<KIND>(x, z + (size_t)k * M * D, kinv + (size_t)k * M * M,
                   params + P_VAR + L + (size_t)k * D, params[P_VAR + k], xs, zs, ki, G, Kp, row0,
                   nrows, D, M);

  float* s1p = s1_part + ((size_t)k * nb + blockIdx.x) * M;
  float* s2p = s2_part + ((size_t)k * nb + blockIdx.x) * M * M;
  for (int m = tid; m < M; m += THREADS) {
    float acc = 0.0f;
    for (int t = 0; t < nrows; ++t) acc = fmaf(Kp[t * M + m], wgs[t], acc);
    s1p[m] = acc;
  }
  for (int i = tid; i < M * M; i += THREADS) {
    const int m = i / M, n = i % M;
    float acc = 0.0f;
    for (int t = 0; t < nrows; ++t) acc = fmaf(Kp[t * M + m] * wss[t], Kp[t * M + n], acc);
    s2p[i] = acc;
  }
}

// s1[k] = sum_b s1_part[k, b], S2[k] = sum_b s2_part[k, b], in block order
__global__ void sum_partials_latents(const float* __restrict__ s1_part,
                                     const float* __restrict__ s2_part, float* __restrict__ s1,
                                     float* __restrict__ s2, int nb, int M, int L) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n1 = (size_t)L * M, mm = (size_t)M * M;
  if (i < n1) {
    const size_t k = i / M, m = i % M;
    float acc = 0.0f;
    for (int b = 0; b < nb; ++b) acc += s1_part[(k * nb + b) * M + m];
    s1[i] = acc;
  } else if (i < n1 + L * mm) {
    const size_t j = i - n1, k = j / mm, e = j % mm;
    float acc = 0.0f;
    for (int b = 0; b < nb; ++b) acc += s2_part[(k * nb + b) * mm + e];
    s2[j] = acc;
  }
}

template <int KIND>
int launch_moments(const float* x, const float* z, const float* kinv, const float* mu,
                   const float* sigma, const float* params, float* mf, float* vf, int B, int D,
                   int M, int L, cudaStream_t st) {
  const size_t smem = moments_smem(D, M);
  cudaError_t err = cudaFuncSetAttribute(latent_moments<KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  latent_moments<KIND><<<dim3((B + TB - 1) / TB, L), THREADS, smem, st>>>(
      x, z, kinv, mu, sigma, params, mf, vf, B, D, M, L);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_stats(const float* x, const float* z, const float* kinv, const float* params,
                 const float* wg, const float* ws, float* s1_part, float* s2_part, float* s1,
                 float* s2, int B, int D, int M, int L, cudaStream_t st) {
  const int nb = (B + TB - 1) / TB;
  const size_t smem = stats_smem(D, M);
  cudaError_t err = cudaFuncSetAttribute(latent_stats<KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  latent_stats<KIND><<<dim3(nb, L), THREADS, smem, st>>>(x, z, kinv, params, wg, ws, s1_part,
                                                         s2_part, B, D, M, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)L * (M + (size_t)M * M);
  sum_partials_latents<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(s1_part, s2_part, s1, s2,
                                                                         nb, M, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int agp_multi_tile_rows(void) { return TB; }

size_t agp_multi_smem_bytes(int D, int M) {
  const size_t a = moments_smem(D, M), b = stats_smem(D, M);
  return a > b ? a : b;
}

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], y one-hot [B, K], z [K, M, D], kinv [K, M, M], mu [K, M],
// sigma [K, M, M], params [3 + K + K D] = (jitter, rho, unused, var [K],
// ls [K, D]), alpha0, beta0 [B]; outputs c, theta, gamma [K, B], alpha [B],
// s1 [K, M], s2 [K, M, M]; scratch mf, vf, wg, ws [K, B],
// s1_part [K, nb, M], s2_part [K, nb, M, M] with nb = ceil(B / TB).  kind:
// a GramKind code.  Returns the CUDA error of the launches
// (cudaErrorInvalidValue for an unknown kind).
int agp_fused_cavi_stats_multiclass(const float* x, const float* y, const float* z,
                                    const float* kinv, const float* mu, const float* sigma,
                                    const float* params, const float* alpha0, const float* beta0,
                                    float* c, float* theta, float* gamma, float* alpha, float* mf,
                                    float* vf, float* wg, float* ws, float* s1_part,
                                    float* s2_part, float* s1, float* s2, int B, int D, int M,
                                    int K, int kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kind(kind, [&](auto k) {
    constexpr int KIND = decltype(k)::value;
    int err = launch_moments<KIND>(x, z, kinv, mu, sigma, params, mf, vf, B, D, M, K, st);
    if (err) return err;
    estep_multiclass<<<(B + ESTEP_THREADS - 1) / ESTEP_THREADS, ESTEP_THREADS, 0, st>>>(
        mf, vf, y, alpha0, beta0, params, c, theta, gamma, alpha, wg, ws, B, K);
    err = (int)cudaGetLastError();
    if (err) return err;
    return launch_stats<KIND>(x, z, kinv, params, wg, ws, s1_part, s2_part, s1, s2, B, D, M, K, st);
  });
}

// As above with 2 latents (f, g): y [B], params [3 + 2 + 2 D] = (jitter,
// rho, lambda, var [2], ls [2, D]); outputs c, phi, gamma, theta, sigg [B],
// s1 [2, M], s2 [2, M, M] with f's statistics WITHOUT the lambda factor.
int agp_fused_cavi_stats_het(const float* x, const float* y, const float* z, const float* kinv,
                             const float* mu, const float* sigma, const float* params, float* c,
                             float* phi, float* gamma, float* theta, float* sigg, float* mf,
                             float* vf, float* wg, float* ws, float* s1_part, float* s2_part,
                             float* s1, float* s2, int B, int D, int M, int kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kind(kind, [&](auto k) {
    constexpr int KIND = decltype(k)::value;
    int err = launch_moments<KIND>(x, z, kinv, mu, sigma, params, mf, vf, B, D, M, 2, st);
    if (err) return err;
    estep_het<<<(B + ESTEP_THREADS - 1) / ESTEP_THREADS, ESTEP_THREADS, 0, st>>>(
        mf, vf, y, params, c, phi, gamma, theta, sigg, wg, ws, B);
    err = (int)cudaGetLastError();
    if (err) return err;
    return launch_stats<KIND>(x, z, kinv, params, wg, ws, s1_part, s2_part, s1, s2, B, D, M, 2, st);
  });
}

}  // extern "C"
