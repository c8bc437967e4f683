// Fused multi-latent CAVI statistics for Hopper (sm_90a), kernels 2 and 3
// of the port: the four stationary gram kinds (gram.cuh) with per-latent
// ARD lengthscales, and two E-steps:
//   * logistic-softmax multiclass (K latents), replacing
//     agp_tpu/ops/pallas_kernels.py, fused_cavi_stats_multiclass (:953,
//     pallas_call at :981) and its body _cavi_fused_mc_kernel (:846), with
//     its digamma _digamma_psi;
//   * heteroscedastic regression (2 latents: f the mean, g the
//     log-precision), replacing fused_cavi_stats_het (:1133, pallas_call at
//     :1159) and its body _cavi_fused_het_kernel (:1034).
//
// They compute the same functions.  For latent l and minibatch row t:
//   gram     Knm[t, m] = k_l(|x_t/ls_l - z_lm/ls_l|^2), rbf or matern12/32/52
//   kappa    kappa[t,:] = Knm[t,:] K_l^-1
//   moments  mf[l,t] = kappa[t,:] mu_l
//            vf[l,t] = max(max(var_l + jitter - kappa.Knm, 1e-12) + kappa Sigma_l kappa^T, 1e-12)
//   E-step   per row, coupling the latents (see estep_* below)
//   stats    s1_l = kappa^T (rho gmu_l),  S2_l = kappa^T diag(rho gs_l) kappa
//
// What bounds them on an H100: operations.  Per row and latent M^2 FMAs
// for kappa, the quadratic form's and S2's M (M+1)/2 each and M D for the
// gram, against 4 (D + 3 + 4 K) bytes a row (multiclass).  At the bench's
// multiclass shape (K=10, B=2048, D=10, M=64; chip_smoke.py::fused_bound): the
// function's bound, its products once at the TF32 tensor-core peak
// (495 TFLOP/s) and the rest at the FP32 one (67), 0.68 us; this design's,
// kappa and kappa Sigma in full and S2's upper triangle in three TF32
// passes, 2.55 us; the FP32 pipes', 5.63 us.  The parent design (FP32
// FMA, K^-1 and Sigma whole in shared memory, the gram and kappa formed
// twice, one [M, M] partial a block) took 158.7 us there.
//
// Design: kernel 1's (fused_cavi_stats.cu) over a (row tile, latent) grid.
// The TPU kernel keeps every latent's K^-1 and Sigma resident in VMEM;
// here they stream from L2 and the latents split across blocks, since the
// E-step couples a row's latents.  Four launches on the caller's stream:
//   1. latent_rows, grid (ceil(B / 64), L), kernel 1's 64 x 128 tile (2 x 4
//      warps of 32 x 32, two blocks an SM): pair_core.cuh's moment_rows on
//      latent l with its variance and lengthscale row from the params
//      buffer (the gram by direct differences, features staged in chunks,
//      so D enters no shared memory; kappa = G K_l^-1 and kappa Sigma_l in
//      3xTF32 mma.sync, K_l^-1 and Sigma_l through a cp.async ring; the
//      row sums in a fixed order); stores kappa to an [L, B, M] scratch
//      and mf, vf to [L, B];
//   2. estep_multiclass or estep_het, one thread a row: the coupled E-step
//      from every latent's mf and vf; writes the local variables and the
//      statistics' weights rho g_mu, rho g_s [L, B];
//   3-4. stats_tc + sum_tiles (stats_tc.cuh, kernel 5's device code with L
//      latents): S2's upper triangle in 3xTF32 and s1 in FP32 from the
//      kappa scratch and the weights, chunk partials added in a fixed order:
//      no atomics, S2 exactly symmetric, two calls bit-equal.
// * The ragged last tile is masked here, from B: rows past B load as zeros,
//   get no weight in s1/S2 and are not written.  Nothing is padded on the
//   host.
// * Scalars (jitter, rho, lambda, the L variances, the [L, D] lengthscales)
//   come in one device buffer; the host never reads them.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "pair_core.cuh"

namespace {

// kernel 1's tile: 64 rows by one output tile of 128 columns
using Tile = TileShape<64, 2, 4, 2, 4, 16>;
constexpr int MAX_M = Tile::NT;  // MAX_M in ops/cuda_kernels.py
// rows of an E-step block: few, so that a minibatch's rows spread over
// many SMs (B=2048: 32 blocks)
constexpr int ESTEP_THREADS = 64;
// params layout (P_JITT and P_VAR as pair_core.cuh's): jitter, rho,
// lambda, var [L], ls [L, D]
constexpr int P_RHO = 1, P_LAM = 2;
constexpr float LOG2F = 0.6931471805599453f;

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

// pass 1: one block a tile of TB rows of latent blockIdx.y; kappa [L, B, M],
// mf, vf [L, B].  vec: 16-byte copies of K^-1 and kappa's rows; vec_s: of
// Sigma.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 2)
latent_rows(const float* __restrict__ x, const float* __restrict__ z, const float* __restrict__ kinv,
            const float* __restrict__ mu, const float* __restrict__ sigma, const float* __restrict__ params,
            float* __restrict__ kappa, float* __restrict__ mf_out, float* __restrict__ vf_out, int B, int D, int M,
            int L, int kind, bool vec, bool vec_s) {
  extern __shared__ float4 sm4[];
  const int l = blockIdx.y;
  const int row0 = blockIdx.x * C::TB;
  const size_t mm = (size_t)l * M * M;
  moment_rows<C>(reinterpret_cast<float*>(sm4), kind, x, z + (size_t)l * M * D, params + P_VAR + L + (size_t)l * D,
                 params[P_VAR + l], params[P_JITT], kinv + mm, mu + (size_t)l * M, sigma + mm,
                 kappa + ((size_t)l * B + row0) * M, row0, min(C::TB, B - row0), D, M, vec, vec_s,
                 [&](int t, float mf, float vf) {
                   const size_t r = (size_t)l * B + row0 + t;
                   mf_out[r] = mf;
                   vf_out[r] = vf;
                 });
}

// pass 2, logistic-softmax, one thread per row; y one-hot [B, K]:
//   c_k = sqrt(mf_k^2 + vf_k)
//   twice: gamma_k = e^psi(alpha) e^{-mf_k/2} / (2 beta cosh(c_k/2)),
//          alpha = 1 + sum_k gamma_k
//   theta_k = (y_k + gamma_k) tanh(c_k/2) / (2 c_k)
//   weights rho (y_k - gamma_k)/2 and rho theta_k/2
// gamma_k is e_round * expcosh_k, so the first round needs only the sum
// of expcosh over the classes and the classes are read twice, not held;
// each loop is unrolled by 4, so that a thread has several classes' loads
// in flight (the sums keep their class order).
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
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float m = mf[(size_t)k * B + r];
    const float c = sqrtf(m * m + vf[(size_t)k * B + r]);
    s += expf(-m / 2.0f - logcoshf(c / 2.0f));
  }
  const float two_beta = 2.0f * beta0[r];
  const float alpha1 = 1.0f + expf(digammaf_pos(alpha0[r])) / two_beta * s;
  const float e2 = expf(digammaf_pos(alpha1));
  float gsum = 0.0f;
#pragma unroll 4
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

// Pass 1 on `st`; the CUDA error of the launch (cudaErrorInvalidValue for
// an unknown kind or M out of range).
int launch_rows(const float* x, const float* z, const float* kinv, const float* mu, const float* sigma,
                const float* params, float* kappa, float* mf, float* vf, int B, int D, int M, int L, int kind,
                cudaStream_t st) {
  if (kind < KIND_RBF || kind > KIND_MATERN52 || M < 1 || M > MAX_M) return (int)cudaErrorInvalidValue;
  const size_t smem = rows_smem<Tile>(M);
  cudaError_t err = prepare_smem<&latent_rows<Tile>>(smem);  // two blocks an SM
  if (err != cudaSuccess) return (int)err;
  auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = M % 4 == 0 && aligned(kinv) && aligned(kappa);
  const bool vec_s = M % 4 == 0 && aligned(sigma);
  latent_rows<Tile><<<dim3((B + Tile::TB - 1) / Tile::TB, L), Tile::THREADS, smem, st>>>(
      x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M, L, kind, vec, vec_s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The shared memory of kernels 2-3's rows pass at M (1 <= M <= MAX_M; any
// D).  ops/cuda_kernels.py::fused_fits is its copy in Python.
size_t agp_multi_smem_bytes(int M) { return rows_smem<Tile>(M); }

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], y one-hot [B, K], z [K, M, D], kinv [K, M, M] (K^-1), mu [K, M],
// sigma [K, M, M], params [3 + K + K D] = (jitter, rho, unused, var [K],
// ls [K, D]), alpha0, beta0 [B]; outputs c, theta, gamma [K, B], alpha [B],
// s1 [K, M], s2 [K, M, M]; scratch kappa [K, B, M] (16-byte aligned for
// 16-byte copies), mf, vf, wg, ws [K, B], s1_part [K, nchunks, M] and
// s2_part [K, nchunks, M, M] with nchunks = ceil(B / rows_per_chunk),
// rows_per_chunk a multiple of stats_tc.cuh's StatsF32::KB
// (ops/cuda_kernels.py::_stats_plan).  kind: a GramKind code,
// 1 <= M <= MAX_M.  Four launches on `stream` (latent_rows,
// estep_multiclass, stats_tc, sum_tiles); returns the CUDA error of the
// launches (cudaErrorInvalidValue for an unknown kind or M out of range).
int agp_fused_cavi_stats_multiclass(const float* x, const float* y, const float* z, const float* kinv,
                                    const float* mu, const float* sigma, const float* params, const float* alpha0,
                                    const float* beta0, float* c, float* theta, float* gamma, float* alpha,
                                    float* kappa, float* mf, float* vf, float* wg, float* ws, float* s1_part,
                                    float* s2_part, float* s1, float* s2, int B, int D, int M, int K, int kind,
                                    int nchunks, int rows_per_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_rows(x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M, K, kind, st);
  if (err) return err;
  estep_multiclass<<<(B + ESTEP_THREADS - 1) / ESTEP_THREADS, ESTEP_THREADS, 0, st>>>(
      mf, vf, y, alpha0, beta0, params, c, theta, gamma, alpha, wg, ws, B, K);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_stats(kappa, wg, ws, s1_part, s2_part, s1, s2, B, M, K, nchunks, rows_per_chunk, st);
}

// As above with 2 latents (f, g): y [B], params [3 + 2 + 2 D] = (jitter,
// rho, lambda, var [2], ls [2, D]); outputs c, phi, gamma, theta, sigg [B],
// s1 [2, M], s2 [2, M, M] with f's statistics WITHOUT the lambda factor.
int agp_fused_cavi_stats_het(const float* x, const float* y, const float* z, const float* kinv, const float* mu,
                             const float* sigma, const float* params, float* c, float* phi, float* gamma,
                             float* theta, float* sigg, float* kappa, float* mf, float* vf, float* wg, float* ws,
                             float* s1_part, float* s2_part, float* s1, float* s2, int B, int D, int M, int kind,
                             int nchunks, int rows_per_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_rows(x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M, 2, kind, st);
  if (err) return err;
  estep_het<<<(B + ESTEP_THREADS - 1) / ESTEP_THREADS, ESTEP_THREADS, 0, st>>>(mf, vf, y, params, c, phi, gamma,
                                                                               theta, sigg, wg, ws, B);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_stats(kappa, wg, ws, s1_part, s2_part, s1, s2, B, M, 2, nchunks, rows_per_chunk, st);
}

}  // extern "C"
