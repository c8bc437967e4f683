// Fused single-latent CAVI statistics for Hopper (sm_90a): the four
// stationary gram kinds and the E-steps of eight likelihoods.
//
// Replaces: agp_tpu/ops/pallas_kernels.py, fused_cavi_stats and its body
// _cavi_fused_kernel (every kind and lik it takes).  It computes the same
// function, one pass per tile of TB minibatch rows:
//   gram     Knm[t, m]  = k(|x_t/ls - z_m/ls|^2)  (gram.cuh: rbf, matern12/32/52)
//   kappa    kappa[t,:] = Knm[t,:] K^-1
//   Ktilde   kt[t]      = max(var + jitter - sum_m kappa[t,m] Knm[t,m], 1e-12)
//   moments  mf[t]      = kappa[t,:] mu
//            vf[t]      = max(kt[t] + kappa[t,:] Sigma kappa[t,:]^T, 1e-12)
//   E-step   (c, theta, g_mu, g_s) of the row's likelihood (estep below)
//   stats    s1 = kappa^T (rho g_mu),  S2 = kappa^T diag(rho g_s) kappa
// The minibatch tile is read from device memory once; Knm, kappa and
// kappa Sigma never leave shared memory.
//
// Design, against the TPU kernel:
// * The TPU grid is a sequential loop that accumulates s1/S2 into one
//   resident block.  CUDA blocks run in parallel, so each block writes its
//   partial s1 [M] and S2 [M, M] to scratch and a second kernel sums the
//   partials in block order: deterministic, no atomics (block_sums.cuh).
// * The ragged last tile is masked here, from B: rows past B load as zeros
//   and get zero weight in s1/S2; their per-row outputs are not written.
// * FP32 FMA throughout, no TF32 and no tensor cores.  The gram uses the
//   direct form sum_d (x_d - z_d)^2, which does not cancel the way
//   |x|^2 + |z|^2 - 2 x.z does; kappa = Knm K^-1 (which cancels by
//   cond(Kmm)) is a full-FP32 dot.  The TPU's [M, TB] lane layout and its
//   bf16-split dots exist for the MXU and are not carried over.
// * The gram kind is a template parameter (it sits in the TB x M loop);
//   the likelihood is a runtime switch, taken once per row by one lane,
//   the same for the whole grid.  The E-step lives in registers, so the
//   shared memory does not depend on the likelihood.
// * Scalars come in one device buffer (ls, var, jitter, rho, p0, p1); the
//   host never reads them, so the Poisson rate p0 can change every step.
// * K^-1 (formed once per call by the wrapper), Sigma, mu, Z and the
//   [TB, M] gram and kappa tiles are resident in shared memory:
//   4 (TB D + M (D|1) + 2 M^2 + M + 2 TB M + 4 TB) bytes, 75 KB at
//   M=64, D=20 and 209 KB at M=128, D=20 (the wrapper refuses M > 128 and
//   any shape above the card's opt-in limit).
//
// What bounds it on an H100: per row it does ~3 M^2 FMAs (kappa, kappa
// Sigma, S2) against ~4 (D + 1) bytes read, so it is bound by FP32 issue
// and shared-memory bandwidth, not by device memory; the E-step is O(1)
// transcendental work per row beside it, and a Matern kind adds one sqrtf
// per gram entry.  One block per TB=64 rows gives B/64 blocks (64 at the
// flagship B=4096) on 132 SMs, so at most about half the card is busy; the
// low occupancy is recorded and left to later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "block_sums.cuh"
#include "gram.cuh"

namespace {

constexpr int TB = 64;  // minibatch rows per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float LOG2F = 0.6931471805599453f;
constexpr float SQRT3F = 1.7320508075688772f;

// codes of the likelihoods: the order of LIKS in ops/cuda_kernels.py
enum Lik : int {
  LIK_LOGISTIC = 0,
  LIK_GAUSSIAN,
  LIK_STUDENTT,
  LIK_LAPLACE,
  LIK_BAYESIANSVM,
  LIK_MATERN32,
  LIK_NEGBINOMIAL,
  LIK_POISSON,
  N_LIKS
};

struct RowStep {
  float c, theta, gmu, gs;
};

// One row's E-step: the local variables (c, theta) and the natural-gradient
// inputs (g_mu, g_s), as the reference's branches compute them, with its
// 1e-30 floor under each sqrt.  p0, p1: the likelihood's parameters.
__device__ inline RowStep estep(int lik, float mf, float vf, float y, float p0, float p1) {
  RowStep r;
  const float d = mf - y;
  switch (lik) {
    case LIK_LOGISTIC:
      r.c = sqrtf(mf * mf + vf);
      r.theta = tanhf(r.c / 2.0f) / (2.0f * r.c);
      r.gmu = y / 2.0f;
      r.gs = r.theta / 2.0f;
      break;
    case LIK_GAUSSIAN:  // p0 = sigma2
      r.c = sqrtf(fmaxf(d * d + vf, 1e-30f));
      r.theta = 1.0f / p0;
      r.gmu = y / p0;
      r.gs = r.theta / 2.0f;
      break;
    case LIK_STUDENTT:  // p0 = nu, p1 = sigma^2
      r.c = (d * d + vf + p1 * p0) / 2.0f;
      r.theta = ((p0 + 1.0f) / 2.0f) / r.c;
      r.gmu = r.theta * y;
      r.gs = r.theta / 2.0f;
      break;
    case LIK_LAPLACE:  // p0 = a = 1/beta^2; c is the local "b"
      r.c = sqrtf(fmaxf(d * d + vf, 1e-30f));
      r.theta = sqrtf(p0) / r.c;
      r.gmu = r.theta * y;
      r.gs = r.theta / 2.0f;
      break;
    case LIK_BAYESIANSVM: {
      const float e = 1.0f - y * mf;
      r.c = e * e + vf;
      r.theta = 1.0f / sqrtf(fmaxf(r.c, 1e-30f));
      r.gmu = y * (r.theta + 1.0f);
      r.gs = r.theta / 2.0f;
      break;
    }
    case LIK_MATERN32:  // p0 = rho, the likelihood's lengthscale
      r.c = sqrtf(fmaxf(d * d + vf, 1e-30f));
      r.theta = 3.0f / (2.0f * SQRT3F * r.c * p0 + 2.0f * p0 * p0);
      r.gmu = 2.0f * r.theta * y;
      r.gs = r.theta;
      break;
    case LIK_NEGBINOMIAL:  // p0 = r; omega ~ PG(y + r, f)
      r.c = sqrtf(fmaxf(mf * mf + vf, 1e-30f));
      r.theta = (y + p0) * tanhf(r.c / 2.0f) / (2.0f * r.c);
      r.gmu = (y - p0) / 2.0f;
      r.gs = r.theta / 2.0f;
      break;
    default: {  // LIK_POISSON, p0 = lambda; gamma = lam e^{-mf/2} / (2 cosh(c/2))
      r.c = sqrtf(fmaxf(mf * mf + vf, 1e-30f));
      const float logcosh_half = r.c / 2.0f + log1pf(expf(-r.c)) - LOG2F;
      const float gamma = p0 * expf(-mf / 2.0f - logcosh_half) / 2.0f;
      r.theta = (y + gamma) * tanhf(r.c / 2.0f) / (2.0f * r.c);
      r.gmu = (y - gamma) / 2.0f;
      r.gs = r.theta / 2.0f;
    }
  }
  return r;
}

// odd row stride for Z in shared memory: column reads across a warp hit
// distinct banks
__host__ __device__ inline int z_stride(int D) { return D | 1; }

// fused_fits in ops/cuda_kernels.py copies this footprint and TB, so that
// the CPU and the card dispatch alike: change both together (chip_smoke.py's
// check_fused_fits holds them against each other)
size_t smem_bytes(int D, int M) {
  size_t f = (size_t)TB * D + (size_t)M * z_stride(D) + 2 * (size_t)M * M + M +
             2 * (size_t)TB * M + 4 * TB;
  return f * sizeof(float);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
cavi_stats(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
           const float* __restrict__ kinv, const float* __restrict__ mu,
           const float* __restrict__ sigma, const float* __restrict__ params,
           float* __restrict__ c_out, float* __restrict__ theta_out, float* __restrict__ mf_out,
           float* __restrict__ vf_out, float* __restrict__ s1_part, float* __restrict__ s2_part,
           int B, int D, int M, int lik) {
  extern __shared__ float sm[];
  const int Dz = z_stride(D);
  float* xs = sm;              // [TB, D]   x / ls
  float* zs = xs + TB * D;     // [M, Dz]   z / ls
  float* ki = zs + M * Dz;     // [M, M]    K^-1
  float* sg = ki + M * M;      // [M, M]    Sigma
  float* mus = sg + M * M;     // [M]       mu
  float* G = mus + M;          // [TB, M]   gram, later kappa Sigma
  float* Kp = G + TB * M;      // [TB, M]   kappa
  float* kt = Kp + TB * M;     // [TB]      Ktilde
  float* mfs = kt + TB;        // [TB]      mf
  float* wg = mfs + TB;        // [TB]      rho g_mu, 0 past B
  float* ws = wg + TB;         // [TB]      rho g_s, 0 past B

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * TB;
  const int nrows = min(TB, B - row0);
  const float ls = params[0], var = params[1], jitt = params[2], rho = params[3];
  const float p0 = params[4], p1 = params[5];

  for (int i = tid; i < TB * D; i += THREADS) {
    const int t = i / D;
    xs[i] = t < nrows ? x[(size_t)row0 * D + i] / ls : 0.0f;
  }
  for (int i = tid; i < M * D; i += THREADS) zs[(i / D) * Dz + i % D] = z[i] / ls;
  for (int i = tid; i < M * M; i += THREADS) {
    ki[i] = kinv[i];
    sg[i] = sigma[i];
  }
  for (int i = tid; i < M; i += THREADS) mus[i] = mu[i];
  __syncthreads();

  // gram, direct form
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

  // kappa = Knm K^-1
  for (int i = tid; i < TB * M; i += THREADS) {
    const float* gr = G + (i / M) * M;
    const int n = i % M;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) acc = fmaf(gr[m], ki[m * M + n], acc);
    Kp[i] = acc;
  }
  __syncthreads();

  // per row: Ktilde and mf, one warp per row
  for (int t = warp; t < TB; t += WARPS) {
    float q = 0.0f, m1 = 0.0f;
    for (int n = lane; n < M; n += 32) {
      const float k = Kp[t * M + n];
      q = fmaf(k, G[t * M + n], q);
      m1 = fmaf(k, mus[n], m1);
    }
    q = warp_sum(q);
    m1 = warp_sum(m1);
    if (lane == 0) {
      kt[t] = fmaxf(var + jitt - q, 1e-12f);
      mfs[t] = m1;
    }
  }
  __syncthreads();

  // kappa Sigma, over the gram tile (no longer needed)
  for (int i = tid; i < TB * M; i += THREADS) {
    const float* kr = Kp + (i / M) * M;
    const int n = i % M;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) acc = fmaf(kr[m], sg[m * M + n], acc);
    G[i] = acc;
  }
  __syncthreads();

  // per row: vf and the likelihood's E-step
  for (int t = warp; t < TB; t += WARPS) {
    float q = 0.0f;
    for (int n = lane; n < M; n += 32) q = fmaf(G[t * M + n], Kp[t * M + n], q);
    q = warp_sum(q);
    if (lane == 0) {
      float wgt = 0.0f, wst = 0.0f;
      if (t < nrows) {
        const int r = row0 + t;
        const float mf = mfs[t];
        const float vf = fmaxf(kt[t] + q, 1e-12f);
        const RowStep e = estep(lik, mf, vf, y[r], p0, p1);
        c_out[r] = e.c;
        theta_out[r] = e.theta;
        mf_out[r] = mf;
        vf_out[r] = vf;
        wgt = rho * e.gmu;
        wst = rho * e.gs;
      }
      wg[t] = wgt;
      ws[t] = wst;
    }
  }
  __syncthreads();

  // this block's partial statistics
  float* s1p = s1_part + (size_t)blockIdx.x * M;
  float* s2p = s2_part + (size_t)blockIdx.x * M * M;
  for (int m = tid; m < M; m += THREADS) {
    float acc = 0.0f;
    for (int t = 0; t < TB; ++t) acc = fmaf(Kp[t * M + m], wg[t], acc);
    s1p[m] = acc;
  }
  for (int i = tid; i < M * M; i += THREADS) {
    const int m = i / M, n = i % M;
    float acc = 0.0f;
    for (int t = 0; t < TB; ++t) acc = fmaf(Kp[t * M + m] * ws[t], Kp[t * M + n], acc);
    s2p[i] = acc;
  }
}

template <int KIND>
int launch(const float* x, const float* y, const float* z, const float* kinv, const float* mu,
           const float* sigma, const float* params, float* c, float* theta, float* mf, float* vf,
           float* s1_part, float* s2_part, float* s1, float* s2, int B, int D, int M, int lik,
           cudaStream_t st) {
  const int nb = (B + TB - 1) / TB;
  const size_t smem = smem_bytes(D, M);
  cudaError_t err = cudaFuncSetAttribute(cavi_stats<KIND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cavi_stats<KIND><<<nb, THREADS, smem, st>>>(x, y, z, kinv, mu, sigma, params, c, theta, mf, vf,
                                              s1_part, s2_part, B, D, M, lik);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_partials(s1_part, s2_part, s1, s2, nb, M, st);
}

}  // namespace

extern "C" {

int agp_fused_cavi_tile_rows(void) { return TB; }

size_t agp_fused_cavi_smem_bytes(int D, int M) { return smem_bytes(D, M); }

const char* agp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], y [B], z [M, D], kinv [M, M], mu [M], sigma [M, M],
// params [6] = (lengthscale, variance, jitter, rho, p0, p1); outputs c,
// theta, mf, vf [B], s1 [M], s2 [M, M]; scratch s1_part [nb, M],
// s2_part [nb, M, M] with nb = ceil(B / TB).  kind: a GramKind code, lik:
// a Lik code.  Returns the CUDA error of the launches
// (cudaErrorInvalidValue for an unknown kind or likelihood).
int agp_fused_cavi_stats(const float* x, const float* y, const float* z, const float* kinv,
                         const float* mu, const float* sigma, const float* params, float* c,
                         float* theta, float* mf, float* vf, float* s1_part, float* s2_part,
                         float* s1, float* s2, int B, int D, int M, int kind, int lik,
                         void* stream) {
  if (lik < 0 || lik >= N_LIKS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kind(kind, [&](auto k) {
    return launch<decltype(k)::value>(x, y, z, kinv, mu, sigma, params, c, theta, mf, vf, s1_part,
                                      s2_part, s1, s2, B, D, M, lik, st);
  });
}

}  // extern "C"
