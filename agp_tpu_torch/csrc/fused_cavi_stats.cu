// Fused single-latent CAVI statistics for Hopper (sm_90a), kernel 1 of the
// port: the four stationary gram kinds and the E-steps of eight likelihoods.
//
// Replaces: agp_tpu/ops/pallas_kernels.py, fused_cavi_stats (:750,
// pallas_call at :784) and its body _cavi_fused_kernel (:578), every kind
// and lik it takes.  It computes the same function, for each minibatch
// row t:
//   gram     Knm[t, m]  = k(|x_t/ls - z_m/ls|^2)  (gram.cuh: rbf, matern12/32/52)
//   kappa    kappa[t,:] = Knm[t,:] K^-1
//   Ktilde   kt[t]      = max(var + jitter - sum_m kappa[t,m] Knm[t,m], 1e-12)
//   moments  mf[t]      = kappa[t,:] mu
//            vf[t]      = max(kt[t] + kappa[t,:] Sigma kappa[t,:]^T, 1e-12)
//   E-step   (c, theta, g_mu, g_s) of the row's likelihood (estep below)
//   stats    s1 = kappa^T (rho g_mu),  S2 = kappa^T diag(rho g_s) kappa
//
// What bounds it on an H100: operations.  Per row M^2 FMAs for kappa, the
// quadratic form's and S2's M (M+1)/2 each and M D for the gram, against
// ~4 (D + 5) bytes a row.  At the sweep's row B=262,144, D=8, M=128
// (chip_smoke.py::fused_bound): the function's bound, its products once at
// the TF32 tensor-core peak (495 TFLOP/s) and the gram and row sums at the
// FP32 one (67), 0.035 ms; this design's, kappa and kappa Sigma in full and
// S2's upper triangle in three TF32 passes, 0.130 ms; the FP32 pipes',
// 0.270 ms.  The FP32 pipes cannot get near the function's bound; the
// TF32 tensor cores can, in three passes as close to float64 as FP32.
//
// Design: kernel 8's (fused_variants.cu, direct form) with the kinds and
// the likelihoods, from the parts of kernels 4-9 (pair_core.cuh,
// stats_tc.cuh, tf32_mma.cuh):
// * cavi_rows, one block a tile of 64 rows, 2 x 4 warps of 32 x 32 over one
//   128-column output tile, so that every M kernel 1 takes (M <= MAX_M =
//   128) is one output tile and two blocks share an SM; its moments pass
//   is pair_core.cuh's moment_rows, which kernels 2-4 run too:
//   - gram_into_slab: the kind's FP32 gram by direct differences into a
//     [64, M] slab, features staged in chunks, so D bounds no shared
//     memory; x / ls and z / ls as products with 1 / ls (ls [D]: the
//     wrapper repeats the scalar lengthscale);
//   - tc_product: kappa = G K^-1 (K^-1 = L^-T L^-1 formed by the wrapper, as
//     the reference's _kinv) in 3xTF32 mma.sync (each operand split into hi
//     and lo, each 8-deep step's three passes from a zero accumulator, then
//     added in FP32), K^-1 streamed from L2 through a cp.async ring; the
//     epilogue takes Ktilde's row sums against the gram slab and
//     mf = kappa mu in FP32 and stores kappa to a [B, M] scratch;
//   - kappa back into the slab (load_rows), then kappa Sigma the same way,
//     contracted with the slab in the epilogue for vf's quadratic form;
//   - the row sums by shuffles and one slot a warp column, in a fixed
//     order; then one thread a row runs the likelihood's E-step (a switch
//     taken the same way by the whole grid) and writes c, theta, mf, vf
//     and the statistics' weights rho g_mu and rho g_s.
// * stats_tc + sum_tiles (kernels 5 and 7's device code, one latent): S2's
//   upper triangle in 3xTF32 and s1 in FP32 from the kappa scratch and the
//   weights, chunk partials added in a fixed order: no atomics, S2 exactly
//   symmetric, two calls bit-equal.  The scratch's round trip is
//   2 x 4 B M bytes, 0.08 ms at the sweep's row.
// * The ragged last tile is masked here, from B: rows past B load as zeros,
//   get no weight in s1/S2 and are not written.
// * Scalars come in one device buffer (layout at agp_fused_cavi_stats); the
//   host never reads them, so the Poisson rate p0 and an Adam-updated
//   lengthscale can change every step.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "pair_core.cuh"

namespace {

// 64 rows by one output tile of 128 columns: 2 x 4 warps of 32 x 32
using Tile = TileShape<64, 2, 4, 2, 4, 16>;
constexpr int MAX_M = Tile::NT;  // MAX_M in ops/cuda_kernels.py
// params layout: jitter, rho, p0, var, p1, ls [D] (P_JITT and P_VAR as
// pair_core.cuh's)
constexpr int P_RHO = 1, P_P0 = 2, P_P1 = 4, P_LS = 5;
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

// One block a tile of TB rows: the moments pass (pair_core.cuh's
// moment_rows: the gram, kappa, Ktilde, mf and vf), then the likelihood's
// E-step, one thread a row, and the statistics' weights.  vec: 16-byte
// copies of K^-1 and kappa's rows; vec_s: of Sigma.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 2)
cavi_rows(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
          const float* __restrict__ kinv, const float* __restrict__ mu, const float* __restrict__ sigma,
          const float* __restrict__ params, float* __restrict__ kappa, float* __restrict__ c_out,
          float* __restrict__ theta_out, float* __restrict__ mf_out, float* __restrict__ vf_out,
          float* __restrict__ wg, float* __restrict__ ws, int B, int D, int M, int kind, int lik, bool vec,
          bool vec_s) {
  extern __shared__ float4 sm4[];
  const int row0 = blockIdx.x * C::TB;
  const float rho = params[P_RHO], p0 = params[P_P0], p1 = params[P_P1];
  moment_rows<C>(reinterpret_cast<float*>(sm4), kind, x, z, params + P_LS, params[P_VAR], params[P_JITT], kinv, mu,
                 sigma, kappa + (size_t)row0 * M, row0, min(C::TB, B - row0), D, M, vec, vec_s,
                 [&](int t, float mf, float vf) {
                   const int r = row0 + t;
                   const RowStep e = estep(lik, mf, vf, y[r], p0, p1);
                   c_out[r] = e.c;
                   theta_out[r] = e.theta;
                   mf_out[r] = mf;
                   vf_out[r] = vf;
                   wg[r] = rho * e.gmu;
                   ws[r] = rho * e.gs;
                 });
}

}  // namespace

extern "C" {

// The shared memory of kernel 1's row kernel at M (1 <= M <= MAX_M; any
// D).  ops/cuda_kernels.py::fused_fits is its copy in Python.
size_t agp_fused_cavi_smem_bytes(int M) { return rows_smem<Tile>(M); }

const char* agp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], y [B], z [M, D], kinv [M, M] (K^-1), mu [M], sigma [M, M],
// params [5 + D] = (jitter, rho, p0, var, p1, ls [D]) with (p0, p1) the
// likelihood's parameters; outputs c, theta, mf, vf [B], s1 [M], s2 [M, M];
// scratch kappa [B, M] (16-byte aligned for 16-byte copies), wg, ws [B],
// s1_part [nchunks, M], s2_part [nchunks, M, M] with nchunks =
// ceil(B / rows_per_chunk), rows_per_chunk a multiple of stats_tc.cuh's StatsF32::KB
// (ops/cuda_kernels.py::_stats_plan).  kind: a GramKind code, lik: a Lik
// code, 1 <= M <= MAX_M.  Three launches on `stream` (cavi_rows,
// stats_tc, sum_tiles); returns the CUDA error of the launches
// (cudaErrorInvalidValue for an unknown kind or likelihood, or M out of
// range).
int agp_fused_cavi_stats(const float* x, const float* y, const float* z, const float* kinv, const float* mu,
                         const float* sigma, const float* params, float* c, float* theta, float* mf, float* vf,
                         float* kappa, float* wg, float* ws, float* s1_part, float* s2_part, float* s1, float* s2,
                         int B, int D, int M, int kind, int lik, int nchunks, int rows_per_chunk, void* stream) {
  if (lik < 0 || lik >= N_LIKS || kind < KIND_RBF || kind > KIND_MATERN52 || M < 1 || M > MAX_M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = rows_smem<Tile>(M);
  cudaError_t err = prepare_smem<&cavi_rows<Tile>>(smem);  // two blocks an SM
  if (err != cudaSuccess) return (int)err;
  auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = M % 4 == 0 && aligned(kinv) && aligned(kappa);
  const bool vec_s = M % 4 == 0 && aligned(sigma);
  cavi_rows<Tile><<<(B + Tile::TB - 1) / Tile::TB, Tile::THREADS, smem, st>>>(
      x, y, z, kinv, mu, sigma, params, kappa, c, theta, mf, vf, wg, ws, B, D, M, kind, lik, vec, vec_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_stats(kappa, wg, ws, s1_part, s2_part, s1, s2, B, M, 1, nchunks, rows_per_chunk, st);
}

}  // extern "C"
