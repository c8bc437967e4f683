// The single-latent split pair for Hopper (sm_90a): one latent beyond the
// fused statistics pass (M > 128, or a wide D), a row-weighted batch, the
// ELBO and the hyperparameter step's forward.
//
// Replaces, in agp_tpu/ops/pallas_kernels.py:
//   * fused_kappa (:213, impl :243, pallas_call at :257, body _kappa_kernel;
//     its custom VJP :224-239 runs the XLA twin _kappa_xla_twin :199):
//     kappa_single below.  For minibatch row t:
//       gram    Knm[t, m]  = k(|x_t/ls - z_m/ls|^2)   (gram.cuh)
//       kappa   kappa[t,:] = Knm[t,:] K^-1
//       Ktilde  kt[t]      = max(var + jitter - sum_m kappa[t,m] Knm[t,m], 1e-12)
//     kappa [B, M] row-major, Ktilde [B].  The caller forms mf = kappa mu
//     and vf = Ktilde + rowsum((kappa Sigma) o kappa) outside, as the
//     reference's latent_moments does (agp_tpu/inference/analytic_vi.py:
//     413-416), and differentiates through the plain version's vjp.
//   * cavi_stats (:545, pallas_call at :553, body _stats_kernel):
//     s1 = kappa^T g, S2 = kappa^T diag(theta) kappa, by kernel 5's
//     3xTF32 tensor-core tiles (stats_tc.cuh) with one latent:
//     agp_cavi_stats below.
//
// What bounds kernel 6 on an H100: FMAs.  Per row B M^2 for kappa and M D
// for the gram, against 4 M bytes of kappa written: at B=65,536, M=512,
// D=20, 17.9 G FMAs, 0.53 ms at the card's FP32 peak, against 0.04 ms for
// writing kappa at 3.35 TB/s.  K^-1 (1 MB at M=512) does not fit a block's
// 227 KB, so, as kernel 4 does, the block keeps only its row tile's gram
// ([TB, M], TB = 32 rows, 16 when M is too large for 32) in shared memory
// and streams K^-1 from L2 through a [16, 256] panel a panel ahead, each
// thread holding an 8 x 4 block of kappa in registers.  kappa goes from
// those registers to device memory (16 bytes a store where M allows), so
// the tile needs no second [TB, M] buffer: at M=512 a block takes 101 KB
// and two fit an SM (see the launch bounds).  Ktilde's row sums ride in
// the product's epilogue and are summed by warp shuffles in a fixed order.
// Kernel 6 is FP32 FMA throughout, no TF32: kappa = Knm K^-1 cancels by
// cond(Kmm).
// The ragged edges are masked from B and M; nothing is padded on the host.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "pair_core.cuh"

namespace {

// G [tb, mk], the panel [KC, NP], the row sums [2, tb], z / ls chunks [M, DC + 1]
size_t ks_smem(int M, int tb) {
  const size_t mk = round_up(M, KC);
  return sizeof(float) *
         ((size_t)tb * mk + (size_t)KC * NP + 2 * (size_t)tb + (size_t)M * (DC + 1));
}

// Two blocks an SM at TB = 32: the register cap of 128 this asks for costs a
// few spills and measured faster than one block an SM at B=65,536, M=512 on
// an H100 (PERF.md, section 6).
template <int KIND, int TB>
__global__ void __launch_bounds__(TB / RM * (NP / 4), TB == 32 ? 2 : 1)
kappa_single(const float* __restrict__ x, const float* __restrict__ z,
             const float* __restrict__ kinv, const float* __restrict__ params,
             float* __restrict__ kappa, float* __restrict__ ktilde, int B, int D, int M) {
  constexpr int T = km_threads(TB);
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int mk = round_up(M, KC);
  float* G = sm;             // [TB, mk]  gram (first |x - z|^2), zero past M
  float* P = G + TB * mk;    // [KC, NP]  panel; x / ls chunks while the gram forms
  float* red = P + KC * NP;  // [2, TB]   Ktilde's row sums, two slots each
  float* zs = red + 2 * TB;  // [M, DC + 1]  z / ls chunks while the gram forms

  const int tid = threadIdx.x, tx = tid % 64, ty = tid / 64;
  const int row0 = blockIdx.x * TB;
  const int nrows = min(TB, B - row0);
  const float jitt = params[P_JITT], var = params[P_VAR];
  const float* ls = params + P_VAR + 1;

  gram_tile<KIND, TB>(x, z, ls, var, G, P, zs, row0, nrows, D, M, mk);
  // (panel_product begins with a barrier)

  // kappa = G K^-1, panel by panel, stored from registers; Ktilde's row sums
  // in the epilogue
  const bool vec = (M & 3) == 0;
  float kq[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) kq[r] = 0.0f;
  for (int c0 = 0; c0 < M; c0 += NP) {
    float acc[RM][4];
    panel_product<TB>(G, mk, kinv, M, c0, P, acc);
    const int cb = c0 + 4 * tx;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ty * RM + r;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cb + j < M) kq[r] = fmaf(acc[r][j], G[row * mk + cb + j], kq[r]);
      if (row < nrows && cb < M) {
        float* out = kappa + (size_t)(row0 + row) * M + cb;
        if (vec) {
          *reinterpret_cast<float4*>(out) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (cb + j < M) out[j] = acc[r][j];
        }
      }
    }
  }
  row_sums<TB>(kq, red);
  __syncthreads();
  for (int t = tid; t < nrows; t += T)
    ktilde[row0 + t] = fmaxf(var + jitt - (red[t] + red[TB + t]), 1e-12f);
}

template <int KIND, int TB>
int launch_kappa_single(const float* x, const float* z, const float* kinv, const float* params,
                        float* kappa, float* ktilde, int B, int D, int M, cudaStream_t st) {
  const size_t smem = ks_smem(M, TB);
  cudaError_t err = cudaFuncSetAttribute(kappa_single<KIND, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kappa_single<KIND, TB><<<(B + TB - 1) / TB, km_threads(TB), smem, st>>>(x, z, kinv, params, kappa,
                                                                         ktilde, B, D, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t agp_fused_kappa_smem_bytes(int M, int tile_rows) { return ks_smem(M, tile_rows); }

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], z [M, D], kinv [M, M], params [4 + D] = (jitter, unused, unused,
// var, ls [D]); outputs kappa [B, M], ktilde [B].  kind: a GramKind code;
// tile_rows: 32 or 16 (agp_fused_kappa_smem_bytes must fit the card).
// Returns the CUDA error of the launch (cudaErrorInvalidValue for an
// unknown kind or tile).
int agp_fused_kappa(const float* x, const float* z, const float* kinv, const float* params,
                    float* kappa, float* ktilde, int B, int D, int M, int kind, int tile_rows,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kind(kind, [&](auto k) {
    constexpr int KIND = decltype(k)::value;
    if (tile_rows == 32)
      return launch_kappa_single<KIND, 32>(x, z, kinv, params, kappa, ktilde, B, D, M, st);
    if (tile_rows == 16)
      return launch_kappa_single<KIND, 16>(x, z, kinv, params, kappa, ktilde, B, D, M, st);
    return (int)cudaErrorInvalidValue;
  });
}

// kappa [B, M], g and theta [B]; outputs s1 [M], s2 [M, M] (exactly
// symmetric); scratch s1_part [nchunks, M], s2_part [nchunks, M, M], with
// nchunks = ceil(B / rows_per_chunk).  Returns the CUDA error of the
// launches.
int agp_cavi_stats(const float* kappa, const float* g, const float* theta, float* s1_part,
                   float* s2_part, float* s1, float* s2, int B, int M, int nchunks,
                   int rows_per_chunk, void* stream) {
  return launch_stats(kappa, g, theta, s1_part, s2_part, s1, s2, B, M, 1, nchunks, rows_per_chunk,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
