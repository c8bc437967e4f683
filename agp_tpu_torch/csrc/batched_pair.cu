// The batched multi-latent pair for Hopper (sm_90a): the large-M tier of
// the CAVI step, for any number of latents L (one included).
//
// Replaces, in agp_tpu/ops/pallas_kernels.py:
//   * fused_kappa_moments_batched (:361, pallas_call at :419, body
//     _kappa_moments_batched_kernel :279): kappa_moments_batched below.
//     For latent l and minibatch row t:
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
//     one latent; that file says what bounds them.
// Between the two the caller runs the likelihood's E-step, which may couple
// the latents (logistic-softmax, heteroscedastic); that is why kappa goes
// through device memory.
//
// What bounds kernel 4 on an H100: operations.  Per row and latent M^2
// FMAs for kappa and M^2 for kappa Sigma (the function needs only its
// quadratic form with kappa, M (M+1)/2), M D for the gram and 3 M for the
// row sums, against 4 M bytes of kappa written.  At B=65,536, M=512, L=1
// (chip_smoke.py::kappa_bounds): the function's bound, kappa and the
// quadratic form once at the TF32 tensor-core peak, 0.104 ms; this
// design's, both full products in three TF32 passes, 0.416 ms; the FP32
// pipes', 0.793 ms.  The design is kernel 6's (kappa_single.cu says what it
// does about the gram, the panel's barriers and the reads of K^-1 from
// L2, and what bounds it), with one grid dimension for the latent and a
// second product:
// * kappa = G K_l^-1 in 3xTF32 on the tensor cores (tc_product,
//   pair_core.cuh), from the gram's [TB, M] slab; its epilogue stores
//   kappa from the fragments and takes Ktilde's and mf's row sums (FP32,
//   mu_l from L1).
// * The gram is then spent, so kappa's rows, just written and still in
//   L2, are copied back into the same slab (load_rows): one slab a block,
//   not a gram slab and a kappa slab, so that the block takes 64 rows up
//   to M = 680 (188 KB at M=512) as kernel 6 does, where two slabs held
//   32, and reads K_l^-1 and Sigma_l once for twice the rows.
// * kappa Sigma_l in 3xTF32 too, the kappa slab as the A operand and
//   Sigma_l streaming through the same cp.async ring; vf's quadratic form
//   is contracted with the slab in its epilogue, so kappa Sigma never
//   leaves the registers.  The reference forms kappa in three bf16 passes
//   (_dot3, :332) and kappa Sigma and mf in one (_dot1, :336-337); the
//   port holds all three to float32's own error against float64
//   (chip_smoke.py phase 12), so kappa Sigma takes three passes too.
// * Row tiles of 64 (M <= 680), 32 (M <= 1,392) or 16 rows (8-row
//   stages, M <= 2,392); past that the column-blocked form (below).  The row sums are summed by shuffles and one slot
//   per warp column in a fixed order: two calls are bit-equal.
// The ragged edges are masked from B and M; nothing is padded on the host.
//
// The float64 form (a float64 model of several latents on the card): at
// M <= 128 the same pass on tiles of doubles
// (agp_fused_kappa_moments_batched_f64; KTile<TB, double>, pair_core.cuh's
// moment_rows): the gram, kappa, kappa Sigma and the row sums in double,
// each product one FP64 mma.sync pass a 4-deep step.  Past M=128, and in
// float32 past the slab's range (M > 2,392), the column-blocked form of
// kappa_cols.cuh (agp_kappa_moments_cols, agp_kappa_moments_cols_f64): the
// gram once, kappa with mf's and Ktilde's row partials, then kappa Sigma on
// kappa read back with vf's, then their fixed-order sums: no M ceiling.
// What bounds the float64 function: kappa's and the quadratic form's
// B M^2 + B M (M+1)/2 FMAs at the FP64 tensor-core peak (67 TFLOP/s),
// 0.77 ms at B=65,536, M=512, L=1; the design forms kappa Sigma in full,
// 1.03 ms.  agp_cavi_stats_batched_f64 is kernel 5's float64 form, in
// double (stats_tc.cuh: FP64 m16n8k8 tiles, or the m8n8k4 geometry on
// request).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "kappa_cols.cuh"
#include "pair_core.cuh"

namespace {

// ---------------------------------------------------------------- kernel 4
// One block a tile of TB rows of latent blockIdx.y: the moments pass
// (pair_core.cuh's moment_rows), kappa stored to [L, B, M], mf and vf to
// [L, B].  Its shared memory is rows_smem<C>(M).
template <class C, class E = typename C::Elem>
__global__ void __launch_bounds__(C::THREADS, 1)
kappa_moments_batched(const E* __restrict__ x, const E* __restrict__ z, const E* __restrict__ kinv,
                      const E* __restrict__ mu, const E* __restrict__ sigma, const E* __restrict__ params,
                      E* __restrict__ kappa, E* __restrict__ mf_out, E* __restrict__ vf_out, int B, int D, int M,
                      int L, int kind, bool vec) {
  extern __shared__ float4 sm4[];
  const int l = blockIdx.y;
  const int row0 = blockIdx.x * C::TB;
  const size_t mm = (size_t)l * M * M;
  moment_rows<C>(reinterpret_cast<E*>(sm4), kind, x, z + (size_t)l * M * D, params + P_VAR + L + (size_t)l * D,
                 params[P_VAR + l], params[P_JITT], kinv + mm, mu + (size_t)l * M, sigma + mm,
                 kappa + ((size_t)l * B + row0) * M, row0, min(C::TB, B - row0), D, M, vec, vec,
                 [&](int t, E mf, E vf) {
                   const size_t r = (size_t)l * B + row0 + t;
                   mf_out[r] = mf;
                   vf_out[r] = vf;
                 });
}

// Its shared-memory attribute is set once a device (stats_tc.cuh's
// prepare_smem), then one launch.
template <class C, class E = typename C::Elem>
int launch_kappa_moments(const E* x, const E* z, const E* kinv, const E* mu, const E* sigma, const E* params,
                         E* kappa, E* mf, E* vf, int B, int D, int M, int L, int kind, cudaStream_t st) {
  const size_t smem = rows_smem<C>(M);
  cudaError_t err = prepare_smem<&kappa_moments_batched<C>>(smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = M % (16 / sizeof(E)) == 0 && reinterpret_cast<uintptr_t>(kinv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sigma) % 16 == 0 && reinterpret_cast<uintptr_t>(kappa) % 16 == 0;
  kappa_moments_batched<C><<<dim3((B + C::TB - 1) / C::TB, L), C::THREADS, smem, st>>>(
      x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M, L, kind, vec);
  return (int)cudaGetLastError();
}

// kernel 4 of elements E at row tiles of tile_rows; cudaErrorInvalidValue
// for an unknown kind or tile
template <class E>
int kappa_moments_of(const E* x, const E* z, const E* kinv, const E* mu, const E* sigma, const E* params, E* kappa,
                     E* mf, E* vf, int B, int D, int M, int L, int kind, int tile_rows, void* stream) {
  if (kind < KIND_RBF || kind > KIND_MATERN52) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_tile<E>(tile_rows, (int)cudaErrorInvalidValue, [&](auto t) {
    return launch_kappa_moments<decltype(t)>(x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M, L, kind, st);
  });
}

}  // namespace

extern "C" {

// The shared memory of kernel 4's slab form at M with row tiles of
// tile_rows (64, 32 or 16; SIZE_MAX for another), and of its float64 form.
// ops/cuda_kernels.py::kappa_smem_bytes is their copy in Python: change
// them together.
size_t agp_kappa_moments_smem_bytes(int M, int tile_rows) {
  return with_tile(tile_rows, SIZE_MAX, [&](auto t) { return rows_smem<decltype(t)>(M); });
}
size_t agp_kappa_moments_smem_bytes_f64(int M, int tile_rows) {
  return with_tile<double>(tile_rows, SIZE_MAX, [&](auto t) { return rows_smem<decltype(t)>(M); });
}

// edge of kernels 5 and 7's output tiles, and of their float64 form's (both
// of its geometries)
int agp_cavi_stats_tile(void) { return StatsF32::TILE; }
int agp_cavi_stats_tile_f64(void) { return StatsF64K8::TILE; }

// resident blocks of kernels 5 and 7 on one SM of the current device, and of
// their float64 form in the geometry of mma depth mma_k (8 or 4; 0 on error
// or for any other depth)
int agp_cavi_stats_blocks_per_sm(void) { return stats_blocks_per_sm<StatsF32>(); }
int agp_cavi_stats_blocks_per_sm_f64(int mma_k) {
  return with_stats_f64(mma_k, 0, [](auto sh) { return stats_blocks_per_sm<decltype(sh)>(); });
}

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], z [L, M, D], kinv [L, M, M], mu [L, M], sigma [L, M, M],
// params [3 + L + L D] = (jitter, unused, unused, var [L], ls [L, D]);
// outputs kappa [L, B, M], mf, vf [L, B].  kind: a GramKind code;
// tile_rows: 64, 32 or 16 (agp_kappa_moments_smem_bytes must fit the card).
// Returns the CUDA error of the launch (cudaErrorInvalidValue for an
// unknown kind or tile).
int agp_fused_kappa_moments_batched(const float* x, const float* z, const float* kinv,
                                    const float* mu, const float* sigma, const float* params,
                                    float* kappa, float* mf, float* vf, int B, int D, int M,
                                    int L, int kind, int tile_rows, void* stream) {
  return kappa_moments_of(x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M, L, kind, tile_rows, stream);
}

// The float64 form: the same arguments as float64 arrays
// (agp_kappa_moments_smem_bytes_f64 must fit the card).
int agp_fused_kappa_moments_batched_f64(const double* x, const double* z, const double* kinv, const double* mu,
                                        const double* sigma, const double* params, double* kappa, double* mf,
                                        double* vf, int B, int D, int M, int L, int kind, int tile_rows,
                                        void* stream) {
  return kappa_moments_of(x, z, kinv, mu, sigma, params, kappa, mf, vf, B, D, M, L, kind, tile_rows, stream);
}

// Kernel 4 in the column-blocked form (kappa_cols.cuh):
// agp_fused_kappa_moments_batched's arguments and scratch
// [agp_kappa_cols_scratch(1, B, M, L)] (16-byte aligned), any M >= 1.  Four
// launches; returns the first CUDA error.
int agp_kappa_moments_cols(const float* x, const float* z, const float* kinv, const float* mu, const float* sigma,
                           const float* params, float* kappa, float* mf, float* vf, float* scratch, int B, int D,
                           int M, int L, int kind, void* stream) {
  return launch_kappa_cols<float, true>(x, z, kinv, mu, sigma, params, kappa, nullptr, mf, vf, scratch, B, D, M, L,
                                        kind, static_cast<cudaStream_t>(stream));
}
int agp_kappa_moments_cols_f64(const double* x, const double* z, const double* kinv, const double* mu,
                               const double* sigma, const double* params, double* kappa, double* mf, double* vf,
                               double* scratch, int B, int D, int M, int L, int kind, void* stream) {
  return launch_kappa_cols<double, true>(x, z, kinv, mu, sigma, params, kappa, nullptr, mf, vf, scratch, B, D, M, L,
                                         kind, static_cast<cudaStream_t>(stream));
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

// The float64 form: the same arguments as float64 arrays, and the mma depth
// mma_k of its geometry (8: m16n8k8, 4: m8n8k4 pairs; stats_tc.cuh), the
// chunks planned with agp_cavi_stats_tile_f64 and
// agp_cavi_stats_blocks_per_sm_f64(mma_k).
int agp_cavi_stats_batched_f64(const double* kappa, const double* g, const double* theta, double* s1_part,
                               double* s2_part, double* s1, double* s2, int B, int M, int L, int nchunks,
                               int rows_per_chunk, int mma_k, void* stream) {
  return launch_stats(kappa, g, theta, s1_part, s2_part, s1, s2, B, M, L, nchunks, rows_per_chunk,
                      static_cast<cudaStream_t>(stream), mma_k);
}

}  // extern "C"
