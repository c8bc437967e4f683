// The single-latent split pair for Hopper (sm_90a): one latent beyond the
// fused statistics pass (M > 128, or a wide D), a row-weighted batch, the
// ELBO and the hyperparameter step's forward.
//
// Replaces, in agp_tpu/ops/pallas_kernels.py:
//   * fused_kappa (:213, impl :243, pallas_call at :257, body _kappa_kernel
//     :185 through _kappa_tile :172; its custom VJP :224-239 runs the XLA
//     twin _kappa_xla_twin :197): kappa_single below.  For minibatch row t:
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
// What bounds kernel 6 on an H100: operations.  Per row M^2 FMAs for kappa,
// M D for the gram and M for Ktilde, against 4 M bytes of kappa written:
// at B=65,536, M=512, D=20, 17.2 G FMAs for kappa and 0.7 G for the gram
// against 140 MB (0.042 ms at 3.35 TB/s).  Three bounds
// (chip_smoke.py::kappa_bounds):
//   * the function's: kappa once at the TF32 tensor-core peak (495 TFLOP/s
//     dense), the gram at the FP32 one (67): 0.069 ms;
//   * this design's: kappa in three TF32 passes: 0.208 ms;
//   * the FP32 pipes': everything at 67 TFLOP/s: 0.534 ms, which no FP32
//     kernel can pass (cuBLAS took 0.716 ms for kappa's product alone).
// So kappa = G K^-1 runs on the tensor cores in 3xTF32 (tf32_mma.cuh: each
// operand split into hi and lo, three mma.sync.m16n8k8 passes, each 8-deep
// step from a zero accumulator and added in FP32).  The reference itself
// forms kappa in three bf16 passes (_dot3 in _kappa_tile :179 and the twin
// :207, Precision.HIGH), which keep ~16 bits of each operand where
// 3xTF32 keeps ~21; one TF32 pass would not do (over 500x float32's error
// at the M=512 oracle shape, tests/test_torch_kappa_tc.py), and the
// kernel is held against float64
// within 2x the float32 plain version's own error (chip_smoke.py phase 12,
// tests/test_torch_cuda.py).  The gram and Ktilde's row sums stay FP32.
// The parent design (FP32 FMA, [16, 256] panels) paid three costs, and
// this one answers each:
//   1. The gram ran alone, two scalar shared loads an FMA.  gram_slab
//      (pair_core.cuh) sums 8 rows of a column in registers over all of
//      D at once where it fits (x / ls and z / ls staged by a reciprocal):
//      16 FP32 operations for three shared loads.  It is still a phase of
//      its own (one block an SM): 0.17 ms of kernel 6's 1.1 at B=65,536,
//      M=512 on an H100 (probes/kappa_tc.cu).
//   2. K^-1's panel went through registers with two barriers every 16
//      rows.  Here 16-byte cp.async feed a ring of three stages of 16 rows
//      (zero-filled past M) straight to shared memory, one barrier a stage.
//   3. Every block read all of K^-1 from L2 for 32 rows.  Row tiles of 64
//      (M <= 696) halve that: at B=65,536, M=512, 1,024 blocks x 1 MB.
//      32-row tiles take M <= 1,408, 16-row ones (8-row stages) M <= 2,406.
//      Kernel 4 keeps one slab too (batched_pair.cu).
// On an H100 what bounds this design is the instruction issue around the
// mma, not the tensor cores: mma.sync alone ran at 1.2 SM-cycles an
// m16n8k8 (450 TFLOP/s), with 3xTF32's splits and FP32 adds at 2.5-3.4,
// and cvt.rna's splits 10-23 % slower than tf32_mma.cuh's integer ones
// (probes/kappa_tc.cu, `python3 chip_smoke.py probe`; PERF.md).
// The block keeps its gram in a [TB, M] slab (A operand, read in place)
// and loops over column tiles of 256: 8 warps side by side, each 64 x 32
// (TB = 64), 32 x 32 (32) or 16 x 16 (16, column tiles of 128).  kappa is
// stored from the fragments (8 bytes a thread, whole 32-byte sectors);
// Ktilde's row sums ride in the same epilogue against the slab and are
// summed by shuffles and one slot per warp column in a fixed order: two
// calls are bit-equal.  The ragged edges are masked from B and M; nothing
// is padded on the host.
//
// The float64 form (a float64 model on the card): at M <= 128 the same
// kernel on tiles of doubles (agp_fused_kappa_f64; KTile<TB, double>,
// pair_core.cuh): the gram in double by direct differences, kappa = G K^-1
// in one FP64 mma.sync pass a 4-deep step (DMMA: IEEE double with FMA, so
// no split), Ktilde's row sums in double; at M=64 and 128 its device time
// beat the column-blocked form's.  Past M=128, and in float32 past the
// slab's range (M > 2,406), the column-blocked form of kappa_cols.cuh
// (agp_fused_kappa_cols, agp_fused_kappa_cols_f64): [128, 128] output tiles
// with both operands streamed, so no M ceiling, and each block's reads of
// K^-1 serve 128 rows where the slab of doubles left 32 at M=512.  What
// bounds the float64 function: kappa's B M^2 FMAs at the FP64 tensor-core
// peak (67 TFLOP/s), 0.51 ms at B=65,536, M=512, against 268 MB of kappa
// written (0.08 ms).  agp_cavi_stats_f64 is kernel 7's float64 form
// (stats_tc.cuh: FP64 m16n8k8 tiles, or the m8n8k4 geometry on request).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "kappa_cols.cuh"
#include "pair_core.cuh"

namespace {

// the slab [TB, S], the scratch, Ktilde's row sums [WARPS_N, TB]
template <class C>
__host__ __device__ constexpr size_t ks_smem(int M) {
  return sizeof(typename C::Elem) *
         ((size_t)C::TB * slab_stride(M) + slab_scratch<C>(M) + (size_t)C::WARPS_N * C::TB);
}

// One block an SM (at M=512 the slab and the ring take 185 KB), so the
// registers are not capped at 128: the passes' partial sums of the warp's
// tiles sit beside its accumulators without spills.  Elements E: float,
// or double for the float64 form.
template <class C, class E = typename C::Elem>
__global__ void __launch_bounds__(C::THREADS, 1)
kappa_single(const E* __restrict__ x, const E* __restrict__ z, const E* __restrict__ kinv,
             const E* __restrict__ params, E* __restrict__ kappa, E* __restrict__ ktilde, int B, int D, int M,
             int kind, bool vec) {
  constexpr int TB = C::TB;
  extern __shared__ float4 sm4[];
  E* sm = reinterpret_cast<E*>(sm4);
  const int S = slab_stride(M);
  E* G = sm;                           // [TB, S]  gram (first |x - z|^2), zero past M
  E* U = G + TB * S;                   // the ring; x / ls, then z / ls, while the gram forms
  E* red = U + slab_scratch<C>(M);    // [WARPS_N, TB]  Ktilde's row sums
  const int row0 = blockIdx.x * TB;
  const int nrows = min(TB, B - row0);
  const E jitt = params[P_JITT], var = params[P_VAR];
  const E* ls = params + P_VAR + 1;

  gram_into_slab<C>(kind, x, z, ls, var, G, S, U, row0, nrows, D, M);

  // kappa = G K^-1, column tile by column tile, stored from the fragments;
  // Ktilde's row sums in the same epilogue
  E kq[C::MI][2] = {};
  E* out = kappa + (size_t)row0 * M;
  tc_product<C>(G, S, kinv, M, U, vec, [&](int n0, E (&acc)[C::MI][C::NJ][4]) {
    for_fragments<C>(n0, acc, [&](int mi, int h, int row, int col, E v0, E v1) {
      if (col < M) kq[mi][h] = fma_t(v0, G[row * S + col], kq[mi][h]);
      if (col + 1 < M) kq[mi][h] = fma_t(v1, G[row * S + col + 1], kq[mi][h]);
      store_pair(out, M, nrows, row, col, v0, v1);
    });
  });
  row_partials<C>(kq, red);
  __syncthreads();
  for (int t = threadIdx.x; t < nrows; t += C::THREADS)
    ktilde[row0 + t] = fmax_t(var + jitt - row_total<C>(red, t), E(1e-12));
}

// Its shared-memory attribute is set once a device (stats_tc.cuh's
// prepare_smem), then one launch.
template <class C, class E = typename C::Elem>
int launch_kappa_single(const E* x, const E* z, const E* kinv, const E* params, E* kappa, E* ktilde, int B, int D,
                        int M, int kind, cudaStream_t st) {
  const size_t smem = ks_smem<C>(M);
  cudaError_t err = prepare_smem<&kappa_single<C>>(smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = M % (16 / sizeof(E)) == 0 && reinterpret_cast<uintptr_t>(kinv) % 16 == 0;
  kappa_single<C><<<(B + C::TB - 1) / C::TB, C::THREADS, smem, st>>>(x, z, kinv, params, kappa, ktilde, B, D,
                                                                     M, kind, vec);
  return (int)cudaGetLastError();
}

// kernel 6 of elements E at row tiles of tile_rows; cudaErrorInvalidValue
// for an unknown kind or tile
template <class E>
int fused_kappa_of(const E* x, const E* z, const E* kinv, const E* params, E* kappa, E* ktilde, int B, int D, int M,
                   int kind, int tile_rows, void* stream) {
  if (kind < KIND_RBF || kind > KIND_MATERN52) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_tile<E>(tile_rows, (int)cudaErrorInvalidValue, [&](auto t) {
    return launch_kappa_single<decltype(t)>(x, z, kinv, params, kappa, ktilde, B, D, M, kind, st);
  });
}

}  // namespace

extern "C" {

// The shared memory of kernel 6's slab form at M with row tiles of
// tile_rows (64, 32 or 16; SIZE_MAX for another), and of its float64 form.
// ops/cuda_kernels.py::kappa_smem_bytes is their copy in Python: change
// them together.
size_t agp_fused_kappa_smem_bytes(int M, int tile_rows) {
  return with_tile(tile_rows, SIZE_MAX, [&](auto t) { return ks_smem<decltype(t)>(M); });
}
size_t agp_fused_kappa_smem_bytes_f64(int M, int tile_rows) {
  return with_tile<double>(tile_rows, SIZE_MAX, [&](auto t) { return ks_smem<decltype(t)>(M); });
}

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], z [M, D], kinv [M, M], params [4 + D] = (jitter, unused, unused,
// var, ls [D]); outputs kappa [B, M], ktilde [B].  kind: a GramKind code;
// tile_rows: 64, 32 or 16 (agp_fused_kappa_smem_bytes must fit the card).
// Returns the CUDA error of the launch (cudaErrorInvalidValue for an
// unknown kind or tile).
int agp_fused_kappa(const float* x, const float* z, const float* kinv, const float* params, float* kappa,
                    float* ktilde, int B, int D, int M, int kind, int tile_rows, void* stream) {
  return fused_kappa_of(x, z, kinv, params, kappa, ktilde, B, D, M, kind, tile_rows, stream);
}

// The float64 form: the same arguments as float64 arrays
// (agp_fused_kappa_smem_bytes_f64 must fit the card).
int agp_fused_kappa_f64(const double* x, const double* z, const double* kinv, const double* params, double* kappa,
                        double* ktilde, int B, int D, int M, int kind, int tile_rows, void* stream) {
  return fused_kappa_of(x, z, kinv, params, kappa, ktilde, B, D, M, kind, tile_rows, stream);
}

// The column-blocked form (kappa_cols.cuh) of kernels 4 and 6: its shared
// memory a block (one tile whatever M), and the elements of the scratch a
// call takes (moments: kernel 4, else kernel 6), in float and in double.
// ops/cuda_kernels.py::kappa_cols_smem_bytes and kappa_cols_scratch are
// their copies in Python: change them together.
size_t agp_kappa_cols_smem_bytes(void) { return ColTile<float>::SMEM; }
size_t agp_kappa_cols_smem_bytes_f64(void) { return ColTile<double>::SMEM; }
size_t agp_kappa_cols_scratch(int moments, int B, int M, int L) {
  return cols_scratch<ColTile<float>>(moments != 0, B, M, L);
}
size_t agp_kappa_cols_scratch_f64(int moments, int B, int M, int L) {
  return cols_scratch<ColTile<double>>(moments != 0, B, M, L);
}

// Kernel 6 in the column-blocked form: agp_fused_kappa's arguments and
// scratch [agp_kappa_cols_scratch(0, B, M, 1)] (16-byte aligned), any M >= 1.
// Three launches; returns the first CUDA error.
int agp_fused_kappa_cols(const float* x, const float* z, const float* kinv, const float* params, float* kappa,
                         float* ktilde, float* scratch, int B, int D, int M, int kind, void* stream) {
  return launch_kappa_cols<float, false>(x, z, kinv, nullptr, nullptr, params, kappa, ktilde, nullptr, nullptr,
                                         scratch, B, D, M, 1, kind, static_cast<cudaStream_t>(stream));
}
int agp_fused_kappa_cols_f64(const double* x, const double* z, const double* kinv, const double* params,
                             double* kappa, double* ktilde, double* scratch, int B, int D, int M, int kind,
                             void* stream) {
  return launch_kappa_cols<double, false>(x, z, kinv, nullptr, nullptr, params, kappa, ktilde, nullptr, nullptr,
                                          scratch, B, D, M, 1, kind, static_cast<cudaStream_t>(stream));
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

// The float64 form: the same arguments as float64 arrays, and the mma depth
// mma_k of its geometry (8 or 4, as agp_cavi_stats_batched_f64's), the
// chunks planned with agp_cavi_stats_tile_f64 and
// agp_cavi_stats_blocks_per_sm_f64(mma_k) (batched_pair.cu).
int agp_cavi_stats_f64(const double* kappa, const double* g, const double* theta, double* s1_part, double* s2_part,
                       double* s1, double* s2, int B, int M, int nchunks, int rows_per_chunk, int mma_k,
                       void* stream) {
  return launch_stats(kappa, g, theta, s1_part, s2_part, s1, s2, B, M, 1, nchunks, rows_per_chunk,
                      static_cast<cudaStream_t>(stream), mma_k);
}

}  // extern "C"
