// Design-sweep variants of the fused single-latent statistics pass for
// Hopper (sm_90a): kernels 8 and 9 of the port.
//
// Replaces: benchmarks/fused_variants.py, direct_stats (:132, pallas_call
// at :151, body _v1_kernel :90; variants "transpose", "nt" and "packed";
// kernel 8) and two_factor_nt (:214, pallas_call at :223, body _v5_kernel
// :185, kappa from _kappa_tile_two_factor :51; kernel 9).  Both compute,
// for the RBF gram and the logistic likelihood, the pass of kernel 1
// (fused_cavi_stats.cu), for each minibatch row t:
//   gram     Knm = var exp(-|x/ls - z/ls|^2 / 2)
//   kappa    direct:      kappa = Knm K^-1,  Ktilde = var + jitt - rowsum(kappa o Knm)
//            two-factor:  W = Knm L^-T,  Ktilde = var + jitt - rowsum(W o W),
//                         kappa = W L^-1
//            (Ktilde floored at 1e-12)
//   moments  mf = kappa mu,  vf = max(Ktilde + rowsum((kappa Sigma) o kappa), 1e-12)
//   E-step   c = sqrt(mf^2 + vf),  theta = tanh(c/2) / (2c)
//   stats    s1 = kappa^T (rho y/2),  S2 = kappa^T diag(rho theta/2) kappa
//
// What bounds them on an H100: operations.  Per row M^2 FMAs for kappa
// (the two-factor form two triangular products, M (M+1)/2 each), the
// quadratic form kappa Sigma kappa^T and S2's share (M (M+1)/2 each), M D
// for the gram, against ~4 (D + 5) bytes a row.  At the sweep's row
// B=262,144, D=8, M=128 (chip_smoke.py::variant_bound): the function's
// bound, its products once at the TF32 tensor-core peak (495 TFLOP/s) and
// the gram and row sums at the FP32 one (67), 0.035 ms; this design's,
// kappa, kappa Sigma (and W, in four passes) in full and S2's upper
// triangle in three TF32 passes, 0.130 ms (kernel 9: 0.200); the FP32
// pipes', 0.270 ms.  The
// parent design (FP32 FMA, one thread an output entry, K^-1 and Sigma
// whole in shared memory, so M <= 128) ran at 3.5-4.8 % of the FP32 bound
// there, 2.8-3.9x the sweep's cuBLAS bar.
//
// Design: the parts of kernels 4-7 (pair_core.cuh, stats_tc.cuh,
// tf32_mma.cuh), one block a tile of TB rows:
// * gram_slab: the FP32 gram by direct differences into a [TB, M] slab.
// * tc_product: the slab times an [M, N] operand streamed from L2 through
//   a cp.async ring, in 3xTF32 mma.sync (each operand split into hi and
//   lo, each 8-deep step's three passes from a zero accumulator, then
//   added in FP32), the epilogue in registers:
//   - kernel 8: kappa = G K^-1 (K^-1 = L^-T L^-1 formed by the wrapper, as
//     the reference's _kinv); Ktilde's row sums against the gram slab and,
//     for "nt"/"transpose", mf = kappa mu (FP32, mu from L1) in the
//     epilogue; kappa stored to a [B, M] scratch from the fragments;
//   - kernel 9: W = G L^-T, Ktilde's row sums of W o W (FP32) in the
//     epilogue.  W's product takes a fourth pass, L^-T split in three
//     (tf32_mma.cuh::split3_tf32): L^-T's entries (up to ~30 at the
//     oracle shape, W's ~1) cancel in W, and 3xTF32's ~2^-22 of each
//     term put S2 at 3.3x and s1 at 2.5x the float32 plain version's
//     error from float64 at the M=128 oracle shape, 0.8-1.3x with four
//     passes (CPU emulation, tests/test_torch_variants_tc.py).  W is
//     stored to the scratch, copied back into the slab (load_rows), then
//     kappa = W L^-1 (L^-1 row-major: the wrapper's one [M, M] copy of
//     L^-T's transpose), mf in its epilogue, kappa stored over W.  Both
//     products are full products over the stored triangles (the zero
//     ones included);
//   - then kappa back into the slab and kappa Sigma, contracted with the
//     slab in the epilogue for vf's quadratic form.  "packed" streams
//     [Sigma | mu ...] ([M, N], N = M + 1 rounded up to 8 columns, a
//     16-byte row stride, mu repeated in the padding; the wrapper's),
//     whose column M is mf; the epilogue reads no column past M.
//   The row sums go by shuffles and one slot per warp column in a fixed
//   order; then one thread a row runs the logistic E-step in FP32 and
//   writes c, theta, mf, vf and the statistics' weights rho y/2 and
//   rho theta/2.
// * stats_tc + sum_tiles (kernels 5 and 7's device code, stats_tc.cuh):
//   S2 over its upper triangle in 3xTF32 and s1 in FP32 from the kappa
//   scratch and the weights, chunk partials added in a fixed order: no
//   atomics, S2 exactly symmetric, two calls bit-equal.  The scratch's
//   round trip is 2 x 4 B M bytes, 0.08 ms at the sweep's row.
// Row tiles (with_variant_tile below; the wrapper's Python copy,
// benchmarks/fused_variants.py::variant_tile, picks one): 64 rows by
// 128-column output tiles (8 warps of 32 x 32, two blocks an SM) where the
// widest streamed operand has at most 128 columns, so that every warp of
// the block computes at the sweep's M=128; else kernel 4's tiles of 64,
// 32 or 16 rows by 256 or 128 columns, the largest whose shared memory
// fits (one slab a block: M up to 2,392 on an H100).  The reference pads
// B up to its tile and does not mask the padded rows, whose theta reaches
// S2; here the ragged last tile is masked: rows past B load as zeros, get
// no weight in s1/S2 and are not written.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "pair_core.cuh"

namespace {

// forms of the pass: the order of _FORMS in benchmarks/fused_variants.py
enum Form : int { FORM_DIRECT = 0, FORM_PACKED = 1, FORM_TWO_FACTOR = 2 };
// params layout (ops/cuda_kernels.py::_multi_params, one latent): jitter,
// rho, unused, var, ls [D]
constexpr int P_RHO = 1;

// 64 rows by 128 columns: 2 x 4 warps of 32 x 32 (8 mma tiles a warp)
using NarrowTile = TileShape<64, 2, 4, 2, 4, 16>;

// blocks an SM each tile's instance is built for: the narrow tile's
// registers are capped at 128 so that two blocks share an SM
template <class C>
struct MinBlocks {
  static constexpr int value = 1;
};
template <>
struct MinBlocks<NarrowTile> {
  static constexpr int value = 2;
};

// the slab [TB, S] (the gram, then W or kappa), the scratch (ring, or the
// gram's staging), the row sums [3, WARPS_N, TB]: kernel 4's footprint
template <class C>
__host__ __device__ constexpr size_t vs_smem(int M) {
  return sizeof(float) * ((size_t)C::TB * slab_stride(M) + slab_scratch<C>(M) + 3 * (size_t)C::WARPS_N * C::TB);
}

// One block a tile of TB rows: gram, kappa (kernel 9 through W), the
// moments and the logistic E-step.  a: K^-1 (direct, packed) or L^-T
// (two-factor); linv: L^-1 (two-factor; unused otherwise); sig: Sigma
// [M, M], or [Sigma | mu ...] [M, ns] (packed).  vec: 16-byte copies
// of a, linv and kappa's rows; vec_s: of sig.
template <class C>
__global__ void __launch_bounds__(C::THREADS, MinBlocks<C>::value)
variant_rows(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
             const float* __restrict__ a, const float* __restrict__ linv, const float* __restrict__ mu,
             const float* __restrict__ sig, const float* __restrict__ params, float* __restrict__ kappa,
             float* __restrict__ c_out, float* __restrict__ theta_out, float* __restrict__ mf_out,
             float* __restrict__ vf_out, float* __restrict__ wg, float* __restrict__ ws, int B, int D, int M,
             int ns, int form, bool vec, bool vec_s) {
  constexpr int TB = C::TB;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int S = slab_stride(M);
  float* G = sm;                           // [TB, S]  the gram, then W (two-factor), then kappa; zero past M
  float* ring = G + TB * S;                // the ring; x / ls and z / ls while the gram forms
  float* red = ring + slab_scratch<C>(M);  // [3, WARPS_N, TB]  row sums: Ktilde, mf, vf
  const bool packed = form == FORM_PACKED, two = form == FORM_TWO_FACTOR;
  const int row0 = blockIdx.x * TB;
  const int nrows = min(TB, B - row0);
  const float jitt = params[P_JITT], rho = params[P_RHO], var = params[P_VAR];
  const float* ls = params + P_VAR + 1;

  gram_into_slab<C>(KIND_RBF, x, z, ls, var, G, S, ring, row0, nrows, D, M);

  float kq[C::MI][2] = {}, mq[C::MI][2] = {}, vq[C::MI][2] = {};
  float* out = kappa + (size_t)row0 * M;
  // kappa = G K^-1 or W = G L^-T (L^-T split in three: 4 passes); Ktilde's
  // row sums (and "nt"'s mf) in the epilogue
  const bool mf_here = form == FORM_DIRECT;
  auto first = [&](int n0, float (&acc)[C::MI][C::NJ][4]) {
    for_fragments<C>(n0, acc, [&](int mi, int h, int row, int col, float v0, float v1) {
      if (col < M) {
        kq[mi][h] = fmaf(v0, two ? v0 : G[row * S + col], kq[mi][h]);
        if (mf_here) mq[mi][h] = fmaf(v0, __ldg(mu + col), mq[mi][h]);
      }
      if (col + 1 < M) {
        kq[mi][h] = fmaf(v1, two ? v1 : G[row * S + col + 1], kq[mi][h]);
        if (mf_here) mq[mi][h] = fmaf(v1, __ldg(mu + col + 1), mq[mi][h]);
      }
      store_pair(out, M, nrows, row, col, v0, v1);
    });
  };
  if (two)
    tc_product<C, 4>(G, S, a, M, M, M, ring, vec, first);
  else
    tc_product<C>(G, S, a, M, ring, vec, first);
  // The gram is spent: the rows just written (tc_product ends with a
  // barrier), still in L2, come back into the slab in its place (its
  // columns [M, mk) stay zero).
  load_rows<C>(G, S, out, M, nrows, vec);
  if (two) {  // kappa = W L^-1, stored over W; mf in the epilogue
    tc_product<C>(G, S, linv, M, ring, vec, [&](int n0, float (&acc)[C::MI][C::NJ][4]) {
      for_fragments<C>(n0, acc, [&](int mi, int h, int row, int col, float v0, float v1) {
        if (col < M) mq[mi][h] = fmaf(v0, __ldg(mu + col), mq[mi][h]);
        if (col + 1 < M) mq[mi][h] = fmaf(v1, __ldg(mu + col + 1), mq[mi][h]);
        store_pair(out, M, nrows, row, col, v0, v1);
      });
    });
    load_rows<C>(G, S, out, M, nrows, vec);
  }

  // kappa Sigma, contracted with the kappa slab in the epilogue; packed:
  // its column M is mf
  tc_product<C>(G, S, sig, M, ns, ns, ring, vec_s, [&](int n0, float (&acc)[C::MI][C::NJ][4]) {
    for_fragments<C>(n0, acc, [&](int mi, int h, int row, int col, float v0, float v1) {
      if (col < M) vq[mi][h] = fmaf(v0, G[row * S + col], vq[mi][h]);
      if (col + 1 < M) vq[mi][h] = fmaf(v1, G[row * S + col + 1], vq[mi][h]);
      if (packed && col == M) mq[mi][h] += v0;
      if (packed && col + 1 == M) mq[mi][h] += v1;
    });
  });
  constexpr int R = C::WARPS_N * TB;
  row_partials<C>(kq, red);
  row_partials<C>(mq, red + R);
  row_partials<C>(vq, red + 2 * R);
  __syncthreads();
  for (int t = threadIdx.x; t < nrows; t += C::THREADS) {
    const int r = row0 + t;
    const float kt = fmaxf(var + jitt - row_total<C>(red, t), 1e-12f);
    const float mf = row_total<C>(red + R, t);
    const float vf = fmaxf(kt + row_total<C>(red + 2 * R, t), 1e-12f);
    const float c = sqrtf(mf * mf + vf);
    const float theta = tanhf(c / 2.0f) / (2.0f * c);
    c_out[r] = c;
    theta_out[r] = theta;
    mf_out[r] = mf;
    vf_out[r] = vf;
    wg[r] = rho * (y[r] / 2.0f);
    ws[r] = rho * (theta / 2.0f);
  }
}

// fn(tile) for the row tile of `rows` rows by `cols`-column output tiles:
// (64, 128) the narrow tile, (64, 256), (32, 256), (16, 128) kernel 4's
// (KTile); `other` for another.  benchmarks/fused_variants.py::
// _VARIANT_TILES lists them in this order.
template <class R, class F>
R with_variant_tile(int rows, int cols, R other, F fn) {
  if (rows == NarrowTile::TB && cols == NarrowTile::NT) return fn(NarrowTile());
  return with_tile(rows, other, [&](auto t) { return cols == decltype(t)::NT ? fn(t) : other; });
}

template <class C>
int launch_variant(const float* x, const float* y, const float* z, const float* a, const float* linv,
                   const float* mu, const float* sig, const float* params, float* kappa, float* c, float* theta,
                   float* mf, float* vf, float* wg, float* ws, float* s1_part, float* s2_part, float* s1, float* s2,
                   int B, int D, int M, int ns, int form, int nchunks, int rows_per_chunk, cudaStream_t st) {
  const size_t smem = vs_smem<C>(M);
  cudaError_t err = prepare_smem<&variant_rows<C>>(smem);  // the narrow tile: two blocks an SM
  if (err != cudaSuccess) return (int)err;
  auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = M % 4 == 0 && aligned(a) && aligned(linv) && aligned(kappa);
  const bool vec_s = ns % 4 == 0 && aligned(sig);
  variant_rows<C><<<(B + C::TB - 1) / C::TB, C::THREADS, smem, st>>>(
      x, y, z, a, linv, mu, sig, params, kappa, c, theta, mf, vf, wg, ws, B, D, M, ns, form, vec, vec_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_stats(kappa, wg, ws, s1_part, s2_part, s1, s2, B, M, 1, nchunks, rows_per_chunk, st);
}

}  // namespace

extern "C" {

// The shared memory of kernels 8-9 at M with the row tile (tile_rows,
// tile_cols) of with_variant_tile (SIZE_MAX for another).
// benchmarks/fused_variants.py::variant_smem_bytes is its copy in Python:
// change them together.
size_t agp_fused_variant_smem_bytes(int M, int tile_rows, int tile_cols) {
  return with_variant_tile(tile_rows, tile_cols, SIZE_MAX, [&](auto t) { return vs_smem<decltype(t)>(M); });
}

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], y [B], z [M, D], a [M, M] (K^-1 for the direct and packed
// forms, L^-T for the two-factor one), linv [M, M] (L^-1, two-factor; a
// for the others), mu [M], sigma [M, ns] (Sigma with ns = M; packed:
// [Sigma | mu ...]), params [4 + D] = (jitter, rho, unused, var,
// ls [D]); outputs c, theta, mf, vf [B], s1 [M], s2 [M, M]; scratch kappa
// [B, M], wg, ws [B], s1_part [nchunks, M], s2_part [nchunks, M, M], with
// nchunks = ceil(B / rows_per_chunk).  form: a Form code; (tile_rows,
// tile_cols) a tile of with_variant_tile (agp_fused_variant_smem_bytes
// must fit the card).  Returns the CUDA error of the launches
// (cudaErrorInvalidValue for an unknown form or tile).
int agp_fused_variant_stats(const float* x, const float* y, const float* z, const float* a, const float* linv,
                            const float* mu, const float* sigma, const float* params, float* c, float* theta,
                            float* mf, float* vf, float* kappa, float* wg, float* ws, float* s1_part,
                            float* s2_part, float* s1, float* s2, int B, int D, int M, int ns, int form,
                            int tile_rows, int tile_cols, int nchunks, int rows_per_chunk, void* stream) {
  if (form < FORM_DIRECT || form > FORM_TWO_FACTOR) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_variant_tile(tile_rows, tile_cols, (int)cudaErrorInvalidValue, [&](auto t) {
    return launch_variant<decltype(t)>(x, y, z, a, linv, mu, sigma, params, kappa, c, theta, mf, vf, wg, ws,
                                       s1_part, s2_part, s1, s2, B, D, M, ns, form, nchunks, rows_per_chunk, st);
  });
}

}  // extern "C"
