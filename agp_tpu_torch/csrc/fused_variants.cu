// Design-sweep variants of the fused single-latent statistics pass for
// Hopper (sm_90a): kernels 8 and 9 of the port.
//
// Replaces: benchmarks/fused_variants.py, direct_stats (body _v1_kernel,
// variants "transpose", "nt" and "packed"; kernel 8) and two_factor_nt
// (body _v5_kernel, kappa from _kappa_tile_two_factor; kernel 9).  Both
// compute, for the RBF gram and the logistic likelihood, the pass of
// kernel 1 (fused_cavi_stats.cu), one tile of TB minibatch rows at a time:
//   gram     Knm = var exp(-|x/ls - z/ls|^2 / 2)
//   kappa    direct:      kappa = Knm K^-1,  Ktilde = var + jitt - rowsum(kappa o Knm)
//            two-factor:  W = Knm L^-T,  Ktilde = var + jitt - rowsum(W o W),
//                         kappa = W L^-1
//            (Ktilde floored at 1e-12)
//   moments  mf = kappa mu,  vf = max(Ktilde + rowsum((kappa Sigma) o kappa), 1e-12)
//   E-step   c = sqrt(mf^2 + vf),  theta = tanh(c/2) / (2c)
//   stats    s1 = kappa^T (rho y/2),  S2 = kappa^T diag(rho theta/2) kappa
//
// Design, against the TPU kernels:
// * "transpose" and "nt" differ only in how the TPU's MXU is fed S2 (an
//   explicit transpose of the [TB, M] kappa tile, or a dot that contracts
//   dim 0 of both operands).  Here S2 is a loop over the tile's rows either
//   way, so one instance (FORM_DIRECT) serves both.
// * "packed" keeps mu as column M of a [M, M+1] Sigma operand in shared
//   memory, so that one product gives kappa Sigma and mf.  The TPU operand
//   is [M, M+128] (lane alignment); its 127 zero columns are not carried.
// * The two-factor form holds L^-T where the direct form holds K^-1, at the
//   same footprint.  W = Knm L^-T goes to the second [TB, M] tile; L^-T is
//   then transposed in place, so that kappa = W L^-1 reads it with the same
//   conflict-free pattern (consecutive threads, consecutive columns), and
//   kappa goes over the gram tile, which is no longer needed; L^-T is
//   transposed back for the block's next tile.  Both products are full
//   products over the stored [M, M] array (the zero triangle included).
// * The reference pads B up to its tile and does not mask the padded rows,
//   whose theta reaches S2.  Here the ragged last tile is masked as in
//   kernel 1: rows past B load as zeros and get zero weight in s1/S2; their
//   per-row outputs are not written.
// * A bounded grid: min(row tiles, blocks the card holds at once) blocks,
//   each looping over row tiles with the grid as its stride and adding its
//   tiles into one partial s1/S2 of its own (each thread owns the same
//   entries in every tile, so no barrier guards the partial);
//   sum_partials (block_sums.cuh) then adds the partials in block order.
//   One partial per tile would take 4,096 x 64 KB = 268 MB of scratch at
//   the sweep's B=262,144, M=128; one per block takes ~8.6 MB.  The grid
//   depends only on the card and the shape, so the sums are deterministic.
// * FP32 FMA throughout, no TF32 and no tensor cores: kappa cancels by
//   cond(Kmm), and in the two-factor form both W and kappa are full FP32.
//
// Shared memory, for every form: K^-1 or L^-T, Sigma (and mu), Z, the row
// tile and two [TB, M] tiles: 4 (TB D + M (D|1) + 2 M^2 + M + 2 TB M + 4 TB)
// bytes, as kernel 1: 75 KB at M=64, D=20 and 204,800 bytes at M=128, D=8
// (the wrapper takes fused_fits(1, D, M) shapes: M <= 128).
//
// What bounds it on an H100: per row ~3 M^2 FMAs (direct: kappa, kappa
// Sigma, S2; two-factor one M^2 more for W) against ~4 (D + 1) bytes read,
// so FP32 issue and shared-memory bandwidth, not device memory.  At the
// flagship's B=4096 the grid is 64 blocks on 132 SMs, as kernel 1's.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "block_sums.cuh"
#include "gram.cuh"

namespace {

constexpr int TB = 64;  // minibatch rows per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// forms of the pass: the order of _FORMS in benchmarks/fused_variants.py
enum Form : int { FORM_DIRECT = 0, FORM_PACKED = 1, FORM_TWO_FACTOR = 2 };

// odd row stride for Z in shared memory: column reads across a warp hit
// distinct banks
__host__ __device__ inline int z_stride(int D) { return D | 1; }

// kernel 1's footprint (fused_fits in ops/cuda_kernels.py mirrors it): the
// packed [M, M+1] Sigma takes the words of Sigma and mu
size_t smem_bytes(int D, int M) {
  size_t f = (size_t)TB * D + (size_t)M * z_stride(D) + 2 * (size_t)M * M + M +
             2 * (size_t)TB * M + 4 * TB;
  return f * sizeof(float);
}

// a [M, M] shared array transposed in place, each pair swapped by one thread
__device__ inline void transpose_in_place(float* a, int M) {
  for (int i = threadIdx.x; i < M * M; i += THREADS) {
    const int r = i / M, c = i % M;
    if (r < c) {
      const float t = a[r * M + c];
      a[r * M + c] = a[c * M + r];
      a[c * M + r] = t;
    }
  }
}

// out[t, n] = sum_m in[t, m] b[m, n] over a [TB, M] tile, b [M, M]; a
// thread per entry, so a warp reads consecutive columns of b and shares
// in's row
__device__ inline void tile_product(const float* in, const float* b, float* out, int M) {
  for (int i = threadIdx.x; i < TB * M; i += THREADS) {
    const float* r = in + (i / M) * M;
    const int n = i % M;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) acc = fmaf(r[m], b[m * M + n], acc);
    out[i] = acc;
  }
}

template <int FORM>
__global__ void __launch_bounds__(THREADS)
variant_stats(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
              const float* __restrict__ a, const float* __restrict__ mu,
              const float* __restrict__ sigma, const float* __restrict__ params,
              float* __restrict__ c_out, float* __restrict__ theta_out, float* __restrict__ mf_out,
              float* __restrict__ vf_out, float* __restrict__ s1_part, float* __restrict__ s2_part,
              int B, int D, int M) {
  constexpr bool PACKED = FORM == FORM_PACKED;
  constexpr bool TWO_FACTOR = FORM == FORM_TWO_FACTOR;
  extern __shared__ float sm[];
  const int Dz = z_stride(D);
  const int ss = PACKED ? M + 1 : M;  // row stride of Sigma
  float* xs = sm;              // [TB, D]   x / ls
  float* zs = xs + TB * D;     // [M, Dz]   z / ls
  float* as = zs + M * Dz;     // [M, M]    K^-1 (direct) or L^-T (two-factor)
  float* sg = as + M * M;      // [M, ss]   Sigma, packed: mu in column M
  float* mus = sg + M * M;     // [M]       mu (unpacked; packed: Sigma's last words)
  float* G = mus + M;          // [TB, M]   gram
  float* Kp = G + TB * M;      // [TB, M]   kappa (direct) or W (two-factor)
  float* kt = Kp + TB * M;     // [TB]      Ktilde
  float* mfs = kt + TB;        // [TB]      mf (packed)
  float* wg = mfs + TB;        // [TB]      rho y/2, 0 past B
  float* ws = wg + TB;         // [TB]      rho theta/2, 0 past B

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float ls = params[0], var = params[1], jitt = params[2], rho = params[3];

  for (int i = tid; i < M * D; i += THREADS) zs[(i / D) * Dz + i % D] = z[i] / ls;
  for (int i = tid; i < M * M; i += THREADS) {
    as[i] = a[i];
    sg[(i / M) * ss + i % M] = sigma[i];
  }
  for (int i = tid; i < M; i += THREADS) {
    if (PACKED)
      sg[i * ss + M] = mu[i];
    else
      mus[i] = mu[i];
  }

  float* s1p = s1_part + (size_t)blockIdx.x * M;
  float* s2p = s2_part + (size_t)blockIdx.x * M * M;
  const int ntiles = (B + TB - 1) / TB;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int row0 = tile * TB;
    const int nrows = min(TB, B - row0);
    for (int i = tid; i < TB * D; i += THREADS)
      xs[i] = i / D < nrows ? x[(size_t)row0 * D + i] / ls : 0.0f;
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
      G[i] = gram_from_r2<KIND_RBF>(r2, var);
    }
    __syncthreads();

    tile_product(G, as, Kp, M);  // kappa = Knm K^-1, or W = Knm L^-T
    __syncthreads();

    float *kap, *scr;  // the kappa tile, and the tile free for kappa Sigma
    if (TWO_FACTOR) {
      for (int t = warp; t < TB; t += WARPS) {
        float q = 0.0f;
        for (int n = lane; n < M; n += 32) q = fmaf(Kp[t * M + n], Kp[t * M + n], q);
        q = warp_sum(q);
        if (lane == 0) kt[t] = fmaxf(var + jitt - q, 1e-12f);
      }
      transpose_in_place(as, M);  // L^-T -> L^-1
      __syncthreads();
      tile_product(Kp, as, G, M);  // kappa = W L^-1, over the gram
      __syncthreads();
      transpose_in_place(as, M);  // back to L^-T; read again after the next gram
      kap = G;
      scr = Kp;
    } else {
      for (int t = warp; t < TB; t += WARPS) {
        float q = 0.0f;
        for (int n = lane; n < M; n += 32) q = fmaf(Kp[t * M + n], G[t * M + n], q);
        q = warp_sum(q);
        if (lane == 0) kt[t] = fmaxf(var + jitt - q, 1e-12f);
      }
      __syncthreads();
      kap = Kp;
      scr = G;
    }

    // kappa Sigma over the free tile; packed: column M of the product is mf
    for (int i = tid; i < TB * ss; i += THREADS) {
      const int t = i / ss, n = i % ss;
      const float* kr = kap + t * M;
      float acc = 0.0f;
      for (int m = 0; m < M; ++m) acc = fmaf(kr[m], sg[m * ss + n], acc);
      if (n < M)
        scr[t * M + n] = acc;
      else
        mfs[t] = acc;
    }
    __syncthreads();

    // per row: vf (and mf, unpacked) and the logistic E-step, one warp a row
    for (int t = warp; t < TB; t += WARPS) {
      float q = 0.0f, m1 = 0.0f;
      for (int n = lane; n < M; n += 32) {
        const float k = kap[t * M + n];
        q = fmaf(scr[t * M + n], k, q);
        if (!PACKED) m1 = fmaf(k, mus[n], m1);
      }
      q = warp_sum(q);
      if (!PACKED) m1 = warp_sum(m1);
      if (lane == 0) {
        float wgt = 0.0f, wst = 0.0f;
        if (t < nrows) {
          const int r = row0 + t;
          const float mf = PACKED ? mfs[t] : m1;
          const float vf = fmaxf(kt[t] + q, 1e-12f);
          const float c = sqrtf(mf * mf + vf);
          const float theta = tanhf(c / 2.0f) / (2.0f * c);
          c_out[r] = c;
          theta_out[r] = theta;
          mf_out[r] = mf;
          vf_out[r] = vf;
          wgt = rho * (y[r] / 2.0f);
          wst = rho * (theta / 2.0f);
        }
        wg[t] = wgt;
        ws[t] = wst;
      }
    }
    __syncthreads();

    // this tile's statistics, added to the block's partial
    for (int m = tid; m < M; m += THREADS) {
      float acc = 0.0f;
      for (int t = 0; t < TB; ++t) acc = fmaf(kap[t * M + m], wg[t], acc);
      s1p[m] = first ? acc : s1p[m] + acc;
    }
    for (int i = tid; i < M * M; i += THREADS) {
      const int m = i / M, n = i % M;
      float acc = 0.0f;
      for (int t = 0; t < TB; ++t) acc = fmaf(kap[t * M + m] * ws[t], kap[t * M + n], acc);
      s2p[i] = first ? acc : s2p[i] + acc;
    }
    // the next tile writes xs, then G only after a barrier, and its first
    // reads of kap's tile (or of as) come after that barrier
  }
}

template <int FORM>
int blocks_per_sm(int D, int M) {
  const size_t smem = smem_bytes(D, M);
  if (cudaFuncSetAttribute(variant_stats<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, variant_stats<FORM>, THREADS, smem) !=
      cudaSuccess)
    return 0;
  return n;
}

template <int FORM>
int launch(const float* x, const float* y, const float* z, const float* a, const float* mu,
           const float* sigma, const float* params, float* c, float* theta, float* mf, float* vf,
           float* s1_part, float* s2_part, float* s1, float* s2, int B, int D, int M, int nblocks,
           cudaStream_t st) {
  const size_t smem = smem_bytes(D, M);
  cudaError_t err = cudaFuncSetAttribute(variant_stats<FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  variant_stats<FORM><<<nblocks, THREADS, smem, st>>>(x, y, z, a, mu, sigma, params, c, theta, mf,
                                                      vf, s1_part, s2_part, B, D, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum_partials(s1_part, s2_part, s1, s2, nblocks, M, st);
}

}  // namespace

extern "C" {

int agp_fused_variant_tile_rows(void) { return TB; }

size_t agp_fused_variant_smem_bytes(int D, int M) { return smem_bytes(D, M); }

// resident blocks of the form's kernel on one SM of the current device at
// (D, M); 0 on error or for an unknown form
int agp_fused_variant_blocks_per_sm(int D, int M, int form) {
  switch (form) {
    case FORM_DIRECT:
      return blocks_per_sm<FORM_DIRECT>(D, M);
    case FORM_PACKED:
      return blocks_per_sm<FORM_PACKED>(D, M);
    case FORM_TWO_FACTOR:
      return blocks_per_sm<FORM_TWO_FACTOR>(D, M);
    default:
      return 0;
  }
}

// All pointers are device pointers to contiguous float32 arrays:
// x [B, D], y [B], z [M, D], a [M, M] (K^-1 for the direct and packed
// forms, L^-T for the two-factor one), mu [M], sigma [M, M],
// params [4] = (lengthscale, variance, jitter, rho); outputs c, theta, mf,
// vf [B], s1 [M], s2 [M, M]; scratch s1_part [nblocks, M], s2_part
// [nblocks, M, M], with 1 <= nblocks <= ceil(B / TB).  form: a Form code.
// Returns the CUDA error of the launches (cudaErrorInvalidValue for an
// unknown form).
int agp_fused_variant_stats(const float* x, const float* y, const float* z, const float* a,
                            const float* mu, const float* sigma, const float* params, float* c,
                            float* theta, float* mf, float* vf, float* s1_part, float* s2_part,
                            float* s1, float* s2, int B, int D, int M, int form, int nblocks,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case FORM_DIRECT:
      return launch<FORM_DIRECT>(x, y, z, a, mu, sigma, params, c, theta, mf, vf, s1_part,
                                 s2_part, s1, s2, B, D, M, nblocks, st);
    case FORM_PACKED:
      return launch<FORM_PACKED>(x, y, z, a, mu, sigma, params, c, theta, mf, vf, s1_part,
                                 s2_part, s1, s2, B, D, M, nblocks, st);
    case FORM_TWO_FACTOR:
      return launch<FORM_TWO_FACTOR>(x, y, z, a, mu, sigma, params, c, theta, mf, vf, s1_part,
                                     s2_part, s1, s2, B, D, M, nblocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
