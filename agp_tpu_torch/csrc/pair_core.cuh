// Device code that the batched pair (batched_pair.cu: kernels 4-5) and the
// single-latent split pair (kappa_single.cu: kernels 6-7) share:
//   * the row tile's gram, FP32, into a [TB, M] slab of shared memory
//     (gram_slab), and the product of a [TB, M] slab with an [M, N] matrix
//     streamed from device memory (L2) on the tensor cores in 3xTF32
//     (tc_product): kappa = Knm K^-1 in kernels 1-4, 6 and 8, kappa Sigma
//     in kernels 1-4 and 8 (kappa copied back into the slab, load_rows), and
//     kernel 9's W = Knm L^-T and kappa = W L^-1; each calls back an
//     epilogue once a column tile of the output is complete, in registers
//     (mma fragments);
//   * the moments pass of kernels 1-4 built from them (moment_rows: kappa,
//     Ktilde, mf and vf of one row tile and latent);
//   * through stats_tc.cuh, the statistics s1 = kappa^T g and
//     S2 = kappa^T diag(theta) kappa of kernels 5 and 7.
// The split, the mma and the copies are tf32_mma.cuh's.
// Kernels 4 and 6's float64 form runs the same parts on tiles of doubles
// (TileShape's element type; KTile<TB, double>): the gram slab, the
// copies and the moments pass are the float code's, in double (the
// double math of gram.cuh), and the product is a micro-tile of its own,
// one FP64 mma.sync pass into double accumulators (tc_product's double
// overload, tf32_mma.cuh's mma_f64_grid).  See
// kappa_single.cu for what bounds kernels 4 and 6 on an H100 and why they
// may use the tensor cores; fused_variants.cu (kernels 8-9) and
// fused_cavi_stats.cu (kernel 1) run the same parts.  Everything is in an
// anonymous namespace: each source that includes this header compiles its
// own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "gram.cuh"
#include "stats_tc.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int DC = 8;         // features a gram pass stages at least
constexpr int KT_STAGES = 3;  // stages in the ring
// params layout (ops/cuda_kernels.py::_multi_params): jitter, rho, lambda,
// var [L], ls [L, D]
constexpr int P_JITT = 0, P_VAR = 3;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The geometry of a block of TB rows of elements T (float, or double for
// kernels 4 and 6's float64 form): WARPS_M x WARPS_N warps over a
// [TB, NT] output tile, each a WM x WN sub-tile of MI x NJ mma tiles
// (16 x 8); a ring of KT_STAGES stages of KB rows of the streamed matrix,
// row stride SP elements (floats: SP = 8 mod 32 puts a warp's B-fragment
// reads on 32 distinct banks; doubles, read 16 lanes a shared-memory
// wavefront: SP = 4 mod 16 puts each half-warp's on 16 distinct 8-byte
// bank pairs).
template <int TB_, int WARPS_M_, int WARPS_N_, int MI_, int NJ_, int KB_, class T = float>
struct TileShape {
  using Elem = T;
  static constexpr int TB = TB_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, MI = MI_, NJ = NJ_, KB = KB_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = 16 * MI, WN = 8 * NJ, NT = WARPS_N * WN;
  static constexpr int SP = NT + (sizeof(T) == 4 ? 8 : 4);
  static constexpr int STAGE = KB * SP;
  static constexpr int RING = KT_STAGES * STAGE;
  static_assert(std::is_same<T, float>::value || std::is_same<T, double>::value, "float or double tiles");
  static_assert(WARPS_M * WM == TB && NT % 32 == 0 && KB % 8 == 0, "whole mma tiles, one warp a sub-tile");
};

// The shapes kernels 4 and 6 take, by row tile (ops/cuda_kernels.py::
// _KAPPA_TILES mirrors them): 8 warps side by side, each all the block's
// rows by 32 columns (64 x 32: 16 mma tiles a warp; 32 x 32), over output
// tiles of 256 columns, 16-row stages; 16-row blocks (the largest M) take
// 16 x 16 warp tiles and 8-row stages, so that the ring stays small.  On
// an H100 at M=512 the 64 x 32 warp tiles ran 3-13 % faster than the other
// shapes of 64-row blocks and 26-27 % faster than two 32-row blocks an SM
// (probes/kappa_tc.cu; PERF.md).
template <int TB>
struct KTileOf;
template <>
struct KTileOf<64> {
  using type = TileShape<64, 1, 8, 4, 4, 16>;
};
template <>
struct KTileOf<32> {
  using type = TileShape<32, 1, 8, 2, 4, 16>;
};
template <>
struct KTileOf<16> {
  using type = TileShape<16, 1, 8, 1, 2, 8>;
};
// The float64 form's (ops/cuda_kernels.py::_KAPPA_TILES_F64 mirrors them):
// the same row tiles at half the float rows' M, 8 warps side by side over
// output tiles of 128 columns (64 x 16, 32 x 16, 16 x 16 a warp: 8, 4 or 2
// tiles of 16 x 8, each two m8n8k4 mma), 16-row stages (8 for 16-row
// blocks).
template <int TB>
struct KTileF64Of;
template <>
struct KTileF64Of<64> {
  using type = TileShape<64, 1, 8, 4, 2, 16, double>;
};
template <>
struct KTileF64Of<32> {
  using type = TileShape<32, 1, 8, 2, 2, 16, double>;
};
template <>
struct KTileF64Of<16> {
  using type = TileShape<16, 1, 8, 1, 2, 8, double>;
};
template <int TB, class T = float>
using KTile = typename std::conditional<std::is_same<T, double>::value, KTileF64Of<TB>, KTileOf<TB>>::type::type;

// v = p[0 : 8], p 16-byte aligned, by 16-byte loads
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const double* p, double (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 a = reinterpret_cast<const double2*>(p)[i];
    v[2 * i] = a.x, v[2 * i + 1] = a.y;
  }
}

// columns of a slab (M padded to whole 8-deep steps, zero past M) and its
// row stride: stride = 4 mod 8 puts a warp's A-fragment reads on 32
// distinct banks (floats), or each half-warp's on 16 distinct bank pairs
// (doubles)
__host__ __device__ constexpr int slab_cols(int M) { return round_up(M, 8); }
__host__ __device__ constexpr int slab_stride(int M) { return slab_cols(M) + 4; }

// floats of the region after the slab: the ring, or while the gram forms
// x / ls [dch, TB], 1 / ls [dch] and z / ls [dch, M + 1], room for at
// least DC features
template <class C>
__host__ __device__ constexpr size_t slab_scratch(int M) {
  const size_t gram = (size_t)DC * (C::TB + M + 2);
  return gram > (size_t)C::RING ? gram : (size_t)C::RING;
}

// G [TB, stride S] = the kind's gram of the row tile x[row0 : row0 + nrows]
// / ls against zl / ls [M, D], zero past nrows and in columns [M, mk).
// r2 = sum_d (x_d - z_d)^2 by direct differences, over chunks of dch
// features staged as xs [dch, TB] (16-byte aligned), 1 / ls [dch] after it
// and zs [dch, M + 1] (shared memory the caller reuses afterwards); x / ls
// and z / ls are both products with 1 / ls, so that a point of the batch
// that is also an inducing point lands on it exactly.  A thread sums 8 rows
// of one column at a time in registers, each feature's x values broadcast
// 16-byte loads (two floats: 16 FP32 operations for three loads) and z one
// load.  G is read back only between chunks (D > dch); the last chunk
// applies the kind's formula.  In the tile's element type.  Ends with a
// barrier.
template <class C, class E = typename C::Elem>
__device__ __forceinline__ void gram_slab(int kind, const E* __restrict__ x, const E* __restrict__ zl,
                                          const E* __restrict__ ls, E var, E* G, int S, E* xs, E* zs, int dch,
                                          int row0, int nrows, int D, int M) {
  constexpr int TB = C::TB, T = C::THREADS, R = 8, U = 8;
  const int tid = threadIdx.x, mk = slab_cols(M), MZ = M + 1;
  E* il = xs + dch * TB;  // 1 / ls of the chunk's features
  for (int d0 = 0; d0 < D; d0 += dch) {
    const int dc = min(dch, D - d0);
    const bool first = d0 == 0, last = d0 + dch >= D;
    if (!first) __syncthreads();  // every thread is done with the previous chunk
    if (tid < dc) il[tid] = E(1) / ls[d0 + tid];
    __syncthreads();
    for (int i = tid; i < dc * TB; i += T) {
      const int dd = i / TB, t = i % TB;
      xs[i] = t < nrows ? x[(size_t)(row0 + t) * D + d0 + dd] * il[dd] : E(0);
    }
    for (int m = tid; m < M; m += T) {  // z's row m, U loads in flight
      const E* zr = zl + (size_t)m * D + d0;
      for (int d = 0; d < dc; d += U) {
        E v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) v[u] = d + u < dc ? zr[d + u] : E(0);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (d + u < dc) zs[(d + u) * MZ + m] = v[u] * il[d + u];
      }
    }
    __syncthreads();
    for (int item = tid; item < mk * (TB / R); item += T) {
      const int m = item % mk, t0 = (item / mk) * R;
      E r[R];
#pragma unroll
      for (int j = 0; j < R; ++j) r[j] = first ? E(0) : G[(t0 + j) * S + m];
      if (m < M) {
#pragma unroll 4
        for (int dd = 0; dd < dc; ++dd) {
          E xv[R];
          load8(xs + dd * TB + t0, xv);
          const E zv = zs[dd * MZ + m];
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const E df = xv[j] - zv;
            r[j] = fma_t(df, df, r[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j)
        G[(t0 + j) * S + m] = !last ? r[j] : (t0 + j < nrows && m < M) ? gram_from_r2_of(kind, r[j], var) : E(0);
    }
  }
  __syncthreads();
}

// The gram slab of the row tile, staged in the scratch U that follows it
// (slab_scratch): gram_slab with as many features a pass as U holds.
template <class C, class E = typename C::Elem>
__device__ __forceinline__ void gram_into_slab(int kind, const E* __restrict__ x, const E* __restrict__ zl,
                                               const E* __restrict__ ls, E var, E* G, int S, E* U, int row0,
                                               int nrows, int D, int M) {
  const int dch = min(D, (int)(slab_scratch<C>(M) / (C::TB + M + 2)));
  gram_slab<C>(kind, x, zl, ls, var, G, S, U, U + (size_t)dch * (C::TB + 1), dch, row0, nrows, D, M);
}

// Copies rows [0, nrows) of src [*, M] (row t at src + t M) into the slab
// A [TB, stride S], columns [0, M), zero in rows [nrows, TB): 16-byte
// copies where vec, else one element a copy.  Columns [M, mk) keep what
// they hold.  Ends with a barrier after the copies have landed.
template <class C, class E = typename C::Elem>
__device__ __forceinline__ void load_rows(E* A, int S, const E* __restrict__ src, int M, int nrows, bool vec) {
  constexpr int W = 16 / sizeof(E), BYTES = sizeof(E);  // elements a 16-byte copy, bytes an element
  if (vec) {
    const int q = M / W;
    for (int i = threadIdx.x; i < C::TB * q; i += C::THREADS) {
      const int r = i / q, c = (i % q) * W;
      cp_async<16>(A + r * S + c, r < nrows ? src + (size_t)r * M + c : src, r < nrows ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < C::TB * M; i += C::THREADS) {
      const int r = i / M, c = i % M;
      cp_async<BYTES>(A + r * S + c, r < nrows ? src + (size_t)r * M + c : src, r < nrows ? BYTES : 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Copies rows [k0, k0 + KB) and columns [n0, n0 + NT) of Bm [K, N]
// (row-major, row stride ldb, as given: no symmetry is assumed) into the
// stage Bs [KB, SP], zero past K and N: 16-byte copies where vec (N and
// ldb whole 16-byte groups of elements, Bm 16-byte aligned), else one
// element a copy.
template <class C, class E = typename C::Elem>
__device__ __forceinline__ void load_b_stage(E* Bs, const E* __restrict__ Bm, int K, int N, int ldb, int k0, int n0,
                                             bool vec) {
  constexpr int W = 16 / sizeof(E), BYTES = sizeof(E);  // elements a 16-byte copy, bytes an element
  if (vec) {
    for (int i = threadIdx.x; i < C::KB * (C::NT / W); i += C::THREADS) {
      const int r = i / (C::NT / W), c = (i % (C::NT / W)) * W;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async<16>(Bs + r * C::SP + c, ok ? Bm + (size_t)(k0 + r) * ldb + n0 + c : Bm, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < C::KB * C::NT; i += C::THREADS) {
      const int r = i / C::NT, c = i % C::NT;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async<BYTES>(Bs + r * C::SP + c, ok ? Bm + (size_t)(k0 + r) * ldb + n0 + c : Bm, ok ? BYTES : 0);
    }
  }
}

// A [TB, mk] (shared memory, row stride S, zero in columns [K, mk),
// mk = slab_cols(K)) times Bm [K, N] (device memory, row stride ldb), one
// [TB, NT] column tile of the output at a time.  Bm's rows stream through
// a ring of KT_STAGES stages of 16-byte cp.async (ring: C::RING floats,
// 16-byte aligned), one barrier a stage, two stages in flight while the
// third is read.  Each warp's
// WM x WN sub-tile runs in 3xTF32 mma.sync: the fragments of A and of the
// stage split into hi and lo as they are loaded, each 8-deep step's three
// passes from a zero accumulator, then added in FP32, the warp's MI x NJ
// tiles pass by pass (mma_3xtf32_grid; with PASSES = 4 the stage's
// fragments split in three, split3_tf32, and mma_4xtf32_grid).  When a
// column tile n0 is complete, epi(n0, acc) takes its fragments (element e
// of acc[mi][nj] at row m_w + mi*16 + gid + 8 (e / 2), column
// n0 + n_w + nj*8 + 2 tig + e % 2) and acc is cleared.  The ring must be
// free at the start; it is free again after the closing barrier.
template <class C, int PASSES = 3, class Epi>
__device__ __forceinline__ void tc_product(const float* A, int S, const float* __restrict__ Bm, int K, int N,
                                           int ldb, float* ring, bool vec, Epi epi) {
  static_assert(PASSES == 3 || PASSES == 4, "3xTF32, or the streamed operand split in three");
  const int mk = slab_cols(K);
  const int nk = (mk + C::KB - 1) / C::KB, nsteps = nk * ((N + C::NT - 1) / C::NT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int m_w = (warp / C::WARPS_N) * C::WM, n_w = (warp % C::WARPS_N) * C::WN;
  auto issue = [&](int s) {
    if (s < nsteps)
      load_b_stage<C>(ring + (s % KT_STAGES) * C::STAGE, Bm, K, N, ldb, (s % nk) * C::KB, (s / nk) * C::NT, vec);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < KT_STAGES - 1; ++s) issue(s);

  float acc[C::MI][C::NJ][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < C::NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<KT_STAGES - 2>();  // this step's stage has landed (for this thread's copies)
    __syncthreads();                 // ... and everyone's; the stage read last step is free
    issue(s + KT_STAGES - 1);
    const int k0 = (s % nk) * C::KB, n0 = (s / nk) * C::NT;
    if (n0 + n_w < N) {  // else the warp's columns lie past N
      const float* Bs = ring + (s % KT_STAGES) * C::STAGE;
#pragma unroll
      for (int kk = 0; kk < C::KB; kk += 8) {
        if (k0 + kk < mk) {
          const float* b0 = Bs + (kk + tig) * C::SP + n_w + gid;  // rows kk + tig and kk + tig + 4
          unsigned bh[C::NJ][2], bl[C::NJ][2], bm[PASSES == 4 ? C::NJ : 1][2];
#pragma unroll
          for (int nj = 0; nj < C::NJ; ++nj) {
            if constexpr (PASSES == 4) {
              split3_tf32(b0[nj * 8], bh[nj][0], bm[nj][0], bl[nj][0]);
              split3_tf32(b0[4 * C::SP + nj * 8], bh[nj][1], bm[nj][1], bl[nj][1]);
            } else {
              split_tf32(b0[nj * 8], bh[nj][0], bl[nj][0]);
              split_tf32(b0[4 * C::SP + nj * 8], bh[nj][1], bl[nj][1]);
            }
          }
          const float* a0 = A + (size_t)(m_w + gid) * S + k0 + kk + tig;  // rows gid, gid + 8; columns tig, tig + 4
          unsigned ah[C::MI][4], al[C::MI][4];
#pragma unroll
          for (int mi = 0; mi < C::MI; ++mi) {
            const float* a = a0 + (size_t)mi * 16 * S;
            split_tf32(a[0], ah[mi][0], al[mi][0]);
            split_tf32(a[8 * S], ah[mi][1], al[mi][1]);
            split_tf32(a[4], ah[mi][2], al[mi][2]);
            split_tf32(a[8 * S + 4], ah[mi][3], al[mi][3]);
          }
          if constexpr (PASSES == 4)
            mma_4xtf32_grid(acc, ah, al, bh, bm, bl);
          else
            mma_3xtf32_grid(acc, ah, al, bh, bl);
        }
      }
    }
    if (k0 + C::KB >= mk) {  // the column tile is complete
      epi(n0, acc);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < C::NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// tc_product's float64 form: A [TB, mk] (shared memory, doubles) times Bm
// [K, N] (device memory), streamed through the same ring of KT_STAGES
// stages (16-byte cp.async: two doubles a copy), one barrier a stage.  Each
// warp's WM x WN sub-tile runs one FP64 mma.sync pass a 4-deep step
// (mma_f64_grid: each 16 x 8 tile two m8n8k4), unsplit, the accumulators
// carrying the whole sum in IEEE double (the mma's FMA).  The fragments
// and the epilogue are tc_product's (element e of acc[mi][nj] at row
// m_w + mi*16 + gid + 8 (e / 2), column n0 + n_w + nj*8 + 2 tig + e % 2).
template <class C, class Epi>
__device__ __forceinline__ void tc_product(const double* A, int S, const double* __restrict__ Bm, int K, int N,
                                           int ldb, double* ring, bool vec, Epi epi) {
  static_assert(std::is_same<typename C::Elem, double>::value, "a tile of doubles");
  const int mk = slab_cols(K);
  const int nk = (mk + C::KB - 1) / C::KB, nsteps = nk * ((N + C::NT - 1) / C::NT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int m_w = (warp / C::WARPS_N) * C::WM, n_w = (warp % C::WARPS_N) * C::WN;
  auto issue = [&](int s) {
    if (s < nsteps)
      load_b_stage<C>(ring + (s % KT_STAGES) * C::STAGE, Bm, K, N, ldb, (s % nk) * C::KB, (s / nk) * C::NT, vec);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < KT_STAGES - 1; ++s) issue(s);

  double acc[C::MI][C::NJ][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < C::NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<KT_STAGES - 2>();  // this step's stage has landed (for this thread's copies)
    __syncthreads();                 // ... and everyone's; the stage read last step is free
    issue(s + KT_STAGES - 1);
    const int k0 = (s % nk) * C::KB, n0 = (s / nk) * C::NT;
    if (n0 + n_w < N) {  // else the warp's columns lie past N
      const double* Bs = ring + (s % KT_STAGES) * C::STAGE;
#pragma unroll
      for (int kk = 0; kk < C::KB; kk += 4) {
        if (k0 + kk < mk) {
          const double* b0 = Bs + (kk + tig) * C::SP + n_w + gid;  // row kk + tig
          double b[C::NJ];
#pragma unroll
          for (int nj = 0; nj < C::NJ; ++nj) b[nj] = b0[nj * 8];
          const double* a0 = A + (size_t)(m_w + gid) * S + k0 + kk + tig;  // rows gid, gid + 8; column tig
          double a[C::MI][2];
#pragma unroll
          for (int mi = 0; mi < C::MI; ++mi) {
            a[mi][0] = a0[(size_t)mi * 16 * S];
            a[mi][1] = a0[(size_t)(mi * 16 + 8) * S];
          }
          mma_f64_grid(acc, a, b);
        }
      }
    }
    if (k0 + C::KB >= mk) {  // the column tile is complete
      epi(n0, acc);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < C::NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// tc_product with a square Bm [M, M] of row stride M (either form)
template <class C, class E, class Epi>
__device__ __forceinline__ void tc_product(const E* A, int S, const E* __restrict__ Bm, int M, E* ring, bool vec,
                                           Epi epi) {
  tc_product<C>(A, S, Bm, M, M, M, ring, vec, epi);
}

// Calls f(row, col, v) for each element of an epilogue's fragments, rows
// and columns within the block's [TB, NT] tile at n0, in a fixed order.
template <class C, class F, class E>
__device__ __forceinline__ void for_fragments(int n0, E (&acc)[C::MI][C::NJ][4], F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int m_w = (warp / C::WARPS_N) * C::WM, n_w = (warp % C::WARPS_N) * C::WN;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < C::NJ; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(mi, h, m_w + mi * 16 + gid + 8 * h, n0 + n_w + nj * 8 + 2 * tig, acc[mi][nj][2 * h],
          acc[mi][nj][2 * h + 1]);
}

// Stores an output tile's fragments to rows [0, nrows) of out [*, M] (row
// t at out + t M): 8-byte stores where M is even (out 8-byte aligned).
__device__ __forceinline__ void store_pair(float* __restrict__ out, int M, int nrows, int row, int col, float v0,
                                           float v1) {
  if (row >= nrows || col >= M) return;
  float* p = out + (size_t)row * M + col;
  if ((M & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (col + 1 < M) p[1] = v1;
  }
}

// store_pair of doubles: 16-byte stores where M is even (out 16-byte
// aligned)
__device__ __forceinline__ void store_pair(double* __restrict__ out, int M, int nrows, int row, int col, double v0,
                                           double v1) {
  if (row >= nrows || col >= M) return;
  double* p = out + (size_t)row * M + col;
  if ((M & 1) == 0) {
    *reinterpret_cast<double2*>(p) = make_double2(v0, v1);
  } else {
    p[0] = v0;
    if (col + 1 < M) p[1] = v1;
  }
}

// Row sums of per-thread partials v[mi][h] (row m_w + mi*16 + gid + 8h):
// the four lanes of a row by shuffles, then one slot per warp column,
// out [WARPS_N, TB]; row_total adds the slots in order.  Deterministic.
template <class C, class E>
__device__ __forceinline__ void row_partials(const E (&v)[C::MI][2], E* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int m_w = (warp / C::WARPS_N) * C::WM;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      E s = v[mi][h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (tig == 0) out[(warp % C::WARPS_N) * C::TB + m_w + mi * 16 + gid + 8 * h] = s;
    }
}

template <class C, class E>
__device__ __forceinline__ E row_total(const E* red, int t) {
  E s = red[t];
#pragma unroll
  for (int w = 1; w < C::WARPS_N; ++w) s += red[w * C::TB + t];
  return s;
}

// Shared memory of a moments pass (moment_rows): the slab [TB, S] (the
// gram, then kappa), the scratch (the ring, or the gram's staging) and the
// row sums [3, WARPS_N, TB]; D does not enter.  ops/cuda_kernels.py's
// fused_fits (kernels 1-3) and kappa_smem_bytes (kernel 4) copy it: change
// them together (chip_smoke.py's check_fused_fits and check_kappa_tiles
// hold them against each other).
template <class C>
__host__ __device__ constexpr size_t rows_smem(int M) {
  return sizeof(typename C::Elem) *
         ((size_t)C::TB * slab_stride(M) + slab_scratch<C>(M) + 3 * (size_t)C::WARPS_N * C::TB);
}

// The moments pass of kernels 1-4 over one row tile of one latent, in the
// block's rows_smem(M) bytes at sm: the gram of x[row0 : row0 + nrows] / ls
// against zl / ls into the slab (gram_into_slab); kappa = G K^-1
// (tc_product), stored from the fragments to rows [0, nrows) of out [*, M],
// with Ktilde's row sums against the gram slab and mf = kappa mu (mu from
// L1) in its epilogue; kappa back into the slab in the gram's place (the
// rows just written, still in L2: load_rows); kappa Sigma, contracted with
// the slab in its epilogue for vf's quadratic form.  The row sums go by
// shuffles and one slot a warp column, added in a fixed order; then for
// each row t < nrows, fin(t, mf, vf) with
//   Ktilde = max(var + jitt - rowsum(kappa o Knm), 1e-12),
//   vf     = max(Ktilde + rowsum((kappa Sigma) o kappa), 1e-12),
// one thread a row.  vec: 16-byte copies of K^-1 and of kappa's rows;
// vec_s: of Sigma.  In the tile's element type: the float64 form runs the
// same pass on doubles, with tc_product's FP64 form.
template <class C, class Fin, class E = typename C::Elem>
__device__ __forceinline__ void moment_rows(E* sm, int kind, const E* __restrict__ x, const E* __restrict__ zl,
                                            const E* __restrict__ ls, E var, E jitt, const E* __restrict__ kinv,
                                            const E* __restrict__ mu, const E* __restrict__ sigma,
                                            E* __restrict__ out, int row0, int nrows, int D, int M, bool vec,
                                            bool vec_s, Fin fin) {
  constexpr int TB = C::TB;
  const int S = slab_stride(M);
  E* G = sm;                           // [TB, S]  the gram, then kappa; zero past M
  E* ring = G + TB * S;                // the ring; x / ls and z / ls while the gram forms
  E* red = ring + slab_scratch<C>(M);  // [3, WARPS_N, TB]  row sums: Ktilde, mf, vf

  gram_into_slab<C>(kind, x, zl, ls, var, G, S, ring, row0, nrows, D, M);

  E kq[C::MI][2] = {}, mq[C::MI][2] = {}, vq[C::MI][2] = {};
  tc_product<C>(G, S, kinv, M, ring, vec, [&](int n0, E (&acc)[C::MI][C::NJ][4]) {
    for_fragments<C>(n0, acc, [&](int mi, int h, int row, int col, E v0, E v1) {
      if (col < M) {
        kq[mi][h] = fma_t(v0, G[row * S + col], kq[mi][h]);
        mq[mi][h] = fma_t(v0, __ldg(mu + col), mq[mi][h]);
      }
      if (col + 1 < M) {
        kq[mi][h] = fma_t(v1, G[row * S + col + 1], kq[mi][h]);
        mq[mi][h] = fma_t(v1, __ldg(mu + col + 1), mq[mi][h]);
      }
      store_pair(out, M, nrows, row, col, v0, v1);
    });
  });
  // The gram is spent: the rows just written (tc_product ends with a
  // barrier) come back into the slab in its place (its columns [M, mk)
  // stay zero), so that one slab serves both products.
  load_rows<C>(G, S, out, M, nrows, vec);
  tc_product<C>(G, S, sigma, M, ring, vec_s, [&](int n0, E (&acc)[C::MI][C::NJ][4]) {
    for_fragments<C>(n0, acc, [&](int mi, int h, int row, int col, E v0, E v1) {
      if (col < M) vq[mi][h] = fma_t(v0, G[row * S + col], vq[mi][h]);
      if (col + 1 < M) vq[mi][h] = fma_t(v1, G[row * S + col + 1], vq[mi][h]);
    });
  });
  constexpr int R = C::WARPS_N * TB;
  row_partials<C>(kq, red);
  row_partials<C>(mq, red + R);
  row_partials<C>(vq, red + 2 * R);
  __syncthreads();
  for (int t = threadIdx.x; t < nrows; t += C::THREADS) {
    const E kt = fmax_t(var + jitt - row_total<C>(red, t), E(1e-12));
    fin(t, row_total<C>(red + R, t), fmax_t(kt + row_total<C>(red + 2 * R, t), E(1e-12)));
  }
}

// fn(KTile<tile_rows, T>()) for the runtime row tile `tile_rows` (64, 32 or
// 16) of elements T (float by default); `other` for another
template <class T = float, class R, class F>
R with_tile(int tile_rows, R other, F fn) {
  switch (tile_rows) {
    case 64:
      return fn(KTile<64, T>());
    case 32:
      return fn(KTile<32, T>());
    case 16:
      return fn(KTile<16, T>());
    default:
      return other;
  }
}

}  // namespace
