// The column-blocked form of kernels 4 and 6 (kappa = Knm K^-1 and what is
// formed beside it), for Hopper (sm_90a): float64 calls past M=128, and
// float32 calls past the row slab's range (kappa_tile_rows is None: M >
// 2,392 for kernel 4, M > 2,406 for kernel 6).  It replaces, in
// agp_tpu/ops/pallas_kernels.py, fused_kappa (:213, pallas_call :257, tile
// _kappa_tile :172) and fused_kappa_moments_batched (:361, pallas_call
// :419); kappa_single.cu and batched_pair.cu hold the entry points and say
// what each function computes.
//
// Why columns.  The slab form (pair_core.cuh) keeps a [TB, M] row slab of
// the gram in shared memory and streams K^-1 past it: its shared memory
// grows with M, which caps M (in double at 1,184 / 1,192, in float at
// 2,392 / 2,406), and at double width it leaves 32-row tiles at M=512, so
// that each of 2,048 blocks reads all of K^-1 from L2 for 32 rows.  Here a
// block computes one [TB, TN] = [128, 128] tile of the output with a loop
// over k-chunks of M in which both operands stream through a ring of
// cp.async stages: its shared memory does not depend on M, so there is no
// ceiling, and each block's reads of K^-1 serve 128 rows.
//
// The A operand is the gram Knm [L, B, M], written once by gram_rows (a
// small kernel of its own) and streamed: on an H100 at B=65,536, M=512,
// D=20 in double it takes 0.30 ms, 0.29 of them its arithmetic (20
// differences and FMAs and a double exp an entry).  Forming the gram chunk
// in the product's blocks instead would repeat that arithmetic for each of
// the M / TN column tiles, 4 x 0.29 ms there (probes/kappa_cols.cu;
// PERF.md).  The grid runs a row panel's column tiles next to each other
// (column tile fastest), so that the panel's later reads come from L2: one
// linear block index on grid x, row tile times column tiles plus column
// tile, which caps neither B nor M (grid y, which holds the latents,
// would cap a dimension at 65,535 tiles).
//
// The product.  Doubles: one FP64 mma.sync.m16n8k8 a warp tile's 16 x 8 x
// 8 step (DMMA: IEEE double with FMA, nothing to split; m16n8k4, k8 and
// k16 each ran at 67 TFLOP/s from registers, probes/dmma_shapes.cu); each
// warp a 64 x 32 tile (MI = 4, NJ = 4: every A fragment serves the warp's
// four column tiles, every B fragment its four row tiles), 8 warps, one
// block an SM (64 doubles of accumulators a thread).  The mma's k index t
// and t + 4 are read from the stage's columns 2t and 2t + 1 (and B's rows
// 2t and 2t + 1): A's two values of a row come in one 16-byte shared load,
// B's in two 8-byte ones, row strides chosen so that a warp's loads hit
// distinct banks.  Floats (past the slab's range only): the same tiles in
// 3xTF32 under the split pairs' rule (tf32_mma.cuh: hi and lo split, each
// 8-deep step's three passes from a zero accumulator, then added in FP32).
//
// The row sums.  K~ = max(var + jitter - sum_m kappa o Knm, 1e-12): each
// column tile's epilogue brings its A tile back into shared memory in one
// batch of copies and takes its rows' partial sums into a [L,
// n_col_tiles, B] scratch by shuffles and one slot a warp column;
// kappa_cols_finish adds them over the column tiles in a fixed order and
// clamps after the sum, so two calls are bit-equal.  Kernel 4 forms mf =
// kappa mu in the same epilogue, then runs a second product, kappa Sigma,
// on kappa read back from device memory (Sigma symmetric: each column tile
// sums k only up to its own last column, the blocks below its diagonal
// twice, about half of the full product), whose epilogue takes
// rowsum((kappa Sigma) o kappa)'s partials, and kappa_cols_finish forms
// vf = max(K~ + that, 1e-12).  So a call of kernel 6 is three launches
// (gram, product, finish) and one of kernel 4 four (gram, kappa, kappa
// Sigma, finish).  The ragged B and M edges are masked in the kernels
// (zero-filled copies, masked stores); nothing is padded on the host.
//
// What bounds it: operations.  Kernel 6 in double at B=65,536, M=512,
// D=20: kappa's 17.2 G FMAs at the FP64 tensor-core peak (67 TFLOP/s),
// 0.51 ms, against 0.27 GB of Knm written and read and 0.27 GB of kappa
// written (0.24 ms at 3.35 TB/s); kernel 4 adds kappa Sigma (the function
// needs its quadratic form, M (M+1)/2 a row).  The product's main loop
// reaches ~39 TFLOP/s there (58 % of the peak): each 128 x 128 tile
// streams one byte from L2 for every 8 FMAs, and the epilogue (~15 %) runs
// alone, one block an SM.  Everything is in an anonymous namespace:
// each source that includes this header compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "pair_core.cuh"

namespace {

// A block of the column-blocked product over elements E: a [TB, TN] output
// tile, WARPS_M x WARPS_N warps each a WM x WN sub-tile of MI x NJ mma
// tiles (16 x 8), k-chunks of KC (by default 16 doubles or 32 floats)
// through a ring of STAGES stages, each the A chunk [TB, SA] then the B
// chunk [KC, SB].  Strides: A's rows SA = KC + 8 elements (doubles: 8 mod
// 16, so that a quarter-warp's 16-byte loads of rows gid, gid + 1 fall on
// distinct banks; floats: 8 mod 32 for 8-byte loads), B's rows SB = TN + 2
// doubles (2 mod 8) or TN + 4 floats (4 mod 16), so that the loads of rows
// 2 tig and columns gid do not collide.  MIN_BLOCKS blocks an SM; the ring,
// reused for the epilogue's A tile and row sums after the product, is all
// its shared memory (SMEM bytes, copied by ops/cuda_kernels.py::
// kappa_cols_smem_bytes: change them together).
template <class E, int TB_, int TN_, int WARPS_M_, int WARPS_N_, int STAGES_, int MIN_BLOCKS_, int KC_ = 0>
struct ColShape {
  using Elem = E;
  static constexpr bool F64 = std::is_same<E, double>::value;
  static constexpr int TB = TB_, TN = TN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_, THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = TB / WARPS_M, WN = TN / WARPS_N, MI = WM / 16, NJ = WN / 8;
  static constexpr int KC = KC_ ? KC_ : F64 ? 16 : 32;
  static constexpr int SA = KC + 8, SB = TN + (F64 ? 2 : 4);
  static constexpr int STAGE = TB * SA + KC * SB;
  static constexpr size_t SMEM = sizeof(E) * (size_t)STAGES * STAGE;
  static_assert(F64 || std::is_same<E, float>::value, "float or double tiles");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && WARPS_M * WM == TB && WARPS_N * WN == TN, "whole mma tiles");
  static_assert(TB * (TN + 8) + 2 * WARPS_N * TB <= STAGES * STAGE, "the epilogue's A tile and row sums fit the ring");
};

// The tiles kernels 4 and 6 take (ops/cuda_kernels.py::_COL_TILES mirrors
// them): [128, 128] in 8 warps of 64 x 32, one block an SM, k-chunks of 32
// in three stages (doubles, 218 KB) or four (floats, 146 KB).  On an H100
// at B=65,536, M=512 in double the product's main loop took 0.885 ms with
// 32-deep chunks against 0.983 with 16-deep ones in four stages, and the
// other shapes tried (two blocks an SM of [128, 64] or [64, 128], 16 warps
// of 32 x 32) 0.96-2.2 ms (probes/kappa_cols.cu; PERF.md).
template <class E>
struct ColTileOf;
template <>
struct ColTileOf<double> {
  using type = ColShape<double, 128, 128, 2, 4, 3, 1, 32>;
};
template <>
struct ColTileOf<float> {
  using type = ColShape<float, 128, 128, 2, 4, 4, 1, 32>;
};
template <class E>
using ColTile = typename ColTileOf<E>::type;

// Copies the stage of k-chunk k0: rows [0, nrows) of A (row t at
// a + t lda), columns [k0, k0 + KC), into As [TB, SA], and rows
// [k0, k0 + KC), columns [n0, n0 + TN) of Bm [K, N] (row stride ldb) into
// Bs [KC, SB], zero past nrows, K and N: 16-byte copies of A where vec_a
// (K and lda whole 16-byte groups, a 16-byte aligned), of B where vec_b,
// else one element a copy.
template <class C, class E>
__device__ __forceinline__ void load_col_stage(E* As, E* Bs, const E* __restrict__ a, int lda, int nrows,
                                               const E* __restrict__ bm, int ldb, int K, int N, int k0, int n0,
                                               bool vec_a, bool vec_b) {
  constexpr int W = 16 / sizeof(E), BYTES = sizeof(E);  // elements a 16-byte copy, bytes an element
  if (vec_a) {
    for (int i = threadIdx.x; i < C::TB * (C::KC / W); i += C::THREADS) {
      const int r = i / (C::KC / W), c = (i % (C::KC / W)) * W;
      const bool ok = r < nrows && k0 + c < K;
      cp_async<16>(As + r * C::SA + c, ok ? a + (size_t)r * lda + k0 + c : a, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < C::TB * C::KC; i += C::THREADS) {
      const int r = i / C::KC, c = i % C::KC;
      const bool ok = r < nrows && k0 + c < K;
      cp_async<BYTES>(As + r * C::SA + c, ok ? a + (size_t)r * lda + k0 + c : a, ok ? BYTES : 0);
    }
  }
  if (vec_b) {
    for (int i = threadIdx.x; i < C::KC * (C::TN / W); i += C::THREADS) {
      const int r = i / (C::TN / W), c = (i % (C::TN / W)) * W;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async<16>(Bs + r * C::SB + c, ok ? bm + (size_t)(k0 + r) * ldb + n0 + c : bm, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < C::KC * C::TN; i += C::THREADS) {
      const int r = i / C::TN, c = i % C::TN;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async<BYTES>(Bs + r * C::SB + c, ok ? bm + (size_t)(k0 + r) * ldb + n0 + c : bm, ok ? BYTES : 0);
    }
  }
}

// One 8-deep step of a warp's MI x NJ tiles, doubles: a0 at the stage's A
// row m_w + gid, column kk + 2 tig; b0 at B's row kk + 2 tig, column
// n_w + gid.  The mma's k = tig and tig + 4 are the stage's columns (rows
// of B) 2 tig and 2 tig + 1, one 16-byte load of A a row.
template <class C>
__device__ __forceinline__ void col_step(double (&acc)[C::MI][C::NJ][4], const double* a0, const double* b0,
                                         double sc) {
  double b[C::NJ][2];
#pragma unroll
  for (int nj = 0; nj < C::NJ; ++nj) {
    b[nj][0] = sc * b0[nj * 8];
    b[nj][1] = sc * b0[C::SB + nj * 8];
  }
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
    const double2 lo = *reinterpret_cast<const double2*>(a0 + mi * 16 * C::SA);
    const double2 hi = *reinterpret_cast<const double2*>(a0 + (mi * 16 + 8) * C::SA);
    const double a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
    for (int nj = 0; nj < C::NJ; ++nj) mma_f64_16x8x8(acc[mi][nj], a, b[nj]);
  }
}

// The same in floats, in 3xTF32: every fragment split into hi and lo as it
// is loaded (one 8-byte load of A a row), the step's three passes from a
// zero accumulator, then added in FP32 (mma_3xtf32_grid).
template <class C>
__device__ __forceinline__ void col_step(float (&acc)[C::MI][C::NJ][4], const float* a0, const float* b0,
                                         float sc) {
  unsigned bh[C::NJ][2], bl[C::NJ][2];
#pragma unroll
  for (int nj = 0; nj < C::NJ; ++nj) {
    split_tf32(sc * b0[nj * 8], bh[nj][0], bl[nj][0]);
    split_tf32(sc * b0[C::SB + nj * 8], bh[nj][1], bl[nj][1]);
  }
  unsigned ah[C::MI][4], al[C::MI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
    const float2 lo = *reinterpret_cast<const float2*>(a0 + mi * 16 * C::SA);
    const float2 hi = *reinterpret_cast<const float2*>(a0 + (mi * 16 + 8) * C::SA);
    split_tf32(lo.x, ah[mi][0], al[mi][0]);
    split_tf32(hi.x, ah[mi][1], al[mi][1]);
    split_tf32(lo.y, ah[mi][2], al[mi][2]);
    split_tf32(hi.y, ah[mi][3], al[mi][3]);
  }
  mma_3xtf32_grid(acc, ah, al, bh, bl);
}

// The [TB, TN] tile at column n0 of A [nrows, K] (row stride lda) times
// Bm [K, N] (row stride ldb), both streamed from device memory through the
// ring (C::SMEM bytes, 16-byte aligned): one barrier a stage, STAGES - 1
// stages in flight while one is read; then epi(acc) with the fragments of
// the whole sum (element e of acc[mi][nj] at row m_w + mi*16 + gid +
// 8 (e / 2), column n0 + n_w + nj*8 + 2 tig + e % 2: for_fragments), the
// ring free again.  A warp whose rows lie past nrows, or columns past N,
// skips the mma; a step past K is skipped by all.  With SYM (Bm symmetric,
// N = K: kernel 4's kappa Sigma) the loop stops at the tile's last column,
// and the k-chunks below the tile's diagonal block enter twice (b scaled by
// 2, exact): summed over the column tiles, the epilogue's sum (A Bm) o A
// then holds each of Bm's off-diagonal blocks once for its mirror too, for
// about half the FMAs.
template <class C, bool SYM = false, class E, class Epi>
__device__ __forceinline__ void cols_product(const E* __restrict__ a, int lda, int nrows, const E* __restrict__ bm,
                                             int ldb, int K, int N, int n0, E* ring, bool vec_a, bool vec_b, Epi epi) {
  static_assert(!SYM || C::TN % C::KC == 0, "k-chunks align with the column tiles");
  const int kend = SYM ? min(K, n0 + C::TN) : K;
  const int nk = (kend + C::KC - 1) / C::KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int m_w = (warp / C::WARPS_N) * C::WM, n_w = (warp % C::WARPS_N) * C::WN;
  const bool busy = m_w < nrows && n0 + n_w < N;
  auto issue = [&](int s) {
    if (s < nk) {
      E* st = ring + (s % C::STAGES) * C::STAGE;
      load_col_stage<C>(st, st + C::TB * C::SA, a, lda, nrows, bm, ldb, K, N, s * C::KC, n0, vec_a, vec_b);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) issue(s);

  E acc[C::MI][C::NJ][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < C::NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = E(0);

  for (int s = 0; s < nk; ++s) {
    cp_async_wait<C::STAGES - 2>();  // this step's stage has landed (for this thread's copies)
    __syncthreads();                 // ... and everyone's; the stage read last step is free
    issue(s + C::STAGES - 1);
    if (busy) {
      const E* As = ring + (s % C::STAGES) * C::STAGE;
      const E* Bs = As + C::TB * C::SA;
#pragma unroll
      for (int kk = 0; kk < C::KC; kk += 8)
        if (s * C::KC + kk < K)
          col_step<C>(acc, As + (m_w + gid) * C::SA + kk + 2 * tig, Bs + (kk + 2 * tig) * C::SB + n_w + gid,
                      E(SYM && (s + 1) * C::KC <= n0 ? 2 : 1));
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  epi(acc);
}

// Copies rows [0, nrows), columns [n0, n0 + TN) of A [*, K] (row t at
// a + t lda) into T [TB, TN + 8] (shared memory; the row stride puts the
// epilogue's pair loads of rows gid, gid + 1 on distinct banks), zero past
// nrows and K: 16-byte copies where vec, else one element a copy.  Ends
// with a barrier after the copies have landed.
template <class C, class E>
__device__ __forceinline__ void load_a_tile(E* T, const E* __restrict__ a, int lda, int nrows, int K, int n0,
                                            bool vec) {
  constexpr int W = 16 / sizeof(E), BYTES = sizeof(E), ST = C::TN + 8;
  if (vec) {
    for (int i = threadIdx.x; i < C::TB * (C::TN / W); i += C::THREADS) {
      const int r = i / (C::TN / W), c = (i % (C::TN / W)) * W;
      const bool ok = r < nrows && n0 + c < K;
      cp_async<16>(T + r * ST + c, ok ? a + (size_t)r * lda + n0 + c : a, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < C::TB * C::TN; i += C::THREADS) {
      const int r = i / C::TN, c = i % C::TN;
      const bool ok = r < nrows && n0 + c < K;
      cp_async<BYTES>(T + r * ST + c, ok ? a + (size_t)r * lda + n0 + c : a, ok ? BYTES : 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// One [TB, TN] tile (column tile blockIdx.x % nc, row tile blockIdx.x /
// nc, nc = col_tiles(M)) of latent blockIdx.y of the product A Bm, A
// [L, B, M] and Bm [L, M, M]
// (cols_product), and in its epilogue the row partials over the tile's
// columns of q0 = sum (A Bm) o A (kernel 6's and 4's Ktilde: A = Knm; kernel
// 4's vf: A = kappa, Bm = Sigma) and, with MF, q1 = sum (A Bm) mu (mf) into
// part0, part1 [L, nc, B]; with STORE the tile is stored to out
// [L, B, M] from the fragments.  A's tile comes back into the ring in one
// batch of copies (load_a_tile: one trip to L2, not one a fragment), the
// row sums after it.
template <class C, bool STORE, bool MF, class E = typename C::Elem>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
kappa_cols(const E* __restrict__ a, const E* __restrict__ bm, const E* __restrict__ mu, E* __restrict__ out,
           E* __restrict__ part0, E* __restrict__ part1, int B, int M, bool vec) {
  extern __shared__ float4 sm4[];
  E* ring = reinterpret_cast<E*>(sm4);
  const int nc = (M + C::TN - 1) / C::TN, j = blockIdx.x % nc, l = blockIdx.y;
  const int n0 = j * C::TN, row0 = (blockIdx.x / nc) * C::TB, nrows = min(C::TB, B - row0);
  const E* al = a + ((size_t)l * B + row0) * M;
  E* ol = STORE ? out + ((size_t)l * B + row0) * M : nullptr;
  const E* mul = MF ? mu + (size_t)l * M : nullptr;
  constexpr int ST = C::TN + 8, R = C::WARPS_N * C::TB;
  E* red = ring + C::TB * ST;  // [2, WARPS_N, TB]  the row sums
  // the kappa Sigma pass (no store) takes Sigma's symmetry (cols_product)
  cols_product<C, !STORE>(al, M, nrows, bm + (size_t)l * M * M, M, M, M, n0, ring, vec, vec,
                  [&](E (&acc)[C::MI][C::NJ][4]) {
                    load_a_tile<C>(ring, al, M, nrows, M, n0, vec);
                    E q0[C::MI][2] = {}, q1[C::MI][2] = {};
                    for_fragments<C>(n0, acc, [&](int mi, int h, int row, int col, E v0, E v1) {
                      // zero past nrows and M in both the tile and the fragments
                      const E* t = ring + row * ST + col - n0;
                      q0[mi][h] = fma_t(v1, t[1], fma_t(v0, t[0], q0[mi][h]));
                      if constexpr (MF)
                        if (col < M)
                          q1[mi][h] = fma_t(v1, col + 1 < M ? __ldg(mul + col + 1) : E(0),
                                            fma_t(v0, __ldg(mul + col), q1[mi][h]));
                      if constexpr (STORE) store_pair(ol, M, nrows, row, col, v0, v1);
                    });
                    row_partials<C>(q0, red);
                    if constexpr (MF) row_partials<C>(q1, red + R);
                  });
  __syncthreads();
  for (int t = threadIdx.x; t < nrows; t += C::THREADS) {
    const size_t r = ((size_t)l * nc + j) * B + row0 + t;
    part0[r] = row_total<C>(red, t);
    if constexpr (MF) part1[r] = row_total<C>(red + R, t);
  }
}

// The gram Knm [L, B, M] of the kind: one block 64 rows by 64 columns of
// latent blockIdx.z, a warp 8 rows and each of its threads two columns of
// them (lane and lane + 32) summed in registers, r2 = sum_d (x_d / ls_d -
// z_d / ls_d)^2 by direct differences over chunks of 16 features staged in
// shared memory: per feature two 16-byte broadcast loads of the rows' x and
// two loads of z for 16 FMAs; x / ls and z / ls both products with 1 / ls
// (as gram_slab: a point of the batch that is also an inducing point lands
// on it exactly).  params as _multi_params: jitter, rho, lambda, var [L],
// ls [L, D].
constexpr int GR = 64, GC = 64, GDC = 16, GT = 256;

template <class E>
__global__ void __launch_bounds__(GT)
gram_rows(const E* __restrict__ x, const E* __restrict__ z, const E* __restrict__ params, E* __restrict__ knm,
          int B, int D, int M, int L, int kind) {
  __shared__ __align__(16) E xs[GDC][GR];
  __shared__ E zs[GDC][GC];
  __shared__ E il[GDC];
  const int l = blockIdx.z, row0 = blockIdx.x * GR, col0 = blockIdx.y * GC;
  const int c = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 8;
  const E* ls = params + P_VAR + L + (size_t)l * D;
  const E* zl = z + (size_t)l * M * D;
  E r[2][8];
#pragma unroll
  for (int t = 0; t < 8; ++t) r[0][t] = r[1][t] = E(0);
  for (int d0 = 0; d0 < D; d0 += GDC) {
    const int dc = min(GDC, D - d0);
    __syncthreads();  // every thread is done with the previous chunk
    if (threadIdx.x < dc) il[threadIdx.x] = E(1) / ls[d0 + threadIdx.x];
    __syncthreads();
    for (int i = threadIdx.x; i < GR * dc; i += GT) {
      const int t = i / dc, dd = i % dc;
      xs[dd][t] = row0 + t < B ? x[(size_t)(row0 + t) * D + d0 + dd] * il[dd] : E(0);
    }
    for (int i = threadIdx.x; i < GC * dc; i += GT) {
      const int m = i / dc, dd = i % dc;
      zs[dd][m] = col0 + m < M ? zl[(size_t)(col0 + m) * D + d0 + dd] * il[dd] : E(0);
    }
    __syncthreads();
    for (int dd = 0; dd < dc; ++dd) {
      E xv[8];
      load8(&xs[dd][r0], xv);
      const E z0 = zs[dd][c], z1 = zs[dd][c + 32];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const E d0v = xv[t] - z0, d1v = xv[t] - z1;
        r[0][t] = fma_t(d0v, d0v, r[0][t]);
        r[1][t] = fma_t(d1v, d1v, r[1][t]);
      }
    }
  }
  const E var = params[P_VAR + l];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = col0 + c + 32 * h;
    if (m >= M) continue;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int row = row0 + r0 + t;
      if (row < B) knm[((size_t)l * B + row) * M + m] = gram_from_r2_of(kind, r[h][t], var);
    }
  }
}

// One thread a row of a latent: Ktilde = max(var + jitter - the sum of
// kpart [L, nc, B] over the column tiles in order, 1e-12), into kt (kernel
// 6) or, with mpart and vpart, mf = their sum of mpart and vf = max(Ktilde
// + the sum of vpart, 1e-12) (kernel 4).
template <class E>
__global__ void kappa_cols_finish(const E* __restrict__ params, const E* __restrict__ kpart,
                                  const E* __restrict__ mpart, const E* __restrict__ vpart, E* __restrict__ kt,
                                  E* __restrict__ mf, E* __restrict__ vf, int B, int L, int nc) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)L * B) return;
  const int l = (int)(i / B);
  const size_t off = (size_t)l * nc * B + i % B;
  E s = kpart[off];
  for (int j = 1; j < nc; ++j) s += kpart[off + (size_t)j * B];
  const E ktl = fmax_t(params[P_VAR + l] + params[P_JITT] - s, E(1e-12));
  if (kt) kt[i] = ktl;
  if (mf) {
    E m = mpart[off], v = vpart[off];
    for (int j = 1; j < nc; ++j) {
      m += mpart[off + (size_t)j * B];
      v += vpart[off + (size_t)j * B];
    }
    mf[i] = m;
    vf[i] = fmax_t(ktl + v, E(1e-12));
  }
}

// column tiles of the product at M
template <class C>
__host__ __device__ constexpr int col_tiles(int M) {
  return (M + C::TN - 1) / C::TN;
}

// Elements of the wrapper's scratch (ops/cuda_kernels.py::
// kappa_cols_scratch copies it: change them together): Knm [L, B, M],
// then the row partials [L, col_tiles, B] of Ktilde and, for kernel 4
// (moments), of mf and vf.
template <class C>
__host__ __device__ constexpr size_t cols_scratch(bool moments, int B, int M, int L) {
  return (size_t)L * B * M + (moments ? 3 : 1) * (size_t)L * col_tiles<C>(M) * B;
}

// Kernel 4 (MOMENTS: mu, sigma, mf, vf) or 6 (kt) in the column-blocked
// form: gram_rows, kappa_cols (kappa, Ktilde's partials, kernel 4's mf's),
// kernel 4's kappa_cols on kappa Sigma (vf's partials), kappa_cols_finish;
// scratch holds cols_scratch elements.  Returns the first CUDA error.
template <class E, bool MOMENTS>
int launch_kappa_cols(const E* x, const E* z, const E* kinv, const E* mu, const E* sigma, const E* params,
                      E* kappa, E* kt, E* mf, E* vf, E* scratch, int B, int D, int M, int L, int kind,
                      cudaStream_t st) {
  using C = ColTile<E>;
  if (kind < KIND_RBF || kind > KIND_MATERN52) return (int)cudaErrorInvalidValue;
  const int nc = col_tiles<C>(M);
  E* knm = scratch;
  E* kpart = knm + (size_t)L * B * M;
  E* mpart = kpart + (size_t)L * nc * B;
  E* vpart = mpart + (size_t)L * nc * B;
  gram_rows<E><<<dim3((B + GR - 1) / GR, (M + GC - 1) / GC, L), GT, 0, st>>>(x, z, params, knm, B, D, M, L, kind);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const dim3 grid((unsigned)nc * (unsigned)((B + C::TB - 1) / C::TB), L);  // column tile fastest
  const bool vec = M % (16 / sizeof(E)) == 0 && aligned(knm) && aligned(kinv) && aligned(kappa);
  err = prepare_smem<&kappa_cols<C, true, MOMENTS>>(C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kappa_cols<C, true, MOMENTS, E><<<grid, C::THREADS, C::SMEM, st>>>(knm, kinv, mu, kappa, kpart, mpart, B, M, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (MOMENTS) {
    err = prepare_smem<&kappa_cols<C, false, false>>(C::SMEM);
    if (err != cudaSuccess) return (int)err;
    kappa_cols<C, false, false, E><<<grid, C::THREADS, C::SMEM, st>>>(kappa, sigma, nullptr, nullptr, vpart, nullptr, B,
                                                                   M, vec && aligned(sigma));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t rows = (size_t)L * B;
  kappa_cols_finish<E><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      params, kpart, MOMENTS ? mpart : nullptr, MOMENTS ? vpart : nullptr, kt, mf, vf, B, L, nc);
  return (int)cudaGetLastError();
}

}  // namespace
