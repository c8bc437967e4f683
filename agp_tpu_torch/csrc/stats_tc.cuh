// The statistics of kernels 5 and 7 on Hopper's tensor cores:
//   s1[l] = kappa[l]^T g[l]  [M]   and   S2[l] = kappa[l]^T diag(theta[l]) kappa[l]  [M, M]
// for kappa [L, B, M] row-major (kernel 7: L = 1), g and theta [L, B].
//
// Replaces, in agp_tpu/ops/pallas_kernels.py, cavi_stats_batched (:486,
// body _stats_batched_kernel) and cavi_stats (:545, body _stats_kernel):
// both C entry points (batched_pair.cu, kappa_single.cu) launch the same
// two kernels below, stats_tc and sum_tiles; kernels 8-9
// (fused_variants.cu) and kernel 1 (fused_cavi_stats.cu) launch them after
// their kappa pass, with one latent.
//
// What bounds it on an H100: operations.  S2 needs B M (M+1)/2 FMAs (its
// upper triangle) against 4 B M bytes of kappa read once: at B=65,536,
// M=512, 8.6 G FMAs and 134 MB, 0.26 ms at the FP32 SIMT peak (67 TFLOP/s)
// against 0.04 ms of memory.  The FP32 pipes cannot get near the memory
// time; the TF32 tensor cores (495 TFLOP/s dense) can, so:
// * 3xTF32 on the tensor cores (tf32_mma.cuh: the split, the mma and the
//   copies that kernels 4-7 share).  Each operand is split into hi and lo
//   as its fragment is loaded, and a product takes three
//   mma.sync.m16n8k8.tf32 passes; the three passes over 8 rows start from
//   a zero accumulator and are then added to the running sums in FP32: a
//   mma truncates, a bias that grows with a long accumulation in the
//   tensor cores (on an H100, 9x the FP32 plain version's error at the
//   M=512 oracle shape when they carried a whole chunk; PERF.md).
//   The A operand is theta kappa, theta applied in FP32 before the split,
//   as the plain version forms it.  mma.sync rather than wgmma: each thread
//   loads its own fragments from shared memory in any layout, which suits
//   kappa's [B, M] rows (contiguous along M, contracted over B); wgmma
//   takes TF32 only K-major, i.e. kappa's tile transposed while staging.
//   Three passes, not one: a single TF32 pass is 100-400x farther from
//   float64 than FP32 is (tests/test_torch_stats_tc.py), three are as close.
//   The reference itself forms S2 in one bf16 pass on the TPU.
// * s1 is an FP32 FMA sum of the untouched kappa and g (M FMAs a row), in
//   the diagonal tiles.
// * A ring of STAGES shared-memory stages of KB rows of both operands'
//   columns, fed by 16-byte cp.async (4-byte where M % 4 != 0 or kappa is
//   not 16-byte aligned), zero-filled past B and M while copying: one
//   barrier a stage, two stages in flight while the third is used.  The
//   row stride TILE + 8 floats puts a warp's fragment reads on 32 distinct
//   banks.  A diagonal tile stages one operand and reads it as both.
// * Only the tiles on or above S2's diagonal are computed, and within a
//   diagonal tile a warp whose sub-tile lies wholly below the diagonal (or
//   past M) stays idle.
// * The TPU grid accumulates S2 over the batch in one resident block; here
//   each block takes one tile and one chunk of rows, and the chunk
//   partials are added in chunk order by sum_tiles, which reads the upper
//   triangle and mirrors it through shared memory (coalesced both ways):
//   deterministic, no atomics, S2 exactly symmetric.  The caller sizes the
//   chunks (ops/cuda_kernels.py::_stats_plan) so that the grid is one wave
//   of resident blocks.
// The float64 form (kernels 5 and 7 on float64 tensors) is the same pair
// of kernels on doubles: theta applied in double, the accumulators carrying
// the whole chunk (an FP64 mma is IEEE double with FMA: nothing to split, no
// truncation to guard against), s1 and the chunk sums in double.  What
// bounds it: S2's B M (M+1)/2 FMAs at the FP64 tensor-core peak (67
// TFLOP/s), 0.26 ms at B=65,536, M=512, against 268 MB of kappa (0.08 ms).
// Two geometries, named by the caller by the mma's depth (ops/
// cuda_kernels.py::STATS_F64_MMA_K):
// * 8 (StatsF64K8, every M): one FP64 mma.sync.m16n8k8 a 16 x 8 x 8 step
//   (1,024 FMAs an instruction), 32-row stages (three take 204 KB), the
//   128 x 128 tile in 8 warps of 64 x 32, one block an SM.  Both operands
//   are kappa rows contiguous along M, contracted over the rows, so each
//   fragment pair comes in one 16-byte shared load: the mma's rows gid and
//   gid + 8 of A's 16-row tile are the tile's columns 2 gid and 2 gid + 1,
//   and B's column gid of the tiles 2p and 2p + 1 are the columns 16 p +
//   2 gid and 16 p + 2 gid + 1 (stats_frag_m / stats_frag_n undo it at the
//   store); k = tig and tig + 4 are the stage's rows k0 + tig and k0 + tig
//   + 4.  The row stride TILE + 4 doubles (4 mod 16) puts each
//   quarter-warp's 16-byte loads on distinct banks.  A warp loads 192
//   bytes a thread for 16 mma (2.7 FMAs a shared byte against the m8n8k4
//   form's 1), and multiplies each A element by theta once.
// * 4 (StatsF64K4): the float form's geometry on doubles, two
//   mma.sync.m8n8k4 a 16 x 8 x 4 step (tf32_mma.cuh::mma_f64_16x8),
//   16-row stages (102 KB for three), 16 warps of 32 x 32, one block an
//   SM: 1.4x the m16n8k8 form's time at M=512 on an H100 (PERF.md), kept
//   as its yardstick.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

// The block's geometry: elements T; a ring of STAGES stages of KB rows; an
// output tile of TILE x TILE; WARPS_M x WARPS_N warps, each a WM x WN
// sub-tile (MI x NJ mma tiles of 16 x 8) stepped MMA_K rows at a time (the
// float form's 8: 3xTF32 m16n8k8; double 4: m8n8k4 pairs, or 8: m16n8k8
// with paired loads); MIN_BLOCKS blocks an SM.
template <class T, int KB_, int TILE_, int WARPS_M_, int WARPS_N_, int MIN_BLOCKS_, int PAD, int MMA_K_>
struct StatsGeometry {
  using Elem = T;
  static constexpr int KB = KB_, STAGES = 3, TILE = TILE_, MMA_K = MMA_K_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WM = TILE / WARPS_M, WN = TILE / WARPS_N;
  static constexpr int MI = WM / 16, NJ = WN / 8;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int SP = TILE + PAD;                 // row stride of a stage (elements)
  static constexpr int STAGE = 2 * KB * SP + 2 * KB;  // A, B, theta, g (elements)
  static constexpr size_t SMEM = sizeof(T) * STAGES * STAGE;
  // the paired fragment layout of the double m16n8k8 form (mma_stage_k8)
  static constexpr bool PAIRED = std::is_same<T, double>::value && MMA_K == 8;
  static_assert(THREADS % TILE == 0, "s1 takes THREADS / TILE rows a pass");
  static_assert(KB % MMA_K == 0 && THREADS >= 2 * KB, "whole mma steps a stage; theta and g one copy a thread");
  static_assert(!PAIRED || (NJ % 2 == 0 && PAD % 16 == 4), "B's tiles in pairs; 16-byte loads on distinct banks");
};
// float: 32-row stages; an output tile of 128 (against 64 it ran 9-19 %
// faster at M=512 and 3 % slower at M=64 on an H100, PERF.md, section 6);
// 2 x 4 warps of 64 x 32, two blocks an SM; the row stride TILE + 8 floats
// puts a warp's fragment reads on 32 distinct banks
using StatsF32 = StatsGeometry<float, 32, 128, 2, 4, 2, 8, 8>;
// double, m16n8k8: 32-row stages, 2 x 4 warps of 64 x 32, one block an SM;
// the row stride TILE + 4 doubles puts each quarter-warp's 16-byte
// fragment loads on distinct banks
using StatsF64K8 = StatsGeometry<double, 32, 128, 2, 4, 1, 4, 8>;
// double, m8n8k4 pairs: 16-row stages, 4 x 4 warps of 32 x 32, one block an
// SM; the row stride TILE + 4 doubles (4 mod 16) puts each half-warp's
// fragment reads on 16 distinct 8-byte bank pairs
using StatsF64K4 = StatsGeometry<double, 16, 128, 4, 4, 1, 4, 4>;
static_assert(StatsF64K8::TILE == StatsF64K4::TILE, "one chunk plan for both float64 forms");

// the t-th tile (ti <= tj) of the upper triangle of an nt x nt grid, row by row
__device__ __forceinline__ void upper_tile(int t, int nt, int& ti, int& tj) {
  ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  tj = ti + t;
}

// Copies rows [b, b + KB) of kappa's columns m0.. (into As) and n0.. (into
// Bs, unless the tile is diagonal), theta and g, zero past b1 and M:
// 16-byte copies of kappa where VEC, else one element a copy.
template <class Sh, bool VEC, class T = typename Sh::Elem>
__device__ __forceinline__ void load_stage(T* As, T* Bs, T* ths, T* gs, const T* __restrict__ kl,
                                           const T* __restrict__ thl, const T* __restrict__ gl, int b, int b1,
                                           int M, int m0, int n0, bool diag) {
  constexpr int KB = Sh::KB, TILE = Sh::TILE, SP = Sh::SP, E = sizeof(T);
  constexpr int W = VEC ? 16 / E : 1;  // elements a copy
  for (int i = threadIdx.x; i < KB * (TILE / W); i += Sh::THREADS) {
    const int r = i / (TILE / W), c = (i % (TILE / W)) * W;
    const int row = b + r;
    const bool oka = row < b1 && m0 + c < M;
    cp_async<E * W>(As + r * SP + c, oka ? kl + (size_t)row * M + m0 + c : kl, oka ? E * W : 0);
    if (!diag) {
      const bool okb = row < b1 && n0 + c < M;
      cp_async<E * W>(Bs + r * SP + c, okb ? kl + (size_t)row * M + n0 + c : kl, okb ? E * W : 0);
    }
  }
  const int t = threadIdx.x;
  if (t < KB) {
    const bool ok = b + t < b1;
    cp_async<E>(ths + t, ok ? thl + b + t : thl, ok ? E : 0);
  } else if (t < 2 * KB) {
    const bool ok = b + t - KB < b1;
    cp_async<E>(gs + t - KB, ok ? gl + b + t - KB : gl, ok ? E : 0);
  }
}

// acc[mi][nj] += (theta kappa)[rows, m_w + ...]^T kappa[rows, n_w + ...]
// over one stage, 3xTF32: each 8 rows' three passes from a zero
// accumulator, then added to acc in FP32 (round to nearest)
template <class Sh>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs, const float* ths, int m_w, int n_w,
                                          float (&acc)[Sh::MI][Sh::NJ][4]) {
  constexpr int KB = Sh::KB, SP = Sh::SP, MI = Sh::MI, NJ = Sh::NJ;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < KB; k0 += 8) {
    const float* a0 = As + (k0 + tig) * SP + m_w + gid;  // rows k0 + tig and k0 + tig + 4
    const float* b0 = Bs + (k0 + tig) * SP + n_w + gid;
    const float t0 = ths[k0 + tig], t1 = ths[k0 + tig + 4];
    unsigned bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      split_tf32(b0[nj * 8], bh[nj][0], bl[nj][0]);
      split_tf32(b0[4 * SP + nj * 8], bh[nj][1], bl[nj][1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      unsigned ah[4], al[4];
      split_tf32(a0[mi * 16] * t0, ah[0], al[0]);
      split_tf32(a0[mi * 16 + 8] * t0, ah[1], al[1]);
      split_tf32(a0[4 * SP + mi * 16] * t1, ah[2], al[2]);
      split_tf32(a0[4 * SP + mi * 16 + 8] * t1, ah[3], al[3]);
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) mma_3xtf32(acc[mi][nj], ah, al, bh[nj], bl[nj]);
    }
  }
}

// The same in FP64: each 4 rows one mma pass (mma_f64_grid), theta
// applied in double to the A fragment, the accumulators carrying the sum
template <class Sh>
__device__ __forceinline__ void mma_stage(const double* As, const double* Bs, const double* ths, int m_w, int n_w,
                                          double (&acc)[Sh::MI][Sh::NJ][4]) {
  constexpr int KB = Sh::KB, SP = Sh::SP, MI = Sh::MI, NJ = Sh::NJ;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < KB; k0 += 4) {
    const double* a0 = As + (k0 + tig) * SP + m_w + gid;  // row k0 + tig, columns gid and gid + 8
    const double* b0 = Bs + (k0 + tig) * SP + n_w + gid;
    const double t = ths[k0 + tig];
    double b[NJ], a[MI][2];
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) b[nj] = b0[nj * 8];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      a[mi][0] = a0[mi * 16] * t;
      a[mi][1] = a0[mi * 16 + 8] * t;
    }
    mma_f64_grid(acc, a, b);
  }
}

// The same in FP64 on m16n8k8 (the StatsF64K8 form): each 8 rows one mma
// a tile, every fragment pair in one 16-byte load (the paired layout:
// stats_frag_m, stats_frag_n), theta applied once to each A element
template <class Sh>
__device__ __forceinline__ void mma_stage_k8(const double* As, const double* Bs, const double* ths, int m_w,
                                             int n_w, double (&acc)[Sh::MI][Sh::NJ][4]) {
  constexpr int KB = Sh::KB, SP = Sh::SP, MI = Sh::MI, NJ = Sh::NJ;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < KB; k0 += 8) {
    const double* a0 = As + (k0 + tig) * SP + m_w + 2 * gid;  // rows k0 + tig and k0 + tig + 4
    const double* b0 = Bs + (k0 + tig) * SP + n_w + 2 * gid;
    const double t0 = ths[k0 + tig], t1 = ths[k0 + tig + 4];
    double b[NJ][2];
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      const double2 u = *reinterpret_cast<const double2*>(b0 + 16 * p);
      const double2 v = *reinterpret_cast<const double2*>(b0 + 4 * SP + 16 * p);
      b[2 * p][0] = u.x;
      b[2 * p + 1][0] = u.y;
      b[2 * p][1] = v.x;
      b[2 * p + 1][1] = v.y;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const double2 u = *reinterpret_cast<const double2*>(a0 + 16 * mi);
      const double2 v = *reinterpret_cast<const double2*>(a0 + 4 * SP + 16 * mi);
      const double a[4] = {u.x * t0, u.y * t0, v.x * t1, v.y * t1};
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) mma_f64_16x8x8(acc[mi][nj], a, b[nj]);
    }
  }
}

// The row (in the warp's sub-tile) of accumulator element e of mma tile mi,
// and its column of tile nj: the mma's own layout, or the paired one
template <class Sh>
__device__ __forceinline__ int stats_frag_m(int mi, int gid, int e) {
  return Sh::PAIRED ? mi * 16 + 2 * gid + (e >> 1) : mi * 16 + gid + (e >> 1) * 8;
}
template <class Sh>
__device__ __forceinline__ int stats_frag_n(int nj, int tig, int e) {
  return Sh::PAIRED ? (nj >> 1) * 16 + 4 * tig + 2 * (e & 1) + (nj & 1) : nj * 8 + 2 * tig + (e & 1);
}

// grid (upper tiles, chunks, L): the partial S2 tile (and, on a diagonal
// tile, the partial s1 of its columns) of one chunk of rows, into
// s2_part [L, nchunks, M, M] and s1_part [L, nchunks, M].  Entries of a
// diagonal tile below its diagonal may be left unwritten; sum_tiles never
// reads them.  Geometry Sh (StatsF32, or StatsF64K8 / StatsF64K4 for the
// float64 form), elements T.
template <class Sh, bool VEC, class T = typename Sh::Elem>
__global__ void __launch_bounds__(Sh::THREADS, Sh::MIN_BLOCKS)
stats_tc(const T* __restrict__ kappa, const T* __restrict__ g, const T* __restrict__ theta,
         T* __restrict__ s1_part, T* __restrict__ s2_part, int B, int M, int rows_per_chunk) {
  constexpr int KB = Sh::KB, STAGES = Sh::STAGES, TILE = Sh::TILE, THREADS = Sh::THREADS, SP = Sh::SP;
  constexpr int STAGE = Sh::STAGE, WARPS_N = Sh::WARPS_N, WM = Sh::WM, WN = Sh::WN, MI = Sh::MI, NJ = Sh::NJ;
  extern __shared__ float4 sm4[];
  T* sm = reinterpret_cast<T*>(sm4);
  const int nt = (M + TILE - 1) / TILE;
  int ti, tj;
  upper_tile(blockIdx.x, nt, ti, tj);
  const int chunk = blockIdx.y, nchunks = gridDim.y, l = blockIdx.z;
  const int m0 = ti * TILE, n0 = tj * TILE;
  const int b0 = chunk * rows_per_chunk, b1 = min(B, b0 + rows_per_chunk);
  const int nsteps = (b1 - b0 + KB - 1) / KB;
  const T* kl = kappa + (size_t)l * B * M;
  const T* gl = g + (size_t)l * B;
  const T* thl = theta + (size_t)l * B;
  const bool diag = ti == tj;
  const int tid = threadIdx.x, warp = tid / 32;
  const int m_w = (warp / WARPS_N) * WM, n_w = (warp % WARPS_N) * WN;
  // a warp computes unless its sub-tile lies past M or wholly below the diagonal
  const bool active = m0 + m_w < M && n0 + n_w < M && !(diag && m_w >= n_w + WN);

  auto stage_ptr = [&](int s) { return sm + s * STAGE; };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) {
      T* As = stage_ptr(s);
      load_stage<Sh, VEC>(As, As + KB * SP, As + 2 * KB * SP, As + 2 * KB * SP + KB, kl, thl, gl, b0 + s * KB, b1,
                          M, m0, n0, diag);
    }
    cp_async_commit();
  }

  T acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = T(0);
  constexpr int H = THREADS / TILE;  // rows of a stage a thread's s1 column takes: h, h + H, ...
  const int c1 = tid % TILE, h = tid / TILE;
  T s1acc = T(0);

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();  // this step's stage has landed (for this thread's copies)
    __syncthreads();              // ... and everyone's; the stage read last step is free
    const int next = step + STAGES - 1;
    if (next < nsteps) {
      T* As = stage_ptr(next % STAGES);
      load_stage<Sh, VEC>(As, As + KB * SP, As + 2 * KB * SP, As + 2 * KB * SP + KB, kl, thl, gl, b0 + next * KB,
                          b1, M, m0, n0, diag);
    }
    cp_async_commit();
    const T* As = stage_ptr(step % STAGES);
    const T* Bs = diag ? As : As + KB * SP;
    const T* ths = As + 2 * KB * SP;
    if (active) {
      if constexpr (Sh::PAIRED)
        mma_stage_k8<Sh>(As, Bs, ths, m_w, n_w, acc);
      else
        mma_stage<Sh>(As, Bs, ths, m_w, n_w, acc);
    }
    if (diag) {
      const T* gs = ths + KB;
#pragma unroll
      for (int k = h; k < KB; k += H) s1acc = fma_t(As[k * SP + c1], gs[k], s1acc);
    }
  }

  const size_t part = (size_t)l * nchunks + chunk;
  if (active) {
    T* out = s2_part + part * M * M;
    const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + m_w + stats_frag_m<Sh>(mi, gid, e), n = n0 + n_w + stats_frag_n<Sh>(nj, tig, e);
          if (m < M && n < M) out[(size_t)m * M + n] = acc[mi][nj][e];
        }
  }
  if (diag) {  // s1's H partial sums of each column, added in a fixed order
    cp_async_wait<0>();
    __syncthreads();
    sm[h * TILE + c1] = s1acc;
    __syncthreads();
    if (h == 0 && m0 + c1 < M) {
      T s = sm[c1];
#pragma unroll
      for (int q = 1; q < H; ++q) s += sm[q * TILE + c1];
      s1_part[part * M + m0 + c1] = s;
    }
  }
}

// grid (4 strips of 8 rows x upper 32 x 32 blocks of S2 + 1, L), 256
// threads, one an entry of the strip: the chunk partials of each upper
// entry added in chunk order, written to S2 and, transposed through
// shared memory, to its mirror (8 consecutive elements a row); on a
// diagonal block the entries above the diagonal are mirrored below it.
// The last block of each latent adds s1's partials.  Strips rather than
// whole blocks: at M=128 (4 x 4 blocks of 32) a block a 32 x 32 block
// left 11 blocks to read 256 chunks' 16.8 MB (72 us on an H100, PERF.md).
// Elements T: float, or double for the float64 form.
constexpr int RB = 32, RS = 8;
template <class T>
__global__ void __launch_bounds__(256)
sum_tiles(const T* __restrict__ s1_part, const T* __restrict__ s2_part, T* __restrict__ s1, T* __restrict__ s2,
          int M, int nchunks) {
  static_assert(RB * RS == 256, "one thread an entry of a strip");
  __shared__ T tile[RS][RB + 1];
  const int l = blockIdx.y, tx = threadIdx.x % RB, ty = threadIdx.x / RB;
  const int nb = (M + RB - 1) / RB;
  const size_t mm = (size_t)M * M;
  if ((int)blockIdx.x == nb * (nb + 1) / 2 * (RB / RS)) {
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      T acc = T(0);
#pragma unroll 8
      for (int c = 0; c < nchunks; ++c) acc += s1_part[((size_t)l * nchunks + c) * M + m];
      s1[(size_t)l * M + m] = acc;
    }
    return;
  }
  int bi, bj;
  upper_tile(blockIdx.x / (RB / RS), nb, bi, bj);
  const int r0 = (blockIdx.x % (RB / RS)) * RS;  // the strip's first row in the block
  const bool dblock = bi == bj;
  const int r = r0 + ty, m = bi * RB + r, n = bj * RB + tx;
  T* out = s2 + (size_t)l * mm;
  T acc = T(0);
  if (m < M && n < M && (!dblock || r <= tx)) {
    const T* p = s2_part + (size_t)l * nchunks * mm + (size_t)m * M + n;
#pragma unroll 8
    for (int c = 0; c < nchunks; ++c) acc += p[(size_t)c * mm];
    out[(size_t)m * M + n] = acc;
  }
  tile[ty][tx] = acc;
  __syncthreads();
  // the mirror: S2[bj*RB + c2, bi*RB + r0 + r2] = tile[r2][c2]
  const int c2 = threadIdx.x / RS, r2 = threadIdx.x % RS;
  const int m2 = bj * RB + c2, n2 = bi * RB + r0 + r2;
  if (m2 < M && n2 < M && (!dblock || r0 + r2 < c2)) out[(size_t)m2 * M + n2] = tile[r2][c2];
}

// Lets kernel FN take `smem` bytes of dynamic shared memory, with the SM's
// shared memory preferred over L1, once per device and size: the
// attributes persist in the context, and setting them before every launch
// cost host time on every call (on an H100 the most when other kernels
// ran in between; PERF.md).
template <auto FN>
cudaError_t prepare_smem(size_t smem) {
  constexpr int DEVICES = 64;
  static size_t done[DEVICES] = {};  // by device: the largest size set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < DEVICES && done[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(FN, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(FN, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < DEVICES) done[dev] = smem;
  return err;
}

// the dynamic shared memory a stage ring of geometry Sh takes (float: two
// blocks an SM)
template <class Sh>
cudaError_t prepare_stats(bool vec) {
  return vec ? prepare_smem<&stats_tc<Sh, true>>(Sh::SMEM) : prepare_smem<&stats_tc<Sh, false>>(Sh::SMEM);
}

// resident blocks of stats_tc of geometry Sh on one SM of the current
// device (0 on error)
template <class Sh>
int stats_blocks_per_sm() {
  int n = 0;
  if (prepare_stats<Sh>(true) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, &stats_tc<Sh, true>, Sh::THREADS, Sh::SMEM) != cudaSuccess)
    return 0;
  return n;
}

// the float64 geometry of the mma depth mma_k (8: StatsF64K8, 4:
// StatsF64K4), f(Sh{}) with it; `bad` for any other depth
template <class F, class R>
R with_stats_f64(int mma_k, R bad, F f) {
  if (mma_k == 8) return f(StatsF64K8{});
  if (mma_k == 4) return f(StatsF64K4{});
  return bad;
}

// Both launches of the statistics of L latents in geometry Sh; returns the
// CUDA error.
template <class Sh, class T = typename Sh::Elem>
int launch_stats_shape(const T* kappa, const T* g, const T* theta, T* s1_part, T* s2_part, T* s1, T* s2, int B,
                       int M, int L, int nchunks, int rows_per_chunk, cudaStream_t st) {
  using StatsFn = void (*)(const T*, const T*, const T*, T*, T*, int, int, int);
  const bool vec = M % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(kappa) % 16 == 0;
  const StatsFn fn = vec ? &stats_tc<Sh, true> : &stats_tc<Sh, false>;
  cudaError_t err = prepare_stats<Sh>(vec);
  if (err != cudaSuccess) return (int)err;
  const int nt = (M + Sh::TILE - 1) / Sh::TILE;
  fn<<<dim3(nt * (nt + 1) / 2, nchunks, L), Sh::THREADS, Sh::SMEM, st>>>(kappa, g, theta, s1_part, s2_part, B, M,
                                                                        rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nb = (M + RB - 1) / RB;
  sum_tiles<T><<<dim3(nb * (nb + 1) / 2 * (RB / RS) + 1, L), 256, 0, st>>>(s1_part, s2_part, s1, s2, M, nchunks);
  return (int)cudaGetLastError();
}

// The float form's launches (kernels 1, 5, 7, 8 and 9)
inline int launch_stats(const float* kappa, const float* g, const float* theta, float* s1_part, float* s2_part,
                        float* s1, float* s2, int B, int M, int L, int nchunks, int rows_per_chunk, cudaStream_t st) {
  return launch_stats_shape<StatsF32>(kappa, g, theta, s1_part, s2_part, s1, s2, B, M, L, nchunks, rows_per_chunk,
                                      st);
}

// The float64 form's, in the geometry of mma depth mma_k (8 or 4; any
// other: cudaErrorInvalidValue)
inline int launch_stats(const double* kappa, const double* g, const double* theta, double* s1_part,
                        double* s2_part, double* s1, double* s2, int B, int M, int L, int nchunks,
                        int rows_per_chunk, cudaStream_t st, int mma_k) {
  return with_stats_f64(mma_k, (int)cudaErrorInvalidValue, [&](auto sh) {
    return launch_stats_shape<decltype(sh)>(kappa, g, theta, s1_part, s2_part, s1, s2, B, M, L, nchunks,
                                            rows_per_chunk, st);
  });
}

}  // namespace
