// The statistics of kernels 5 and 7 on Hopper's tensor cores:
//   s1[l] = kappa[l]^T g[l]  [M]   and   S2[l] = kappa[l]^T diag(theta[l]) kappa[l]  [M, M]
// for kappa [L, B, M] row-major (kernel 7: L = 1), g and theta [L, B].
//
// Replaces, in agp_tpu/ops/pallas_kernels.py, cavi_stats_batched (:486,
// body _stats_batched_kernel) and cavi_stats (:545, body _stats_kernel):
// both C entry points (batched_pair.cu, kappa_single.cu) launch the same
// two kernels below, stats_tc and sum_tiles; kernels 8-9
// (fused_variants.cu) launch them after their kappa pass, with one
// latent.
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
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int KB = 32;      // rows of a stage
constexpr int STAGES = 3;   // stages in the ring
// edge of an output tile: 128 against 64 ran 9-19 % faster at M=512 and 3 %
// slower at M=64 on an H100 (PERF.md, section 6)
constexpr int TILE = 128;
// WARPS_M x WARPS_N warps, each a WM x WN sub-tile (MI x NJ mma tiles of
// 16 x 8); two blocks an SM
constexpr int WARPS_M = 2, WARPS_N = 4, MIN_BLOCKS = 2;
constexpr int WM = TILE / WARPS_M, WN = TILE / WARPS_N;
constexpr int MI = WM / 16, NJ = WN / 8;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int SP = TILE + 8;                 // row stride of a stage (floats)
constexpr int STAGE = 2 * KB * SP + 2 * KB;  // A, B, theta, g (floats)
constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;
static_assert(THREADS % TILE == 0, "s1 takes THREADS / TILE rows a pass");

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
// Bs, unless the tile is diagonal), theta and g, zero past b1 and M.
template <bool VEC>
__device__ __forceinline__ void load_stage(float* As, float* Bs, float* ths, float* gs,
                                           const float* __restrict__ kl, const float* __restrict__ thl,
                                           const float* __restrict__ gl, int b, int b1, int M, int m0,
                                           int n0, bool diag) {
  constexpr int W = VEC ? 4 : 1;  // floats a copy
  for (int i = threadIdx.x; i < KB * (TILE / W); i += THREADS) {
    const int r = i / (TILE / W), c = (i % (TILE / W)) * W;
    const int row = b + r;
    const bool oka = row < b1 && m0 + c < M;
    cp_async<4 * W>(As + r * SP + c, oka ? kl + (size_t)row * M + m0 + c : kl, oka ? 4 * W : 0);
    if (!diag) {
      const bool okb = row < b1 && n0 + c < M;
      cp_async<4 * W>(Bs + r * SP + c, okb ? kl + (size_t)row * M + n0 + c : kl, okb ? 4 * W : 0);
    }
  }
  const int t = threadIdx.x;
  if (t < KB) {
    const bool ok = b + t < b1;
    cp_async<4>(ths + t, ok ? thl + b + t : thl, ok ? 4 : 0);
  } else if (t < 2 * KB) {
    const bool ok = b + t - KB < b1;
    cp_async<4>(gs + t - KB, ok ? gl + b + t - KB : gl, ok ? 4 : 0);
  }
}

// acc[mi][nj] += (theta kappa)[rows, m_w + ...]^T kappa[rows, n_w + ...]
// over one stage, 3xTF32: each 8 rows' three passes from a zero
// accumulator, then added to acc in FP32 (round to nearest)
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs, const float* ths, int m_w,
                                          int n_w, float (&acc)[MI][NJ][4]) {
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

// grid (upper tiles, chunks, L): the partial S2 tile (and, on a diagonal
// tile, the partial s1 of its columns) of one chunk of rows, into
// s2_part [L, nchunks, M, M] and s1_part [L, nchunks, M].  Entries of a
// diagonal tile below its diagonal may be left unwritten; sum_tiles never
// reads them.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
stats_tc(const float* __restrict__ kappa, const float* __restrict__ g, const float* __restrict__ theta,
         float* __restrict__ s1_part, float* __restrict__ s2_part, int B, int M, int rows_per_chunk) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int nt = (M + TILE - 1) / TILE;
  int ti, tj;
  upper_tile(blockIdx.x, nt, ti, tj);
  const int chunk = blockIdx.y, nchunks = gridDim.y, l = blockIdx.z;
  const int m0 = ti * TILE, n0 = tj * TILE;
  const int b0 = chunk * rows_per_chunk, b1 = min(B, b0 + rows_per_chunk);
  const int nsteps = (b1 - b0 + KB - 1) / KB;
  const float* kl = kappa + (size_t)l * B * M;
  const float* gl = g + (size_t)l * B;
  const float* thl = theta + (size_t)l * B;
  const bool diag = ti == tj;
  const int tid = threadIdx.x, warp = tid / 32;
  const int m_w = (warp / WARPS_N) * WM, n_w = (warp % WARPS_N) * WN;
  // a warp computes unless its sub-tile lies past M or wholly below the diagonal
  const bool active = m0 + m_w < M && n0 + n_w < M && !(diag && m_w >= n_w + WN);

  auto stage_ptr = [&](int s) { return sm + s * STAGE; };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) {
      float* As = stage_ptr(s);
      load_stage<VEC>(As, As + KB * SP, As + 2 * KB * SP, As + 2 * KB * SP + KB, kl, thl, gl,
                      b0 + s * KB, b1, M, m0, n0, diag);
    }
    cp_async_commit();
  }

  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
  constexpr int H = THREADS / TILE;  // rows of a stage a thread's s1 column takes: h, h + H, ...
  const int c1 = tid % TILE, h = tid / TILE;
  float s1acc = 0.0f;

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();  // this step's stage has landed (for this thread's copies)
    __syncthreads();              // ... and everyone's; the stage read last step is free
    const int next = step + STAGES - 1;
    if (next < nsteps) {
      float* As = stage_ptr(next % STAGES);
      load_stage<VEC>(As, As + KB * SP, As + 2 * KB * SP, As + 2 * KB * SP + KB, kl, thl, gl,
                      b0 + next * KB, b1, M, m0, n0, diag);
    }
    cp_async_commit();
    const float* As = stage_ptr(step % STAGES);
    const float* Bs = diag ? As : As + KB * SP;
    const float* ths = As + 2 * KB * SP;
    if (active) mma_stage(As, Bs, ths, m_w, n_w, acc);
    if (diag) {
      const float* gs = ths + KB;
#pragma unroll
      for (int k = h; k < KB; k += H) s1acc = fmaf(As[k * SP + c1], gs[k], s1acc);
    }
  }

  const size_t part = (size_t)l * nchunks + chunk;
  if (active) {
    float* out = s2_part + part * M * M;
    const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + m_w + mi * 16 + gid + (e >> 1) * 8, n = n0 + n_w + nj * 8 + 2 * tig + (e & 1);
          if (m < M && n < M) out[(size_t)m * M + n] = acc[mi][nj][e];
        }
  }
  if (diag) {  // s1's H partial sums of each column, added in a fixed order
    cp_async_wait<0>();
    __syncthreads();
    sm[h * TILE + c1] = s1acc;
    __syncthreads();
    if (h == 0 && m0 + c1 < M) {
      float s = sm[c1];
#pragma unroll
      for (int q = 1; q < H; ++q) s += sm[q * TILE + c1];
      s1_part[part * M + m0 + c1] = s;
    }
  }
}

// grid (4 strips of 8 rows x upper 32 x 32 blocks of S2 + 1, L), 256
// threads, one an entry of the strip: the chunk partials of each upper
// entry added in chunk order, written to S2 and, transposed through
// shared memory, to its mirror (8 consecutive floats a row); on a
// diagonal block the entries above the diagonal are mirrored below it.
// The last block of each latent adds s1's partials.  Strips rather than
// whole blocks: at M=128 (4 x 4 blocks of 32) a block a 32 x 32 block
// left 11 blocks to read 256 chunks' 16.8 MB (72 us on an H100, PERF.md).
constexpr int RB = 32, RS = 8;
__global__ void __launch_bounds__(256)
sum_tiles(const float* __restrict__ s1_part, const float* __restrict__ s2_part, float* __restrict__ s1,
          float* __restrict__ s2, int M, int nchunks) {
  static_assert(RB * RS == 256, "one thread an entry of a strip");
  __shared__ float tile[RS][RB + 1];
  const int l = blockIdx.y, tx = threadIdx.x % RB, ty = threadIdx.x / RB;
  const int nb = (M + RB - 1) / RB;
  const size_t mm = (size_t)M * M;
  if ((int)blockIdx.x == nb * (nb + 1) / 2 * (RB / RS)) {
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      float acc = 0.0f;
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
  float* out = s2 + (size_t)l * mm;
  float acc = 0.0f;
  if (m < M && n < M && (!dblock || r <= tx)) {
    const float* p = s2_part + (size_t)l * nchunks * mm + (size_t)m * M + n;
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

using StatsFn = void (*)(const float*, const float*, const float*, float*, float*, int, int, int);

// the dynamic shared memory a stage ring takes (two blocks an SM)
cudaError_t prepare_stats(bool vec) {
  return vec ? prepare_smem<&stats_tc<true>>(SMEM) : prepare_smem<&stats_tc<false>>(SMEM);
}

// resident blocks of stats_tc on one SM of the current device (0 on error)
int stats_blocks_per_sm() {
  int n = 0;
  if (prepare_stats(true) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, &stats_tc<true>, THREADS, SMEM) != cudaSuccess)
    return 0;
  return n;
}

// Both launches of the statistics of L latents; returns the CUDA error.
int launch_stats(const float* kappa, const float* g, const float* theta, float* s1_part, float* s2_part,
                 float* s1, float* s2, int B, int M, int L, int nchunks, int rows_per_chunk, cudaStream_t st) {
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(kappa) % 16 == 0;
  const StatsFn fn = vec ? &stats_tc<true> : &stats_tc<false>;
  cudaError_t err = prepare_stats(vec);
  if (err != cudaSuccess) return (int)err;
  const int nt = (M + TILE - 1) / TILE;
  fn<<<dim3(nt * (nt + 1) / 2, nchunks, L), THREADS, SMEM, st>>>(kappa, g, theta, s1_part, s2_part, B, M,
                                                                rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nb = (M + RB - 1) / RB;
  sum_tiles<<<dim3(nb * (nb + 1) / 2 * (RB / RS) + 1, L), 256, 0, st>>>(s1_part, s2_part, s1, s2, M, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace
