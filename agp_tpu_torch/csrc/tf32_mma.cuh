// The tensor-core and copy primitives that kernels 4-7 share on Hopper
// (sm_90a): the 3xTF32 split of an FP32 operand, the m16n8k8 TF32
// mma.sync, and 16- or 4-byte cp.async into shared memory with zero fill.
//
// 3xTF32: x = hi + lo with hi = tf32(x) (to nearest) and lo = x - hi, which
// the mma reads truncated to TF32, so that hi and lo keep 2 x 11
// significant bits of x; a product a b is taken as lo_a hi_b + hi_a lo_b +
// hi_a hi_b in three mma passes, each exact in FP32, and misses lo_a lo_b
// and lo's truncation (~2^-21 of it at most).  A mma aligns its addends
// to the largest and truncates, so its callers start every 8-deep step
// from a zero accumulator (mma_tf32_first) and add the step to their
// running sums in FP32, round to nearest (stats_tc.cuh, pair_core.cuh).
// Everything is in an anonymous namespace: each source that includes this
// header compiles its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (4 or 16) with the source's first `src_bytes` copied
// and the rest of the destination zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo exactly: hi = x rounded to TF32 (to nearest, ties away from
// zero, as cvt.rna rounds a finite x) by two integer operations, and
// lo = x - hi in FP32, whose low 13 bits the mma drops (it reads a TF32
// operand's top 19 bits), so that lo enters truncated to 11 significant
// bits.  cvt.rna.tf32.f32 itself costs about five instructions a
// conversion on an H100 (it checks for infinities and NaN), two of them a
// split; this is three instructions in all.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b over one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b over one m16n8k8 TF32 tile, from a zero accumulator
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// acc += a b in 3xTF32 from the split fragments: lo.hi + hi.lo first, then
// hi.hi, from a zero accumulator, then added to acc in FP32
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const unsigned (&ah)[4], const unsigned (&al)[4],
                                           const unsigned (&bh)[2], const unsigned (&bl)[2]) {
  float d[4];
  mma_tf32_first(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// acc[mi][nj] += a[mi] b[nj] in 3xTF32 over an MI x NJ grid of m16n8k8
// tiles, pass by pass: every tile's lo.hi pass, then every tile's hi.lo,
// then every tile's hi.hi, so that each mma has MI NJ - 1 independent ones
// between it and the mma whose result it adds to; then the FP32 adds
template <int MI, int NJ>
__device__ __forceinline__ void mma_3xtf32_grid(float (&acc)[MI][NJ][4], const unsigned (&ah)[MI][4],
                                                const unsigned (&al)[MI][4], const unsigned (&bh)[NJ][2],
                                                const unsigned (&bl)[NJ][2]) {
  float d[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) mma_tf32_first(d[mi][nj], al[mi], bh[nj]);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) mma_tf32(d[mi][nj], ah[mi], bl[nj]);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) mma_tf32(d[mi][nj], ah[mi], bh[nj]);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] += d[mi][nj][e];
}

}  // namespace
