// A measurement program (not part of the library): whether this toolkit's
// ptxas takes the FP64 mma.sync shape m16n8k{DMMA_K} (4, 8 or 16; the
// larger two exist from sm_90), whether its fragments follow the layout
// that csrc/kappa_cols.cuh assumes for m16n8k8 (A's a[i] at row gid + 8
// (i % 2), column tig + 4 (i / 2); B's b[i] at row tig + 4 i, column gid;
// C's c[i] at row gid + 8 (i / 2), column 2 tig + i % 2), and the rate one
// warp tile of MMAs reaches on the card.  Built once for each shape with
// -DDMMA_K=4, 8 or 16 by `python3 chip_smoke.py probe` (a shape ptxas
// refuses fails that build alone).
#include <cmath>
#include <cstdio>

#ifndef DMMA_K
#define DMMA_K 8
#endif

constexpr int K = DMMA_K;
constexpr int NA = K / 2, NB = K / 4;  // doubles of A and of B a thread

__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[NA], const double (&b)[NB]) {
#if DMMA_K == 4
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(b[0]));
#elif DMMA_K == 8
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]),
        "d"(b[1]), "d"(b[2]), "d"(b[3]));
#endif
}

// D = A B for A [16, K], B [K, 8] row-major, one warp, the assumed layout
__global__ void layout(const double* A, const double* B, double* D) {
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  double a[NA], b[NB], c[4] = {0, 0, 0, 0};
  for (int i = 0; i < NA; ++i) a[i] = A[(gid + 8 * (i % 2)) * K + tig + 4 * (i / 2)];
  for (int i = 0; i < NB; ++i) b[i] = B[(tig + 4 * i) * 8 + gid];
  mma(c, a, b);
  for (int i = 0; i < 4; ++i) D[(gid + 8 * (i / 2)) * 8 + 2 * tig + i % 2] = c[i];
}

// each warp: REPS steps of a 4 x 4 grid of independent tiles (a 64 x 32
// warp tile), the fragments in registers
constexpr int REPS = 4096;
__global__ void __launch_bounds__(256) rate(double* out, double seed) {
  double a[NA], b[NB], c[4][4][4] = {};
  for (int i = 0; i < NA; ++i) a[i] = seed + threadIdx.x + i;
  for (int i = 0; i < NB; ++i) b[i] = seed - i;
  for (int r = 0; r < REPS; ++r) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) mma(c[mi][nj], a, b);
  }
  double s = 0;
  for (int mi = 0; mi < 4; ++mi)
    for (int nj = 0; nj < 4; ++nj)
      for (int e = 0; e < 4; ++e) s += c[mi][nj][e];
  if (s == 12345.678) out[0] = s;  // keeps the loop
}

int main() {
  double hA[16 * K], hB[K * 8], hD[128], ref[128];
  for (int i = 0; i < 16 * K; ++i) hA[i] = std::sin(0.7 * i + 0.1);
  for (int i = 0; i < K * 8; ++i) hB[i] = std::cos(0.3 * i + 0.2);
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 8; ++c) {
      double s = 0;
      for (int k = 0; k < K; ++k) s += hA[r * K + k] * hB[k * 8 + c];
      ref[r * 8 + c] = s;
    }
  double *A, *B, *D;
  cudaMalloc(&A, sizeof hA);
  cudaMalloc(&B, sizeof hB);
  cudaMalloc(&D, sizeof hD);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout<<<1, 32>>>(A, B, D);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(hD, D, sizeof hD, cudaMemcpyDeviceToHost);
  double worst = 0;
  for (int i = 0; i < 128; ++i) worst = std::fmax(worst, std::fabs(hD[i] - ref[i]));
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  const int blocks = sms * 2;
  rate<<<blocks, 256>>>(D, 1.0);
  cudaEventRecord(t0);
  rate<<<blocks, 256>>>(D, 1.0);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0;
  cudaEventElapsedTime(&ms, t0, t1);
  const double flops = 2.0 * 16 * 8 * K * 16.0 * REPS * (blocks * 8.0);
  printf("dmma m16n8k%d: %s; layout max |D - A B| = %.3e (%s); rate %.1f TFLOP/s (%d blocks of 8 warps, "
         "64 x 32 warp tiles, %.3f ms)\n",
         K, err == cudaSuccess ? "ran" : cudaGetErrorString(err), worst, worst < 1e-12 ? "layout as assumed" : "LAYOUT DIFFERS",
         flops / (ms * 1e-3) / 1e12, blocks, ms);
  return worst < 1e-12 && err == cudaSuccess ? 0 : 1;
}
