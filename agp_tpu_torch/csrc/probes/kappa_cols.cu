// A measurement program for the column-blocked form of kernels 4 and 6
// (csrc/kappa_cols.cuh; not part of the library), at logistic_m512_b65536's
// shape (B=65,536, M=512, D=20) in double:
//   * the gram's two ways of reaching the product: written once by
//     gram_rows (its time with the stores), or formed again in each block
//     of the product (its compute alone, which the block would repeat for
//     each of the M / TN column tiles);
//   * the product kappa = Knm K^-1 with its epilogue at several block tiles
//     and blocks an SM, beside the library's ColTile<double>;
//   * the float form (3xTF32) at M=4,096, B=16,384.
// `python3 chip_smoke.py probe` builds it with nvcc and runs it on the card;
// PERF.md quotes what it prints for the design choices.  Inputs are made
// on the card from a fixed formula.
#include <cstdio>

#include "../kappa_cols.cuh"

namespace {

template <class E>
__global__ void fill(E* p, size_t n, double scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x)
    p[i] = E(scale * sin(0.37 * (double)(i % 10007)));
}

template <class F>
float time_ms(F f, int reps = 10) {
  f();
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < reps; ++r) f();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms / reps;
}

// gram_rows' arithmetic with one store a thread (its sum): what forming
// the gram costs a block that does not write it
template <class E>
__global__ void __launch_bounds__(GT) gram_compute(const E* x, const E* z, const E* params, E* sink, int B, int D,
                                                   int M, int kind) {
  __shared__ __align__(16) E xs[GDC][GR];
  __shared__ E zs[GDC][GC];
  __shared__ E il[GDC];
  const int row0 = blockIdx.x * GR, col0 = blockIdx.y * GC;
  const int c = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 8;
  const E* ls = params + P_VAR + 1;
  E r[2][8] = {};
  for (int d0 = 0; d0 < D; d0 += GDC) {
    const int dc = min(GDC, D - d0);
    __syncthreads();
    if (threadIdx.x < dc) il[threadIdx.x] = E(1) / ls[d0 + threadIdx.x];
    __syncthreads();
    for (int i = threadIdx.x; i < GR * dc; i += GT) {
      const int t = i / dc, dd = i % dc;
      xs[dd][t] = row0 + t < B ? x[(size_t)(row0 + t) * D + d0 + dd] * il[dd] : E(0);
    }
    for (int i = threadIdx.x; i < GC * dc; i += GT) {
      const int m = i / dc, dd = i % dc;
      zs[dd][m] = col0 + m < M ? z[(size_t)(col0 + m) * D + d0 + dd] * il[dd] : E(0);
    }
    __syncthreads();
    for (int dd = 0; dd < dc; ++dd) {
      E xv[8];
      load8(&xs[dd][r0], xv);
      const E z0 = zs[dd][c], z1 = zs[dd][c + 32];
      for (int t = 0; t < 8; ++t) {
        const E d0v = xv[t] - z0, d1v = xv[t] - z1;
        r[0][t] = fma_t(d0v, d0v, r[0][t]);
        r[1][t] = fma_t(d1v, d1v, r[1][t]);
      }
    }
  }
  E s = 0;
  for (int t = 0; t < 8; ++t) s += gram_from_r2_of(kind, r[0][t], params[P_VAR]) + gram_from_r2_of(kind, r[1][t], params[P_VAR]);
  sink[(blockIdx.y * gridDim.x + blockIdx.x) * GT + threadIdx.x] = s;
}

// the product's main loop alone (cols_product, one store a thread); with
// SAME_A every block reads the first row panel (A always in L2)
template <class C, bool SAME_A, class E = typename C::Elem>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
loop_only(const E* a, const E* bm, E* sink, int B, int M) {
  extern __shared__ float4 sm4[];
  E* ring = reinterpret_cast<E*>(sm4);
  const int n0 = blockIdx.x * C::TN, row0 = SAME_A ? 0 : blockIdx.y * C::TB;
  cols_product<C>(a + (size_t)row0 * M, M, C::TB, bm, M, M, M, n0, ring, true, true,
                  [&](E (&acc)[C::MI][C::NJ][4]) {
                    E s = 0;
                    for (int mi = 0; mi < C::MI; ++mi)
                      for (int nj = 0; nj < C::NJ; ++nj)
                        for (int e = 0; e < 4; ++e) s += acc[mi][nj][e];
                    sink[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * C::THREADS + threadIdx.x] = s;
                  });
}

template <class C, bool SAME_A, class E = typename C::Elem>
float loop_ms(const E* a, const E* bm, E* sink, int B, int M) {
  if (prepare_smem<&loop_only<C, SAME_A>>(C::SMEM) != cudaSuccess) return -1.0f;
  const dim3 grid((M + C::TN - 1) / C::TN, (B + C::TB - 1) / C::TB, 1);
  const float ms = time_ms([&] { loop_only<C, SAME_A, E><<<grid, C::THREADS, C::SMEM, 0>>>(a, bm, sink, B, M); });
  return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}

template <class C, class E = typename C::Elem>
float product_ms(const E* knm, const E* kinv, E* kappa, E* part, int B, int M) {
  if (prepare_smem<&kappa_cols<C, true, false>>(C::SMEM) != cudaSuccess) return -1.0f;
  const dim3 grid(((M + C::TN - 1) / C::TN) * ((B + C::TB - 1) / C::TB), 1);  // as launch_kappa_cols's
  const float ms = time_ms([&] {
    kappa_cols<C, true, false, E><<<grid, C::THREADS, C::SMEM, 0>>>(knm, kinv, nullptr, kappa, part, nullptr, B, M, true);
  });
  return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}

template <class C>
void report(const char* what, float ms, double fmas) {
  printf("  %s [%d x %d], %d warps of %d x %d, %d stages, %d blocks an SM, %zu B shared: %.4f ms (%.1f TFLOP/s)\n",
         what, C::TB, C::TN, C::WARPS_M * C::WARPS_N, C::WM, C::WN, C::STAGES, C::MIN_BLOCKS, C::SMEM, ms,
         2.0 * fmas / (ms * 1e-3) / 1e12);
}

}  // namespace

int main() {
  const int B = 65536, M = 512, D = 20;
  double *x, *z, *kinv, *params, *knm, *kappa, *part, *sink;
  cudaMalloc(&x, sizeof(double) * B * D);
  cudaMalloc(&z, sizeof(double) * M * D);
  cudaMalloc(&kinv, sizeof(double) * M * M);
  cudaMalloc(&params, sizeof(double) * (4 + D));
  cudaMalloc(&knm, sizeof(double) * B * M);
  cudaMalloc(&kappa, sizeof(double) * B * M);
  cudaMalloc(&part, sizeof(double) * 8 * B);
  cudaMalloc(&sink, sizeof(double) * (size_t)B * M);
  fill<<<512, 256>>>(x, (size_t)B * D, 1.0);
  fill<<<64, 256>>>(z, (size_t)M * D, 1.0);
  fill<<<256, 256>>>(kinv, (size_t)M * M, 0.01);
  fill<<<1, 32>>>(params, 4 + D, 0.0);
  double hp[4 + 20];
  for (int i = 0; i < 4 + D; ++i) hp[i] = i < 3 ? 1e-3 : 2.0;
  cudaMemcpy(params, hp, sizeof hp, cudaMemcpyHostToDevice);
  const dim3 gg((B + GR - 1) / GR, (M + GC - 1) / GC, 1);
  const float gram_ms = time_ms([&] { gram_rows<double><<<gg, GT>>>(x, z, params, knm, B, D, M, 1, KIND_RBF); });
  const float comp_ms = time_ms([&] { gram_compute<double><<<gg, GT>>>(x, z, params, sink, B, D, M, KIND_RBF); });
  const int tn = ColTile<double>::TN;
  printf("gram, double, B=%d M=%d D=%d: written once (gram_rows) %.4f ms; its compute alone %.4f ms, so "
         "forming it in each block of the product would cost %d x %.4f = %.4f ms\n",
         B, M, D, gram_ms, comp_ms, (M + tn - 1) / tn, comp_ms, (M + tn - 1) / tn * comp_ms);
  const double fmas = (double)B * M * M;
  printf("kappa = Knm K^-1 with its epilogue (kappa stored, Ktilde's partials), double, B=%d M=%d:\n", B, M);
  report<ColTile<double>>("library ColTile<double>", product_ms<ColTile<double>>(knm, kinv, kappa, part, B, M), fmas);
  using T1 = ColShape<double, 128, 64, 2, 2, 3, 2>;
  report<T1>("candidate", product_ms<T1>(knm, kinv, kappa, part, B, M), fmas);
  using T2 = ColShape<double, 64, 128, 1, 4, 3, 2>;
  report<T2>("candidate", product_ms<T2>(knm, kinv, kappa, part, B, M), fmas);
  using T4 = ColShape<double, 128, 128, 4, 4, 4, 1>;
  report<T4>("candidate", product_ms<T4>(knm, kinv, kappa, part, B, M), fmas);
  using T5 = ColShape<double, 128, 128, 2, 4, 3, 1, 32>;
  report<T5>("candidate, k-chunks of 32", product_ms<T5>(knm, kinv, kappa, part, B, M), fmas);
  printf("the same products' main loop alone (no epilogue):\n");
  report<ColTile<double>>("library ColTile<double>", loop_ms<ColTile<double>, false>(knm, kinv, sink, B, M), fmas);
  report<ColTile<double>>("library ColTile<double>, every block on one row panel (A in L2)",
                          loop_ms<ColTile<double>, true>(knm, kinv, sink, B, M), fmas);
  report<T1>("candidate", loop_ms<T1, false>(knm, kinv, sink, B, M), fmas);
  report<T5>("candidate, k-chunks of 32", loop_ms<T5, false>(knm, kinv, sink, B, M), fmas);

  const int Bf = 16384, Mf = 4096;
  float *kf, *kif, *kapf, *pf;
  cudaMalloc(&kf, sizeof(float) * (size_t)Bf * Mf);
  cudaMalloc(&kif, sizeof(float) * (size_t)Mf * Mf);
  cudaMalloc(&kapf, sizeof(float) * (size_t)Bf * Mf);
  cudaMalloc(&pf, sizeof(float) * 64 * Bf);
  fill<<<512, 256>>>(kf, (size_t)Bf * Mf, 1.0);
  fill<<<512, 256>>>(kif, (size_t)Mf * Mf, 0.001);
  printf("kappa in 3xTF32, float, B=%d M=%d:\n", Bf, Mf);
  report<ColTile<float>>("library ColTile<float>", product_ms<ColTile<float>>(kf, kif, kapf, pf, Bf, Mf),
                         (double)Bf * Mf * Mf);
  const cudaError_t err = cudaDeviceSynchronize();
  printf("probe: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
