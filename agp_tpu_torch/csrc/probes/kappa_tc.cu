// A measurement program for kernels 4 and 6 (not part of the library): where
// kernel 6's block spends its time at logistic_m512_b65536's shape (B=65,536,
// M=512, D=20), how other tile shapes of kernels 4 and 6 compare, and the
// tensor cores' rate under mma.sync with and without 3xTF32's splits.
// `python3 chip_smoke.py probe` builds it with nvcc and runs it on the card;
// the numbers it prints are the ones PERF.md quotes for the design choices
// of kernels 4 and 6.  Inputs are made on the card from a fixed formula.
#include <cstdio>
#include <vector>

#include "../batched_pair.cu"
#include "../kappa_single.cu"

namespace {

__global__ void fill(float* p, size_t n, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x)
    p[i] = scale * __sinf(0.37f * (float)(i % 10007));
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

// One part of kernel 6's block: 0 the gram alone, 1 the product with a
// trivial epilogue, 2 the product with kappa's stores and Ktilde's sums.
template <class C, int PART>
__global__ void __launch_bounds__(C::THREADS, 1)
part(const float* x, const float* z, const float* kinv, const float* params, float* kappa, float* kt, int B,
     int D, int M) {
  constexpr int TB = C::TB;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int S = slab_stride(M);
  float* G = sm;
  float* U = G + TB * S;
  float* red = U + slab_scratch<C>(M);
  const int row0 = blockIdx.x * TB, nrows = min(TB, B - row0);
  if constexpr (PART == 0) {
    gram_into_slab<C>(KIND_RBF, x, z, params + 4, 1.0f, G, S, U, row0, nrows, D, M);
    if (threadIdx.x < TB) kt[row0 + threadIdx.x] = G[threadIdx.x * S + threadIdx.x];
  } else {
    for (int i = threadIdx.x; i < TB * S; i += C::THREADS) G[i] = 0.001f * (i % 97);
    __syncthreads();
    float kq[C::MI][2] = {};
    float* out = kappa + (size_t)row0 * M;
    tc_product<C>(G, S, kinv, M, U, true, [&](int n0, float (&acc)[C::MI][C::NJ][4]) {
      for_fragments<C>(n0, acc, [&](int mi, int h, int row, int col, float v0, float v1) {
        if (PART == 2) {
          if (col < M) kq[mi][h] = fmaf(v0, G[row * S + col], kq[mi][h]);
          if (col + 1 < M) kq[mi][h] = fmaf(v1, G[row * S + col + 1], kq[mi][h]);
          store_pair(out, M, nrows, row, col, v0, v1);
        } else {
          kq[mi][h] += v0 + v1;
        }
      });
    });
    row_partials<C>(kq, red);
    __syncthreads();
    for (int t = threadIdx.x; t < nrows; t += C::THREADS) kt[row0 + t] = row_total<C>(red, t);
  }
}

// split x as the kernels did first: both halves by cvt.rna
__device__ __forceinline__ void split_cvt(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// MI x NJ m16n8k8 tiles a warp, n times, 3 passes each (mma_3xtf32_grid),
// the operands from registers: SPLIT 0 none, 1 split_tf32, 2 cvt.rna
template <int MI, int NJ, int SPLIT>
__global__ void mma_rate(const float* in, float* out, int n) {
  float a[MI][4], b[NJ][2];
  for (int i = 0; i < MI; ++i)
    for (int q = 0; q < 4; ++q) a[i][q] = in[(threadIdx.x * 7 + i * 4 + q) % 1024];
  for (int j = 0; j < NJ; ++j)
    for (int q = 0; q < 2; ++q) b[j][q] = in[(threadIdx.x * 3 + j * 2 + q) % 1024];
  float acc[MI][NJ][4] = {};
  for (int it = 0; it < n; ++it) {
    unsigned ah[MI][4], al[MI][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (SPLIT == 1) split_tf32(a[i][q] + it, ah[i][q], al[i][q]);
        else if (SPLIT == 2) split_cvt(a[i][q] + it, ah[i][q], al[i][q]);
        else ah[i][q] = al[i][q] = __float_as_uint(a[i][q]);
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (SPLIT == 1) split_tf32(b[j][q] + it, bh[j][q], bl[j][q]);
        else if (SPLIT == 2) split_cvt(b[j][q] + it, bh[j][q], bl[j][q]);
        else bh[j][q] = bl[j][q] = __float_as_uint(b[j][q]);
      }
    mma_3xtf32_grid(acc, ah, al, bh, bl);
  }
  float s = 0;
  for (int i = 0; i < MI; ++i)
    for (int j = 0; j < NJ; ++j)
      for (int e = 0; e < 4; ++e) s += acc[i][j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

struct Bufs {
  float *x, *z, *kinv, *mu, *sigma, *params, *kappa, *a, *b;
};

template <class C, int PART>
void run_part(const char* name, Bufs& u, int B, int D, int M) {
  const size_t smem = ks_smem<C>(M);
  cudaFuncSetAttribute(part<C, PART>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int nb = (B + C::TB - 1) / C::TB;
  const float ms = time_ms([&] { part<C, PART><<<nb, C::THREADS, smem>>>(u.x, u.z, u.kinv, u.params, u.kappa, u.a, B, D, M); });
  printf("kernel 6 part  %-40s %9.1f us (%s)\n", name, 1000 * ms, cudaGetErrorString(cudaGetLastError()));
}

template <class C>
void shape6(const char* name, Bufs& u, int B, int D, int M) {
  int occ = 0;
  const float ms = time_ms([&] { launch_kappa_single<C>(u.x, u.z, u.kinv, u.params, u.kappa, u.a, B, D, M, 0, 0); });
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kappa_single<C>, C::THREADS, ks_smem<C>(M));
  printf("kernel 6 shape %-40s %9.1f us at B=%d M=%d (blocks an SM %d; %s)\n", name, 1000 * ms, B, M, occ,
         cudaGetErrorString(cudaGetLastError()));
}

template <class C>
void shape4(const char* name, Bufs& u, int B, int D, int M, int L) {
  int occ = 0;
  const float ms = time_ms([&] {
    launch_kappa_moments<C>(u.x, u.z, u.kinv, u.mu, u.sigma, u.params, u.kappa, u.a, u.b, B, D, M, L, 0, 0);
  });
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kappa_moments_batched<C>, C::THREADS, rows_smem<C>(M));
  printf("kernel 4 shape %-40s %9.1f us at B=%d M=%d L=%d (blocks an SM %d; %s)\n", name, 1000 * ms, B, M, L, occ,
         cudaGetErrorString(cudaGetLastError()));
}

template <int MI, int NJ, int SPLIT>
void rate(const char* name, const float* in, float* out, int warps, double clock_ghz, int sms) {
  const int n = 4096;
  const float ms = time_ms([&] { mma_rate<MI, NJ, SPLIT><<<sms, 32 * warps>>>(in, out, n); });
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("mma.sync rate  %-40s %2d warps an SM: not launched (%s)\n", name, warps, cudaGetErrorString(err));
    return;
  }
  const double mmas = 3.0 * MI * NJ * n * warps * sms;
  printf("mma.sync rate  %-40s %2d warps an SM: %.2f SM-cycles an m16n8k8, %.1f TFLOP/s\n", name, warps,
         ms * 1e-3 * clock_ghz * 1e9 * sms / mmas, mmas * 2048 / (ms * 1e-3) / 1e12);
}

}  // namespace

int main() {
  const int B = 65536, D = 20, M = 512, L = 3;
  Bufs u;
  cudaMalloc(&u.x, 4ull * B * D);
  cudaMalloc(&u.z, 4ull * L * M * D);
  cudaMalloc(&u.kinv, 4ull * L * M * M);
  cudaMalloc(&u.mu, 4ull * L * M);
  cudaMalloc(&u.sigma, 4ull * L * M * M);
  cudaMalloc(&u.params, 4ull * (3 + L + L * D));
  cudaMalloc(&u.kappa, 4ull * B * M);
  cudaMalloc(&u.a, 4ull * B * L);
  cudaMalloc(&u.b, 4ull * B * L);
  fill<<<256, 256>>>(u.x, (size_t)B * D, 1.0f);
  fill<<<256, 256>>>(u.z, (size_t)L * M * D, 1.0f);
  fill<<<256, 256>>>(u.kinv, (size_t)L * M * M, 0.1f);
  fill<<<256, 256>>>(u.mu, (size_t)L * M, 1.0f);
  fill<<<256, 256>>>(u.sigma, (size_t)L * M * M, 0.1f);
  std::vector<float> p(3 + L + L * D, 2.0f);
  p[0] = 1e-3f;
  for (int l = 0; l < L; ++l) p[3 + l] = 1.0f;
  cudaMemcpy(u.params, p.data(), 4 * p.size(), cudaMemcpyHostToDevice);
  int sms = 0, clock_khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  const double ghz = clock_khz * 1e-6;
  printf("SMs %d, SM clock %.3f GHz (the rate below assumes it)\n", sms, ghz);
  using K64 = KTile<64>;
  for (int rep = 0; rep < 2; ++rep) {
    run_part<K64, 0>("the gram alone", u, B, D, M);
    run_part<K64, 1>("the product, no stores", u, B, D, M);
    run_part<K64, 2>("the product with its epilogue", u, B, D, M);
    shape6<K64>("64 rows, 1 x 8 warps of 64 x 32 (built)", u, B, D, M);
    shape6<TileShape<64, 2, 4, 2, 4, 32>>("64 rows, 2 x 4 warps of 32 x 32", u, B, D, M);
    shape6<TileShape<64, 4, 4, 1, 4, 32>>("64 rows, 4 x 4 warps of 16 x 32", u, B, D, M);
    shape6<TileShape<64, 2, 8, 2, 4, 16>>("64 rows, 2 x 8 warps of 32 x 32", u, B, D, M);
    shape6<TileShape<32, 2, 4, 1, 4, 16>>("32 rows, 2 x 4 warps of 16 x 32", u, B, D, M);
    shape4<KTile<64>>("64 rows, 1 x 8 warps of 64 x 32 (built)", u, B, D, M, 1);
    shape4<KTile<32>>("32 rows, 1 x 8 warps of 32 x 32", u, B, D, M, 1);
    shape4<KTile<64>>("64 rows, 1 x 8 warps of 64 x 32 (built)", u, 8192, D, M, L);
    shape4<KTile<32>>("32 rows, 1 x 8 warps of 32 x 32", u, 8192, D, M, L);
  }
  for (int w : {8, 16}) {
    rate<2, 4, 0>("2 x 4 tiles, no split", u.kinv, u.kappa, w, ghz, sms);
    rate<2, 4, 1>("2 x 4 tiles, integer split", u.kinv, u.kappa, w, ghz, sms);
    rate<2, 4, 2>("2 x 4 tiles, cvt.rna split", u.kinv, u.kappa, w, ghz, sms);
    rate<4, 4, 1>("4 x 4 tiles, integer split", u.kinv, u.kappa, w, ghz, sms);
    rate<4, 4, 2>("4 x 4 tiles, cvt.rna split", u.kinv, u.kappa, w, ghz, sms);
  }
  return 0;
}
