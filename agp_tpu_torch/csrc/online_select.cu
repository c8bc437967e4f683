// Accept walks of the online inducing-set updates for Hopper (sm_90a):
// OIPS's and StreamKmeans' pass over a streaming batch, one point after the
// other, on each latent's slot buffer.
//
// Replaces no Pallas kernel.  These are the counterparts of the reference's
// lax.scans over a batch's points: oips_update's
// (agp_tpu/inducing/algorithms.py:134-151) and streamkmeans_update's
// (:277-297).  Each point's decision depends on the decisions before it, so
// the walk is sequential: neither an elementwise pass nor a plain reduction.
//
// Design:
// * One thread block a latent (the grid is [L]); the latents' walks are
//   independent, one launch takes them all.
// * oips_accept: OIPS never moves a slot, so every correlation a point can
//   meet is known before the walk: with the slots active as the batch
//   starts (g_z = k(X, Z) [B, Mc]) and with the batch's earlier points
//   (g_x = k(X, X) [B, B]).  The block first takes each point's largest
//   correlation with the active slots, a warp a row (max_z, in a scratch
//   row), then warp 0 walks the points: a point whose max_z is already >=
//   rho (or NaN) is never accepted, since accepting rows only adds
//   correlations, so it is skipped with no work; another one is reduced
//   over the rows accepted before it, its lanes spread over them, and goes
//   into the first inactive slot when its largest correlation is below rho.
//   A full buffer accepts nothing and returns at once.  The result is a map
//   row_of_slot [Mc] (-1 where nothing was written), which the caller
//   applies with static shapes.
// * streamkmeans_pass: an absorbing centre moves, so nothing is known
//   ahead.  Each point's squared distance to every active centre is taken by
//   the centre's owner thread (centre j belongs to thread j mod THREADS),
//   which alone reads and writes that centre, its mask bit and its count;
//   the block's argmin (the first of equal minima, as jnp.argmin) takes one
//   barrier a point, its partials double-buffered so that the next point
//   needs none before it writes; every thread then makes the same decision
//   and the owner opens or moves its centre.  Z, the mask and the counts are
//   updated in place.
// * Arithmetic: the model's dtype, each operation correctly rounded
//   (__f*_rn / __d*_rn: no FMA contraction, IEEE division and square root,
//   no fast math), in the plain versions' order
//   (inducing/algorithms.py::oips_accept_reference,
//   streamkmeans_pass_reference): the decisions are theirs bit for bit.  A
//   NaN correlation rejects a point, as the reference's max propagates it.
//
// What bounds it on an H100: neither bytes nor operations.  oips_accept
// reads only g_z's active columns and g_x's entries of walked points
// against earlier accepted rows (a full buffer: the mask alone), well under
// (B Mc + B^2) 4 B, itself ~0.1 us at 3.35 TB/s at the streaming row (B=256,
// Mc=128, float32); the walk is a chain of dependent decisions, each a few
// hundred cycles of one warp (streamkmeans_pass: a block barrier a point),
// so its time is latency: B times one decision.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int OIPS_THREADS = 512;
constexpr int KM_THREADS = 256;
constexpr int KM_WARPS = KM_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
  __device__ static float inf() { return __int_as_float(0x7f800000); }
};

template <>
struct Rn<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
  __device__ static double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
};

// the larger of a and b, NaN if either is (torch.maximum, jnp.max)
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// g / sqrt(max(kx kd, 1e-30)), each step rounded once; NaN stays NaN
template <typename T>
__device__ __forceinline__ T correlation(T g, T kx, T kd) {
  const T tiny = T(1e-30);
  const T p = Rn<T>::mul(kx, kd);
  return Rn<T>::div(g, Rn<T>::sqrt(p < tiny ? tiny : p));
}

template <typename T>
__device__ __forceinline__ T warp_nanmax(T v) {
  for (int off = 16; off > 0; off >>= 1) v = nanmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(OIPS_THREADS)
oips_accept(const T* __restrict__ g_z, const T* __restrict__ g_x, const T* __restrict__ kx,
            const T* __restrict__ kd, const unsigned char* __restrict__ mask, long long* __restrict__ row_of_slot,
            T* max_z, int B, int Mc, T rho) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* acc_row = reinterpret_cast<int*>(smem);                             // [Mc] rows accepted, in order
  T* acc_kd = reinterpret_cast<T*>(smem + ((Mc * sizeof(int) + 15) / 16) * 16);  // [Mc] kd of their slots
  __shared__ int s_active;
  const size_t l = blockIdx.x;
  g_z += l * B * (size_t)Mc;
  g_x += l * B * (size_t)B;
  kx += l * B;
  kd += l * Mc;
  mask += l * Mc;
  row_of_slot += l * Mc;
  max_z += l * B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_active = 0;
  __syncthreads();
  int mine = 0;
  for (int s = tid; s < Mc; s += OIPS_THREADS) {
    row_of_slot[s] = -1;
    mine += mask[s] != 0;
  }
  atomicAdd(&s_active, mine);
  __syncthreads();
  int n_active = s_active;
  if (n_active >= Mc) return;  // a full buffer accepts nothing
  // each point's largest correlation with the active slots, a warp a row
  for (int i = warp; i < B; i += OIPS_THREADS / 32) {
    T m = -Rn<T>::inf();
    const T kxi = kx[i];
    for (int s = lane; s < Mc; s += 32)
      if (mask[s]) m = nanmax(m, correlation(g_z[(size_t)i * Mc + s], kxi, kd[s]));
    m = warp_nanmax(m);
    if (lane == 0) max_z[i] = m;
  }
  __syncthreads();
  if (warp != 0) return;
  // the walk: warp 0, its lanes over the rows accepted so far
  int n_acc = 0, slot = 0;
  for (int i = 0; i < B && n_active < Mc; ++i) {
    T best = max_z[i];
    if (!(best < rho)) continue;  // never accepted: correlations only grow
    const T kxi = kx[i];
    T m = -Rn<T>::inf();
    for (int j = lane; j < n_acc; j += 32) m = nanmax(m, correlation(g_x[(size_t)i * B + acc_row[j]], kxi, acc_kd[j]));
    best = nanmax(best, warp_nanmax(m));
    if (best < rho) {  // the same on every lane: each holds the reduced value
      while (mask[slot]) ++slot;  // the first inactive slot not yet taken
      if (lane == 0) {
        row_of_slot[slot] = i;
        acc_row[n_acc] = i;
        acc_kd[n_acc] = kd[slot];
      }
      __syncwarp();
      ++slot;
      ++n_acc;
      ++n_active;
    }
  }
}

// (v, j) before (w, k): the smaller value, NaN smallest, then the smaller
// index (numpy's and jnp.argmin's first of equal minima)
template <typename T>
__device__ __forceinline__ bool before(T v, int j, T w, int k) {
  const bool vn = v != v, wn = w != w;
  if (vn || wn) return vn && (!wn || j < k);
  return v < w || (v == w && j < k);
}

template <typename T>
__global__ void __launch_bounds__(KM_THREADS)
streamkmeans_pass(T* __restrict__ Z, unsigned char* __restrict__ mask, T* __restrict__ counts,
                  const T* __restrict__ X, int B, int Mc, int D, int cap, T r2) {
  __shared__ T s_val[2][KM_WARPS];
  __shared__ int s_idx[2][KM_WARPS];
  __shared__ int s_free[2][KM_WARPS];
  __shared__ int s_count[KM_WARPS];
  const size_t l = blockIdx.x;
  Z += l * Mc * (size_t)D;
  mask += l * Mc;
  counts += l * Mc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T inf = Rn<T>::inf();
  // the active count and the first inactive slot, the same in every thread
  int n = 0, first = Mc;
  for (int j = tid; j < Mc; j += KM_THREADS) {
    if (mask[j]) ++n;
    else if (j < first) first = j;
  }
  for (int off = 16; off > 0; off >>= 1) {
    n += __shfl_xor_sync(FULL, n, off);
    first = min(first, __shfl_xor_sync(FULL, first, off));
  }
  if (lane == 0) {
    s_count[warp] = n;
    s_free[0][warp] = first;
  }
  __syncthreads();
  int n_active = 0, first_free = Mc;
  for (int w = 0; w < KM_WARPS; ++w) {
    n_active += s_count[w];
    first_free = min(first_free, s_free[0][w]);
  }
  for (int i = 0; i < B; ++i) {
    const T* x = X + (size_t)i * D;
    const int buf = i & 1;
    T bv = inf;
    int bj = 0x7fffffff;
    for (int j = tid; j < Mc; j += KM_THREADS) {
      T d2 = inf;
      if (mask[j]) {
        const T* z = Z + (size_t)j * D;
        T diff = Rn<T>::sub(z[0], x[0]);
        d2 = Rn<T>::mul(diff, diff);
        for (int d = 1; d < D; ++d) {
          diff = Rn<T>::sub(z[d], x[d]);
          d2 = Rn<T>::add(d2, Rn<T>::mul(diff, diff));
        }
      }
      if (before(d2, j, bv, bj)) {
        bv = d2;
        bj = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_xor_sync(FULL, bv, off);
      const int oj = __shfl_xor_sync(FULL, bj, off);
      if (before(ov, oj, bv, bj)) {
        bv = ov;
        bj = oj;
      }
    }
    if (lane == 0) {
      s_val[buf][warp] = bv;
      s_idx[buf][warp] = bj;
    }
    __syncthreads();
    bv = s_val[buf][0];
    bj = s_idx[buf][0];
    for (int w = 1; w < KM_WARPS; ++w)
      if (before(s_val[buf][w], s_idx[buf][w], bv, bj)) {
        bv = s_val[buf][w];
        bj = s_idx[buf][w];
      }
    if (bv > r2 && n_active < cap && first_free < Mc) {  // open the first inactive slot
      const int slot = first_free;
      if (slot % KM_THREADS == tid) {
        T* z = Z + (size_t)slot * D;
        for (int d = 0; d < D; ++d) z[d] = x[d];
        mask[slot] = 1;
        counts[slot] = T(1);
      }
      ++n_active;
      int f = Mc;  // the next first inactive slot, from the owners' masks
      for (int j = tid; j < Mc; j += KM_THREADS)
        if (!mask[j] && j < f) f = j;
      for (int off = 16; off > 0; off >>= 1) f = min(f, __shfl_xor_sync(FULL, f, off));
      if (lane == 0) s_free[1][warp] = f;
      __syncthreads();
      first_free = Mc;
      for (int w = 0; w < KM_WARPS; ++w) first_free = min(first_free, s_free[1][w]);
      __syncthreads();  // s_free[1] is rewritten at the next opening
    } else if (bj % KM_THREADS == tid) {  // the nearest centre absorbs the point
      const T cj = Rn<T>::add(counts[bj], T(1));
      T* z = Z + (size_t)bj * D;
      for (int d = 0; d < D; ++d) z[d] = Rn<T>::add(z[d], Rn<T>::div(Rn<T>::sub(x[d], z[d]), cj));
      counts[bj] = cj;
    }
  }
}

template <typename T>
int launch_oips(const void* g_z, const void* g_x, const void* kx, const void* kd, const void* mask,
                void* row_of_slot, void* max_z, int L, int B, int Mc, double rho, cudaStream_t st) {
  const size_t smem = ((Mc * sizeof(int) + 15) / 16) * 16 + (size_t)Mc * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(oips_accept<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  oips_accept<T><<<L, OIPS_THREADS, smem, st>>>(
      static_cast<const T*>(g_z), static_cast<const T*>(g_x), static_cast<const T*>(kx), static_cast<const T*>(kd),
      static_cast<const unsigned char*>(mask), static_cast<long long*>(row_of_slot), static_cast<T*>(max_z), B, Mc,
      static_cast<T>(rho));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_streamkmeans(void* Z, void* mask, void* counts, const void* X, int L, int B, int Mc, int D, int cap,
                        double r2, cudaStream_t st) {
  streamkmeans_pass<T><<<L, KM_THREADS, 0, st>>>(static_cast<T*>(Z), static_cast<unsigned char*>(mask),
                                                  static_cast<T*>(counts), static_cast<const T*>(X), B, Mc, D, cap,
                                                  static_cast<T>(r2));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// OIPS's accept walk for L latents.  Device pointers to contiguous arrays
// of float32 (f64 = 0) or float64 (f64 = 1): g_z [L, B, Mc] = k(X, Z),
// g_x [L, B, B] = k(X, X), kx [L, B] = k(x, x), kd [L, Mc] = k(z, z) as
// the batch starts; mask [L, Mc] of bytes 0/1 (torch.bool); row_of_slot
// [L, Mc] int64, written: the batch row each slot takes, -1 where none;
// max_z [L, B] scratch of the dtype.  L, B, Mc >= 1.  Returns the CUDA error
// of the launch.
int agp_oips_accept(const void* g_z, const void* g_x, const void* kx, const void* kd, const void* mask,
                    void* row_of_slot, void* max_z, int L, int B, int Mc, double rho, int f64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L < 1 || B < 1 || Mc < 1) return (int)cudaErrorInvalidValue;
  return f64 ? launch_oips<double>(g_z, g_x, kx, kd, mask, row_of_slot, max_z, L, B, Mc, rho, st)
             : launch_oips<float>(g_z, g_x, kx, kd, mask, row_of_slot, max_z, L, B, Mc, rho, st);
}

// StreamKmeans' pass for L latents, in place: Z [L, Mc, D], mask [L, Mc]
// (bytes 0/1), counts [L, Mc] of the dtype, X [B, D] (every latent's
// batch), float32 (f64 = 0) or float64 (f64 = 1), contiguous; at most cap
// active centres.  L, B, Mc, D >= 1.  Returns the CUDA error of the launch.
int agp_streamkmeans_pass(void* Z, void* mask, void* counts, const void* X, int L, int B, int Mc, int D, int cap,
                          double r2, int f64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L < 1 || B < 1 || Mc < 1 || D < 1) return (int)cudaErrorInvalidValue;
  return f64 ? launch_streamkmeans<double>(Z, mask, counts, X, L, B, Mc, D, cap, r2, st)
             : launch_streamkmeans<float>(Z, mask, counts, X, L, B, Mc, D, cap, r2, st);
}

}  // extern "C"
