// Host-side native components of agp_tpu_torch: a copy of the JAX package's
// native/agp_native.cpp (the same functions, the same arithmetic), so that
// the port builds and loads its own.  The port's device-side tier is its
// CUDA kernels (agp_tpu_torch/csrc/*.cu); this file is the HOST-side tier:
// setup-time algorithms with data-dependent control flow that numpy
// handles poorly at large N -- inducing-point selection over many rows.
//
//   * kmeans_lloyd: OpenMP Lloyd iterations (k-means inducing init,
//     the InducingPoints.KmeansAlg equivalent)
//   * oips_select: sequential online-inducing-point selection (accept a
//     point when its max RBF correlation to the accepted set < rho); the
//     accept rule is inherently sequential, so a tight C++ loop beats any
//     vectorized-batch approximation.
//
// Built with: g++ -O3 -march=native -fopenmp -shared -fPIC
// Loaded via ctypes (agp_tpu_torch/utils/native.py), which falls back to
// the numpy versions of inducing/algorithms.py without a compiler.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Lloyd k-means: X [n, d] row-major, C [k, d] in/out (pre-seeded), assign [n]
void kmeans_lloyd(const double* X, int64_t n, int64_t d, double* C, int64_t k,
                  int32_t n_iters, int32_t* assign) {
  std::vector<double> sums(k * d);
  std::vector<int64_t> counts(k);
  for (int32_t it = 0; it < n_iters; ++it) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      double best = 1e300;
      int32_t bj = 0;
      for (int64_t j = 0; j < k; ++j) {
        double acc = 0.0;
        const double* xi = X + i * d;
        const double* cj = C + j * d;
        for (int64_t t = 0; t < d; ++t) {
          double diff = xi[t] - cj[t];
          acc += diff * diff;
        }
        if (acc < best) { best = acc; bj = (int32_t)j; }
      }
      assign[i] = bj;
    }
    std::memset(sums.data(), 0, sizeof(double) * k * d);
    std::memset(counts.data(), 0, sizeof(int64_t) * k);
    for (int64_t i = 0; i < n; ++i) {
      int32_t j = assign[i];
      counts[j]++;
      const double* xi = X + i * d;
      double* sj = sums.data() + (int64_t)j * d;
      for (int64_t t = 0; t < d; ++t) sj[t] += xi[t];
    }
    for (int64_t j = 0; j < k; ++j) {
      if (counts[j] > 0) {
        for (int64_t t = 0; t < d; ++t) C[j * d + t] = sums[j * d + t] / counts[j];
      }
    }
  }
}

// OIPS: returns number of accepted points; Z [capacity, d] out.
// correlation = exp(-0.5 * |x - z|^2 / ls^2)  (RBF, unit-variance -- the
// acceptance rule only depends on the correlation, not the scale)
int64_t oips_select(const double* X, int64_t n, int64_t d, double rho,
                    double lengthscale, int64_t capacity, double* Z) {
  if (n == 0 || capacity == 0) return 0;
  int64_t m = 0;
  const double inv2l2 = 0.5 / (lengthscale * lengthscale);
  const double log_rho = std::log(rho);
  // accept x iff max_j exp(-|x-z_j|^2 * inv2l2) < rho
  //          iff min_j |x-z_j|^2 * inv2l2 > -log(rho)
  const double thresh = -log_rho;
  std::memcpy(Z, X, sizeof(double) * d);
  m = 1;
  for (int64_t i = 1; i < n && m < capacity; ++i) {
    const double* xi = X + i * d;
    double min_d2 = 1e300;
#pragma omp parallel for reduction(min : min_d2) schedule(static)
    for (int64_t j = 0; j < m; ++j) {
      double acc = 0.0;
      const double* zj = Z + j * d;
      for (int64_t t = 0; t < d; ++t) {
        double diff = xi[t] - zj[t];
        acc += diff * diff;
      }
      if (acc < min_d2) min_d2 = acc;
    }
    if (min_d2 * inv2l2 > thresh) {
      std::memcpy(Z + m * d, xi, sizeof(double) * d);
      ++m;
    }
  }
  return m;
}

}  // extern "C"
