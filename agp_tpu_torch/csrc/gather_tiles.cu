// Tile gather for Hopper (sm_90a): kernel 10 of the port.
//
// Replaces: benchmarks/gather_modes.py, gather_row_tiles (body
// _gather_tiles_kernel).  It computes the "block" minibatch draw:
//   out[j tr : (j+1) tr, :] = X[tidx[j] tr : (tidx[j]+1) tr, :]  for j < T,
// each tile a contiguous run of tr D floats of the row-major [N, D] X.
//
// Design, against the TPU kernel:
// * The TPU kernel keeps 64 async DMAs in flight per grid step, with the
//   indices scalar-prefetched to SMEM, and views X as [N D / 128, 128]
//   because Mosaic's DMA slices must be 128-lane aligned (hence its
//   tile_rows D % 128 == 0).  Here there is no such constraint: the copy
//   is a grid-stride loop over the output, 16-byte vectors (float4 loads and
//   stores) when a tile is a whole number of them and both arrays are
//   16-byte aligned, single floats otherwise.  Consecutive threads copy
//   consecutive vectors of a tile, so every access is coalesced.
// * No scalar prefetch: each thread reads its tile's index itself; a
//   tile's threads share it, so after the first read it is a cache hit.
// * Indices out of range are the caller's to avoid, as in the reference:
//   checking them on the host would cost a sync.
//
// What bounds it on an H100: device memory, 2 T tr D 4 bytes moved
// (655,360 at the flagship's B=4096, D=20: ~0.2 us at 3.35 TB/s).  At that
// size the launch itself (a few us) is what it costs.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 4096;

// out[v] = x[tidx[v / tile_len] tile_len + v % tile_len] for v < total, in
// units of V (float4 or float)
template <typename V, typename I>
__global__ void __launch_bounds__(THREADS)
gather_tiles(const V* __restrict__ x, const I* __restrict__ tidx, V* __restrict__ out,
             long long tile_len, long long total) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < total; v += stride) {
    const long long j = v / tile_len;
    out[v] = x[(long long)tidx[j] * tile_len + (v - j * tile_len)];
  }
}

template <typename V, typename I>
int launch(const float* x, const void* tidx, float* out, long long T, long long tile_len,
           cudaStream_t st) {
  const long long total = T * tile_len;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  gather_tiles<V, I><<<(unsigned)blocks, THREADS, 0, st>>>(
      reinterpret_cast<const V*>(x), static_cast<const I*>(tidx), reinterpret_cast<V*>(out),
      tile_len, total);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_index(const float* x, const void* tidx, float* out, long long T, long long tile_words,
                 cudaStream_t st) {
  const bool vec = tile_words % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) return launch<float4, I>(x, tidx, out, T, tile_words / 4, st);
  return launch<float, I>(x, tidx, out, T, tile_words, st);
}

}  // namespace

extern "C" {

// x: device pointer to the contiguous float32 [N, D] array; tidx: T tile
// indices, int32 (index_bytes 4) or int64 (8), each < N / tr; out: the
// float32 [T tr, D] output; tile_words = tr D.  T >= 1.  Returns the CUDA
// error of the launch (cudaErrorInvalidValue for another index width or an
// empty gather).
int agp_gather_row_tiles(const float* x, const void* tidx, int index_bytes, float* out, long long T,
                         long long tile_words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || tile_words < 1) return (int)cudaErrorInvalidValue;
  if (index_bytes == 4) return launch_index<int32_t>(x, tidx, out, T, tile_words, st);
  if (index_bytes == 8) return launch_index<int64_t>(x, tidx, out, T, tile_words, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
