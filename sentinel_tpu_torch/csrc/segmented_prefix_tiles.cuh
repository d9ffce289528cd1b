// Tile-walk segmented exclusive prefix: the large-N path of
// segmented_prefix.cu, chosen by N alone for N above the single-block
// capacity of the block radix sort.
//
// Same contract as the block-sort kernel. Grid (ceil(N/128), K), 128
// threads, one row per thread: each block walks the column tiles up to its
// own diagonal, staging each tile's ids and values in shared memory, and
// sums the values of earlier equal-id rows in registers (M sums and an int
// earlier-count). That is N(N-1)/2 * K compare-and-adds, so its time grows
// with N/128, the tiles the last block walks one after another. A
// multi-block sort path for large N is later work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 128;  // rows per block = threads = tile width

template <int M>
__global__ void __launch_bounds__(kTileRows)
segmented_prefix_tiles_kernel(const int32_t* __restrict__ ids,
                              const float* __restrict__ vals,
                              float* __restrict__ prefix,
                              bool* __restrict__ is_first, int n) {
  __shared__ int32_t s_ids[kTileRows];
  __shared__ float s_vals[kTileRows * M];

  const int k = blockIdx.y;
  const int32_t* ids_k = ids + static_cast<size_t>(k) * n;
  const float* vals_k = vals + static_cast<size_t>(k) * n * M;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kTileRows + tid;
  const bool live = i < n;
  const int32_t my_id = live ? ids_k[i] : 0;

  float acc[M];
#pragma unroll
  for (int c = 0; c < M; ++c) acc[c] = 0.0f;
  int earlier = 0;

  for (int t = 0; t <= static_cast<int>(blockIdx.x); ++t) {
    const int j0 = t * kTileRows;
    const int jl = j0 + tid;
    __syncthreads();  // the previous tile has been consumed
    if (jl < n) {
      s_ids[tid] = ids_k[jl];
#pragma unroll
      for (int c = 0; c < M; ++c)
        s_vals[tid * M + c] = vals_k[static_cast<size_t>(jl) * M + c];
    }
    __syncthreads();
    if (live) {
      // Columns j = j0 + jj with j < i and j < n. On the diagonal tile
      // j0 + jj < i is jj < tid; below it every column is earlier.
      const int tile_len = min(kTileRows, n - j0);
      const int lim = (t == static_cast<int>(blockIdx.x)) ? tid : tile_len;
      for (int jj = 0; jj < lim; ++jj) {
        if (s_ids[jj] == my_id) {
          ++earlier;
#pragma unroll
          for (int c = 0; c < M; ++c) acc[c] += s_vals[jj * M + c];
        }
      }
    }
  }

  if (live) {
    float* out = prefix + (static_cast<size_t>(k) * n + i) * M;
#pragma unroll
    for (int c = 0; c < M; ++c) out[c] = acc[c];
    is_first[static_cast<size_t>(k) * n + i] = (earlier == 0);
  }
}

template <int M>
cudaError_t launch_tiles(const void* ids, const void* vals, void* prefix,
                         void* is_first, int n, int k,
                         cudaStream_t stream) {
  const dim3 grid((n + kTileRows - 1) / kTileRows, k);
  auto kernel = segmented_prefix_tiles_kernel<M>;
  kernel<<<grid, kTileRows, 0, stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(vals),
      static_cast<float*>(prefix), static_cast<bool*>(is_first), n);
  return cudaGetLastError();
}

}  // namespace
