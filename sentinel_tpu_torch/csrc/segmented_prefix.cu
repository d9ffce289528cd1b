// Segmented exclusive prefix over a micro-batch, for Hopper (sm_90a).
//
// Replaces the TPU kernel sentinel_tpu/ops/pallas_prefix.py
// (_make_kernel, launched by prefix_pallas / prefix_pallas_multi). For
// each row i of each of K (ids, values) pairs it computes
//   prefix[k, i, :] = sum of values[k, j, :] over j < i, ids[k, j] == ids[k, i]
//   is_first[k, i]  = no such j exists
// Ids are compared by equality only: negative ids form their own shared
// segment, exactly as in the JAX forms.
//
// What bounds it on this card. The function's least work is an
// O(N log N) sort and scan over K*N*(4 + 8M + 1) bytes of input and
// output, so the function is bound by bytes: about 0.15 us at N = 8192,
// K = 3, M = 2. This kernel does not reach that bound, by design: it
// spends N(N-1)/2 * K compare-and-add pairs, (M+1) adds each, on the
// lower triangle, so it is bound by its own fp32/int32 issue rate, which
// is hundreds of times the function's bound at N = 2048..8192.
//
// What the design does about it (a simple kernel that is exact first):
//   * grid (ceil(N/128), K), 128 threads, one row per thread; one launch
//     covers all K pairs that share N and M (the flow sweep's three row
//     spaces) instead of the Pallas version's K launches;
//   * each block walks the column tiles up to its own diagonal only — the
//     Pallas kernel visits every tile — which halves the work;
//   * each tile's ids and values are staged once in shared memory and read
//     by all 128 threads as broadcasts (every thread reads the same j);
//   * the M sums live in registers (M is a template parameter, 1 or 2:
//     the column counts of the models' sweeps) and the earlier-count is
//     an int, so there is no padding column, no padding sentinel and no
//     mask matrix: a thread checks j < i and j < N.
// An O(N log N) design that reaches the bytes bound is later work.
//
// Exactness: values are integers and each thread adds only equal-id rows,
// so every partial sum is at most the final prefix. Below 2^24 float32
// addition of integers is exact in any order, so the result is bit-equal
// to the plain sort + cumsum version in ops/segment.py.
//
// Build (ops/prefix_cuda.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// The launcher is a plain C function bound with ctypes; it takes device
// pointers and the stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // rows per block = threads per block = tile width

template <int M>
__global__ void __launch_bounds__(kRows)
segmented_prefix_kernel(const int32_t* __restrict__ ids,
                        const float* __restrict__ vals,
                        float* __restrict__ prefix,
                        bool* __restrict__ is_first, int n) {
  __shared__ int32_t s_ids[kRows];
  __shared__ float s_vals[kRows * M];

  const int k = blockIdx.y;
  const int32_t* ids_k = ids + static_cast<size_t>(k) * n;
  const float* vals_k = vals + static_cast<size_t>(k) * n * M;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kRows + tid;
  const bool live = i < n;
  const int32_t my_id = live ? ids_k[i] : 0;

  float acc[M];
#pragma unroll
  for (int c = 0; c < M; ++c) acc[c] = 0.0f;
  int earlier = 0;

  for (int t = 0; t <= static_cast<int>(blockIdx.x); ++t) {
    const int j0 = t * kRows;
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
      const int tile_len = min(kRows, n - j0);
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
void launch(const void* ids, const void* vals, void* prefix, void* is_first,
            int n, int k, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, k);
  segmented_prefix_kernel<M><<<grid, kRows, 0, stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(vals),
      static_cast<float*>(prefix), static_cast<bool*>(is_first), n);
}

}  // namespace

// ids int32[K, N], vals float32[K, N, M], prefix float32[K, N, M],
// is_first bool[K, N] with M in {1, 2}; all contiguous on the current device.
extern "C" int sp_segmented_prefix(const void* ids, const void* vals,
                                   void* prefix, void* is_first, int n,
                                   int k, int m, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: launch<1>(ids, vals, prefix, is_first, n, k, s); break;
    case 2: launch<2>(ids, vals, prefix, is_first, n, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
