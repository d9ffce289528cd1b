// Segmented exclusive prefix over a micro-batch, for Hopper (sm_90a): an
// in-shared-memory block radix sort and segmented scan.
//
// Replaces the TPU kernel sentinel_tpu/ops/pallas_prefix.py:40
// (_make_kernel), launched by prefix_pallas (:65, pl.pallas_call at :82)
// and prefix_pallas_multi (:102, one launch per pair). For each row i of
// each of K (ids, values) pairs it computes
//   prefix[k, i, :] = sum of values[k, j, :] over j < i, ids[k, j] == ids[k, i]
//   is_first[k, i]  = no such j exists
// Ids are compared by equality only, so every int32 is just a key
// (INT32_MIN, -1 and INT32_MAX included) and negative ids form their own
// segments, exactly as in the JAX forms.
//
// What bounds it on this card. The function's least work is a stable
// grouping by id plus a segmented scan: O(N log N) operations on
// K*N*(4 + 8M + 1) bytes moved once, so it is bound by bytes -- 0.15 us at
// N = 8192, K = 3, M = 2 over 3.35 TB/s, below the card's launch floor of
// one to two microseconds. What stands between this kernel and that floor
// is the work of one SM on one pair: the integer instructions of the
// ranking and the scan, and one SM's share of the memory bandwidth.
//
// What the design does about it:
//   * one thread block per pair, grid K: one launch for all K pairs, each
//     pair on its own SM. The whole pair -- keys, 16-bit arrival positions
//     and the M value columns -- is loaded once into dynamic shared memory
//     (the ids by coalesced loads, the values by 16-byte cp.async issued
//     once the keys are in, so that they arrive during the sort) and
//     touches device memory again only as the result;
//   * a stable LSB radix sort of (key, position), 8 bits a pass, between
//     two ping-pong buffers in shared memory. Keys are the raw 32-bit
//     patterns plus one (mod 2^32): a bijection, so equality is kept; it
//     maps the -1 of unused rows to 0, so row ids below 2^16 need two
//     passes. A pass whose digit is the same in every key is skipped: its
//     stable sort is the identity;
//   * a warp ranks its keys by the popcount of the lower lanes with the
//     same digit against its own 256 digit counters. The lanes with the
//     same digit come from __match_any_sync while the warp's keys hold
//     few distinct digits, else from eight ballots, one per digit bit.
//     One block-wide exclusive scan of all counters in (digit, warp)
//     order places every key. Each warp owns a contiguous run of keys, so
//     the sort is stable. Keys and positions sit one spare word in 32
//     apart, so the bucket-spaced scatter spreads over the banks;
//   * a segmented exclusive scan of the M columns over the sorted order:
//     IPT consecutive keys per thread, then warp shuffles, then one warp
//     scan of the warp carries, reset at segment heads. is_first is the
//     segment head: the sort is stable, so the head is the first arrival;
//   * the results are scattered back to arrival order in shared memory
//     (the prefix over the values it was computed from) and written to
//     device memory in coalesced 16-byte stores.
//
// Single-block capacity: N <= 8192 for M = 1 and for M = 2 (1024 threads
// x 8 keys; 16-bit positions would allow 65536). Shared memory is not what
// binds: at N = 8192 a block takes 168,448 B for M = 1 and 201,344 B for
// M = 2 of the 232,448 B an H100 block may use. Above 8192 the launcher
// takes, by N alone, the tile-walk kernel of segmented_prefix_tiles.cuh
// (O(N^2) work). A multi-block sort path for large N (a thread-block
// cluster over distributed shared memory, or global-memory passes) is
// later work.
//
// Exactness: values are integers and the scan only ever adds values of
// one segment; every partial sum that reaches a row's result is a run of
// that row's segment ending before the row, so it is at most the row's
// prefix. Below 2^24 float32 addition of integers is exact in any order,
// so the result is bit-equal to the plain version in ops/segment.py
// wherever each prefix is below 2^24.
//
// Build (ops/prefix_cuda.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC segmented_prefix.cu
// The launchers are plain C functions bound with ctypes; they take device
// pointers and the stream, do not synchronise or allocate (so they can be
// captured in a CUDA graph), and return the first CUDA error: the shared
// memory attribute's, then the launch's.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "segmented_prefix_tiles.cuh"

extern __shared__ __align__(16) unsigned char sp_smem[];

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 32;
constexpr int kMaxItems = 8;  // keys per thread
constexpr int kBlockCapacity = kMaxWarps * kLanes * kMaxItems;  // 8192
constexpr int kRadixBits = 8;
constexpr int kDigits = 1 << kRadixBits;
// Each warp's digit counters, padded to 257 words: while ranking, the
// lanes of a warp hit banks d % 32; the scan's (digit, warp) walk hits
// banks (w + d) % 32, which is conflict-free at 32 warps.
constexpr int kCounterStride = kDigits + 1;
// 256 counters per warp, scanned by the warp's 32 threads.
constexpr int kCountersPerThread = kDigits / kLanes;
constexpr unsigned kFull = 0xffffffffu;

// What sp_segmented_prefix reports it launched.
constexpr int kPathNone = -1;
constexpr int kPathBlockSort = 0;
constexpr int kPathTileWalk = 1;

// Padded shared-memory indices: one spare word after every 32 keys, two
// spare halfwords after every 32 positions. A digit bucket holds about 32
// keys, so without them the scatter's targets 32 d + w, and the blocked
// scan's stride of 8 keys, would land in one bank.
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }
__device__ __forceinline__ int pad16(int i) { return i + ((i >> 5) << 1); }
__host__ __device__ constexpr int round_up(int x, int to) {
  return (x + to - 1) / to * to;
}
__host__ __device__ constexpr int key_stride(int rows) {
  return round_up(rows + rows / 32, 4);
}
__host__ __device__ constexpr int pos_stride(int rows) {
  return round_up(rows + rows / 16, 8);
}
__host__ __device__ constexpr int vals_words(int rows, int m) {
  return round_up(rows * m, 4);
}

// Shared memory of one block, with rows = threads * IPT >= n, every
// region a multiple of 16 bytes:
//   keys  u32[2][key_stride]  ping-pong sort buffers (padded)
//   pos   u16[2][pos_stride]  arrival positions riding with the keys
//   vals  f32[rows * M]       values in arrival order; the prefix
//                             overwrites them before the copy out
//   count u32[warps * 257]    per-warp digit counters, then offsets
//   warp  u32[32], wflag u32[32], wsum f32[32 * M]   block-scan scratch
// After the sort, the free pos buffer holds is_first as plain bytes.
constexpr size_t block_smem_bytes(int rows, int warps, int m) {
  return static_cast<size_t>(4) * 2 * key_stride(rows) +
         static_cast<size_t>(2) * 2 * pos_stride(rows) +
         static_cast<size_t>(4) * vals_words(rows, m) +
         static_cast<size_t>(warps) * kCounterStride * 4 +
         static_cast<size_t>(kLanes) * 4 * (2 + m);
}

// Exclusive sum over the block of one value per thread. Every thread
// calls it; s_warp may be written again only after a later __syncthreads.
__device__ __forceinline__ uint32_t block_exclusive_sum(
    uint32_t x, uint32_t* s_warp, int lane, int warp, int warps) {
  uint32_t incl = x;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == kLanes - 1) s_warp[warp] = incl;
  __syncthreads();
  uint32_t w = lane < warps ? s_warp[lane] : 0u;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, w, off);
    if (lane >= off) w += up;
  }
  const uint32_t before = __shfl_sync(kFull, w, warp > 0 ? warp - 1 : 0);
  return (warp > 0 ? before : 0u) + incl - x;
}

// The live lanes whose digit equals this lane's. __match_any_sync takes
// the longer the more distinct digits the warp holds, while the eight
// ballots below (one per digit bit) cost the same for any digits. So a
// warp takes the hardware match while the first round of its latest pass
// held at most kFewDigits distinct digits, and the ballots otherwise.
// Such warps are common on the engine's path, where a request with no
// origin or no parameter rule brings the id -1: with the ballots alone
// the prefix launches of a main-path round took 21% longer on an H100.
constexpr int kFewDigits = 16;

__device__ __forceinline__ uint32_t match_digit(uint32_t digit, bool live,
                                                bool few) {
  if (few) return __match_any_sync(kFull, live ? digit : kDigits);
  uint32_t peers = __ballot_sync(kFull, live);
#pragma unroll
  for (int b = 0; b < kRadixBits; ++b) {
    const uint32_t ones = __ballot_sync(kFull, (digit >> b) & 1u);
    peers &= ((digit >> b) & 1u) ? ones : ~ones;
  }
  return peers;
}

// Inclusive segmented scan over a warp of (head seen, sums): a lane's sums
// take the earlier lanes' only while no head lies between, so only values
// of one segment are ever added.
template <int M>
__device__ __forceinline__ void warp_segmented_scan(uint32_t& head,
                                                    float (&sum)[M],
                                                    int lane) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const uint32_t head_up = __shfl_up_sync(kFull, head, off);
    float up[M];
#pragma unroll
    for (int c = 0; c < M; ++c) up[c] = __shfl_up_sync(kFull, sum[c], off);
    if (lane >= off) {
      if (!head) {
#pragma unroll
        for (int c = 0; c < M; ++c) sum[c] += up[c];
      }
      head |= head_up;
    }
  }
}

// One warp zeroes its 257 digit counters.
__device__ __forceinline__ void clear_counters(uint32_t* count, int lane) {
#pragma unroll
  for (int j = 0; j < kDigits / kLanes; ++j) count[lane + j * kLanes] = 0;
  if (lane == 0) count[kDigits] = 0;
}

// Asynchronous copy of `count` 4-byte words into shared memory (one
// commit group): 16-byte cp.async where the source is aligned, 4-byte
// copies for the rest.
template <typename T>
__device__ __forceinline__ void copy_in_async(T* dst, const T* src,
                                              int count, int tid,
                                              int threads) {
  static_assert(sizeof(T) == 4, "4-byte words");
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = count / 4 * 4;
    for (int i = tid * 4; i < done; i += threads * 4)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  }
  for (int i = done + tid; i < count; i += threads)
    __pipeline_memcpy_async(dst + i, src + i, 4);
  __pipeline_commit();
}

// Coalesced copy of `count` floats out of shared memory, in 16-byte
// stores where the target is aligned.
__device__ __forceinline__ void copy_out(float* dst, const float* src,
                                         int count, int tid, int threads) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    done = count / 4 * 4;
    for (int i = tid * 4; i < done; i += threads * 4)
      *reinterpret_cast<float4*>(dst + i) =
          *reinterpret_cast<const float4*>(src + i);
  }
  for (int i = done + tid; i < count; i += threads) dst[i] = src[i];
}

// The M values of arrival row p in shared memory (one 8-byte access for
// M = 2).
template <int M>
__device__ __forceinline__ void load_values(const float* s_vals, int p,
                                            float (&out)[M]) {
  if constexpr (M == 2) {
    const float2 x = reinterpret_cast<const float2*>(s_vals)[p];
    out[0] = x.x;
    out[1] = x.y;
  } else {
#pragma unroll
    for (int c = 0; c < M; ++c) out[c] = s_vals[p * M + c];
  }
}

template <int M>
__device__ __forceinline__ void store_values(float* s_vals, int p,
                                             const float (&in)[M]) {
  if constexpr (M == 2) {
    reinterpret_cast<float2*>(s_vals)[p] = make_float2(in[0], in[1]);
  } else {
#pragma unroll
    for (int c = 0; c < M; ++c) s_vals[p * M + c] = in[c];
  }
}

// Coalesced copy of `count` bytes out of shared memory (16-byte aligned).
__device__ __forceinline__ void copy_out_bytes(uint8_t* dst,
                                               const uint8_t* src, int count,
                                               int tid, int threads) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    done = count / 16 * 16;
    for (int i = tid * 16; i < done; i += threads * 16)
      *reinterpret_cast<uint4*>(dst + i) =
          *reinterpret_cast<const uint4*>(src + i);
  }
  for (int i = done + tid; i < count; i += threads) dst[i] = src[i];
}

template <int M, int IPT>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
segmented_prefix_block_kernel(const int32_t* __restrict__ ids,
                              const float* __restrict__ vals,
                              float* __restrict__ prefix,
                              bool* __restrict__ is_first, int n) {
  const int tid = threadIdx.x;
  const int lane = tid & (kLanes - 1);
  const int warp = tid / kLanes;
  const int threads = blockDim.x;
  const int warps = threads / kLanes;
  const int rows = threads * IPT;

  const int kstride = key_stride(rows);
  const int pstride = pos_stride(rows);
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(sp_smem);
  uint16_t* s_pos = reinterpret_cast<uint16_t*>(s_keys + 2 * kstride);
  float* s_vals = reinterpret_cast<float*>(s_pos + 2 * pstride);
  uint32_t* s_count =
      reinterpret_cast<uint32_t*>(s_vals + vals_words(rows, M));
  uint32_t* s_warp = s_count + warps * kCounterStride;
  uint32_t* s_wflag = s_warp + kLanes;
  float* s_wsum = reinterpret_cast<float*>(s_wflag + kLanes);

  const size_t k = blockIdx.x;
  const int32_t* ids_k = ids + k * n;
  const float* vals_k = vals + k * n * M;
  float* prefix_k = prefix + k * n * M;
  uint8_t* first_k = reinterpret_cast<uint8_t*>(is_first) + k * n;

  // 1. Ids into registers (coalesced loads, all in flight at once); the
  //    values follow by cp.async once the keys are in, and arrive during
  //    the sort.
  uint32_t raw[IPT];
#pragma unroll
  for (int r = 0; r < IPT; ++r) {
    const int i = tid + r * threads;
    raw[r] = i < n ? static_cast<uint32_t>(__ldg(ids_k + i)) : 0u;
  }
  uint32_t* my_count = s_count + warp * kCounterStride;
  clear_counters(my_count, lane);

  // 2. Keys (id + 1 mod 2^32) and positions into the padded first buffer;
  //    `diff` gathers the bits in which some key differs from the first.
  const uint32_t key0 = static_cast<uint32_t>(__ldg(ids_k)) + 1u;
  uint32_t diff = 0;
#pragma unroll
  for (int r = 0; r < IPT; ++r) {
    const int i = tid + r * threads;
    if (i < n) {
      const uint32_t key = raw[r] + 1u;
      s_keys[pad32(i)] = key;
      s_pos[pad16(i)] = static_cast<uint16_t>(i);
      diff |= key ^ key0;
    }
  }
  diff = __reduce_or_sync(kFull, diff);
  if (lane == 0) s_warp[warp] = diff;
  __syncthreads();
  diff = __reduce_or_sync(kFull, lane < warps ? s_warp[lane] : 0u);
  copy_in_async(s_vals, vals_k, n * M, tid, threads);

  // 3. Stable LSB radix sort of (key, position). Warp w owns keys
  //    [w * 32 * IPT, (w + 1) * 32 * IPT); item `it` of lane l is key
  //    w * 32 * IPT + it * 32 + l, so (item, lane) order is key order.
  int cur = 0;
  const int e0 = warp * kLanes * IPT + lane;
  const uint32_t lower_lanes = (1u << lane) - 1u;
  const int log2_warps = __ffs(warps) - 1;
  bool few = false;  // see match_digit
  for (int shift = 0; shift < 32; shift += kRadixBits) {
    if (((diff >> shift) & (kDigits - 1)) == 0) continue;  // identity pass
    const uint32_t* src_key = s_keys + cur * kstride;
    const uint16_t* src_pos = s_pos + cur * pstride;
    uint32_t* dst_key = s_keys + (cur ^ 1) * kstride;
    uint16_t* dst_pos = s_pos + (cur ^ 1) * pstride;

    // Rank each key among the equal digits of its warp before it. Item
    // `it` of this lane sits 33 words (34 halfwords) after item 0.
    const uint32_t* key_in = src_key + pad32(e0);
    const uint16_t* pos_in = src_pos + pad16(e0);
    uint32_t key[IPT];
    uint32_t rank[IPT];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const bool live = e0 + it * kLanes < n;
      key[it] = live ? key_in[it * (kLanes + 1)] : 0u;
      // Rows past n match no lane and are not counted.
      const uint32_t digit = (key[it] >> shift) & (kDigits - 1);
      const uint32_t peers = match_digit(digit, live, few);
      const uint32_t below = __popc(peers & lower_lanes);
      // The group's highest lane adds the group's size to the count.
      const int last = 31 - __clz(peers);
      if (it == 0)
        few = __popc(__ballot_sync(kFull, live && lane == last)) <= kFewDigits;
      uint32_t base = 0;
      if (live && lane == last) {
        base = my_count[digit];
        my_count[digit] = base + below + 1;
      }
      rank[it] = __shfl_sync(kFull, base, last) + below;
      __syncwarp();
    }
    __syncthreads();

    // Exclusive scan of the counters in (digit, warp) order: each entry
    // becomes the first place of its warp's keys with that digit.
    uint32_t count[kCountersPerThread];
    uint32_t total = 0;
#pragma unroll
    for (int j = 0; j < kCountersPerThread; ++j) {
      const int e = tid * kCountersPerThread + j;
      count[j] =
          s_count[(e & (warps - 1)) * kCounterStride + (e >> log2_warps)];
      total += count[j];
    }
    uint32_t run = block_exclusive_sum(total, s_warp, lane, warp, warps);
#pragma unroll
    for (int j = 0; j < kCountersPerThread; ++j) {
      const int e = tid * kCountersPerThread + j;
      s_count[(e & (warps - 1)) * kCounterStride + (e >> log2_warps)] = run;
      run += count[j];
    }
    __syncthreads();

#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int e = e0 + it * kLanes;
      if (e < n) {
        const int at = static_cast<int>(
            my_count[(key[it] >> shift) & (kDigits - 1)] + rank[it]);
        dst_key[pad32(at)] = key[it];
        dst_pos[pad16(at)] = pos_in[it * (kLanes + 2)];
      }
    }
    // Only this warp reads its counters in the scatter: it zeroes them
    // for the next pass's ranking.
    __syncwarp();
    clear_counters(my_count, lane);
    __syncthreads();
    cur ^= 1;
  }

  // 4. Segmented exclusive scan over the sorted order; thread t owns the
  //    sorted rows [t * IPT, (t + 1) * IPT).
  __pipeline_wait_prior(0);
  __syncthreads();
  const uint32_t* skey = s_keys + cur * kstride;
  const uint16_t* spos = s_pos + cur * pstride;
  uint8_t* s_first = reinterpret_cast<uint8_t*>(s_pos + (cur ^ 1) * pstride);
  const int j0 = tid * IPT;  // j0 .. j0 + IPT - 1 share a 32-row block
  const uint32_t* key_row = skey + pad32(j0);
  const uint16_t* pos_row = spos + pad16(j0);
  float v[IPT][M];
  uint32_t heads = 0;
  uint32_t head = 0;   // a segment head among this thread's rows
  float sum[M];        // values from this thread's last head on
#pragma unroll
  for (int c = 0; c < M; ++c) sum[c] = 0.0f;
  uint32_t prev = j0 > 0 ? skey[pad32(j0 - 1)] : ~skey[0];
#pragma unroll
  for (int it = 0; it < IPT; ++it) {
#pragma unroll
    for (int c = 0; c < M; ++c) v[it][c] = 0.0f;
    if (j0 + it < n) {
      const uint32_t key = key_row[it];
      if (key != prev) {
        heads |= 1u << it;
        head = 1;
#pragma unroll
        for (int c = 0; c < M; ++c) sum[c] = 0.0f;
      }
      prev = key;
      load_values<M>(s_vals, pos_row[it], v[it]);
#pragma unroll
      for (int c = 0; c < M; ++c) sum[c] += v[it][c];
    }
  }
  // Carry into this thread: the segmented sum of the lanes before it in
  // its warp, continued from the warps before it.
  warp_segmented_scan<M>(head, sum, lane);
  uint32_t head_before = __shfl_up_sync(kFull, head, 1);
  float before[M];
#pragma unroll
  for (int c = 0; c < M; ++c) before[c] = __shfl_up_sync(kFull, sum[c], 1);
  if (lane == 0) {
    head_before = 0;
#pragma unroll
    for (int c = 0; c < M; ++c) before[c] = 0.0f;
  }
  if (lane == kLanes - 1) {
    s_wflag[warp] = head;
#pragma unroll
    for (int c = 0; c < M; ++c) s_wsum[warp * M + c] = sum[c];
  }
  __syncthreads();
  if (warp == 0) {
    // The carry into warp w: the segmented sum of warps 0 .. w - 1.
    uint32_t warp_head = lane < warps ? s_wflag[lane] : 0u;
    float warp_sum[M];
#pragma unroll
    for (int c = 0; c < M; ++c)
      warp_sum[c] = lane < warps ? s_wsum[lane * M + c] : 0.0f;
    warp_segmented_scan<M>(warp_head, warp_sum, lane);
    __syncwarp();
    if (lane + 1 < warps) {
#pragma unroll
      for (int c = 0; c < M; ++c) s_wsum[(lane + 1) * M + c] = warp_sum[c];
    }
  }
  __syncthreads();
  float acc[M];
#pragma unroll
  for (int c = 0; c < M; ++c) {
    const float carry = warp > 0 ? s_wsum[warp * M + c] : 0.0f;
    acc[c] = head_before ? before[c] : carry + before[c];
  }
#pragma unroll
  for (int it = 0; it < IPT; ++it) {
    if (j0 + it < n) {
      const int p = pos_row[it];
      const uint32_t is_head = (heads >> it) & 1u;
      if (is_head) {
#pragma unroll
        for (int c = 0; c < M; ++c) acc[c] = 0.0f;
      }
      store_values<M>(s_vals, p, acc);
#pragma unroll
      for (int c = 0; c < M; ++c) acc[c] += v[it][c];
      s_first[p] = static_cast<uint8_t>(is_head);
    }
  }
  __syncthreads();

  // 5. Out to device memory in arrival order.
  copy_out(prefix_k, s_vals, n * M, tid, threads);
  copy_out_bytes(first_k, s_first, n, tid, threads);
}

template <int M, int IPT>
cudaError_t launch_block(const void* ids, const void* vals, void* prefix,
                         void* is_first, int n, int k,
                         cudaStream_t stream) {
  auto kernel = segmented_prefix_block_kernel<M, IPT>;
  // Allow this instantiation its largest block once per device (bit d).
  static std::atomic<unsigned long long> allowed{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit == 0 || (allowed.load() & bit) == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(block_smem_bytes(kMaxWarps * kLanes * IPT,
                                          kMaxWarps, M)));
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  int warps = 1;
  while (warps * kLanes * IPT < n) warps *= 2;
  const int threads = warps * kLanes;
  const size_t smem = block_smem_bytes(threads * IPT, warps, M);
  kernel<<<k, threads, smem, stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(vals),
      static_cast<float*>(prefix), static_cast<bool*>(is_first), n);
  return cudaGetLastError();
}

// The path is chosen by N alone: the tile walk above the block's
// capacity, else the block sort with the keys per thread that fill at most
// 16 warps (32 above N = 4096). More warps would buy parallelism but cost
// more in the block-wide counter scan (256 counters a warp per pass).
// *path is set to the path taken.
template <int M>
cudaError_t launch(const void* ids, const void* vals, void* prefix,
                   void* is_first, int n, int k, cudaStream_t stream,
                   int* path) {
  if (n > kBlockCapacity) {
    *path = kPathTileWalk;
    return launch_tiles<M>(ids, vals, prefix, is_first, n, k, stream);
  }
  *path = kPathBlockSort;
  if (n <= kBlockCapacity / 16)
    return launch_block<M, 1>(ids, vals, prefix, is_first, n, k, stream);
  if (n <= kBlockCapacity / 8)
    return launch_block<M, 2>(ids, vals, prefix, is_first, n, k, stream);
  if (n <= kBlockCapacity / 4)
    return launch_block<M, 4>(ids, vals, prefix, is_first, n, k, stream);
  return launch_block<M, kMaxItems>(ids, vals, prefix, is_first, n, k,
                                    stream);
}

}  // namespace

// The largest N the single-block sort takes (for M = 1 and M = 2).
extern "C" int sp_block_capacity() { return kBlockCapacity; }

// ids int32[K, N], vals float32[K, N, M], prefix float32[K, N, M],
// is_first bool[K, N] with M in {1, 2}; all contiguous on the current device.
// *path (host memory) receives the kernel launched: 0 for the block sort,
// 1 for the tile walk, -1 if nothing was launched.
extern "C" int sp_segmented_prefix(const void* ids, const void* vals,
                                   void* prefix, void* is_first, int n,
                                   int k, int m, void* stream, int* path) {
  *path = kPathNone;
  if (n <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1:
      return static_cast<int>(
          launch<1>(ids, vals, prefix, is_first, n, k, s, path));
    case 2:
      return static_cast<int>(
          launch<2>(ids, vals, prefix, is_first, n, k, s, path));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same function through the tile walk at any N: the large-N path,
// callable on its own to compare it with the block sort.
extern "C" int sp_segmented_prefix_tiles(const void* ids, const void* vals,
                                         void* prefix, void* is_first, int n,
                                         int k, int m, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1:
      return static_cast<int>(
          launch_tiles<1>(ids, vals, prefix, is_first, n, k, s));
    case 2:
      return static_cast<int>(
          launch_tiles<2>(ids, vals, prefix, is_first, n, k, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
