// The token service's serial admission as one CUDA kernel for sm_90a.
//
// Replaces the XLA scan in sentinel_tpu/cluster/token_service.py:136
// (acquire_step, the lax.scan body at :183-206): no Pallas kernel, but the
// plain torch form of a scan is a Python loop of ~10 device ops per
// request, and the wire path fuses up to thousands of requests a batch.
//
// What it computes, for N requests in arrival order: each request sees
// the usage of every EARLIER admitted (OK or SHOULD_WAIT) request of the
// same rule slot, and nothing of other slots:
//
//   x        = base[i] + used[slot]
//   passed   = x * scale[i]                      (returned, rounded)
//   ok       = known[i] && fma(x, scale[i], cnt) <= thr[i]
//   backlog  = waiting[i] + wait[slot]
//   can_wait = known[i] && prio[i] && !ok && backlog + cnt <= ratio * thr[i]
//   used[slot] += cnt if ok or can_wait;  wait[slot] += cnt if can_wait
//
// Rounding is pinned with explicit intrinsics (nvcc contracts a*b+c by
// default): the admission test is ONE fused multiply-add, as XLA's CPU
// backend compiles the reference; every other product and sum rounds on
// its own. The plain form (ops/cluster_acquire.py) computes the same
// roundings, so the two are bit-equal.
//
// Lanes outside the table: slot -1 is unknown (never ok, commits
// nothing); a slot >= num_slots is "known" but reads used = wait = 0 and
// drops its update (the reference's mode="fill" / mode="drop"). Each
// such lane is independent of every other lane.
//
// Design (right first, fast later): one block of 1024 threads, four
// passes split by barriers.
//   1. Lanes outside the table, one thread per lane, each alone.
//   2. A histogram of the in-table lanes by slot, then its exclusive
//      scan: pos[s] is where slot s's run starts.
//   3. A stable grouping by slot: warp 0 walks the lanes 32 at a time in
//      arrival order; __match_any_sync ranks each lane among its warp's
//      lanes of the same slot, and the slot's cursor pos[s] advances by
//      the group's size. Afterwards pos[s] is the end of slot s's run,
//      and the run starts where slot s - 1's ends.
//   4. One thread per slot (strided over num_slots) walks its own run.
// Each slot's run is a dependent chain of its own, so the longest
// same-slot run bounds pass 4; pass 3 is N / 32 dependent warp steps.
// pos lives in shared memory up to kSmemSlots slots, else in the
// caller's scratch; the grouped order is always in the scratch
// (int32[n + num_slots]). Any N, any number of slots.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemSlots = 8192;
constexpr unsigned kFull = 0xffffffffu;

struct Lanes {
  const int* slots;
  const float* counts;
  const float* base;
  const float* thr;
  const float* scale;
  const bool* known;
  const bool* prio;
  const float* waiting;
  bool* ok;
  bool* can_wait;
  float* passed;
};

// One lane against the table values of its slot; returns its outcome
// and updates used / wait as the scan body does.
__device__ __forceinline__ void lane_step(const Lanes& L, int i, float ratio,
                                          float& used, float& wait) {
  const float cnt = L.counts[i];
  const float thr = L.thr[i];
  const float sc = L.scale[i];
  const bool kn = L.known[i];
  const float x = __fadd_rn(L.base[i], used);
  const bool ok = kn && (__fmaf_rn(x, sc, cnt) <= thr);
  const float backlog = __fadd_rn(L.waiting[i], wait);
  const bool cw = kn && L.prio[i] && !ok &&
                  (__fadd_rn(backlog, cnt) <= __fmul_rn(ratio, thr));
  L.ok[i] = ok;
  L.can_wait[i] = cw;
  L.passed[i] = __fmul_rn(x, sc);
  used = __fadd_rn(used, (ok || cw) ? cnt : 0.0f);
  wait = __fadd_rn(wait, cw ? cnt : 0.0f);
}

__device__ __forceinline__ bool in_table(int s, int num_slots) {
  return s >= 0 && s < num_slots;
}

__global__ void __launch_bounds__(kThreads)
acquire_kernel(Lanes L, int n, int num_slots, float ratio, int* scratch) {
  __shared__ int pos_smem[kSmemSlots];
  __shared__ int warp_sums[kWarps];
  __shared__ int carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* order = scratch;
  int* pos = num_slots <= kSmemSlots ? pos_smem : scratch + n;

  // Pass 1: lanes outside the table, each alone.
  for (int i = tid; i < n; i += kThreads) {
    if (!in_table(L.slots[i], num_slots)) {
      float used = 0.0f, wait = 0.0f;
      lane_step(L, i, ratio, used, wait);
    }
  }

  // Pass 2: histogram by slot, then its exclusive scan in chunks of 1024.
  for (int s = tid; s < num_slots; s += kThreads) pos[s] = 0;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const int s = L.slots[i];
    if (in_table(s, num_slots)) atomicAdd(&pos[s], 1);
  }
  __syncthreads();
  for (int s0 = 0; s0 < num_slots; s0 += kThreads) {
    const int s = s0 + tid;
    const int v = s < num_slots ? pos[s] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    if (s < num_slots) {
      pos[s] = carry + (warp ? warp_sums[warp - 1] : 0) + x - v;
    }
    __syncthreads();
    if (tid == 0) carry += warp_sums[kWarps - 1];
    __syncthreads();
  }

  // Pass 3: stable grouping by slot, warp 0 in arrival order.
  if (warp == 0) {
    for (int b = 0; b < n; b += 32) {
      const int i = b + lane;
      const int s = i < n ? L.slots[i] : -1;
      const bool in = i < n && in_table(s, num_slots);
      const unsigned group = __match_any_sync(kFull, in ? s : -1);
      const int rank = __popc(group & ((1u << lane) - 1u));
      const int at = in ? pos[s] : 0;
      __syncwarp();
      if (in) {
        order[at + rank] = i;
        if (rank == 0) pos[s] = at + __popc(group);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // Pass 4: one thread per slot walks its own run.
  for (int s = tid; s < num_slots; s += kThreads) {
    const int end = pos[s];
    float used = 0.0f, wait = 0.0f;
    for (int j = s ? pos[s - 1] : 0; j < end; ++j) {
      lane_step(L, order[j], ratio, used, wait);
    }
  }
}

}  // namespace

// Plain C launcher (bound with ctypes). ``scratch`` is int32[n +
// num_slots] on the device. Returns the cudaError_t of the launch;
// N == 0 launches nothing.
extern "C" int ca_acquire(const int* slots, const float* counts,
                          const float* base, const float* thr,
                          const float* scale, const bool* known,
                          const bool* prio, const float* waiting, int n,
                          int num_slots, float ratio, bool* ok,
                          bool* can_wait, float* passed, int* scratch,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  Lanes L{slots, counts, base, thr, scale, known, prio, waiting,
          ok, can_wait, passed};
  acquire_kernel<<<1, kThreads, 0, stream>>>(L, n, num_slots, ratio,
                                              scratch);
  return static_cast<int>(cudaGetLastError());
}
