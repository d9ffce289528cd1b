"""Chip smoke for the PyTorch port (``sentinel_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; none is caught):

1. Device: CUDA must be available; prints the card, the count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compiles ``sentinel_tpu_torch/csrc/segmented_prefix.cu`` (and
   the headers it includes) and ``csrc/cluster_acquire.cu``, one nvcc for
   each, both started together, for sm_90a, and prints the ``-Xptxas -v``
   register / shared-memory lines.
3. Kernel vs plain: the segmented-prefix kernel against the plain sort +
   cumsum version on the card, bit-equal, at N in {1, 8, 64, 512, 1000, 1024,
   2048, 8192}, K in {1, 3}, M in {1, 2}, with the 256 and near-2^24 value
   edges, the id patterns a radix sort gets wrong (``full_int32``,
   ``all_distinct``, ``all_equal``), and N in {16384, 65536}, above the
   block sort's capacity, where the launcher takes the tile walk; device
   times for both (CUDA-graph replay), the kernel's per-call time with
   host dispatch, the card's bound for the function's least work (bytes,
   or an N log N sort-and-scan), and at N=8192, K=3, M=2 the tile walk's
   device time on the same inputs (``previous_ms``).
4. Main path: ``SentinelEngine(capacity=32768)`` with the bench headline
   rules (10,000 resources; flow on every 10th, degrade on every 20th,
   param on every 40th, one system rule), 32 check_batch + complete_batch
   rounds at widths 2048 and 8192 on an advancing clock (bucket and
   second boundaries) plus one mixed-count batch; prints rule-checks/s,
   per-step ms, host syncs per step and kernel launches per entry step;
   requires the kernel to have run, and through the block sort only.
   A profile of a few rounds at width 8192 gives the device busy share,
   the kernels that take the most device time, and the prefix kernel's
   own time and share; the trace's kernel names must show the block sort
   alone, as many times as the wrapper counted.
5. Parity: the same 8-round sequence at width 2048 on ``cuda`` and on
   ``cpu`` with a blocking rule mix; decisions and integer state must be
   equal, float state within FLOAT_RTOL.
6. API: ``sentinel_tpu_torch.reset(capacity=32768)`` on the card, the
   bench's 10,000 resources with flow (every 10th; DEFAULT, WARM_UP,
   RATE_LIMITER, WARM_UP_RATE_LIMITER by ``(i // 10) % 4``), param (every
   40th), degrade (``i % 20 == 5``) and authority (``i % 50 == 5``)
   rules, so every path of ``entry()`` carries traffic: 8 threads x 5,000
   ``with st.entry(...)`` pairs on the real clock (60% unruled, 38%
   leased, 2% device path; 20% inside ``context_enter``), timed per pair
   and class; the engine lock's waits and holds by taker (callers'
   device steps, the committer's flushes) and its busy share of the
   window; 16 device-path pairs alone after the window, for scale; the
   committer's flushes and their widths, the prefix launches by shape
   (block sort only), ``fail_open_count`` (must be 0), the lease ring
   (must be ``"native"``); then a system rule must stand every fast path
   down, and ``close()`` must leave the committer's queues empty with no
   failed flush. A seeded single-threaded script of 2,000 entry/exit pairs, 8 to
   each 5 ms step of the port's frozen clock, then runs on ``cuda`` and on
   ``cpu``: verdicts and ``node_snapshot()`` must be equal. Prints one
   ``{"api": ...}`` line.
7. Pipeline: a fresh default engine with the API phase's resources and
   rules, warmed at widths 1, 8 and 64, under ``start_pipeline(max_batch=8,
   linger_s=0.0002)``: 16 threads of ``with st.entry(...)`` pairs on the
   real clock for 10 s over the API phase's class mix, every one of them
   decided on the card in the collector's cycles. Prints one
   ``{"pipeline": ...}`` line: pairs/s, pair ms by class, blocked shares,
   ``pipeline_stats()``, the cycles' ladder widths, ``step_timer``, the
   engine lock's held share, prefix launches by shape, host-to-device
   copies per batch, the trace ring's counts and ``fail_open_count``; no
   cycle may fail open, batching must engage, the kernel must run (block
   sort only), the thread gauges must drain and the trace pump must see
   no error. Then, under the frozen clock, each on a fresh engine: 100
   tickets straight to the collector come back in FIFO order (50 pass, 50
   FLOW) with two cycles in flight, and 40 more entries allocate no
   staging buffer; 16 threads x 10 entries on a count-25 rule pass exactly
   25; a seeded 90-op stream gives the same verdicts synchronously on
   ``cuda``, pipelined on ``cuda`` and pipelined on ``cpu``, and the two
   pipelined ``node_snapshot()``s agree.
8. Slots: first card against CPU, with identical injected clocks: the
   reference's differential oracle (16 names, ``FlowRule(count=3)`` on
   names 0, 5 and 10, Zipf weights, 10 simulated seconds x 20 pairs, slot
   budgets 8 and 64) and its storm drill (budget 3, ``slots.evict.storm``
   armed after=2, times=2) give the same verdicts, ``slots.status()``,
   event histories, ``timeseries_view`` and state (ring included) on both;
   the budget-8 engine evicts, its twin does not, and their verdicts are
   equal. Then a timed run at a deployment's size:
   ``SentinelEngine(slot_budget=4098)``, 4,000 resources with leaseable
   QPS rules (pinned hot) and an unruled Zipf(1.2) tail of 12,000 names
   contesting the 96 dynamic slots, 10 simulated seconds of 1,024 leased
   and 64 tail pairs and one fold each. It must evict, rehydrate and pass
   cold, never block cold or evict a pinned resource, never fail open,
   and conserve every PASS (device totals at the current slots + spill
   records + cold tallies = pairs served). Prints one ``{"slots": ...}``
   line: pairs/s, pair latency by class, hit rate, steals, evictions and
   rehydrations, the surgeries (count, ms, bytes each way), the spill ms,
   the prefix launches by shape (block sort only) and the peak memory.
   The phase must end within 120 s.
9. Boot: the engine's boot surface, each part on the card and on the CPU
   with identical injected clocks. (1) Config: engines built under
   ``csp.sentinel.statistic.interval.ms`` 2000, ``.sample.count`` 4 and
   ``csp.sentinel.occupy.timeout.ms`` 250 must seed (2000, 4, 250); a
   seeded stream of 500 ``with eng.entry(...)`` pairs over 5 simulated
   seconds (a leased QPS quota, a leased warm-up rule, a rate limiter, an
   exception-ratio breaker, an unruled name) must give the same verdicts
   and state on both; then ``window_geometry_property`` (1000 ms / 2) and
   ``occupy_timeout_property`` (250) are pushed (accepted, then an equal
   push returns False) and the stream runs again. (2) Warm restart: five
   ``save_checkpoint``s of the main path's engine (capacity 32,768; the
   lock-held ms, the save ms, the file's bytes), which must leave its
   state unchanged; the file restored into a fresh card engine and a
   fresh CPU engine must give the twelve tensors bit for bit (the thread
   gauges zero) and the same decisions over the next 8 batches at width
   8192; the slot phase's engine (budget 4,098) saved and restored on
   both must give back its slot assignment; a ``CheckpointTimer`` every
   0.5 s over at least 3 s of the API phase's traffic on one thread must
   write at least 4 files, all loadable. (3) SPI: the two checkers of
   ``tests/test_spi.py`` in torch (a cap on ``count > 3``, 2 PASS a
   second per cluster row from the rotated ``w1``) over 250 pairs in 2.5
   simulated seconds on the API phase's engine kind (capacity 8,192, as
   its parity script): the same verdicts, reasons and ``rule_slot``s,
   ``node_snapshot`` and state on both, every pair a device entry while
   registered, the leased pairs back after unregistering; and one
   ``check_batch`` at width 8192 with the cap checker must launch the
   prefix kernel 4 times. Prints one ``{"boot": ...}`` line with the
   prefix launches by shape (block sort only); the phase must end within
   60 s.
10. Rollout: staged rollout and the metric log, each part on the card and
   on the CPU with identical injected clocks and seeded streams. (1) The
   main path's engine kind (capacity 32,768, the headline rules) with a
   candidate staged through ``rollout.load_candidate``: finite QPS counts
   on 100 flow-ruled resources (half DEFAULT, half RATE_LIMITER), one
   param rule, one authority white list; 8 check_batch + complete_batch
   rounds at width 8192 and 8 at 2048, 130 ms apart. Decisions,
   ``shadow_counts()`` and the whole state (shadow included) must be
   equal; a second card engine ENFORCING the merged rules over the same
   stream must tally, per resource, what the shadow's would-pass and
   would-block counters hold. Prints entry ms, prefix launches and host
   syncs per step with the candidate (beside the main path's without),
   and the shadow's device bytes. Both engines' metric logs are sealed
   at the stream's end: the files and their ``.idx`` must be byte-equal
   and a ``MetricSearcher`` reads every line back. (2) A bad candidate
   (count 0 on the same 100 resources) in canary at 2,500 bps, 4 rounds
   at 8192 from 64 origins: every lane's verdict is its host
   ``in_canary`` prediction; then 0 bps governs no lane and 10,000 every
   lane. (3) The guardrail's ``tick()`` once a simulated second until it
   aborts; then ``shadow_counts()`` is None, a headline round at 8192 is
   back to 15.0625 syncs, a ``MetricTimerListener`` thread writes at
   least 2 seconds, the leases come back (system rule removed), and a
   promoted candidate's rules are live and equal on card and CPU. (4) The
   slot phase's oracle engine at budget 8 (it steals and rehydrates) with
   a datasource-staged candidate, 10 simulated seconds: card = CPU,
   shadow included, and every surgery leaves the touched shadow columns
   zero. Prints one ``{"rollout": ...}`` line with each part's seconds
   and the prefix launches by shape (block sort only); the phase must
   end within 60 s.
11. Cluster: the cluster token path on the card (BASELINE config #4,
   the 64-node mesh). (1) The acquire kernel (``csrc/cluster_acquire.cu``)
   against its plain form at N in {1, 8, 64, 256, 1024, 4096} over 64
   flows, on seeded lanes that hit every status with unknown and
   out-of-range slots: ``ok``, ``can_wait`` and ``passed`` bit-equal;
   kernel ms (CUDA-graph replay), call ms, plain ms and the bound (bytes,
   operations, or the longest same-slot run as a dependent chain, with
   its derivation). (2) ``DefaultTokenService`` on the card and on the
   CPU over one seeded stream on a frozen clock (bench.py:231's 64 flows
   and batches of 512, GLOBAL and AVG_LOCAL, a prioritized share, a rule
   push halfway, param tokens): every TokenResult, the window state and
   ``metrics_snapshot`` equal. (3) The wire mesh of bench.py:1106: 64
   GLOBAL flows, the limiter lifted, the reactor on the card, 8 threads x
   8 connections with 64 requests in flight each, a 5 s settle and two 4
   s windows; every reply OK, the server's OK verdicts equal the replies,
   and after the window empties one burst's replies equal the server's
   window total; acquires/s, ``wire_stats()``, host ms per fused batch
   and the device share of one profiled batch. (4) The API phase's
   engine kind as the client of a port server in this process: 64
   cluster-mode rules (GLOBAL, 2 a second, local fallback), every entry
   sampled, 4 threads of pairs for 10 s: pair p50/p99, no flow admitted
   over 2 in any second, the engine's passes equal the server's OK
   verdicts, three stitched spans per entry; then the server stops
   answering and 8 entries fall back inside the entry budget until the
   breaker opens, and after the server stops the check is local. Counts
   are zeroed before (3) and read after (4). The phase must end within
   60 s. Prints one ``{"cluster": ...}`` line.
12. Pod: the pod path (``parallel/cluster.py``, ``parallel/namespaces.py``)
   on the card. (a) Eight shards of the main path's configuration
   (capacity 32,768, the 10,000 resources, the 128-second ring each), the
   flow rules on every 10th resource cluster-mode at 5 a second and the
   param rules on every 40th cluster-mode at 3, half the lanes on those
   resources; a pod batch of 8,192 (1,024 a shard) for 16 rounds 50 ms
   apart on a frozen clock, with exits. Per cluster rule and second the
   pod admits at most the threshold plus (D - 1) x its largest per-shard
   admission in one step, and no rule admits in the step after its pod
   total reached the threshold; 4 x D prefix launches a step, host syncs
   a step at most D x 15.0625; entry ms per step and per shard, pod
   rule-checks/s, the reduction's ms and bytes. (b) The same kind of
   stream at the cut size (4 shards, capacity 8,192, 2,000 resources, 256
   lanes a shard, 6 rounds) on the card and the CPU: every decision and
   every leaf equal. (c) A 2 x 4 pod with a global-scope and a pod-scope
   rule: the bounds of ``tests/test_namespaces.py:80-135``. (d) NCCL at
   world size 1 (a FileStore): the distributed drivers equal the
   one-process drivers at D = 1, and the all_reduce's ms. (e) At the cut
   size a candidate staged pod-wide: its summed shadow counters equal the
   counts of a pod enforcing it; the pod checkpoint saved and restored on
   the card; the global reads equal the sums of the shards' reads. Counts
   are zeroed before (a)'s rounds and read after them. The phase must end
   within 60 s. Prints one ``{"pod": ...}`` line.
13. Control: the control plane that rides the once-per-second fold. (a-c)
   The main path's configuration (capacity 32,768, the 10,000 resources
   and headline rules) on an injected clock, 17 simulated seconds of four
   width-2048 batches a second with exits and one fold a second, on the
   card and then on the CPU: after 4 s, availability objectives load on 64
   resources (a 10 s / 2 s page pair and a 30 s / 5 s ticket pair) and
   adaptive targets on 16 tunable flow rules; a burst on ``res0`` (its
   rule tightened to 8 a second) fires and resolves both alerts and raises
   ``abort_signal``; the loop proposes, shadows, canaries and promotes
   ``res1000`` (64 -> 128 under 96 a second) and proposes a decrease of
   ``res1010`` (exits at 50 ms against a 1 ms p99 target) that the
   guardrail aborts, leaving the last-known-good rules live. Decisions,
   every fold's alert store, ``abort_signal`` and guardrail states, the
   shadow counters, the SLO status, the decision log, the live rules, the
   journal's records, ``why_query`` and ``explain_trace`` (less the window
   the trace pump reads at its own time) must be equal on both; the
   webhook must deliver every transition to a loopback endpoint; the
   card's journal directory must recover in a fresh engine (records, the
   decision log and the alert log). Prints the fold's ms with and without
   objectives, the render's ms, entry ms / host syncs / prefix launches a
   step with no candidate, in shadow and in canary, the journal's bytes
   and its record-with-fsync ms. (d) The pipeline under 16 callers for
   4 s on a card engine that is also an embedded token server answering 4
   loopback connections: every sealed second's pipeline, batch and wire
   counts equal the observations filed in it, their totals equal the
   pipeline's harvests, the token service's harvested batches and the
   replies; the wire stages reconcile with the RTT and the exemplars
   resolve to stitched spans. (e) Three port leaders (engine + token
   server; cut to 200 resources so a second fits a frame) under one
   ``FleetView``: every settled fleet cell is the sum of the leaders' own
   ``timeseries_view`` cells. (f) With objectives and idle targets loaded
   the main path's step stays at 15.0625 host syncs and 4.0 prefix
   launches. (g) No thread the phase started is alive after its engines
   close. The phase must end within 60 s. Prints one ``{"control": ...}``
   line.
14. The smoke's wall time, the kernels line (both kernels, with the pod
   and control paths' prefix launches), the card line, and the final
   ``{"ok": true, ...}``.

Every engine above carries the 128-second flight ring by default: the
main path prints its bytes, holds ``host_syncs_per_round`` at 15.0625 and
checks that the spilled history's PASS per resource equals the device
totals; the parity phase compares the card's ring with the CPU's. Each
phase prints ``torch.cuda.memory_allocated()`` at its start (what earlier
phases still hold) and ``torch.cuda.max_memory_allocated()`` over it.

It imports the port only — never JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# The port itself: a copy of this script outside the repository fails here,
# before it prints anything.
import sentinel_tpu_torch as st
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.cluster import codec as ccodec
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import (
    H2D, make_entry_batch_np, make_exit_batch_np, to_device)
from sentinel_tpu_torch.core.checkpoint import _load_npz, _state_arrays
from sentinel_tpu_torch.core.config import LOG_DIR, config
from sentinel_tpu_torch.core.engine import SentinelEngine
from sentinel_tpu_torch.models import authority as A
from sentinel_tpu_torch.models import degrade as D
from sentinel_tpu_torch.models import flow as F
from sentinel_tpu_torch.models import param_flow as P
from sentinel_tpu_torch.models import system as Y
from sentinel_tpu_torch.native import build_error
from sentinel_tpu_torch.ops import prefix_cuda
from sentinel_tpu_torch.ops.segment import segmented_prefix_plain
from sentinel_tpu_torch.utils import time_util
from sentinel_tpu_torch.utils.device import SYNCS

NOW0 = 1_700_000_000_000
CAPACITY = 32_768
N_RESOURCES = 10_000
ROUNDS = 32
WIDTHS = (2048, 8192)
PARITY_ROUNDS = 8
PARITY_WIDTH = 2048
FLOAT_RTOL = 1e-6  # float32 state: same arithmetic on both devices
# Host syncs of one check_batch + complete_batch round on the main path
# (PERF.md section 5): the flight ring's fold must not add one.
HOST_SYNCS_PER_ROUND = 15.0625
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM fp32, outside the tensor cores
CTX = "sentinel_default_context"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernel against its plain version
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    """Wall time of one call as a caller pays it: CUDA events around a
    Python loop of ``reps`` calls, host dispatch included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    CUDA events around its replays, so no host dispatch is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replays = 5
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def radix_passes(ids: np.ndarray) -> int:
    """8-bit passes the block sort runs on these ids, summed over the K
    pairs: the digits of (id + 1 mod 2^32) that differ between keys."""
    total = 0
    for row in ids.reshape(ids.shape[0], -1):
        if row.size == 0:
            continue
        keys = row.astype(np.int64).astype(np.uint32) + np.uint32(1)
        diff = int(np.bitwise_or.reduce(keys ^ keys[0]))
        total += sum(1 for s in range(0, 32, 8) if (diff >> s) & 0xFF)
    return total


def prefix_bound(ids: np.ndarray, m: int):
    """Least time the card could take for the function, the larger of:
    its bytes (ids + values read once, prefix + is_first written once)
    over the HBM rate, and its least operations — a sort and a scan,
    K * N * ceil(log2 N) * (M+1) — over the fp32 rate. Returns
    ``(bound_ms, bound_by)``."""
    k, n = ids.shape
    nbytes = k * n * (4 + 4 * m + 4 * m + 1)
    ops = k * n * max(1, math.ceil(math.log2(max(n, 2)))) * (m + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def algorithm_ops_estimate(ids: np.ndarray, m: int, design: str) -> int:
    """An estimate, computed and not measured, of the element operations
    the kernel that ran spends on these ids: for the block sort one key
    placement per key per radix pass plus the scan's K * N * M adds; for
    the tile walk its N(N-1)/2 * K * (M+1) compare-adds. It counts
    elements, not instructions: ranking one key takes several integer
    instructions and each pass also scans 256 counters a warp."""
    k, n = ids.shape
    if design == "tile_walk":
        return n * (n - 1) // 2 * k * (m + 1)
    return radix_passes(ids) * n + k * n * m


I32 = np.iinfo(np.int32)


def prefix_case(rng, n: int, k: int, m: int, edge: str, dev):
    """Inputs of one case: row-like ids (0..N/4, 10% -1) and small counts,
    or a value edge (``256``, ``2^24``), or an id pattern a radix sort
    gets wrong: repeats from a pool of INT32_MIN, INT32_MAX, -1, -7, 0 and
    large keys of both signs (``full_int32``), a permutation spread over
    the int32 range (``all_distinct``), or INT32_MIN everywhere
    (``all_equal``)."""
    ids = rng.integers(0, max(1, n // 4), size=(k, n)).astype(np.int32)
    ids[rng.random((k, n)) < 0.1] = -1
    vals = rng.integers(0, 4, size=(k, n, m)).astype(np.float32)
    if edge == "full_int32":
        pool = np.concatenate([[I32.min, I32.max, -1, -7, 0],
                               rng.integers(2**30, I32.max, size=8),
                               rng.integers(I32.min + 1, -2**30, size=8)])
        ids = rng.choice(pool, size=(k, n)).astype(np.int32)
    elif edge == "all_distinct":
        step = (2**32 - 1) // n
        ids = np.stack([rng.permutation(n).astype(np.int64) * step + I32.min
                        for _ in range(k)]).astype(np.int32)
    elif edge == "all_equal":
        ids[:] = I32.min
    elif edge == "256":
        vals[:] = rng.integers(250, 257, size=(k, n, m))
    elif edge == "2^24":
        # One segment whose running sum reaches 2^24 - 1 exactly at the
        # last row: a head value, then n - 2 ones, then a trailing 0.
        ids[:, :] = 7
        vals[:] = 0
        vals[:, 0, :] = 2**24 - 1 - (n - 2)
        vals[:, 1:n - 1, :] = 1
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev))


MAIN_SHAPE = (8192, 3, 2, "random")


def kernel_phase(dev):
    rng = np.random.default_rng(20261017)
    max_err = 0.0
    main_shape = None
    # N = 1024: the pod path's width a shard.
    cases = [(n, k, m, "random")
             for n in (1, 8, 64, 512, 1000, 1024, 2048, 8192)
             for k in (1, 3) for m in (1, 2)]
    cases += [(2048, 3, 2, "256"), (8192, 1, 2, "256"), (64, 1, 1, "2^24"),
              (1000, 3, 2, "2^24")]
    cases += [(n, k, 2, pattern)
              for pattern in ("full_int32", "all_distinct", "all_equal")
              for n, k in ((2048, 3), (8192, 3), (16384, 1))]
    cases += [(16384, 1, 2, "random"), (65536, 1, 2, "random")]
    for n, k, m, edge in cases:
        ids, vals = prefix_case(rng, n, k, m, edge, dev)
        tiles_before = prefix_cuda.tile_launches
        prefix, first = prefix_cuda.segmented_prefix_cuda(ids, vals)
        design = ("tile_walk" if prefix_cuda.tile_launches > tiles_before
                  else "block_radix_sort")
        torch.cuda.synchronize()
        for kk in range(k):
            want_p, want_f = segmented_prefix_plain(ids[kk], vals[kk])
            if not (torch.equal(prefix[kk], want_p)
                    and torch.equal(first[kk], want_f)):
                raise AssertionError(f"kernel != plain at N={n} K={k} M={m} "
                                     f"edge={edge} pair {kk}")
            max_err = max(max_err, float((prefix[kk] - want_p).abs().max())
                          if n else 0.0)
        if edge == "2^24" and not bool((prefix[:, -1, :] == 2**24 - 1).all()):
            raise AssertionError(f"2^24 edge at N={n} did not reach 2^24 - 1")
        reps = 200 if n <= 2048 else 50 if n <= 16384 else 10

        def kernel():
            prefix_cuda.segmented_prefix_cuda(ids, vals)

        def tiles():
            prefix_cuda.segmented_prefix_tiles_cuda(ids, vals)

        def plain():
            for kk in range(k):
                segmented_prefix_plain(ids[kk], vals[kk])

        kernel_ms = device_ms(kernel, reps)
        call_ms = time_ms(kernel, reps)
        plain_ms = device_ms(plain, max(10, reps // 5))
        ids_np = ids.cpu().numpy()
        bound_ms, bound_by = prefix_bound(ids_np, m)
        row = {"shape": {"N": n, "K": k, "M": m, "values": edge},
               "design": design, "bit_equal": True, "kernel_ms": kernel_ms,
               "call_ms": call_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "algorithm_ops_estimate": algorithm_ops_estimate(
                   ids_np, m, design)}
        if (n, k, m, edge) == MAIN_SHAPE:
            # The tile walk on the same inputs, in this call: the kernel
            # the block sort replaced on the main path.
            tile_p, tile_f = prefix_cuda.segmented_prefix_tiles_cuda(ids, vals)
            if not (torch.equal(tile_p, prefix) and torch.equal(tile_f, first)):
                raise AssertionError("tile walk != block sort at the main "
                                     "shape")
            row["previous_ms"] = device_ms(tiles, reps)
            main_shape = row
        print(json.dumps(row), flush=True)
    return main_shape, max_err


# ---------------------------------------------------------------------------
# Phases 4-5: the engine
# ---------------------------------------------------------------------------


def load_rules(eng, tight: bool) -> None:
    """Bench headline rules (``bench.py`` bench_throughput); ``tight``
    swaps in thresholds that block, every flow behavior and authority
    rules, for the parity phase."""
    n = N_RESOURCES
    if not tight:
        flow = [F.FlowRule(resource=f"res{i}", count=1e9)
                for i in range(0, n, 10)]
        param = [P.ParamFlowRule(f"res{i}", param_idx=0, count=1e9)
                 for i in range(0, n, 40)]
        auth = []
    else:
        behaviors = (C.CONTROL_BEHAVIOR_DEFAULT, C.CONTROL_BEHAVIOR_WARM_UP,
                     C.CONTROL_BEHAVIOR_RATE_LIMITER,
                     C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER)
        flow = [F.FlowRule(resource=f"res{i}", count=1 + (i // 10) % 4,
                           control_behavior=behaviors[(i // 10) % 4],
                           warm_up_period_sec=3, max_queueing_time_ms=300,
                           grade=(C.FLOW_GRADE_THREAD if i % 70 == 0
                                  else C.FLOW_GRADE_QPS))
                for i in range(0, n, 10)]
        param = [P.ParamFlowRule(f"res{i}", param_idx=0, count=2)
                 for i in range(0, n, 40)]
        auth = [A.AuthorityRule(resource=f"res{i}", limit_app="appA",
                                strategy=C.AUTHORITY_BLACK)
                for i in range(5, n, 50)]
    degrade = [D.DegradeRule(resource=f"res{i}", count=100 if not tight else 2,
                             grade=i % 3, time_window=10 if not tight else 1,
                             min_request_amount=5 if not tight else 2)
               for i in range(0, n, 20)]
    eng.flow_rules.load_rules(flow)
    eng.degrade_rules.load_rules(degrade)
    eng.param_rules.load_rules(param)
    eng.authority_rules.load_rules(auth)
    eng.system_rules.load_rules([Y.SystemRule(qps=1e12)])


class Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


def make_engine(dev, tight: bool):
    clock = Clock(NOW0)
    eng = SentinelEngine(capacity=CAPACITY, device=dev, clock=clock)
    reg = eng.registry
    ent = reg.entrance_row(CTX)
    cluster = np.array([reg.cluster_row(f"res{i}")
                        for i in range(N_RESOURCES)], np.int32)
    dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                   for i in range(N_RESOURCES)], np.int32)
    origin_a = reg.origin_id("appA")
    load_rules(eng, tight)
    return eng, clock, cluster, dn, origin_a


def entry_buf(rng, width, cluster, dn, origin_a, mixed=False):
    buf = make_entry_batch_np(width)
    pick = rng.integers(0, N_RESOURCES, size=width)
    buf["cluster_row"][:] = cluster[pick]
    buf["dn_row"][:] = dn[pick]
    buf["count"][:] = rng.integers(1, 4, size=width) if mixed else 1
    buf["origin_id"][:] = np.where(rng.random(width) < 0.2, origin_a, -3)
    buf["param_hash"][:, 0] = rng.integers(1, 1 << 31, size=width)
    buf["param_present"][:, 0] = True
    return buf


def exit_buf(rng, ebuf, reason):
    width = ebuf["cluster_row"].shape[0]
    buf = make_exit_batch_np(width)
    for f in ("cluster_row", "dn_row", "origin_row", "entry_in", "count",
              "param_hash", "param_present"):
        buf[f][:] = ebuf[f]
    ok = reason == 0
    buf["cluster_row"][~ok] = -1
    buf["success"][:] = ok
    buf["rt_ms"][:] = rng.integers(1, 250, size=width)
    buf["error"][:] = rng.random(width) < 0.2
    return buf


def memory_mark() -> int:
    """Reset the peak counter; the bytes allocated now (what earlier
    phases still hold)."""
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def memory_report(at_start: int) -> dict:
    peak = torch.cuda.max_memory_allocated()
    return {"at_start": at_start, "peak": peak,
            "peak_above_start": peak - at_start}


def ring_bytes(ring) -> int:
    return sum(t.numel() * t.element_size() for t in ring)


def headline_rounds(eng, clock, cluster, dn, origin_a, rng, width, dev):
    """One warm-up round and ROUNDS timed check_batch + complete_batch
    rounds of the headline stream at ``width`` (50 ms apart: bucket and
    second boundaries; the middle round with mixed acquire counts).
    Returns (the result line, admitted tokens)."""
    admitted_tokens = 0

    def check(batch):
        return eng.harvest_decisions(eng.check_batch(batch))[0]

    # Batches staged and copied to the card before the timed rounds.
    bufs = [entry_buf(rng, width, cluster, dn, origin_a,
                      mixed=(r == ROUNDS // 2)) for r in range(ROUNDS + 1)]
    batches = [to_device(b, dev) for b in bufs]
    # Warm-up round (allocations, first load of the kernel).
    reason, ebuf = check(batches[ROUNDS]), bufs[ROUNDS]
    admitted_tokens += int(ebuf["count"][reason == 0].sum())
    eng.complete_batch(to_device(exit_buf(rng, ebuf, reason), dev))
    torch.cuda.synchronize()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    SYNCS.count = 0
    entry_s = exit_s = 0.0
    for r in range(ROUNDS):
        clock.now += 50  # 32 rounds x 50 ms: bucket + second boundaries
        t0 = time.perf_counter()
        reason, ebuf = check(batches[r]), bufs[r]
        entry_s += time.perf_counter() - t0
        admitted_tokens += int(ebuf["count"][reason == 0].sum())
        xb = to_device(exit_buf(rng, ebuf, reason), dev)
        t0 = time.perf_counter()
        eng.complete_batch(xb)
        torch.cuda.synchronize()
        exit_s += time.perf_counter() - t0
    launches = prefix_cuda.launches
    syncs = SYNCS.count
    if launches <= 0:
        raise AssertionError("main path never launched the prefix kernel")
    if prefix_cuda.tile_launches:
        raise AssertionError(f"main path at width {width} took the tile "
                             "walk, not the block sort")
    return {
        "width": width, "rounds": ROUNDS,
        "rule_checks_per_s": width * ROUNDS / entry_s,
        "entry_step_ms": entry_s / ROUNDS * 1e3,
        "exit_step_ms": exit_s / ROUNDS * 1e3,
        "prefix_launches": launches,
        "prefix_launches_per_entry_step": launches / ROUNDS,
        "prefix_design": "block_radix_sort",
        "host_syncs_per_round": syncs / ROUNDS,
    }, admitted_tokens


def main_path_phase(dev):
    """Drive the engine at the headline size; returns (per-width results,
    kernel launches during the measured rounds, the engine and its rows,
    still open)."""
    mem0 = memory_mark()
    eng, clock, cluster, dn, origin_a = make_engine(dev, tight=False)
    rng = np.random.default_rng(7)
    results = {}
    admitted_tokens = 0
    total_launches = 0
    for width in WIDTHS:
        results[width], admitted = headline_rounds(
            eng, clock, cluster, dn, origin_a, rng, width, dev)
        admitted_tokens += admitted
        total_launches += results[width]["prefix_launches"]
        print(json.dumps({"main_path": results[width]}), flush=True)
        syncs = results[width]["host_syncs_per_round"]
        if syncs != HOST_SYNCS_PER_ROUND:
            raise AssertionError(f"host syncs per round {syncs} at "
                                 f"width {width}, not {HOST_SYNCS_PER_ROUND}")
    # Output check: every admitted token committed PASS to its DefaultNode
    # and ClusterNode rows, and every admitted entry has exited.
    st = eng.state
    passes = int(st.telemetry.totals[0].sum()) + int(st.sec.counts[0].sum())
    if passes != 2 * admitted_tokens:
        raise AssertionError(f"committed PASS {passes} != 2 x admitted "
                             f"tokens {admitted_tokens}")
    if int(st.cur_threads.sum()) != 0:
        raise AssertionError("thread gauges did not return to 0")
    # The flight recorder: the completed seconds' PASS per resource in the
    # spilled history equal the device's cumulative PASS totals (the fold
    # moves every completed second into both).
    if st.flight is None:
        raise AssertionError("the default engine carries no flight ring")
    view = eng.timeseries_view(now_ms=clock.now)
    ring_pass = {}
    for sec in view["seconds"]:
        for res, r in sec["resources"].items():
            ring_pass[res] = ring_pass.get(res, 0) + r["pass"]
    totals = eng.state.telemetry.totals[C.MetricEvent.PASS].cpu().numpy()
    for res, row in eng.registry.resources().items():
        if ring_pass.get(res, 0) != int(totals[row]):
            raise AssertionError(f"{res}: ring PASS {ring_pass.get(res, 0)} "
                                 f"!= device totals {int(totals[row])}")
    print(json.dumps({"main_path_check": {
        "admitted_tokens": admitted_tokens, "committed_pass": passes,
        "flight_ring_seconds": eng.flight_seconds,
        "flight_ring_bytes": ring_bytes(eng.state.flight),
        "ring_seconds_spilled": len(view["seconds"]),
        "ring_pass_total": sum(ring_pass.values()),
        "ring_pass_equals_device_totals": True,
        "memory_bytes": memory_report(mem0)}}),
          flush=True)
    # The engine stays open for the boot phase's warm restart.
    main = {"eng": eng, "clock": clock, "cluster": cluster, "dn": dn,
            "origin_a": origin_a}
    return results, total_launches, main


def profile_phase(dev, rounds: int = 8, width: int = 8192):
    """Where one round's time goes on the card: ``torch.profiler`` over a
    few main-path rounds (after warm-up), kernel time summed by name
    against the host wall clock. Prints the device busy share and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    eng, clock, cluster, dn, origin_a = make_engine(dev, tight=False)
    rng = np.random.default_rng(13)
    bufs = [entry_buf(rng, width, cluster, dn, origin_a)
            for _ in range(rounds + 2)]
    batches = [to_device(b, dev) for b in bufs]

    def one_round(i):
        clock.now += 50
        reason, _ = eng.harvest_decisions(eng.check_batch(batches[i]))
        eng.complete_batch(to_device(exit_buf(rng, bufs[i], reason), dev))

    for i in range(rounds, rounds + 2):
        one_round(i)
    torch.cuda.synchronize()
    prefix_cuda.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(rounds):
            one_round(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = prefix_cuda.launches
    eng.close()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    prefix = [e for e in kernels if "segmented_prefix" in e.key]
    prefix_us = sum(e.self_device_time_total for e in prefix)
    # The trace's own kernel names: the main path ran the block sort and
    # nothing else, as many times as the wrapper counted.
    if not prefix or any("segmented_prefix_block_kernel" not in e.key
                         for e in prefix):
        raise AssertionError("profiled main path did not run the block sort "
                             f"alone: {[e.key for e in prefix]}")
    if sum(e.count for e in prefix) != counted:
        raise AssertionError(f"trace shows {sum(e.count for e in prefix)} "
                             f"prefix kernels, the wrapper counted {counted}")
    print(json.dumps({"profile": {
        "width": width, "rounds": rounds,
        "wall_ms_per_round": wall_ms / rounds,
        "device_ms_per_round": dev_us / 1e3 / rounds,
        "device_busy_share": dev_us / 1e3 / wall_ms,
        "device_ops_per_round": sum(e.count for e in kernels) / rounds,
        "prefix_kernel": {
            "names": [e.key[:80] for e in prefix],
            "count_per_round": sum(e.count for e in prefix) / rounds,
            "ms_per_round": prefix_us / 1e3 / rounds,
            "share_of_device_time": prefix_us / dev_us if dev_us else 0.0},
        "top": [{"name": e.key[:80], "count_per_round": e.count / rounds,
                 "ms_per_round": e.self_device_time_total / 1e3 / rounds}
                for e in top]}}), flush=True)


def compare_states(x, y, path=""):
    """Two states as ``convert.state_to_numpy`` gives them: the same keys,
    integer tensors equal, float tensors within FLOAT_RTOL."""
    if set(x) != set(y):
        raise AssertionError(f"{path}: fields {sorted(set(x) ^ set(y))} "
                             "differ between cuda and cpu")
    for k in x:
        if isinstance(x[k], dict):
            compare_states(x[k], y[k], f"{path}.{k}")
            continue
        if x[k].dtype != y[k].dtype:
            raise AssertionError(f"{path}.{k}: dtype {x[k].dtype} vs "
                                 f"{y[k].dtype}")
        if x[k].dtype.kind == "f":
            np.testing.assert_allclose(x[k], y[k], rtol=FLOAT_RTOL,
                                       atol=0, err_msg=f"{path}.{k}")
        elif not np.array_equal(x[k], y[k]):
            raise AssertionError(f"{path}.{k} differs between cuda "
                                 "and cpu")


def parity_phase():
    mem0 = memory_mark()
    runs = {}
    for dev in ("cuda", "cpu"):
        eng, clock, cluster, dn, origin_a = make_engine(dev, tight=True)
        rng = np.random.default_rng(11)
        decs = []
        for r in range(PARITY_ROUNDS):
            clock.now += 170
            ebuf = entry_buf(rng, PARITY_WIDTH, cluster, dn, origin_a,
                             mixed=(r % 3 == 2))
            dec = eng.check_batch(ebuf)
            decs.append({f: getattr(dec, f).cpu().numpy()
                         for f in dec._fields})
            clock.now += 20
            eng.complete_batch(exit_buf(rng, ebuf, decs[-1]["reason"]))
        runs[dev] = (decs, convert.state_to_numpy(eng.state))
        eng.close()
    blocked = 0
    for r, (a, b) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        for f in a:
            if not np.array_equal(a[f], b[f]):
                raise AssertionError(f"round {r}: decisions.{f} differ "
                                     "between cuda and cpu")
        blocked += int((a["reason"] > 0).sum())

    cuda_state, cpu_state = runs["cuda"][1], runs["cpu"][1]
    if "flight" not in cuda_state or "flight" not in cpu_state:
        raise AssertionError("a parity engine carries no flight ring")
    compare_states(cuda_state, cpu_state)
    ring_seconds = int((cuda_state["flight"]["stamps"] >= 0).sum())
    if ring_seconds < 1:
        raise AssertionError("the parity run folded no second into the ring")
    print(json.dumps({"parity": {"rounds": PARITY_ROUNDS,
                                 "width": PARITY_WIDTH,
                                 "blocked_decisions": blocked,
                                 "decisions_bit_equal": True,
                                 "int_state_equal": True,
                                 "flight_ring_equal": True,
                                 "flight_ring_seconds": ring_seconds,
                                 "float_rtol": FLOAT_RTOL,
                                 "memory_bytes": memory_report(mem0)}}),
          flush=True)


# ---------------------------------------------------------------------------
# Phase 6: the st.entry path through the module API
# ---------------------------------------------------------------------------

API_THREADS = 8
API_PAIRS = 5_000
API_MIX = (0.60, 0.38, 0.02)  # unruled, leased, device path
API_PARITY_OPS = 2_000
API_PARITY_MIX = (0.55, 0.42, 0.03)
API_PARITY_CAPACITY = 8_192
# Pairs per 5 ms step of the frozen clock: every advance flushes the
# committer (one entry and one exit batch), ~4,000 steps a run at one
# pair a step.
API_PARITY_OPS_PER_STEP = 8
API_PARAM_KEYS = 16
API_ALONE_PAIRS = 16
API_BEHAVIORS = ("DEFAULT", "WARM_UP", "RATE_LIMITER", "WARM_UP_RATE_LIMITER")


def api_pools():
    """Resource names by the path ``entry()`` takes for them."""
    n = N_RESOURCES
    pools = {
        "leased_default_param": range(0, n, 40),
        "leased_warm_up": range(10, n, 40),
        "device_rate_limiter": range(20, n, 40),
        "device_warm_up_rate_limiter": range(30, n, 40),
        "device_degrade_or_authority": sorted(set(range(5, n, 20))
                                              | set(range(5, n, 50))),
        "unruled": [i for i in range(n) if i % 10 in (1, 2, 3, 4)],
    }
    return {k: [f"res{i}" for i in v] for k, v in pools.items()}


def api_engine(dev, capacity=CAPACITY, register=True):
    """A fresh default engine with the API phase's rules, so every path of
    ``entry()`` has resources; ``register`` interns the bench's 10,000
    resources up front, as the bench does."""
    eng = st.reset(capacity=capacity, device=dev)
    reg = eng.registry
    ent = reg.entrance_row(CTX)
    for i in range(N_RESOURCES if register else 0):
        reg.cluster_row(f"res{i}")
        reg.default_row(CTX, f"res{i}", ent)
    behaviors = [getattr(C, f"CONTROL_BEHAVIOR_{b}") for b in API_BEHAVIORS]
    st.load_flow_rules([
        st.FlowRule(resource=f"res{i}", count=2 + (i // 40) % 4,
                    control_behavior=behaviors[(i // 10) % 4],
                    warm_up_period_sec=2, max_queueing_time_ms=20)
        for i in range(0, N_RESOURCES, 10)])
    st.load_param_flow_rules([st.ParamFlowRule(f"res{i}", param_idx=0,
                                               count=2)
                              for i in range(0, N_RESOURCES, 40)])
    st.load_degrade_rules([
        st.DegradeRule(resource=f"res{i}", count=0.5,
                       grade=C.DEGRADE_GRADE_EXCEPTION_RATIO, time_window=1,
                       min_request_amount=5)
        for i in range(5, N_RESOURCES, 20)])
    st.load_authority_rules([
        st.AuthorityRule(resource=f"res{i}", limit_app="appA",
                         strategy=C.AUTHORITY_BLACK)
        for i in range(5, N_RESOURCES, 50)])
    pools = api_pools()
    for res in pools["leased_default_param"] + pools["leased_warm_up"]:
        if res not in eng._leases:
            raise AssertionError(f"{res} should be leased")
    for name in pools:
        if name.startswith("device") and any(r in eng._leases
                                             for r in pools[name]):
            raise AssertionError(f"a {name} resource is leased")
    return eng


def api_pick(rng, pools, mix):
    """One request: (class, resource, context origin or None, args,
    traced error)."""
    r = rng.random()
    if r < mix[0]:
        cls = "unruled"
    elif r < mix[0] + mix[1]:
        cls = ("leased_default_param", "leased_warm_up")[int(rng.integers(2))]
    else:
        cls = ("device_rate_limiter", "device_warm_up_rate_limiter",
               "device_degrade_or_authority")[int(rng.integers(3))]
    pool = pools[cls]
    res = pool[int(rng.integers(len(pool)))]
    origin = ("appA", "appB")[int(rng.integers(2))] \
        if rng.random() < 0.2 else None
    args = (int(rng.integers(API_PARAM_KEYS)),)
    return cls, res, origin, args, rng.random() < 0.1


def api_pair(res, origin, args, error, prioritized=False):
    """One ``with st.entry(...)`` pair; the verdict (``"pass"`` or the
    exception's type)."""
    if origin is not None:
        st.context_enter("ctx", origin)
    try:
        with st.entry(res, args=args, prioritized=prioritized):
            if error:
                st.trace(RuntimeError("business error"))
        return "pass"
    except st.BlockException as ex:
        return type(ex).__name__
    finally:
        if origin is not None:
            st.exit_context()


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else None


class TimedLock:
    """The engine lock, with each outermost hold's wait to acquire and its
    hold timed and keyed by the taking thread's role (the committer's
    thread, the pipeline's collector, the trace pump, or a caller) and the
    function that took it. The engine only takes its lock with ``with``;
    reentrant holds are not timed again."""

    ROLES = {"sentinel-torch-stats-committer": "committer",
             "sentinel-torch-pipeline": "collector",
             "sentinel-torch-trace-pump": "trace_pump"}

    def __init__(self, inner):
        self._inner = inner
        self._local = threading.local()
        self.samples = []  # (key, wait_s, hold_s); list.append is atomic

    def __enter__(self):
        local = self._local
        depth = getattr(local, "depth", 0)
        t0 = time.perf_counter()
        self._inner.acquire()
        if depth == 0:
            role = self.ROLES.get(threading.current_thread().name, "caller")
            local.key = f"{role}:{sys._getframe(1).f_code.co_name}"
            local.t_req, local.t_acq = t0, time.perf_counter()
        local.depth = depth + 1
        return self

    def __exit__(self, *exc):
        local = self._local
        local.depth -= 1
        if local.depth == 0:
            self.samples.append((local.key, local.t_acq - local.t_req,
                                 time.perf_counter() - local.t_acq))
        self._inner.release()
        return False

    def report(self, wall_s):
        by_key = {}
        for key, wait, hold in self.samples:
            by_key.setdefault(key, []).append((wait, hold))
        out = {}
        for key, xs in sorted(by_key.items()):
            waits = [w * 1e3 for w, _ in xs]
            holds = [h * 1e3 for _, h in xs]
            out[key] = {"n": len(xs),
                        "wait_ms": {"p50": pct(waits, 50),
                                    "p99": pct(waits, 99),
                                    "sum_s": sum(waits) / 1e3},
                        "hold_ms": {"p50": pct(holds, 50),
                                    "p99": pct(holds, 99),
                                    "sum_s": sum(holds) / 1e3}}
        held = sum(h for _, _, h in self.samples)
        return {"busy_share": held / wall_s, "held_s": held, "by": out}


def api_timed(eng):
    """8 threads x 5,000 pairs on the real clock; per-class latency and
    blocked share, and what the committer did meanwhile."""
    pools = api_pools()
    eng.warmup()
    committer_widths = lambda c: (dict(c.entry_widths), dict(c.exit_widths))
    # Start the committer before the window so its flushes are counted.
    api_pair("res1", None, (), False)
    committer = eng.committer
    flushes0 = committer.flushes
    widths0 = committer_widths(committer)
    results = [None] * API_THREADS
    barrier = threading.Barrier(API_THREADS + 1)

    def worker(t):
        rng = np.random.default_rng(1000 + t)
        out = []
        barrier.wait()
        for _ in range(API_PAIRS):
            cls, res, origin, args, error = api_pick(rng, pools, API_MIX)
            t0 = time.perf_counter()
            verdict = api_pair(res, origin, args, error)
            out.append((cls, time.perf_counter() - t0, verdict))
        results[t] = out

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(API_THREADS)]
    for th in threads:
        th.start()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    eng._lock.samples.clear()
    barrier.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    wall_s = time.perf_counter() - t0
    lock = eng._lock.report(wall_s)
    eng._flush_committer()  # the window's last commits land on the card
    launches = prefix_cuda.launches
    tile = prefix_cuda.tile_launches
    by_shape = dict(prefix_cuda.launches_by_shape)
    flushes = committer.flushes - flushes0
    widths = committer_widths(committer)
    rows = [r for out in results for r in out]
    if len(rows) != API_THREADS * API_PAIRS:
        raise AssertionError("a caller thread did not finish")
    by_cls = {}
    for cls, dt, verdict in rows:
        by_cls.setdefault(cls, []).append((dt, verdict))

    def lat(prefixes, scale):
        xs = [dt * scale for c, v in by_cls.items()
              if c.startswith(prefixes) for dt, _ in v]
        return {"n": len(xs), "p50": pct(xs, 50), "p99": pct(xs, 99)}

    if launches <= 0:
        raise AssertionError("the API phase never launched the prefix kernel")
    if tile:
        raise AssertionError("the API phase took the tile walk")
    # The same device-path pairs with no other caller, for scale.
    alone = []
    for res in pools["device_degrade_or_authority"][:API_ALONE_PAIRS]:
        t1 = time.perf_counter()
        api_pair(res, None, (0,), False)
        alone.append((time.perf_counter() - t1) * 1e3)
    return {
        "threads": API_THREADS, "pairs_per_thread": API_PAIRS,
        "wall_s": wall_s,
        "pairs_per_s": len(rows) / wall_s,
        "leased_pair_us": lat("leased", 1e6),
        "unruled_pair_us": lat("unruled", 1e6),
        "device_path_pair_ms": lat("device", 1e3),
        "device_path_pair_ms_alone": {"n": len(alone), "p50": pct(alone, 50),
                                      "max": max(alone)},
        "engine_lock": lock,
        "blocked_share": {c: sum(v != "pass" for _, v in xs) / len(xs)
                          for c, xs in sorted(by_cls.items())},
        "committer_flushes": flushes,
        "flush_entry_widths": {
            w: n - widths0[0].get(w, 0) for w, n in sorted(widths[0].items())},
        "flush_exit_widths": {
            w: n - widths0[1].get(w, 0) for w, n in sorted(widths[1].items())},
        "prefix_launches": launches,
        "prefix_launches_block_sort": launches - tile,
        "prefix_launches_by_shape": {
            f"K={k},N={n},M={m}": c for (k, n, m), c in sorted(by_shape.items())},
    }


def api_script(dev):
    """The seeded single-threaded script on ``dev`` under the frozen
    clock: (verdicts, node_snapshot, seconds)."""
    t0 = time.perf_counter()
    time_util.freeze_time(NOW0)
    try:
        # Rows only for the ruled resources and the script's traffic: the
        # CPU run pays for every row in each of its ~4,000 steps.
        eng = api_engine(dev, capacity=API_PARITY_CAPACITY, register=False)
        waits = []
        submit = eng._submit_entry

        def recorded(*a, **k):
            out = submit(*a, **k)
            waits.append(out[1])
            return out

        eng._submit_entry = recorded
        pools = api_pools()
        rng = np.random.default_rng(23)
        verdicts = []
        for op in range(API_PARITY_OPS):
            if op % API_PARITY_OPS_PER_STEP == 0:
                time_util.advance_time(5)  # flushes the committer first
            cls, res, origin, args, error = api_pick(rng, pools,
                                                     API_PARITY_MIX)
            prioritized = cls.startswith("device") and rng.random() < 0.2
            n_waits = len(waits)
            verdict = api_pair(res, origin, args, error, prioritized)
            if verdict == "pass" and len(waits) > n_waits and waits[-1] > 0:
                verdict = "wait"
            verdicts.append(verdict)
        snapshot = eng.node_snapshot()
        committer = eng.committer
        eng.close()
        failures = committer.failures if committer is not None else 0
        if eng.fail_open_count or failures:
            raise AssertionError(f"{dev}: fail_open_count "
                                 f"{eng.fail_open_count}, committer "
                                 f"failures {failures}")
    finally:
        time_util.unfreeze_time()
    return verdicts, snapshot, time.perf_counter() - t0


def api_phase(dev):
    # Block logs stay inside the checkout (``smoke_logs/``, gitignored).
    config.set(LOG_DIR, str(Path(__file__).resolve().parent / "smoke_logs"))
    mem0 = memory_mark()
    t0 = time.perf_counter()
    eng = api_engine(dev)
    eng._lock = TimedLock(eng._lock)
    out = {"lease_ring": eng.lease_ring}
    if out["lease_ring"] != "native":
        raise AssertionError("the lease ring did not build natively: "
                             f"{build_error()}")
    out.update(api_timed(eng))
    out["fail_open_count"] = eng.fail_open_count
    if eng.fail_open_count:
        raise AssertionError(f"fail_open_count {eng.fail_open_count}")
    st.load_system_rules([st.SystemRule(qps=1e12)])
    out["leases_after_system_rule"] = len(eng._leases)
    out["unruled_fastpath_after_system_rule"] = eng._unruled_fastpath
    if eng._leases or eng._unruled_fastpath:
        raise AssertionError("a fast path survived the system rule")
    committer = eng.committer
    eng.close()
    out["committer_pending_after_close"] = list(committer.pending())
    if committer.pending() != (0, 0) or eng.committer is not None:
        raise AssertionError("close() left queued commits")
    out["committer_failures"] = committer.failures
    if committer.failures:
        raise AssertionError(f"{committer.failures} committer flushes failed")
    timed_s = time.perf_counter() - t0

    runs = {d: api_script(d) for d in ("cuda", "cpu")}
    (vc, sc, tc), (vp, sp, tp) = runs["cuda"], runs["cpu"]
    if vc != vp:
        first = next(i for i, (a, b) in enumerate(zip(vc, vp)) if a != b)
        raise AssertionError(f"API parity: op {first} is {vc[first]} on "
                             f"cuda and {vp[first]} on cpu")
    if set(sc) != set(sp):
        raise AssertionError("API parity: node_snapshot resources differ")
    for res in sc:
        for k, v in sc[res].items():
            if not math.isclose(v, sp[res][k], rel_tol=FLOAT_RTOL, abs_tol=0):
                raise AssertionError(f"API parity: {res}.{k} {v} on cuda, "
                                     f"{sp[res][k]} on cpu")
    out["parity"] = {
        "ops": API_PARITY_OPS, "verdicts_equal": True,
        "node_snapshot_equal": True,
        "verdict_counts": {v: vc.count(v) for v in sorted(set(vc))},
        "cuda_s": tc, "cpu_s": tp}
    out["timed_part_s"] = timed_s
    out["phase_s"] = time.perf_counter() - t0
    out["memory_bytes"] = memory_report(mem0)
    print(json.dumps({"api": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 7: pipelined admission
# ---------------------------------------------------------------------------

PIPE_THREADS = 16
PIPE_WINDOW_S = 10.0
PIPE_MAX_BATCH = 8       # below the producer count (bench.py:338-340)
PIPE_LINGER_S = 0.0002   # bench.py's latency section
PIPE_STREAM_OPS = 90
PIPE_STREAM_SEED = 11


def stream_ops(seed: int, n: int = PIPE_STREAM_OPS):
    """A seeded entry/exit stream of ``tests/test_pipeline.py``'s kind:
    three resources (a QPS quota, a THREAD gauge, a rate limiter), mixed
    acquire counts, random holds and clock advances."""
    import random

    rng = random.Random(seed)
    ops, live = [], []
    for i in range(n):
        if rng.random() < 0.15:
            ops.append(("advance", rng.choice([1, 40, 300, 1000])))
        if live and rng.random() < 0.4:
            ops.append(("exit", live.pop(rng.randrange(len(live)))))
        res = rng.choice(["sa", "sa", "st_thread", "sr"])
        ops.append(("entry", i, res, rng.choice([1, 1, 2, 3])))
        live.append(i)
    return ops


def stream_rules():
    return [st.FlowRule(resource="sa", count=25),
            st.FlowRule(resource="st_thread", count=3,
                        grade=C.FLOW_GRADE_THREAD),
            st.FlowRule(resource="sr", count=40,
                        control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                        max_queueing_time_ms=0)]


def run_stream(ops):
    """The stream through the module API; the verdict of each entry."""
    verdicts, held = [], {}
    for op in ops:
        if op[0] == "advance":
            time_util.advance_time(op[1])
        elif op[0] == "entry":
            try:
                held[op[1]] = st.entry(op[2], count=op[3])
                verdicts.append("pass")
            except st.BlockException as ex:
                verdicts.append(type(ex).__name__)
        elif op[1] in held:
            held.pop(op[1]).exit()
    for h in held.values():
        h.exit()
    return verdicts


def frozen_engine(dev, rules, capacity=512):
    """A fresh default engine under the port's frozen clock."""
    time_util.freeze_time(NOW0)
    eng = st.reset(capacity=capacity, device=dev)
    st.load_flow_rules(rules)
    return eng


def ticket_fields(eng, resource, context="t_ctx"):
    reg = eng.registry
    cr, dr, orow, oid = reg.resolve_entry(
        resource, context, "", reg.entrance_row(context), 0)
    return dict(cluster_row=cr, dn_row=dr, origin_row=orow, origin_id=oid,
                origin_named=False, context_id=reg.context_id(context),
                count=1, prioritized=False, entry_in=False,
                skip_cluster=False, pre_blocked=False, params=())


def pipeline_card_checks(dev):
    """The frozen-clock checks of the pipeline on the card."""
    out = {}
    try:
        # 1. FIFO tickets with two cycles in flight, then a warm pool.
        eng = frozen_engine(dev, [st.FlowRule(resource="deep", count=50),
                                  st.FlowRule(resource="pool", count=1e9)])
        eng.warmup((1, 8))
        pipe = eng.start_pipeline(max_batch=PIPE_MAX_BATCH, linger_s=0.0)
        tickets = [pipe.submit_entry(ticket_fields(eng, "deep"))
                   for _ in range(100)]
        for t in tickets:
            if not t.done.wait(30.0):
                raise AssertionError("a ticket never resolved")
        reasons = [t.reason for t in tickets]
        if reasons != [0] * 50 + [int(C.BlockReason.FLOW)] * 50:
            raise AssertionError(f"ticket verdicts out of FIFO order: "
                                 f"{reasons}")
        if pipe.max_inflight < 2:
            raise AssertionError("the double buffer never engaged")
        for _ in range(6):
            st.entry("pool").exit()
        allocated = pipe.pool.allocated
        for _ in range(40):
            st.entry("pool").exit()
        if pipe.pool.allocated != allocated:
            raise AssertionError("a warm pipeline allocated a staging buffer")
        pinned = all(buf.block.is_pinned() for stack in pipe.pool._free.values()
                     for buf in stack)
        if not pipe.pool.pinned or not pinned:
            raise AssertionError("a staging buffer on the card is not pinned")
        out["fifo_tickets"] = {"tickets": 100, "passed": reasons.count(0),
                               "inflight_depth_max": pipe.max_inflight,
                               "pool_allocated": pipe.pool.allocated,
                               "pool_reused": pipe.pool.reused,
                               "buffers_pinned": True}
        eng.close()

        # 2. A shared quota under 16 concurrent callers.
        eng = frozen_engine(dev, [st.FlowRule(resource="conc", count=25)])
        eng.start_pipeline(max_batch=PIPE_MAX_BATCH, linger_s=0.0005)
        passed = []

        def worker():
            n = 0
            for _ in range(10):
                h = st.entry_ok("conc")
                if h:
                    n += 1
                    h.exit()
            passed.append(n)

        threads = [threading.Thread(target=worker)
                   for _ in range(PIPE_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if sum(passed) != 25:
            raise AssertionError(f"{sum(passed)} of 160 passed a count-25 "
                                 "rule")
        out["shared_quota"] = {"attempts": 160, "passed": sum(passed)}
        eng.close()

        # 3. The same stream synchronously on the card, pipelined on the
        # card, pipelined on the CPU.
        ops = stream_ops(PIPE_STREAM_SEED)
        runs = {}
        for name, d, piped in (("sync_cuda", dev, False),
                               ("pipelined_cuda", dev, True),
                               ("pipelined_cpu", "cpu", True)):
            eng = frozen_engine(d, stream_rules())
            if piped:
                eng.start_pipeline(max_batch=PIPE_MAX_BATCH, linger_s=0.0005)
            verdicts = run_stream(ops)
            eng.stop_pipeline()
            runs[name] = (verdicts, eng.node_snapshot(), eng.fail_open_count)
            eng.close()
        want = runs["sync_cuda"][0]
        for name, (verdicts, _, fail_open) in runs.items():
            if verdicts != want:
                first = next(i for i, (a, b) in enumerate(zip(verdicts, want))
                             if a != b)
                raise AssertionError(f"stream op {first}: {verdicts[first]} "
                                     f"{name}, {want[first]} sync_cuda")
            if fail_open:
                raise AssertionError(f"{name}: fail_open_count {fail_open}")
        sc, sp = runs["pipelined_cuda"][1], runs["pipelined_cpu"][1]
        if set(sc) != set(sp):
            raise AssertionError("pipelined node_snapshot resources differ")
        for res in sc:
            for k, v in sc[res].items():
                if not math.isclose(v, sp[res][k], rel_tol=FLOAT_RTOL,
                                    abs_tol=0):
                    raise AssertionError(f"pipelined {res}.{k}: {v} on cuda, "
                                         f"{sp[res][k]} on cpu")
        out["stream"] = {"ops": len(ops), "entries": len(want),
                         "verdicts_equal": True, "node_snapshot_equal": True,
                         "verdict_counts": {v: want.count(v)
                                            for v in sorted(set(want))}}
    finally:
        time_util.unfreeze_time()
    return out


def pipeline_phase(dev):
    """16 producers of ``st.entry`` pairs for a fixed window under the
    pipeline, then the frozen-clock card checks; prints the
    ``{"pipeline": ...}`` line."""
    t0 = time.perf_counter()
    mem0 = memory_mark()
    pools = api_pools()
    eng = api_engine(dev)
    eng.warmup((1, 8, 64))
    eng._lock = TimedLock(eng._lock)
    pipe = eng.start_pipeline(max_batch=PIPE_MAX_BATCH, linger_s=PIPE_LINGER_S)
    results = [None] * PIPE_THREADS
    barrier = threading.Barrier(PIPE_THREADS + 1)
    window = {}

    def worker(t):
        rng = np.random.default_rng(2000 + t)
        out = []
        barrier.wait()
        end = window["end"]
        while time.perf_counter() < end:
            cls, res, origin, args, error = api_pick(rng, pools, API_MIX)
            t1 = time.perf_counter()
            verdict = api_pair(res, origin, args, error)
            out.append((cls, time.perf_counter() - t1, verdict))
        results[t] = out

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(PIPE_THREADS)]
    for th in threads:
        th.start()
    torch.cuda.synchronize()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    h2d0 = H2D.copies
    eng.step_timer.snapshot(reset=True)
    eng._lock.samples.clear()
    t1 = time.perf_counter()
    window["end"] = t1 + PIPE_WINDOW_S
    barrier.wait()
    for th in threads:
        th.join()
    wall_s = time.perf_counter() - t1
    lock = eng._lock.report(wall_s)
    eng.stop_pipeline()
    torch.cuda.synchronize()
    launches = prefix_cuda.launches
    tile = prefix_cuda.tile_launches
    by_shape = dict(prefix_cuda.launches_by_shape)
    h2d = H2D.copies - h2d0
    steps = eng.step_timer.snapshot()
    stats = eng.pipeline_stats()
    inflight_left = pipe.inflight_depth_now()
    eng._flush_committer()
    threads_left = int(eng.state.cur_threads.sum())
    eng.traces.drain()
    traces = eng.traces.snapshot(limit=0)
    fail_open = eng.fail_open_count
    committer = eng.committer
    eng.close()
    rows = [r for out in results for r in out]
    by_cls = {}
    for cls, dt, verdict in rows:
        by_cls.setdefault(cls, []).append((dt, verdict))
    all_ms = [dt * 1e3 for _, dt, _ in rows]
    batches = sum(steps.get(k, {}).get("dispatches", 0)
                  for k in ("entry", "exit"))

    if stats["failOpenCycles"] or fail_open:
        raise AssertionError(f"failOpenCycles {stats['failOpenCycles']}, "
                             f"fail_open_count {fail_open}")
    if stats["batched"] <= stats["cycles"]:
        raise AssertionError(f"batching never engaged: {stats['batched']} "
                             f"entries in {stats['cycles']} cycles")
    if launches <= 0 or tile:
        raise AssertionError(f"prefix launches {launches}, tile walk {tile}")
    if inflight_left or threads_left:
        raise AssertionError(f"after stop: {inflight_left} cycles in flight, "
                             f"thread gauges sum to {threads_left}")
    if traces["errors"]:
        raise AssertionError(f"trace pump errors {traces['errors']}")
    if committer is not None and (committer.pending() != (0, 0)
                                  or committer.failures):
        raise AssertionError(f"committer after close: {committer.pending()} "
                             f"pending, {committer.failures} failures")
    out = {
        "threads": PIPE_THREADS, "window_s": PIPE_WINDOW_S,
        "max_batch": PIPE_MAX_BATCH, "linger_s": PIPE_LINGER_S,
        "wall_s": wall_s, "pairs": len(rows),
        "pairs_per_s": len(rows) / wall_s,
        "pair_ms": {"p50": pct(all_ms, 50), "p99": pct(all_ms, 99)},
        "pair_ms_by_class": {
            c: {"n": len(xs), "p50": pct([dt * 1e3 for dt, _ in xs], 50),
                "p99": pct([dt * 1e3 for dt, _ in xs], 99)}
            for c, xs in sorted(by_cls.items())},
        "blocked_share": {c: sum(v != "pass" for _, v in xs) / len(xs)
                          for c, xs in sorted(by_cls.items())},
        "pipeline_stats": stats,
        "mean_cycle_width": stats["batched"] / stats["cycles"],
        "entry_cycle_ladder_widths": dict(sorted(pipe.widths.items())),
        "step_timer": steps,
        "engine_lock": lock,
        "prefix_launches": launches,
        "prefix_launches_block_sort": launches - tile,
        "prefix_launches_by_shape": {
            f"K={k},N={n},M={m}": c for (k, n, m), c in sorted(by_shape.items())},
        "h2d_copies": h2d,
        "h2d_copies_per_batch": h2d / batches if batches else None,
        "h2d_copies_per_entry_cycle": h2d / stats["cycles"],
        "traces": {k: traces[k] for k in ("seenBlocked", "recorded",
                                          "droppedBatches", "errors")},
        "fail_open_count": fail_open,
        "inflight_after_stop": inflight_left,
        "thread_gauges_after_stop": threads_left,
        "committer_started": committer is not None,
    }
    out["card_checks"] = pipeline_card_checks(dev)
    out["phase_s"] = time.perf_counter() - t0
    out["memory_bytes"] = memory_report(mem0)
    print(json.dumps({"pipeline": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 8: slot-table admission and the once-per-second fold
# ---------------------------------------------------------------------------

SLOT_ORACLE_NAMES = 16
SLOT_ORACLE_SECONDS = 10
SLOT_ORACLE_PAIRS = 20
# The timed run at a deployment's size (docs/OPERATIONS.md "Slot-table
# admission": registry 16,384 names, 8 steals a tick, 20% hysteresis):
# 4,096 usable device rows, 4,000 of them pinned by leaseable QPS rules.
SLOT_BUDGET = 4098
SLOT_RULED = 4000
SLOT_TAIL = 12000
SLOT_LEASED_PER_S = 1024
SLOT_TAIL_PER_S = 64
SLOT_SECONDS = 10
SLOT_PHASE_LIMIT_S = 120.0


class SlotRun:
    """One slot-mode engine on an injected clock, its event sink kept."""

    def __init__(self, dev, budget, flow=()):
        from sentinel_tpu_torch.core import context as ctx_mod

        ctx_mod.replace_context(None)
        self.clock = Clock(NOW0)
        self.eng = SentinelEngine(device=dev, clock=self.clock,
                                  slot_budget=budget)
        self.events = []
        self.eng.slots.event_sink = self.events.append
        if flow:
            self.eng.flow_rules.load_rules(
                [F.FlowRule(resource=r, count=c) for r, c in flow])

    def serve(self, res) -> str:
        try:
            self.eng.entry(res).exit()
            return "P"
        except st.BlockException:
            return "B"

    def second(self):
        """Land the second's leased commits, step the clock, run the fold
        (``timeseries_view`` flushes the committer and spills)."""
        self.eng._flush_committer()
        self.clock.now += 1000
        return self.eng.timeseries_view(now_ms=self.clock.now)

    def result(self, verdicts):
        from sentinel_tpu_torch.core import context as ctx_mod

        eng = self.eng
        view = eng.timeseries_view(now_ms=self.clock.now)
        with eng._lock:
            state = convert.state_to_numpy(eng.state)
        out = {"verdicts": "".join(verdicts), "status": eng.slots.status(),
               "events": list(self.events), "view": view, "state": state,
               "fail_open": eng.fail_open_count}
        committer = eng.committer
        eng.close()
        out["committer_failures"] = committer.failures if committer else 0
        ctx_mod.replace_context(None)
        return out


def slot_oracle(dev):
    """The reference's differential oracle (tests/test_slots.py): a
    6-usable-slot engine and a 62-usable-slot twin on one Zipf stream."""
    import random

    names = [f"oracle{i}" for i in range(SLOT_ORACLE_NAMES)]
    flow = [(names[i], 3) for i in (0, 5, 10)]
    weights = [1.0 / (i + 1) ** 1.2 for i in range(SLOT_ORACLE_NAMES)]
    out = {}
    for budget in (8, 64):
        run = SlotRun(dev, budget, flow)
        rng = random.Random(1234)
        verdicts = []
        for _ in range(SLOT_ORACLE_SECONDS):
            for _ in range(SLOT_ORACLE_PAIRS):
                verdicts.append(run.serve(
                    rng.choices(names, weights=weights)[0]))
            run.second()
        out[budget] = run.result(verdicts)
    return out


def slot_storm(dev):
    """The reference's storm drill: budget 3 (one usable slot),
    ``slots.evict.storm`` armed after=2, times=2."""
    from sentinel_tpu_torch.resilience.faults import FaultInjector

    run = SlotRun(dev, 3)
    plan = [["alpha"] * 3, ["alpha"] * 2, [], ["beta"] * 3,
            ["alpha"] * 2 + ["beta"], ["alpha", "beta"]]
    verdicts = []
    with FaultInjector(seed=99, scope_thread=True) as inj:
        inj.arm("slots.evict.storm", mode="error", after=2, times=2)
        for second in plan:
            for res in second:
                verdicts.append(run.serve(res))
            run.second()
    return run.result(verdicts)


def slot_exactness():
    """Card against CPU: the oracle and the storm drill give the same
    verdicts, statuses, event histories, views and states on both."""
    runs = {dev: {"oracle": slot_oracle(dev), "storm": slot_storm(dev)}
            for dev in ("cuda", "cpu")}
    cuda, cpu = runs["cuda"], runs["cpu"]
    pairs = [(f"oracle{b}", cuda["oracle"][b], cpu["oracle"][b])
             for b in (8, 64)] + [("storm", cuda["storm"], cpu["storm"])]
    for name, a, b in pairs:
        for k in ("verdicts", "status", "events", "view"):
            if a[k] != b[k]:
                raise AssertionError(f"slot {name}: {k} differs between "
                                     "cuda and cpu")
        compare_states(a["state"], b["state"], name)
        if a["fail_open"] or a["committer_failures"]:
            raise AssertionError(f"slot {name}: fail-open {a['fail_open']}, "
                                 f"committer failures "
                                 f"{a['committer_failures']}")
    small, twin = cuda["oracle"][8], cuda["oracle"][64]
    if small["verdicts"] != twin["verdicts"]:
        raise AssertionError("eviction changed a verdict on the card")
    if small["status"]["evictionsTotal"] <= 0 \
            or twin["status"]["evictionsTotal"] != 0:
        raise AssertionError("the budget-8 engine must evict and the "
                             "budget-64 twin must not")
    if cuda["storm"]["status"]["stormsTotal"] != 2:
        raise AssertionError("the storm drill did not storm twice")
    return {
        "oracle_verdicts": small["verdicts"].count("P"),
        "oracle_blocks": small["verdicts"].count("B"),
        "oracle_budget8": {k: small["status"][k] for k in (
            "evictionsTotal", "rehydrationsTotal", "coldPassTotal",
            "hitRate")},
        "storm_events": len(cuda["storm"]["events"]),
        "storm_status": {k: cuda["storm"]["status"][k] for k in (
            "stormsTotal", "evictionsTotal", "rehydrationsTotal",
            "coldPassTotal")},
        "cuda_equals_cpu": True,
    }


def slot_timed(dev):
    """4,000 pinned leaseable resources and a Zipf(1.2) tail of 12,000
    unruled names contesting the 96 dynamic slots, 10 simulated seconds
    of 1,024 leased and 64 tail pairs each, one fold a second."""
    torch.cuda.synchronize()
    mem0 = memory_mark()  # the engine's own state counts above it
    run = SlotRun(dev, SLOT_BUDGET)
    eng, slots = run.eng, run.eng.slots
    ruled = [f"slot_hot{i}" for i in range(SLOT_RULED)]
    tail = [f"slot_tail{i}" for i in range(SLOT_TAIL)]
    surgeries = []

    execute = slots._execute

    def timed_execute(evicts, admits, now_ms):
        torch.cuda.synchronize()
        b0 = (slots.surgery_h2d_bytes_total, slots.surgery_d2h_bytes_total)
        t0 = time.perf_counter()
        execute(evicts, admits, now_ms)
        torch.cuda.synchronize()
        surgeries.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "evicts": len(evicts), "admits": len(admits),
            "h2d_bytes": slots.surgery_h2d_bytes_total - b0[0],
            "d2h_bytes": slots.surgery_d2h_bytes_total - b0[1]})

    slots._execute = timed_execute
    t0 = time.perf_counter()
    eng.flow_rules.load_rules([F.FlowRule(resource=r, count=1e9)
                               for r in ruled])
    pin_s = time.perf_counter() - t0
    pin_surgery = surgeries.pop() if surgeries else None
    missing = [r for r in ruled if slots.current(r) is None
               or r not in eng._leases]
    if missing:
        raise AssertionError(f"{len(missing)} ruled resources are not "
                             "pinned hot and leased")
    eng.warmup((1,))

    spill = eng._spill_flight
    folds = []

    def timed_spill(now_ms=None):
        n = len(surgeries)
        t1 = time.perf_counter()
        spill(now_ms)
        torch.cuda.synchronize()
        took = (time.perf_counter() - t1) * 1e3
        folds.append({"ms": took, "surgery_ms": sum(
            x["ms"] for x in surgeries[n:])})

    eng._spill_flight = timed_spill
    torch.cuda.synchronize()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    import hashlib

    # The draws, made up front (the tail as bench.py draws its Zipf
    # churn); their hash says whether two runs served the same stream.
    rng = np.random.default_rng(20)
    pick = np.random.default_rng(21)
    draws = []
    digest = hashlib.sha256()
    for _ in range(SLOT_SECONDS):
        leased = pick.integers(0, SLOT_RULED, size=SLOT_LEASED_PER_S)
        tail_i = np.minimum(rng.zipf(1.2, size=SLOT_TAIL_PER_S), SLOT_TAIL) - 1
        digest.update(leased.tobytes())
        digest.update(tail_i.tobytes())
        draws.append((leased, tail_i))
    leased_us, tail_ms, served = [], [], 0
    t0 = time.perf_counter()
    for leased, tail_i in draws:
        for i in leased:
            t1 = time.perf_counter()
            if run.serve(ruled[int(i)]) != "P":
                raise AssertionError("a leased pair blocked at count 1e9")
            leased_us.append((time.perf_counter() - t1) * 1e6)
        for i in tail_i:
            t1 = time.perf_counter()
            if run.serve(tail[int(i)]) != "P":
                raise AssertionError("an unruled pair blocked")
            tail_ms.append((time.perf_counter() - t1) * 1e3)
        served += SLOT_LEASED_PER_S + SLOT_TAIL_PER_S
        run.second()
    eng._flush_committer()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = prefix_cuda.launches
    tile = prefix_cuda.tile_launches
    by_shape = dict(prefix_cuda.launches_by_shape)
    memory = memory_report(mem0)
    status = slots.status()

    # Conservation: every served PASS is on the device at its current
    # slot, in a spill record, or in a cold tally.
    PASS = C.MetricEvent.PASS
    with eng._lock:
        state = eng.state
        dev_pass = (state.telemetry.totals[PASS]
                    + state.sec.counts[PASS].to(torch.int64)).cpu().numpy()
        ring = state.flight
        flight_bytes = ring_bytes(ring) if ring is not None else 0
    on_device = sum(int(dev_pass[slot])
                    for slot in slots.resources().values())
    in_spill = sum(int(rec.tel_totals[PASS]) + int(rec.sec_counts[PASS])
                   for rec in slots._spill.values())
    in_cold = sum(int(vec[PASS]) for vec in slots._cold.values())
    ruled_set = set(ruled)
    evicted_pinned = [e["resource"] for e in run.events
                      if e["e"] == "slotEvict" and e["resource"] in ruled_set]
    committer = eng.committer
    failures = committer.failures if committer is not None else 0
    fail_open = eng.fail_open_count

    if status["evictionsTotal"] <= 0 or status["rehydrationsTotal"] <= 0 \
            or status["coldPassTotal"] <= 0:
        raise AssertionError(f"the slot table did not churn: {status}")
    if status["coldBlockTotal"] != 0:
        raise AssertionError(f"coldBlockTotal {status['coldBlockTotal']}")
    if evicted_pinned:
        raise AssertionError(f"pinned resources evicted: {evicted_pinned[:5]}")
    if fail_open or failures:
        raise AssertionError(f"fail-open {fail_open}, committer failures "
                             f"{failures}")
    if on_device + in_spill + in_cold != served:
        raise AssertionError(
            f"PASS not conserved: device {on_device} + spill {in_spill} + "
            f"cold {in_cold} != served {served}")
    if launches <= 0 or tile:
        raise AssertionError(f"prefix launches {launches}, tile walk {tile}")
    if eng.registry.overflow_count:
        raise AssertionError(f"registry overflow {eng.registry.overflow_count}")
    ms = [x["ms"] for x in surgeries]
    spill_ms = [f["ms"] - f["surgery_ms"] for f in folds]
    by_kind = {}
    for x in surgeries:
        k = by_kind.setdefault(f"evicts={x['evicts']},admits={x['admits']}",
                               {"n": 0, "h2d_bytes": x["h2d_bytes"],
                                "d2h_bytes": x["d2h_bytes"], "ms": []})
        k["n"] += 1
        k["ms"].append(x["ms"])
    for k in by_kind.values():
        k["ms_p50"] = pct(k.pop("ms"), 50)
    # The engine stays open for the boot phase's slot-mode checkpoint.
    return run, {
        "budget": SLOT_BUDGET, "ruled": SLOT_RULED, "tail_names": SLOT_TAIL,
        "seconds": SLOT_SECONDS, "pairs": served, "wall_s": wall_s,
        "draws_sha256": digest.hexdigest()[:16],
        "pairs_per_s": served / wall_s,
        "leased_pair_us": {"n": len(leased_us), "p50": pct(leased_us, 50),
                           "p99": pct(leased_us, 99)},
        "tail_pair_ms": {"n": len(tail_ms), "p50": pct(tail_ms, 50),
                         "p99": pct(tail_ms, 99)},
        "hit_rate": status["hitRate"],
        "steals": status["stealsTotal"],
        "evictions": status["evictionsTotal"],
        "rehydrations": status["rehydrationsTotal"],
        "cold_pass": status["coldPassTotal"],
        "status": status,
        "pin_load_s": pin_s, "pin_surgery": pin_surgery,
        "surgeries": {
            "n": len(surgeries), "ms_p50": pct(ms, 50),
            "ms_max": max(ms) if ms else None,
            "h2d_bytes_total": sum(x["h2d_bytes"] for x in surgeries),
            "d2h_bytes_total": sum(x["d2h_bytes"] for x in surgeries),
            "by_kind": by_kind},
        "folds": len(folds),
        "spill_ms_p50": pct(spill_ms, 50),
        "fold_ms_p50": pct([f["ms"] for f in folds], 50),
        "conservation": {"served": served, "on_device": on_device,
                         "in_spill": in_spill, "in_cold": in_cold},
        "prefix_launches": launches,
        "prefix_launches_block_sort": launches - tile,
        "prefix_launches_by_shape": {
            f"K={k},N={n},M={m}": c for (k, n, m), c in sorted(by_shape.items())},
        "flight_ring_bytes": flight_bytes,
        "memory_bytes": memory,
    }


def slot_phase(dev):
    t0 = time.perf_counter()
    out = {"exactness": slot_exactness()}
    out["exactness_s"] = time.perf_counter() - t0
    run, out["timed"] = slot_timed(dev)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"slots": out}), flush=True)
    if out["phase_s"] > SLOT_PHASE_LIMIT_S:
        raise AssertionError(f"slot phase took {out['phase_s']:.1f} s, over "
                             f"{SLOT_PHASE_LIMIT_S} s")
    return out, run


# ---------------------------------------------------------------------------
# Phase 9: the engine's boot surface (config seeding, checkpoints, SPI)
# ---------------------------------------------------------------------------

BOOT_KEYS = {"csp.sentinel.statistic.interval.ms": ("2000", "1000"),
             "csp.sentinel.statistic.sample.count": ("4", "2"),
             "csp.sentinel.occupy.timeout.ms": ("250", "500")}
BOOT_CAPACITY = 1_024
# Cut from 2,000 stream pairs over 20 s and 1,000 SPI pairs over 10 s, at
# the same rates, to keep the phase well inside its 60 s: on an H100
# (700 W) it took 57.3 s with 1,000 and 500.
BOOT_STREAM_PAIRS = 500
BOOT_STREAM_SECONDS = 5
BOOT_PAIRS_PER_STEP = 8
BOOT_SAVES = 5
BOOT_RESTORE_BATCHES = 8
BOOT_RESTORE_WIDTH = 8_192
BOOT_TIMER_PERIOD_S = 0.5
BOOT_TIMER_WINDOW_S = 3.0
BOOT_TIMER_MIN_FILES = 4
BOOT_SPI_PAIRS = 250
BOOT_SPI_STEP_MS = 10
BOOT_PHASE_LIMIT_S = 60.0
CKPT_DIR = Path(__file__).resolve().parent / "smoke_logs" / "checkpoints"


def boot_stream_ops(seed: int = 31):
    """(resource, count, prioritized, error) per pair: a leased QPS quota,
    a leased warm-up rule and an unruled name on the host, a rate limiter
    and a degraded resource on the device path."""
    rng = np.random.default_rng(seed)
    names = ("bq", "bw", "bu", "brl", "bd")
    ops = []
    for _ in range(BOOT_STREAM_PAIRS):
        res = names[int(rng.choice(5, p=(0.3, 0.3, 0.3, 0.05, 0.05)))]
        ops.append((res, int(rng.integers(1, 3)),
                    res == "bq" and rng.random() < 0.005,
                    res == "bd" and rng.random() < 0.6))
    return ops


def boot_rules(eng) -> None:
    """The stream's rules, compiled at once: a compile that the committer's
    background flush ran would intern the rules' rows at a moment set by
    thread timing, so row numbers would differ between two runs."""
    eng.flow_rules.load_rules([
        st.FlowRule(resource="bq", count=20),
        st.FlowRule(resource="bw", count=60,
                    control_behavior=C.CONTROL_BEHAVIOR_WARM_UP,
                    warm_up_period_sec=5),
        st.FlowRule(resource="brl", count=25,
                    control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                    max_queueing_time_ms=10)])
    eng.degrade_rules.load_rules([st.DegradeRule(
        resource="bd", count=0.5, grade=C.DEGRADE_GRADE_EXCEPTION_RATIO,
        time_window=2, min_request_amount=5)])
    with eng._lock, eng._on_stream():
        eng._ensure_compiled()


class BusinessError(Exception):
    """The error a guarded call of the boot stream raises (traced by the
    entry's ``with`` block as an exception, never a block)."""


def boot_drive(eng, clock, ops):
    """Each pair ``with eng.entry(...)``, 8 to a clock step, the
    committer flushed before every step (so leased commits land in the
    second they were admitted in on both devices): the verdict of each."""
    from sentinel_tpu_torch.core import context as ctx_mod

    step_ms = BOOT_STREAM_SECONDS * 1000 * BOOT_PAIRS_PER_STEP \
        // BOOT_STREAM_PAIRS
    waits = []
    submit = eng._submit_entry

    def recorded(*a, **k):
        out = submit(*a, **k)
        waits.append(out[1])
        return out

    eng._submit_entry = recorded
    verdicts = []
    try:
        for i, (res, count, prioritized, error) in enumerate(ops):
            if i % BOOT_PAIRS_PER_STEP == 0:
                eng._flush_committer()
                clock.now += step_ms
            n = len(waits)
            try:
                with eng.entry(res, count=count, prioritized=prioritized):
                    if error:
                        raise BusinessError()
            except st.BlockException as ex:
                verdicts.append(type(ex).__name__)
                continue
            except BusinessError:
                pass
            verdicts.append("wait" if len(waits) > n and waits[-1] > 0
                            else "pass")
        eng._flush_committer()
    finally:
        del eng._submit_entry
        ctx_mod.replace_context(None)
    return verdicts


def boot_config_run(dev, ops):
    """Engine under 2000 / 4 / 250 from config: the stream, then the two
    push properties (accepted, then an equal push refused), the stream
    again."""
    from sentinel_tpu_torch.core import context as ctx_mod

    t0 = time.perf_counter()
    # A pooled context of an earlier engine on this thread holds that
    # engine's rows: retire it, or the rows interned here would differ.
    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    for key, (value, _) in BOOT_KEYS.items():
        config.set(key, value)
    clock = Clock(NOW0)
    try:
        eng = SentinelEngine(capacity=BOOT_CAPACITY, device=dev, clock=clock)
    finally:
        for key, (_, default) in BOOT_KEYS.items():
            config.set(key, default)
    seeded = (eng._spec1.interval_ms, eng._spec1.buckets,
              eng._occupy_timeout_ms)
    if seeded != (2000, 4, 250):
        raise AssertionError(f"{dev}: config seeded {seeded}, not "
                             "(2000, 4, 250)")
    boot_rules(eng)
    out = {"seeded": seeded, "first": boot_drive(eng, clock, ops)}
    with eng._lock:
        out["first_state"] = convert.state_to_numpy(eng.state)
    push = ({"intervalMs": 1000, "sampleCount": 2}, 250)
    out["push"] = [eng.window_geometry_property.update_value(push[0]),
                   eng.occupy_timeout_property.update_value(push[1])]
    out["equal_push"] = [eng.window_geometry_property.update_value(push[0]),
                         eng.occupy_timeout_property.update_value(push[1])]
    out["pushed"] = (eng._spec1.interval_ms, eng._spec1.buckets,
                     eng._occupy_timeout_ms)
    if out["push"] != [True, True] or out["equal_push"] != [False, False] \
            or out["pushed"] != (1000, 2, 250):
        raise AssertionError(f"{dev}: pushes {out['push']}, equal pushes "
                             f"{out['equal_push']}, pushed {out['pushed']}")
    out["second"] = boot_drive(eng, clock, ops)
    with eng._lock:
        out["second_state"] = convert.state_to_numpy(eng.state)
    out["fail_open"] = eng.fail_open_count
    committer = eng.committer
    eng.close()
    out["committer_failures"] = committer.failures if committer else 0
    out["s"] = time.perf_counter() - t0
    return out


def boot_config(dev):
    ops = boot_stream_ops()
    runs = {d: boot_config_run(d, ops) for d in (dev, "cpu")}
    card, cpu = runs[dev], runs["cpu"]
    for part in ("first", "second"):
        if card[part] != cpu[part]:
            i = next(i for i, (a, b) in enumerate(zip(card[part], cpu[part]))
                     if a != b)
            raise AssertionError(f"boot config stream ({part}) pair {i}: "
                                 f"{card[part][i]} on the card, "
                                 f"{cpu[part][i]} on the CPU")
        compare_states(card[f"{part}_state"], cpu[f"{part}_state"],
                       f"boot config {part}")
    for name, run in runs.items():
        if run["fail_open"] or run["committer_failures"]:
            raise AssertionError(f"boot config {name}: fail-open "
                                 f"{run['fail_open']}, committer failures "
                                 f"{run['committer_failures']}")
    verdicts = card["first"] + card["second"]
    if not {"pass", "FlowException", "DegradeException"} <= set(verdicts):
        raise AssertionError(f"the boot stream blocked too little: "
                             f"{sorted(set(verdicts))}")
    return {"pairs": 2 * len(ops), "card_s": card["s"], "cpu_s": cpu["s"],
            "seeded": card["seeded"],
            "pushed": card["pushed"], "push": card["push"],
            "equal_push": card["equal_push"], "card_equals_cpu": True,
            "verdict_counts": {v: verdicts.count(v)
                               for v in sorted(set(verdicts))}}


def restored_equal(eng, arrays, what):
    """The engine's persisted tensors equal the file's, bit for bit, on the
    engine's device; the thread gauges zero."""
    got = _state_arrays(eng.state)
    for name, want in arrays.items():
        t = got[name]
        if t.device.type != eng.device.type or tuple(t.shape) != want.shape \
                or t.dtype != torch.from_numpy(want).dtype:
            raise AssertionError(f"{what}: {name} is {t.dtype}"
                                 f"{list(t.shape)} on {t.device}")
        if name == "cur_threads":
            if int(t.abs().sum()):
                raise AssertionError(f"{what}: cur_threads not zero")
        elif not np.array_equal(t.cpu().numpy(), want):
            raise AssertionError(f"{what}: {name} differs from the file")


def boot_restart(dev, main, slot_run):
    """Warm restart at the main path's size and in slot mode, and the
    background timer."""
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    meng, mclock = main["eng"], main["clock"]
    out = {}
    # The main-path engine must come out unchanged: a device copy of its
    # whole state, compared after the saves.
    with meng._lock:
        before = [t.clone() for t in state_tensors(meng.state)]
    inner = meng._lock
    meng._lock = TimedLock(inner)
    path = str(CKPT_DIR / "main.npz")
    save_ms = []
    for _ in range(BOOT_SAVES):
        t0 = time.perf_counter()
        st.save_checkpoint(meng, path)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    holds = [h * 1e3 for key, _, h in meng._lock.samples
             if key.endswith(":save_checkpoint")]
    meng._lock = inner
    if len(holds) != BOOT_SAVES:
        raise AssertionError(f"{len(holds)} save lock holds for "
                             f"{BOOT_SAVES} saves")
    with meng._lock:
        after = state_tensors(meng.state)
        if len(after) != len(before) or not all(
                torch.equal(a, b) for a, b in zip(before, after)):
            raise AssertionError("a save changed the main-path engine's state")
    _, arrays = _load_npz(path)
    with meng._lock:
        for name, t in _state_arrays(meng.state).items():
            if not np.array_equal(t.cpu().numpy(), arrays[name]):
                raise AssertionError(f"main checkpoint: {name} differs from "
                                     "the engine")
    del before, after
    out["main"] = {
        "capacity": meng.capacity, "file_bytes": os.path.getsize(path),
        "persisted_bytes": sum(a.nbytes for a in arrays.values()),
        "lock_held_ms": {"p50": pct(holds, 50), "max": max(holds)},
        "save_ms": {"p50": pct(save_ms, 50), "max": max(save_ms)}}
    # Restore into a fresh card engine and a fresh CPU engine; the next
    # batches decide the same on both.
    restored = {}
    for d in (dev, "cpu"):
        clock = Clock(mclock.now)
        eng = SentinelEngine(capacity=CAPACITY, device=d, clock=clock)
        load_rules(eng, tight=False)
        if d == dev:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.restore_checkpoint(eng, path)
        if d == dev:
            torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        restored_equal(eng, arrays, f"main restore on {d}")
        restored[d] = (eng, clock, restore_ms)
    out["main"]["restore_ms"] = restored[dev][2]
    out["main"]["restore_ms_cpu"] = restored["cpu"][2]
    rng = np.random.default_rng(41)
    for r in range(BOOT_RESTORE_BATCHES):
        buf = entry_buf(rng, BOOT_RESTORE_WIDTH, main["cluster"], main["dn"],
                        main["origin_a"], mixed=(r % 2 == 1))
        decs = []
        for d in (dev, "cpu"):
            eng, clock, _ = restored[d]
            clock.now += 50
            dec = eng.check_batch(buf)
            decs.append({f: getattr(dec, f).cpu().numpy()
                         for f in dec._fields})
        for f in decs[0]:
            if not np.array_equal(decs[0][f], decs[1][f]):
                raise AssertionError(f"restored batch {r}: decisions.{f} "
                                     "differ between the card and the CPU")
    restored["cpu"][0].close()
    out["main"].update({"restored_bit_equal": True,
                        "next_batches_equal": BOOT_RESTORE_BATCHES})
    # Slot mode: the slot phase's engine after its timed run.
    seng = slot_run.eng
    spath = str(CKPT_DIR / "slots.npz")
    t0 = time.perf_counter()
    st.save_checkpoint(seng, spath)
    slot_save_ms = (time.perf_counter() - t0) * 1e3
    saved = seng.slots.checkpoint_dict()
    seng.close()
    _, sarrays = _load_npz(spath)
    for d in (dev, "cpu"):
        from sentinel_tpu_torch.core import context as ctx_mod

        ctx_mod.replace_context(None)
        eng = SentinelEngine(device=d, clock=Clock(slot_run.clock.now),
                             slot_budget=SLOT_BUDGET)
        st.restore_checkpoint(eng, spath)
        if eng.slots.checkpoint_dict() != saved:
            raise AssertionError(f"slot restore on {d}: the assignment "
                                 "differs from the saved one")
        restored_equal(eng, sarrays, f"slot restore on {d}")
        eng.close()
    out["slots"] = {"budget": SLOT_BUDGET, "hot": len(saved["hot"]),
                    "file_bytes": os.path.getsize(spath),
                    "persisted_bytes": sum(a.nbytes for a in
                                           sarrays.values()),
                    "save_ms": slot_save_ms, "assignment_equal": True}
    out["timer"] = boot_timer(dev)
    return out, (restored[dev][0], restored[dev][1], buf)


def state_tensors(state):
    """Every tensor of a state, in field order."""
    out = []
    for v in state:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(state_tensors(v))
    return out


def boot_timer(dev):
    """A CheckpointTimer every 0.5 s on the API phase's engine while one
    thread serves its traffic mix: each save goes to a file of its own,
    every file must load and no save may fail."""
    eng = api_engine(dev)
    paths, failures = [], []

    def save(engine, _path):
        path = str(CKPT_DIR / f"timer{len(paths)}.npz")
        try:
            st.save_checkpoint(engine, path)
        except Exception as ex:  # noqa: BLE001 — counted, then re-raised
            failures.append(repr(ex))
            raise
        paths.append(path)

    pools = api_pools()
    rng = np.random.default_rng(43)
    timer = st.CheckpointTimer(eng, str(CKPT_DIR / "timer.npz"),
                               period_s=BOOT_TIMER_PERIOD_S, save=save)
    pairs = 0
    t0 = time.perf_counter()
    timer.start()
    try:
        # At least the window; on until the timer has written its files
        # (a slow host's compression can stretch a period).
        while time.perf_counter() - t0 < BOOT_TIMER_WINDOW_S or (
                len(paths) < BOOT_TIMER_MIN_FILES
                and time.perf_counter() - t0 < 4 * BOOT_TIMER_WINDOW_S):
            _, res, origin, args, error = api_pick(rng, pools, API_MIX)
            api_pair(res, origin, args, error)
            pairs += 1
    finally:
        timer.stop()
    window_s = time.perf_counter() - t0
    for path in paths:
        _load_npz(path)
    committer = eng.committer
    eng.close()
    if failures or len(paths) < BOOT_TIMER_MIN_FILES:
        raise AssertionError(f"timer wrote {len(paths)} files, failures "
                             f"{failures}")
    if eng.fail_open_count or (committer and committer.failures):
        raise AssertionError("the timer run failed open")
    return {"period_s": BOOT_TIMER_PERIOD_S, "window_s": window_s,
            "pairs": pairs, "files": len(paths), "all_load": True,
            "failures": 0}


def cap_big_acquires(state, rules, batch, now_ms, candidate):
    """tests/test_spi.py:91's checker: no acquire of more than 3."""
    return candidate & (batch.count > 3)


def two_per_second(state, rules, batch, now_ms, candidate):
    """tests/test_spi.py:112's checker: 2 PASS a second per cluster row."""
    from sentinel_tpu_torch.ops import window as W

    used = W.row_totals(state.w1, batch.cluster_row)[:, C.MetricEvent.PASS]
    return candidate & (used >= 2)


def boot_spi_run(dev):
    """The API phase's engine kind (capacity 8,192 as its parity script)
    under the frozen clock: ``BOOT_SPI_PAIRS`` pairs 10 ms apart with both
    checkers registered, then leased pairs after unregistering them."""
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.core import spi

    t0 = time.perf_counter()
    time_util.freeze_time(NOW0)
    try:
        ctx_mod.replace_context(None)
        ctx_mod.bump_generation()
        eng = api_engine(dev, capacity=API_PARITY_CAPACITY, register=False)
        # Five names a class: ~3 pairs a name a second, so the 2-a-second
        # checker has rows to block.
        pools = {k: v[:5] for k, v in api_pools().items()}
        device_calls = []
        submit = eng._submit_entry

        def counted(*a, **k):
            device_calls.append(1)
            return submit(*a, **k)

        eng._submit_entry = counted
        decisions = []
        step = eng._entry_step

        def recorded(*a, **k):
            state, dec = step(*a, **k)
            decisions.append((dec.reason.cpu().numpy().tolist(),
                              dec.rule_slot.cpu().numpy().tolist()))
            return state, dec

        eng._entry_step = recorded
        spi.register_device_checker(cap_big_acquires, order=-1)
        spi.register_device_checker(two_per_second, order=1)
        rng = np.random.default_rng(47)
        verdicts = []
        try:
            for _ in range(BOOT_SPI_PAIRS):
                time_util.advance_time(BOOT_SPI_STEP_MS)
                _, res, origin, args, error = api_pick(rng, pools,
                                                       API_PARITY_MIX)
                count = int(rng.integers(1, 6))
                if origin is not None:
                    st.context_enter("ctx", origin)
                try:
                    with st.entry(res, count=count, args=args):
                        if error:
                            st.trace(RuntimeError("business error"))
                    verdicts.append("pass")
                except st.BlockException as ex:
                    verdicts.append(type(ex).__name__)
                finally:
                    if origin is not None:
                        st.exit_context()
        finally:
            spi.unregister_device_checker(cap_big_acquires)
            spi.unregister_device_checker(two_per_second)
        eng._entry_step = step
        registered_calls = len(device_calls)
        time_util.advance_time(1000)
        leased = pools["leased_default_param"] + pools["leased_warm_up"]
        for res in leased:
            api_pair(res, None, (0,), False)
        leased_device_calls = len(device_calls) - registered_calls
        snapshot = eng.node_snapshot()
        with eng._lock:
            state = convert.state_to_numpy(eng.state)
        out = {"verdicts": verdicts, "decisions": decisions,
               "registered_device_calls": registered_calls,
               "leased_pairs": len(leased),
               "leased_after_unregister": len(leased) - leased_device_calls,
               "snapshot": snapshot, "state": state,
               "fail_open": eng.fail_open_count}
        committer = eng.committer
        eng.close()
        out["committer_failures"] = committer.failures if committer else 0
    finally:
        time_util.unfreeze_time()
    out["s"] = time.perf_counter() - t0
    return out


def boot_spi(dev, restored_main):
    runs = {d: boot_spi_run(d) for d in (dev, "cpu")}
    card, cpu = runs[dev], runs["cpu"]
    for k in ("verdicts", "decisions"):
        if card[k] != cpu[k]:
            raise AssertionError(f"boot SPI: {k} differ between the card "
                                 "and the CPU")
    if set(card["snapshot"]) != set(cpu["snapshot"]):
        raise AssertionError("boot SPI: node_snapshot resources differ")
    for res, row in card["snapshot"].items():
        for k, v in row.items():
            if not math.isclose(v, cpu["snapshot"][res][k],
                                rel_tol=FLOAT_RTOL, abs_tol=0):
                raise AssertionError(f"boot SPI: {res}.{k} {v} on the card, "
                                     f"{cpu['snapshot'][res][k]} on the CPU")
    compare_states(card["state"], cpu["state"], "boot SPI")
    for name, run in runs.items():
        if run["registered_device_calls"] != BOOT_SPI_PAIRS:
            raise AssertionError(
                f"boot SPI {name}: {run['registered_device_calls']} device "
                f"entries for {BOOT_SPI_PAIRS} pairs: a pair took a fast "
                "path while a checker was registered")
        if run["leased_after_unregister"] != run["leased_pairs"]:
            raise AssertionError(f"boot SPI {name}: the lease did not come "
                                 "back after unregistering")
        if run["fail_open"] or run["committer_failures"]:
            raise AssertionError(f"boot SPI {name}: fail-open")
    custom = int(C.BlockReason.CUSTOM)
    by_slot = {}
    for reason, slot in card["decisions"]:
        for r, s in zip(reason, slot):
            if r == custom:
                by_slot[s] = by_slot.get(s, 0) + 1
    if set(by_slot) != {0, 1}:
        raise AssertionError(f"CUSTOM blocks by checker index {by_slot}")
    blocked = card["verdicts"].count("BlockException")
    # One check_batch at the main path's width with the cap checker, on
    # the restored card engine: the splice keeps the 4 launches a step.
    from sentinel_tpu_torch.core import spi

    eng, clock, buf = restored_main
    spi.register_device_checker(cap_big_acquires)
    try:
        buf = dict(buf)
        buf["count"] = buf["count"].copy()
        buf["count"][::97] = 4
        clock.now += 50
        torch.cuda.synchronize()
        before = prefix_cuda.launches
        dec = eng.check_batch(buf)
        reason = dec.reason.cpu().numpy()
        launches = prefix_cuda.launches - before
    finally:
        spi.unregister_device_checker(cap_big_acquires)
    eng.close()
    if launches != 4:
        raise AssertionError(f"{launches} prefix launches for one entry "
                             "step with a checker, not 4")
    if int((reason == custom).sum()) != len(buf["count"][::97]):
        raise AssertionError("the cap checker did not block its lanes")
    return {"pairs": BOOT_SPI_PAIRS,
            "seconds": BOOT_SPI_PAIRS * BOOT_SPI_STEP_MS / 1000,
            "card_s": card["s"], "cpu_s": cpu["s"],
            "card_equals_cpu": True,
            "verdict_counts": {v: card["verdicts"].count(v)
                               for v in sorted(set(card["verdicts"]))},
            "custom_by_checker_index": by_slot,
            "custom_blocked_pairs": blocked,
            "device_entries_while_registered": card["registered_device_calls"],
            "leased_after_unregister": card["leased_after_unregister"],
            "check_batch_width": len(buf["count"]),
            "check_batch_prefix_launches": launches,
            "check_batch_custom_lanes": int((reason == custom).sum())}


def boot_phase(dev, main, slot_run):
    t0 = time.perf_counter()
    mem0 = memory_mark()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    out = {"config": boot_config(dev)}
    out["config_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["restart"], restored_main = boot_restart(dev, main, slot_run)
    out["restart_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["spi"] = boot_spi(dev, restored_main)
    out["spi_s"] = time.perf_counter() - t1
    if prefix_cuda.launches <= 0 or prefix_cuda.tile_launches:
        raise AssertionError(f"boot phase prefix launches "
                             f"{prefix_cuda.launches}, tile walk "
                             f"{prefix_cuda.tile_launches}")
    out["prefix_launches"] = prefix_cuda.launches
    out["prefix_launches_by_shape"] = {
        f"K={k},N={n},M={m}": c
        for (k, n, m), c in sorted(prefix_cuda.launches_by_shape.items())}
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"boot": out}), flush=True)
    if out["phase_s"] > BOOT_PHASE_LIMIT_S:
        raise AssertionError(f"boot phase took {out['phase_s']:.1f} s, over "
                             f"{BOOT_PHASE_LIMIT_S} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: staged rollout (shadow lanes, canary, guardrail) and the metric log
# ---------------------------------------------------------------------------

ROLLOUT_RULED = 100        # candidate QPS counts on 100 flow-ruled resources
ROLLOUT_ROUNDS = 8         # check_batch + complete_batch rounds per width
ROLLOUT_WIDTHS = (8192, 2048)
ROLLOUT_STEP_MS = 130      # bucket and second boundaries
ROLLOUT_PARAM_VALUES = 16
CANARY_BPS = 2500
CANARY_ROUNDS = 4
CANARY_ORIGINS = 64
TIMER_PERIOD_S = 0.1
ROLLOUT_PHASE_LIMIT_S = 60.0
METRIC_LOG_DIR = Path(__file__).resolve().parent / "smoke_logs" / "metric_log"


def rollout_candidate():
    """Finite QPS counts on 100 of the flow-ruled resources (half DEFAULT,
    half RATE_LIMITER), one param rule and one authority white list."""
    flow = []
    for k in range(ROLLOUT_RULED):
        rule = {"resource": f"res{10 * k}", "count": 2}
        if k % 2:
            rule.update(controlBehavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                        maxQueueingTimeMs=100)
        flow.append(rule)
    return {"flow": flow,
            "paramFlow": [{"resource": "res40", "paramIdx": 0, "count": 1}],
            "authority": [{"resource": "res5", "limitApp": "appB",
                           "strategy": C.AUTHORITY_WHITE}]}


def cut_candidate():
    """A bad candidate: count 0 on the same 100 resources."""
    return {"flow": [{"resource": f"res{10 * k}", "count": 0}
                     for k in range(ROLLOUT_RULED)]}


def rollout_buf(rng, width, cluster, dn, origin_a):
    """The headline stream with a small param space (the candidate's
    param rule sees repeated values) and a quarter of the lanes on the
    candidate's 100 resources."""
    buf = entry_buf(rng, width, cluster, dn, origin_a)
    pick = rng.integers(0, ROLLOUT_RULED, size=width) * 10
    hot = rng.random(width) < 0.25
    buf["cluster_row"][hot] = cluster[pick[hot]]
    buf["dn_row"][hot] = dn[pick[hot]]
    buf["param_hash"][:, 0] = rng.integers(1, ROLLOUT_PARAM_VALUES + 1,
                                           size=width)
    return buf


def rollout_exit_buf(rng, ebuf, reason):
    """Exits that keep every breaker closed in both worlds (RT 1-50 ms,
    no business error), so the oracle's enforced completions and the live
    ones feed the same verdicts."""
    buf = exit_buf(rng, ebuf, reason)
    buf["rt_ms"][:] = rng.integers(1, 51, size=len(reason))
    buf["error"][:] = False
    return buf


def canary_buf(rng, width, cluster, origins):
    """Lanes on the candidate's 100 resources from 64 distinct origins."""
    buf = make_entry_batch_np(width)
    pick = rng.integers(0, ROLLOUT_RULED, size=width) * 10
    buf["cluster_row"][:] = cluster[pick]
    buf["count"][:] = 1
    buf["origin_id"][:] = np.asarray(origins)[
        rng.integers(0, len(origins), size=width)]
    return buf


def tree_bytes(tree) -> int:
    """Device bytes of a NamedTuple of tensors (nested)."""
    total = 0
    for v in tree:
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, tuple):
            total += tree_bytes(v)
    return total


def decisions_np(dec):
    return {f: getattr(dec, f).cpu().numpy() for f in dec._fields}


def rollout_shadow(dev, card: bool):
    """Part 1 on one device: the main path's engine kind with the staged
    candidate, ROLLOUT_ROUNDS rounds at each width. On the card also the
    times, launches and syncs per step, the shadow's bytes and the
    oracle; returns (printed numbers, what card and CPU must share, the
    engine and its rows)."""
    from sentinel_tpu_torch.ops import step as S

    eng, clock, cluster, dn, origin_a = make_engine(dev, tight=False)
    with eng._lock, eng._on_stream():
        eng._ensure_compiled()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng.rollout.load_candidate("rollout-v2", rollout_candidate())
    with eng._lock, eng._on_stream():
        eng._ensure_compiled()
    torch.cuda.synchronize()
    out = {"shadow_state_bytes": tree_bytes(eng.state.shadow),
           "shadow_rules_bytes": tree_bytes(eng._shadow_rules),
           "allocated_by_compile": torch.cuda.memory_allocated() - before}
    rng = np.random.default_rng(17)
    stream, decs = [], []
    for width in ROLLOUT_WIDTHS:
        bufs = [rollout_buf(rng, width, cluster, dn, origin_a)
                for _ in range(ROLLOUT_ROUNDS)]
        batches = [to_device(b, dev) for b in bufs]
        torch.cuda.synchronize()
        launches0, syncs0 = prefix_cuda.launches, SYNCS.count
        entry_s = 0.0
        for b, batch in zip(bufs, batches):
            clock.now += ROLLOUT_STEP_MS
            t0 = time.perf_counter()
            dec = eng.check_batch(batch)
            reason = eng.harvest_decisions(dec)[0]
            entry_s += time.perf_counter() - t0
            decs.append(decisions_np(dec))
            eng.complete_batch(to_device(rollout_exit_buf(rng, b, reason),
                                         dev))
            stream.append((clock.now, b))
        torch.cuda.synchronize()
        out[f"width_{width}"] = {
            "entry_step_ms": entry_s / ROLLOUT_ROUNDS * 1e3,
            "prefix_launches_per_entry_step":
                (prefix_cuda.launches - launches0) / ROLLOUT_ROUNDS,
            "host_syncs_per_round": (SYNCS.count - syncs0) / ROLLOUT_ROUNDS}
    counts = eng.shadow_counts()
    with eng._lock:
        state = convert.state_to_numpy(eng.state)
    if "shadow" not in state:
        raise AssertionError("the candidate's shadow world is missing")
    would_block = int(counts[S.SH_WOULD_BLOCK].sum())
    if would_block <= 0 or int(counts[S.SH_LIVE_BLOCK].sum()) != 0:
        raise AssertionError(f"shadow would-block {would_block}, live block "
                             f"{int(counts[S.SH_LIVE_BLOCK].sum())}: the "
                             "candidate must block and the live world not")
    out["would_block"] = would_block
    out["would_block_by_family"] = {
        name: int(counts[ch].sum()) for name, ch in (
            ("authority", S.SH_WB_AUTHORITY), ("param", S.SH_WB_PARAM),
            ("flow", S.SH_WB_FLOW))}
    if card:
        out["oracle"] = rollout_oracle(dev, eng, stream, counts)
    share = {"decisions": decs, "shadow_counts": counts, "state": state}
    return out, share, (eng, clock, cluster, dn, origin_a)


def rollout_oracle(dev, eng, stream, counts):
    """A second card engine ENFORCING the merged rule set over the same
    stream: its per-resource tallies equal the shadow's would-pass /
    would-block counters on every cluster row."""
    from sentinel_tpu_torch.ops import step as S

    spec = eng.rollout.device_spec()
    oracle, clock, _, _, _ = make_engine(dev, tight=False)
    try:
        for fam, attr in (("flow", "flow_rules"), ("degrade", "degrade_rules"),
                          ("authority", "authority_rules"),
                          ("system", "system_rules"),
                          ("param", "param_rules")):
            getattr(oracle, attr).load_rules(spec[fam])
        rng = np.random.default_rng(23)
        n_rows = eng.capacity
        passed = np.zeros(n_rows, np.int64)
        blocked = np.zeros(n_rows, np.int64)
        for now, b in stream:
            clock.now = now
            reason = oracle.harvest_decisions(
                oracle.check_batch(to_device(b, dev)))[0]
            rows = b["cluster_row"]
            ok = rows >= 0
            np.add.at(passed, rows[ok & (reason == 0)],
                      b["count"][ok & (reason == 0)])
            np.add.at(blocked, rows[ok & (reason > 0)],
                      b["count"][ok & (reason > 0)])
            oracle.complete_batch(to_device(rollout_exit_buf(rng, b, reason),
                                            dev))
        cluster_rows = np.array(sorted(eng.registry.resources().values()))
        for name, want, ch in (("pass", passed, S.SH_WOULD_PASS),
                               ("block", blocked, S.SH_WOULD_BLOCK)):
            got = counts[ch][cluster_rows]
            if not np.array_equal(got, want[cluster_rows]):
                bad = cluster_rows[np.nonzero(got != want[cluster_rows])[0]]
                raise AssertionError(
                    f"shadow would-{name} differs from the enforcing engine "
                    f"on rows {bad[:8].tolist()}")
        return {"resources_compared": int(len(cluster_rows)),
                "enforced_pass": int(passed.sum()),
                "enforced_block": int(blocked.sum()),
                "equal_to_shadow": True}
    finally:
        oracle.close()


def rollout_seal(eng, clock, dev_name):
    """The metric log of the parity stream's engine: one timer tick at the
    stream's end into a fresh directory; returns the directory."""
    import shutil

    from sentinel_tpu_torch.metrics.timer import MetricTimerListener
    from sentinel_tpu_torch.metrics.writer import MetricWriter

    d = METRIC_LOG_DIR / dev_name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    writer = MetricWriter(app="rollout", base_dir=str(d))
    lines = MetricTimerListener(eng, writer).tick(clock.now)
    writer.close()
    if lines <= 0:
        raise AssertionError("the seal wrote no metric line")
    return d, lines


def rollout_canary(dev, run):
    """Part 2: the bad candidate enforced for a 2,500 bps canary slice,
    then the 0 and 10,000 bps edges; every lane's verdict is its host
    prediction. Part 3: the guardrail's ticks until it aborts."""
    from sentinel_tpu_torch.rollout import canary
    from sentinel_tpu_torch.rollout.manager import _salt_for

    eng, clock, cluster, _, _ = run
    eng.rollout.abort("rollout-v2", reason="next part")
    origins = [eng.registry.origin_id(f"origin{i}")
               for i in range(CANARY_ORIGINS)]
    eng.rollout.load_candidate("cut", cut_candidate(), stage="canary",
                               canary_bps=CANARY_BPS)
    salt = _salt_for("cut")
    rng = np.random.default_rng(29)
    decs, in_slice = [], 0
    plan = [CANARY_BPS] * CANARY_ROUNDS + [0, 10_000]
    for bps in plan:
        if bps != eng.rollout.active_set().canary_bps:
            eng.rollout.set_stage("cut", "canary", canary_bps=bps)
        b = canary_buf(rng, 8192, cluster, origins)
        clock.now += ROLLOUT_STEP_MS
        dec = eng.check_batch(to_device(b, dev))
        decs.append(decisions_np(dec))
        want = np.array([canary.in_canary(int(o), int(c), salt, bps)
                         for o, c in zip(b["origin_id"], b["context_id"])])
        got = decs[-1]["reason"] > 0
        if not np.array_equal(got, want):
            raise AssertionError(f"canary at {bps} bps: "
                                 f"{int((got != want).sum())} lanes differ "
                                 "from the host prediction")
        if bps == CANARY_BPS:
            in_slice += int(want.sum())
        eng.complete_batch(to_device(rollout_exit_buf(
            rng, b, decs[-1]["reason"]), dev))
    if decs[-2]["reason"].any() or not (decs[-1]["reason"] > 0).all():
        raise AssertionError("canary edges: 0 bps must govern no lane and "
                             "10,000 bps every lane")
    # Part 3: shadow again, one tick per simulated second until abort.
    eng.rollout.set_stage("cut", "shadow")
    ticks = [eng.rollout.tick(now_ms=clock.now)]
    while ticks[-1].get("status") != "aborted" and len(ticks) < 8:
        b = canary_buf(rng, 8192, cluster, origins)
        clock.now += 1000
        reason = eng.harvest_decisions(eng.check_batch(to_device(b, dev)))[0]
        eng.complete_batch(to_device(rollout_exit_buf(rng, b, reason), dev))
        ticks.append(eng.rollout.tick(now_ms=clock.now))
    if ticks[-1].get("status") != "aborted" \
            or eng.rollout.active_name is not None \
            or eng.shadow_counts() is not None:
        raise AssertionError(f"the guardrail did not abort: {ticks[-1]}")
    return {"canary_lanes": in_slice,
            "canary_lanes_of": CANARY_ROUNDS * 8192,
            "guardrail_windows": len(ticks) - 1,
            "ended": eng.rollout.candidate("cut").ended_reason}, \
        {"decisions": decs, "ticks": ticks}


def rollout_promote(run):
    """After the abort: the leases come back once the system rule goes; a
    second candidate stands them down again, and its promote makes its
    rules live and brings them back."""
    eng = run[0]
    eng.system_rules.load_rules([])
    leases = len(eng._leases)
    eng.rollout.load_candidate("v3", {"flow": [{"resource": "res0",
                                                "count": 5}]})
    gated = len(eng._leases)
    eng.rollout.promote("v3")
    with eng._lock, eng._on_stream():
        eng._ensure_compiled()
    live = {r.resource: r.count for r in eng.flow_rules.get_rules()}
    if leases <= 0 or gated != 0 or len(eng._leases) != leases \
            or live.get("res0") != 5 or eng.shadow_counts() is not None:
        raise AssertionError(f"promote: leases {leases} -> {gated} -> "
                             f"{len(eng._leases)}, res0 count "
                             f"{live.get('res0')}")
    with eng._lock:
        return {"leases_back": leases, "promoted_rule_count": 5}, \
            convert.state_to_numpy(eng.rules)


def rollout_slots(dev):
    """Part 4: the slot phase's oracle engine (budget 8: it steals and
    rehydrates) with a datasource-staged candidate; every surgery leaves
    the touched shadow columns zero."""
    import random

    from sentinel_tpu_torch.ops.window import MIN_RT_EMPTY

    names = [f"oracle{i}" for i in range(SLOT_ORACLE_NAMES)]
    live = [(names[i], 3) for i in (0, 5, 10)]
    run = SlotRun(dev, 8, live)
    eng = run.eng
    checked = []
    execute = eng.slots._execute

    def zeroed(evicts, admits, now_ms):
        execute(evicts, admits, now_ms)
        touched = sorted({s for _, s, _ in evicts} | {s for _, s in admits})
        with eng._lock:
            sh = eng.state.shadow
            if sh is None or sh.counts[:, touched].any() \
                    or sh.w1.counts[:, :, touched].any() \
                    or (sh.w1.min_rt[:, touched] != MIN_RT_EMPTY).any():
                raise AssertionError(f"surgery on slots {touched} left "
                                     "shadow columns")
        checked.append(len(touched))

    eng.slots._execute = zeroed
    staged = [F.FlowRule(resource=r, count=c) for r, c in live] + [
        F.FlowRule(resource=names[0], count=1, candidate_set="slotc"),
        F.FlowRule(resource=names[3], count=2, candidate_set="slotc")]
    eng.flow_rules.load_rules(staged)
    if eng.rollout.active_name != "slotc":
        raise AssertionError("the tagged rules did not stage a candidate")
    weights = [1.0 / (i + 1) ** 1.2 for i in range(SLOT_ORACLE_NAMES)]
    rng = random.Random(1234)
    verdicts = []
    for _ in range(SLOT_ORACLE_SECONDS):
        for _ in range(SLOT_ORACLE_PAIRS):
            verdicts.append(run.serve(rng.choices(names, weights=weights)[0]))
        run.second()
    counts = eng.shadow_counts()
    out = run.result(verdicts)
    out["shadow_counts"] = counts
    out["surgeries_checked"] = len(checked)
    return out


def rollout_timer(eng, clock, dev):
    """A MetricTimerListener on the card engine's own thread writes the
    seconds the stream seals while it runs."""
    import shutil

    from sentinel_tpu_torch.metrics.searcher import MetricSearcher
    from sentinel_tpu_torch.metrics.timer import MetricTimerListener
    from sentinel_tpu_torch.metrics.writer import MetricWriter

    d = METRIC_LOG_DIR / "timer"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    cluster = np.array([eng.registry.get_cluster_row(f"res{i}")
                        for i in range(N_RESOURCES)], np.int32)
    rng = np.random.default_rng(31)
    timer = MetricTimerListener(eng, MetricWriter(app="timer",
                                                  base_dir=str(d)),
                                period_s=TIMER_PERIOD_S).start()
    t0 = time.perf_counter()
    try:
        for _ in range(3):
            b = make_entry_batch_np(2048)
            b["cluster_row"][:] = cluster[rng.integers(0, N_RESOURCES,
                                                       size=2048)]
            b["count"][:] = 1
            eng.check_batch(to_device(b, dev))
            clock.now += 1000
            time.sleep(3 * TIMER_PERIOD_S)
    finally:
        timer.stop()
    window = time.perf_counter() - t0
    seconds = sorted({n.timestamp for n in
                      MetricSearcher(str(d), "timer").find(0)})
    if len(seconds) < 2:
        raise AssertionError(f"the timer wrote {len(seconds)} seconds in "
                             f"{window:.2f} s")
    return {"seconds_written": len(seconds), "window_s": window}


def rollout_phase(dev, main_results):
    import gc

    from sentinel_tpu_torch.metrics.searcher import MetricSearcher

    t0 = time.perf_counter()
    # Earlier phases' closed engines are freed now, not during the phase,
    # so the peak above the start is this phase's own.
    gc.collect()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    out, parts = {}, {}
    runs, shares = {}, {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        t1 = time.perf_counter()
        nums, shares[name], runs[name] = rollout_shadow(d, name == "card")
        if name == "card":
            out["shadow"] = nums
            out["shadow"]["without_candidate"] = {
                f"width_{w}": {k: main_results[w][k] for k in (
                    "entry_step_ms", "prefix_launches_per_entry_step",
                    "host_syncs_per_round")} for w in WIDTHS}
        parts[f"shadow_{name}_s"] = time.perf_counter() - t1
    a, b = shares["card"], shares["cpu"]
    for r, (x, y) in enumerate(zip(a["decisions"], b["decisions"])):
        for f in x:
            if not np.array_equal(x[f], y[f]):
                raise AssertionError(f"rollout round {r}: decisions.{f} "
                                     "differ between the card and the CPU")
    if not np.array_equal(a["shadow_counts"], b["shadow_counts"]):
        raise AssertionError("shadow_counts differ between card and CPU")
    compare_states(a["state"], b["state"], "rollout")

    t1 = time.perf_counter()
    logs = {n: rollout_seal(runs[n][0], runs[n][1], n) for n in runs}
    files = {n: {p.name: p.read_bytes() for p in sorted(d.iterdir())}
             for n, (d, _) in logs.items()}
    if files["card"] != files["cpu"] or not any(
            k.endswith(".idx") for k in files["card"]):
        raise AssertionError("the metric log files differ between the card "
                             "and the CPU")
    found = MetricSearcher(str(logs["card"][0]), "rollout").find(
        0, recommend_lines=logs["card"][1] + 1)
    if len(found) != logs["card"][1]:
        raise AssertionError(f"the searcher read {len(found)} of "
                             f"{logs['card'][1]} lines")
    out["metric_log"] = {"lines": logs["card"][1],
                         "seconds": len({n.timestamp for n in found}),
                         "files": sorted(files["card"]),
                         "bytes": sum(len(v) for v in files["card"].values()),
                         "card_equals_cpu": True}
    parts["metric_log_s"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    canary = {n: rollout_canary(runs[n][0].device, runs[n]) for n in runs}
    out["canary"] = canary["card"][0]
    for r, (x, y) in enumerate(zip(canary["card"][1]["decisions"],
                                   canary["cpu"][1]["decisions"])):
        for f in x:
            if not np.array_equal(x[f], y[f]):
                raise AssertionError(f"canary round {r}: decisions.{f} "
                                     "differ between the card and the CPU")
    if canary["card"][1]["ticks"] != canary["cpu"][1]["ticks"]:
        raise AssertionError("guardrail ticks differ between card and CPU")
    with runs["card"][0]._lock, runs["cpu"][0]._lock:
        compare_states(convert.state_to_numpy(runs["card"][0].state),
                       convert.state_to_numpy(runs["cpu"][0].state),
                       "canary")
    parts["canary_guardrail_s"] = time.perf_counter() - t1

    # Teardown: a main-path round on the card is back to its syncs.
    t1 = time.perf_counter()
    eng, clock, cluster, dn, origin_a = runs["card"]
    clock.now += 1000 - clock.now % 1000
    after, _ = headline_rounds(eng, clock, cluster, dn, origin_a,
                               np.random.default_rng(7), 8192, dev)
    out["after_abort"] = {k: after[k] for k in (
        "entry_step_ms", "prefix_launches_per_entry_step",
        "host_syncs_per_round")}
    if after["host_syncs_per_round"] != HOST_SYNCS_PER_ROUND:
        raise AssertionError(f"host syncs per round {after['host_syncs_per_round']}"
                             f" after the abort, not {HOST_SYNCS_PER_ROUND}")
    out["timer"] = rollout_timer(eng, clock, dev)
    promoted = {n: rollout_promote(runs[n]) for n in runs}
    out["promote"] = promoted["card"][0]
    compare_states(promoted["card"][1], promoted["cpu"][1], "promoted_rules")
    for n in runs:
        runs[n][0].close()
    parts["teardown_s"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    slots = {n: rollout_slots(d) for n, d in (("card", dev), ("cpu", "cpu"))}
    x, y = slots["card"], slots["cpu"]
    for k in ("verdicts", "status", "events", "view"):
        if x[k] != y[k]:
            raise AssertionError(f"rollout slots: {k} differs between the "
                                 "card and the CPU")
    compare_states(x["state"], y["state"], "rollout_slots")
    if not np.array_equal(x["shadow_counts"], y["shadow_counts"]):
        raise AssertionError("slot-mode shadow_counts differ")
    if x["status"]["evictionsTotal"] <= 0 or x["surgeries_checked"] <= 0 \
            or x["fail_open"] or x["committer_failures"]:
        raise AssertionError(f"rollout slots: {x['status']}")
    out["slots"] = {"surgeries_checked": x["surgeries_checked"],
                    "evictions": x["status"]["evictionsTotal"],
                    "rehydrations": x["status"]["rehydrationsTotal"],
                    "would_block": int(x["shadow_counts"][1].sum()),
                    "card_equals_cpu": True}
    parts["slots_s"] = time.perf_counter() - t1

    if prefix_cuda.launches <= 0 or prefix_cuda.tile_launches:
        raise AssertionError(f"rollout phase prefix launches "
                             f"{prefix_cuda.launches}, tile walk "
                             f"{prefix_cuda.tile_launches}")
    out["prefix_launches"] = prefix_cuda.launches
    out["prefix_launches_by_shape"] = {
        f"K={k},N={n},M={m}": c
        for (k, n, m), c in sorted(prefix_cuda.launches_by_shape.items())}
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"rollout": out}), flush=True)
    if out["phase_s"] > ROLLOUT_PHASE_LIMIT_S:
        raise AssertionError(f"rollout phase took {out['phase_s']:.1f} s, "
                             f"over {ROLLOUT_PHASE_LIMIT_S} s")
    return out



# ---------------------------------------------------------------------------
# Phase 11: the cluster token path
# ---------------------------------------------------------------------------

CLUSTER_PHASE_LIMIT_S = 60.0
ACQUIRE_WIDTHS = (1, 8, 64, 256, 1024, 4096)
ACQUIRE_FLOWS = 64
ACQUIRE_INTERVALS = (1000, 700, 7000, 3000)
# The acquire scan's bound: one same-slot run is a dependent chain; each
# step waits on an add, a fused multiply-add, a compare-select and an add,
# at 4 cycles apiece, at the H100 SXM's 1,980 MHz boost clock.
CHAIN_CYCLES_PER_STEP = 16
SM_CLOCK_HZ = 1.98e9
ACQUIRE_BYTES_PER_LANE = 4 * 6 + 2 + 1 + 1 + 4  # 6 x 4 B + 2 bools in; out
ACQUIRE_FLOPS_PER_LANE = 8
SERVICE_BATCHES = 24
SERVICE_WIDTH = 512           # bench.py:231 bench_token_service
SERVICE_FLOW0 = 1000
MESH_FLOW0 = 6000             # bench.py:1106 bench_wire_mesh
MESH_THREADS, MESH_CONNS, MESH_BURST = 8, 8, 64
MESH_SETTLE_S, MESH_WINDOW_S = 5.0, 4.0
CLIENT_FLOW0 = 7000
CLIENT_FLOWS = 64
CLIENT_COUNT = 2              # per flow per second: blocks within a second
CLIENT_THREADS = 4
CLIENT_WINDOW_S = 10.0
CLIENT_FALLBACK_PAIRS = 8


def acquire_case(rng, n: int, dev):
    """Seeded lanes for the acquire scan at width ``n`` over 64 flows:
    thresholds with fractions, intervals that do not divide 1000 (so the
    rounding pins matter), usage near the thresholds, 30% prioritized
    lanes with a backlog, 5% unknown (-1) and 5% out-of-range slots."""
    slots = rng.integers(0, ACQUIRE_FLOWS, size=n)
    r = rng.random(n)
    slots[r < 0.05] = -1
    oob = (r >= 0.05) & (r < 0.10)
    slots[oob] = rng.integers(ACQUIRE_FLOWS, ACQUIRE_FLOWS + 8,
                              size=int(oob.sum()))
    if n >= 8:  # at least one lane of each kind, whatever the draw
        slots[-2:] = (-1, ACQUIRE_FLOWS + 3)
    thr_tab = (rng.integers(1, 60, ACQUIRE_FLOWS)
               / rng.choice([1, 3, 7], ACQUIRE_FLOWS)).astype(np.float32)
    iv_tab = rng.choice(ACQUIRE_INTERVALS, ACQUIRE_FLOWS)
    idx = np.where(slots >= 0, slots % ACQUIRE_FLOWS, 0)
    thr = thr_tab[idx]
    interval = iv_tab[idx].astype(np.float32)
    base = np.floor(rng.random(n) * thr * interval / 1000.0 * 1.1)
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        slots=slots.astype(np.int32),
        counts=rng.integers(1, 4, n).astype(np.float32),
        base=base.astype(np.float32), thr=thr,
        interval=interval,
        prioritized=rng.random(n) < 0.3,
        waiting=rng.integers(0, 3, n).astype(np.float32)).items()}
    iv = t.pop("interval")
    t["qps_scale"] = torch.full_like(iv, 1000.0) / iv  # the service's form
    t["known"] = t["slots"] >= 0
    return t


def acquire_args(t):
    return (t["slots"], t["counts"], t["base"], t["thr"], t["qps_scale"],
            t["known"], t["prioritized"], t["waiting"], ACQUIRE_FLOWS, 0.8)


def acquire_bound(slots: np.ndarray):
    """Least time for the scan on these lanes, the larger of: its bytes
    (each input read once, each output written once) over the HBM rate;
    its float operations over the fp32 rate; and its longest same-slot
    run as a dependent chain (each step a few dependent float operations,
    CHAIN_CYCLES_PER_STEP cycles at the boost clock)."""
    n = slots.shape[0]
    inside = slots[(slots >= 0) & (slots < ACQUIRE_FLOWS)]
    run = int(np.bincount(inside).max()) if inside.size else 1
    run = max(run, 1)
    t_bytes = n * ACQUIRE_BYTES_PER_LANE / HBM_BYTES_PER_S * 1e3
    t_ops = n * ACQUIRE_FLOPS_PER_LANE / FP32_OPS_PER_S * 1e3
    t_chain = run * CHAIN_CYCLES_PER_STEP / SM_CLOCK_HZ * 1e3
    bound = max(t_bytes, t_ops, t_chain)
    derivation = (f"max(bytes {n} x {ACQUIRE_BYTES_PER_LANE} B / 3.35e12 B/s"
                  f" = {t_bytes:.3g} ms, ops {n} x {ACQUIRE_FLOPS_PER_LANE}"
                  f" / 67e12 = {t_ops:.3g} ms, chain {run} steps x "
                  f"{CHAIN_CYCLES_PER_STEP} cycles / 1.98 GHz = "
                  f"{t_chain:.3g} ms)")
    return bound, ("bytes" if bound == t_bytes else "operations"), run, \
        derivation


def zero_cluster_counts():
    """Every kernel count of the cluster path to 0: just before a run of
    the path that the kernels line reports."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    CA.launches = 0
    CA.launches_by_width.clear()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()


def read_cluster_counts():
    """The counts since :func:`zero_cluster_counts`, just after the run."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    return {"acquire": CA.launches,
            "acquire_by_width": dict(CA.launches_by_width),
            "prefix": prefix_cuda.launches,
            "prefix_by_shape": dict(prefix_cuda.launches_by_shape)}


def cluster_kernel(dev):
    """The acquire kernel against its plain form on the card at every
    width of the pad ladder the wire path takes, bit for bit."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    rng = np.random.default_rng(20261018)
    rows = {}
    for n in ACQUIRE_WIDTHS:
        t = acquire_case(rng, n, dev)
        args = acquire_args(t)
        ok, cw, passed = CA.acquire_scan_cuda(*args)
        torch.cuda.synchronize()
        want = CA.acquire_scan_plain(*args)
        if not (torch.equal(ok, want[0]) and torch.equal(cw, want[1])
                and torch.equal(passed.view(torch.int32),
                                want[2].view(torch.int32))):
            raise AssertionError(f"acquire kernel != plain at N={n}")
        known = t["known"]
        statuses = {"ok": int(ok.sum()), "should_wait": int(cw.sum()),
                    "blocked": int((known & ~ok & ~cw).sum()),
                    "no_rule": int((~known).sum()),
                    "out_of_range": int((t["slots"] >= ACQUIRE_FLOWS).sum())}
        if n >= 64 and min(statuses.values()) == 0:
            raise AssertionError(f"N={n} misses a status: {statuses}")
        reps = 200 if n <= 256 else 50
        bound, bound_by, run, derivation = acquire_bound(
            t["slots"].cpu().numpy())
        rows[n] = {
            "shape": {"N": n, "flows": ACQUIRE_FLOWS}, "bit_equal": True,
            "max_abs_err": float((passed - want[2]).abs().max()),
            "statuses": statuses,
            "kernel_ms": device_ms(lambda: CA.acquire_scan_cuda(*args), reps),
            "call_ms": time_ms(lambda: CA.acquire_scan_cuda(*args), reps),
            "plain_ms": time_ms(lambda: CA.acquire_scan_plain(*args),
                                max(3, reps // 20)),
            "bound_ms": bound, "bound_by": bound_by, "longest_run": run,
            "bound_derivation": derivation}
        print(json.dumps({"acquire_kernel": rows[n]}), flush=True)
    return rows


def service_stream(seed: int = 23):
    """A seeded stream for ``DefaultTokenService`` at bench.py:231's
    configuration: 64 flows, batches of 512, GLOBAL and AVG_LOCAL rules,
    a prioritized share, unknown flows, a rule push halfway (counts,
    geometry, one flow gone, one new) and param tokens with duplicate
    values. -> (rules, pushed rules, ops)."""
    rng = np.random.default_rng(seed)

    def rule(i, count, ttype, interval):
        return F.FlowRule(resource=f"clus{i}", count=count, cluster_mode=True,
                          cluster_config={"flowId": SERVICE_FLOW0 + i,
                                          "thresholdType": ttype,
                                          "windowIntervalMs": interval})

    spec = [(float(rng.integers(20, 200)), int(i % 2),
             int(rng.choice([1000, 2000]))) for i in range(64)]
    rules = [rule(i, *spec[i]) for i in range(64)]
    pushed = [rule(i, c * (0.5 if i % 3 == 0 else 1.0), t,
                   3000 if i % 7 == 0 else iv)
              for i, (c, t, iv) in enumerate(spec) if i != 5]
    pushed.append(rule(64, 50.0, 1, 1000))
    ops = []
    for b in range(SERVICE_BATCHES):
        fids = SERVICE_FLOW0 + (rng.zipf(1.3, SERVICE_WIDTH) - 1) % 66
        batch = [(int(f), int(rng.integers(1, 4)), bool(rng.random() < 0.2))
                 for f in fids]
        params = [(SERVICE_FLOW0 + int(rng.integers(0, 8)),
                   int(rng.integers(1, 3)),
                   [int(v) for v in rng.integers(0, 4, 3)]) for _ in range(8)]
        ops.append((int(rng.integers(0, 300)), batch, params))
    return rules, pushed, ops


def run_service(dev, rules, pushed, ops):
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

    time_util.freeze_time(NOW0)
    try:
        svc = DefaultTokenService(device=dev)
        svc.rules.load_rules("default", rules)
        for _ in range(3):
            svc.connections.connect("default")
        results, walls = [], []
        for b, (dt, batch, params) in enumerate(ops):
            if b == len(ops) // 2:
                svc.rules.load_rules("default", pushed)
            time_util.advance_time(dt)
            t0 = time.perf_counter()
            results.append(svc.request_tokens(batch))
            walls.append((time.perf_counter() - t0) * 1e3)
            results.append([svc.request_param_token(f, c, v)
                            for f, c, v in params])
        state = convert.state_to_numpy(svc._state)
        return results, state, svc.metrics_snapshot(), walls
    finally:
        time_util.unfreeze_time()


def cluster_service(dev):
    """``DefaultTokenService`` on the card and on the CPU over one seeded
    stream on a frozen clock: every TokenResult, the window state and
    ``metrics_snapshot`` equal."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    stream = service_stream()
    before = CA.launches
    card = run_service(dev, *stream)
    launches = CA.launches - before
    cpu = run_service("cpu", *stream)
    if card[0] != cpu[0]:
        raise AssertionError("token service card != cpu results")
    for k in card[1]["win"]:
        if not np.array_equal(card[1]["win"][k], cpu[1]["win"][k]):
            raise AssertionError(f"token service window {k}: card != cpu")
    if card[2] != cpu[2]:
        raise AssertionError("metrics_snapshot card != cpu")
    flat = [r for batch in card[0] for r in batch]
    statuses = {}
    for r in flat:
        statuses[int(r.status)] = statuses.get(int(r.status), 0) + 1
    if not {0, 1, 2, 3} <= set(statuses):
        raise AssertionError(f"service stream misses a status: {statuses}")
    return {"batches": SERVICE_BATCHES, "width": SERVICE_WIDTH,
            "results": len(flat), "statuses": statuses,
            "card_equals_cpu": True, "acquire_launches": launches,
            "batch_ms_p50": {"card": pct(card[3], 50), "cpu": pct(cpu[3], 50)}}


class ServiceTally:
    """Server-side accounting around a token service's dispatch / harvest
    split: the host ms of each fused batch (its dispatch plus its
    harvest), and every OK verdict by flowId and by second."""

    def __init__(self, svc):
        self.svc = svc
        self.lock = threading.Lock()
        self.host_ms = []
        self.ok = {}
        self.ok_by_second = {}
        self._dispatch_ms = {}
        dispatch, harvest = svc.dispatch_tokens, svc.harvest_tokens

        def timed_dispatch(requests, now_ms=None):
            t0 = time.perf_counter()
            ticket = dispatch(requests, now_ms)
            with self.lock:
                self._dispatch_ms[id(ticket)] = \
                    (time.perf_counter() - t0) * 1e3
            return ticket

        def counted_harvest(ticket):
            t0 = time.perf_counter()
            out = harvest(ticket)
            sec = ticket.now_ms // 1000
            with self.lock:
                self.host_ms.append((time.perf_counter() - t0) * 1e3
                                    + self._dispatch_ms.pop(id(ticket), 0.0))
                for req, r in zip(ticket.requests, out):
                    if r.status == 0 and req[0] is not None:
                        f = int(req[0])
                        self.ok[f] = self.ok.get(f, 0) + 1
                        key = (f, sec)
                        self.ok_by_second[key] = \
                            self.ok_by_second.get(key, 0) + 1
            return out

        svc.dispatch_tokens = timed_dispatch
        svc.harvest_tokens = counted_harvest

    def detach(self):
        del self.svc.dispatch_tokens, self.svc.harvest_tokens


def mesh_burst(conns, frames):
    """One burst on every connection; -> (replies, ok replies)."""
    replies = ok = 0
    for s, _ in conns:
        s.sendall(frames)
    for s, reader in conns:
        got = 0
        while got < MESH_BURST:
            data = s.recv(65536)
            if not data:
                raise AssertionError("mesh connection closed")
            for body in reader.feed(data):
                resp = ccodec.decode_response(body)
                got += 1
                replies += 1
                ok += resp.status == 0
    return replies, ok


def cluster_mesh(dev):
    """bench.py:1106 bench_wire_mesh: 64 GLOBAL flows (count 1e9), the
    limiter lifted, the reactor on the card, 8 threads x 8 connections
    with a 64-request burst in flight each, a settle and two windows."""
    import socket as _socket

    from sentinel_tpu_torch.cluster.constants import MSG_FLOW
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer, pad_width
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

    svc = DefaultTokenService(device=dev, max_allowed_qps=1e12)
    svc.rules.load_rules("default", [
        F.FlowRule(resource=f"wm{i}", count=1e9, cluster_mode=True,
                   cluster_config={"flowId": MESH_FLOW0 + i,
                                   "thresholdType": 1})
        for i in range(64)])
    for w in (MESH_BURST, 256, 1024, 4096):  # warm the allocator
        svc.request_tokens([(MESH_FLOW0, 1, False)] * w)
    # The mesh's traffic is the run the kernels line reports: its counts
    # start here and are read once the server stops, before the replay.
    zero_cluster_counts()
    tally = ServiceTally(svc)
    server = ClusterTokenServer(svc, host="127.0.0.1", port=0).start()
    stop = threading.Event()
    replies = [0] * MESH_THREADS
    ok = [0] * MESH_THREADS
    errors = []
    barrier = threading.Barrier(MESH_THREADS + 1)
    conns_all = [None] * MESH_THREADS

    def frames_of(tid):
        return b"".join(ccodec.encode_request(
            xid + 1, MSG_FLOW, ccodec.encode_flow_request(
                MESH_FLOW0 + (tid * MESH_CONNS + xid) % 64, 1, False))
            for xid in range(MESH_BURST))

    def worker(tid):
        try:
            conns = []
            for _ in range(MESH_CONNS):
                s = _socket.create_connection(
                    ("127.0.0.1", server.bound_port), timeout=10)
                s.settimeout(10)
                s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
                conns.append((s, ccodec.FrameReader()))
            conns_all[tid] = conns
            frames = frames_of(tid)
            barrier.wait()
            while not stop.is_set():
                r, o = mesh_burst(conns, frames)
                replies[tid] += r
                ok[tid] += o
        except Exception as ex:  # noqa: BLE001 -- reported below
            errors.append(repr(ex))
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(MESH_THREADS)]
    for t in threads:
        t.start()
    barrier.wait()
    time.sleep(MESH_SETTLE_S)
    rates = []
    for _ in range(2):
        r0, o0 = sum(replies), sum(ok)
        t0 = time.perf_counter()
        time.sleep(MESH_WINDOW_S)
        dt = time.perf_counter() - t0
        rates.append({"acquires_per_s": (sum(replies) - r0) / dt,
                      "ok_per_s": (sum(ok) - o0) / dt})
    stop.set()
    for t in threads:
        t.join(timeout=30)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"mesh workers failed: {errors}")
    total_replies, total_ok = sum(replies), sum(ok)
    if total_ok != total_replies:
        raise AssertionError(f"mesh: {total_replies - total_ok} replies "
                             "not OK")
    # The window empties; one burst on one thread's connections (well
    # inside a window), then the server's own window total must equal the
    # replies the clients counted.
    time.sleep(1.1)
    final_r, final_ok = mesh_burst(conns_all[0], frames_of(0))
    snap = svc.metrics_snapshot()
    window_pass = int(sum(v["pass"] for v in snap.values()))
    if not final_ok == final_r == window_pass:
        raise AssertionError(f"mesh final burst: {final_r} replies, "
                             f"{final_ok} OK, server window {window_pass}")
    served_ok = sum(tally.ok.values())
    if served_ok != total_replies + final_r:
        raise AssertionError(f"server OK verdicts {served_ok} != replies "
                             f"{total_replies + final_r}")
    for conns in conns_all:
        for s, _ in conns:
            s.close()
    wire = server.wire_stats() or {}
    server.stop()
    counts = read_cluster_counts()
    tally.detach()
    # Device share of a fused batch: one replay at the mesh's p50 width.
    from torch.profiler import ProfilerActivity, profile

    width = pad_width(max(1, int(wire.get("coalescedBatchP50", 1))))
    batch = [(MESH_FLOW0 + i % 64, 1, False) for i in range(width)]
    svc.request_tokens(batch)
    reps = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            svc.request_tokens(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return {
        "windows": rates, "connections": MESH_THREADS * MESH_CONNS,
        "pipelined_per_conn": MESH_BURST, "replies": total_replies,
        "all_ok": True, "final_burst": final_r,
        "server_window_pass": window_pass,
        "rtt_ms": {"p50": wire.get("rttP50Ms"), "p99": wire.get("rttP99Ms")},
        "coalesced_batch": {"p50": wire.get("coalescedBatchP50"),
                            "max": wire.get("coalescedBatchMax")},
        "fused_batches": wire.get("fusedBatches"),
        "queue_wait_p50_ms": wire.get("queueWaitP50Ms"),
        "coalesce_wait_p50_ms": wire.get("coalesceWaitP50Ms"),
        "host_ms_per_fused_batch": {"p50": pct(tally.host_ms, 50),
                                    "p99": pct(tally.host_ms, 99),
                                    "batches": len(tally.host_ms)},
        "profiled_batch": {"width": width, "wall_ms": wall_ms,
                           "device_ms": dev_ms,
                           "device_share": dev_ms / wall_ms,
                           "device_ops": sum(e.count for e in kernels) / reps},
        "counts": counts}


def cluster_client(dev):
    """The API phase's engine kind on the card as the token client of a
    port server in this process: 64 cluster-mode flow rules on 64 of its
    unruled resources (GLOBAL, CLIENT_COUNT a second, local fallback),
    every entry sampled for spans, a few threads of ``with st.entry``
    pairs on the real clock; then the server stops answering (the
    half-open seam) and the entries fall back inside the entry budget
    until the breaker opens; then the server stops."""
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.resilience import faults
    from sentinel_tpu_torch.telemetry.spans import SpanCollector

    flows = [F.FlowRule(resource=res, count=CLIENT_COUNT, cluster_mode=True,
                        cluster_config={"flowId": CLIENT_FLOW0 + i,
                                        "thresholdType": 1,
                                        "fallbackToLocalWhenFail": True})
             for i, res in enumerate(api_pools()["unruled"][:CLIENT_FLOWS])]
    svc = DefaultTokenService(device=dev)
    svc.rules.load_rules("default", [
        F.FlowRule(resource=r.resource, count=r.count, cluster_mode=True,
                   cluster_config={"flowId": r.cluster_config["flowId"],
                                   "thresholdType": 1}) for r in flows])
    tally = ServiceTally(svc)
    server = ClusterTokenServer(svc, host="127.0.0.1", port=0).start()
    eng = api_engine(dev, capacity=API_PARITY_CAPACITY, register=False)
    eng.flow_rules.load_rules(eng.flow_rules.get_rules() + flows)
    eng.spans = SpanCollector(sample_every=1, capacity=1 << 16)
    eng.cluster.set_to_client("127.0.0.1", server.bound_port,
                              request_timeout_s=2.0)
    if eng.cluster.client_if_active() is None:
        raise AssertionError("engine client did not connect")
    names = [r.resource for r in flows]
    zero_cluster_counts()  # the entries from here on are the client's run
    for res in names[:4]:  # first steps of each kind, untimed
        api_pair(res, None, (), False)
    base_entries = len(names[:4])
    lat, verdicts = [], []
    lock = threading.Lock()
    stop_at = time.perf_counter() + CLIENT_WINDOW_S

    def worker(tid):
        rng = np.random.default_rng(100 + tid)
        while time.perf_counter() < stop_at:
            # 70% of the traffic on 8 hot flows: they block every second.
            i = int(rng.integers(8)) if rng.random() < 0.7 \
                else int(rng.integers(CLIENT_FLOWS))
            t0 = time.perf_counter()
            v = api_pair(names[i], None, (), False)
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
                verdicts.append(v)

    prefix_before = prefix_cuda.launches
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(CLIENT_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=CLIENT_WINDOW_S + 30)
    entries = len(verdicts)
    prefix_launches = prefix_cuda.launches - prefix_before
    if eng.cluster_fallback_count or eng.fail_open_count:
        raise AssertionError(f"fallbacks {eng.cluster_fallback_count}, "
                             f"fail-open {eng.fail_open_count} under load")
    over = {k: v for k, v in tally.ok_by_second.items() if v > CLIENT_COUNT}
    if over:
        raise AssertionError(f"admitted over the threshold: {over}")
    tele = eng.telemetry_snapshot()["resources"]
    engine_pass = sum(tele.get(r, {}).get("passTotal", 0) for r in names)
    server_pass = sum(tally.ok.values())
    if engine_pass != server_pass:
        raise AssertionError(f"engine cluster passes {engine_pass} != "
                             f"server OK verdicts {server_pass}")
    traces = eng.spans.traces()
    shapes = set()
    for tr in traces:
        by_id = {sp["spanId"]: sp for sp in tr["spans"]}
        shapes.add(tuple(sorted(
            (sp["name"], by_id[sp["parentSpanId"]]["name"]
             if sp["parentSpanId"] in by_id else "")
            for sp in tr["spans"])))
    want_shape = (("cluster.token_request", "sentinel.entry"),
                  ("cluster.token_service", "cluster.token_request"),
                  ("sentinel.entry", ""))
    if shapes != {want_shape} or len(traces) != entries + base_entries:
        raise AssertionError(f"span trees {shapes}, {len(traces)} traces "
                             f"for {entries + base_entries} entries")
    # The server stops answering: every acquire times out inside the
    # entry's budget and falls back; three failures open the breaker.
    fb_lat = []
    with faults.FaultInjector(seed=5) as inj:
        inj.arm("cluster.ha.halfopen", "garbage", garbage=b"")
        for k in range(CLIENT_FALLBACK_PAIRS):
            t0 = time.perf_counter()
            api_pair(names[8 + k], None, (), False)
            fb_lat.append((time.perf_counter() - t0) * 1e3)
    stats = eng.resilience_stats()
    budget = eng.cluster_entry_budget_ms
    if (stats["clusterFallbackCount"] != CLIENT_FALLBACK_PAIRS
            or stats["tokenClientBreaker"]["state"] != "OPEN"
            or max(fb_lat) > budget + 250):
        raise AssertionError(f"fallback: {stats['clusterFallbackCount']}, "
                             f"breaker {stats['tokenClientBreaker']}, "
                             f"latency {fb_lat} ms against {budget} ms")
    server.stop()
    deadline = time.monotonic() + 10
    while eng.cluster.client_if_active() is not None:
        if time.monotonic() > deadline:
            raise AssertionError("client still active after server stop")
        time.sleep(0.02)
    if api_pair(names[20], None, (), False) != "pass":
        raise AssertionError("local check after the server stopped")
    counts = read_cluster_counts()
    eng.close()
    blocked = sum(v != "pass" for v in verdicts)
    return {
        "threads": CLIENT_THREADS, "window_s": CLIENT_WINDOW_S,
        "entries": entries, "entries_per_s": entries / CLIENT_WINDOW_S,
        "blocked_share": blocked / max(entries, 1),
        "pair_ms": {"p50": pct(lat, 50), "p99": pct(lat, 99)},
        "server_ok": server_pass, "engine_cluster_passes": engine_pass,
        "max_ok_per_flow_second": max(tally.ok_by_second.values()),
        "prefix_launches_per_entry_step": prefix_launches / max(entries, 1),
        "spans_per_sampled_entry": 3, "traces": len(traces),
        "fallback": {"pairs": CLIENT_FALLBACK_PAIRS,
                     "pair_ms": {"p50": pct(fb_lat, 50), "max": max(fb_lat)},
                     "budget_ms": budget,
                     "cluster_fallback_count": stats["clusterFallbackCount"],
                     "breaker": stats["tokenClientBreaker"]["state"],
                     "rejected": stats["tokenClientBreaker"]["rejectedCount"]},
        "counts": counts}


def cluster_phase(dev):
    """The cluster token path on the card: the acquire kernel at every
    width, the service card against CPU, the 64-connection wire mesh, and
    an engine as the token client. Prints one ``{"cluster": ...}`` line."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    out, parts = {}, {}
    t1 = time.perf_counter()
    out["kernel"] = cluster_kernel(dev)
    parts["kernel_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["service"] = cluster_service(dev)
    parts["service_s"] = time.perf_counter() - t1
    # The path's two runs, the wire mesh and the engine client: each zeroes
    # the counts just before its traffic and reads them just after.
    t1 = time.perf_counter()
    out["mesh"] = cluster_mesh(dev)
    parts["mesh_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["client"] = cluster_client(dev)
    parts["client_s"] = time.perf_counter() - t1
    runs = {"mesh": out["mesh"].pop("counts"),
            "client": out["client"].pop("counts")}
    for run, c in runs.items():
        if c["acquire"] <= 0 or (run == "client" and c["prefix"] <= 0):
            raise AssertionError(f"cluster {run} run launched acquire "
                                 f"{c['acquire']}, prefix {c['prefix']} "
                                 "times")
    by_width, by_shape = {}, {}
    for c in runs.values():
        for w, k in c["acquire_by_width"].items():
            by_width[w] = by_width.get(w, 0) + k
        for sh, k in c["prefix_by_shape"].items():
            by_shape[sh] = by_shape.get(sh, 0) + k
    out["acquire_launches"] = sum(c["acquire"] for c in runs.values())
    out["acquire_launches_by_run"] = {
        run: {str(w): k for w, k in sorted(c["acquire_by_width"].items())}
        for run, c in runs.items()}
    out["acquire_launches_by_width"] = {
        str(w): k for w, k in sorted(by_width.items())}
    out["prefix_launches"] = sum(c["prefix"] for c in runs.values())
    out["prefix_launches_by_shape"] = {
        f"K={k},N={n},M={m}": c
        for (k, n, m), c in sorted(by_shape.items())}
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"cluster": out}), flush=True)
    if out["phase_s"] > CLUSTER_PHASE_LIMIT_S:
        raise AssertionError(f"cluster phase took {out['phase_s']:.1f} s, "
                             f"over {CLUSTER_PHASE_LIMIT_S} s")
    return out


def acquire_kernel_entry(cluster):
    """The acquire kernel's entry of the kernels line, at the width its
    main run (the wire mesh and the engine client) launched most."""
    by_width = {int(w): c
                for w, c in cluster["acquire_launches_by_width"].items()}
    width = max((w for w in ACQUIRE_WIDTHS),
                key=lambda w: (by_width.get(w, 0), w))
    row = cluster["kernel"][width]
    return {
        "name": "cluster_acquire",
        "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/cluster_acquire.cu",
        "replaces": "sentinel_tpu/cluster/token_service.py:136",
        "replaces_function": "acquire_step",
        "replaces_kind": "xla_scan",
        "launches": cluster["acquire_launches"],
        "launches_by_width": cluster["acquire_launches_by_width"],
        "bit_equal": True,
        "max_abs_err": max(r["max_abs_err"]
                           for r in cluster["kernel"].values()),
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "bound_derivation": row["bound_derivation"],
        "call_ms": row["call_ms"],
        "library_ms": None,
        "shape": row["shape"],
    }


# ---------------------------------------------------------------------------
# Phase 12: the pod
# ---------------------------------------------------------------------------

POD_SHARDS = 8
POD_PER_SHARD = 1_024          # a pod batch of 8,192
POD_ROUNDS = 16
POD_STEP_MS = 50
POD_START_MS = 400             # the rounds cross a second boundary
POD_FLOW_COUNT = 5             # cluster flow rules on every 10th resource
POD_PARAM_COUNT = 3            # cluster param rules on every 40th
POD_HOT_SHARE = 0.5            # lanes on the cluster-ruled resources
POD_PARAM_VALUES = 8
# The cut of parts (b) and (e): shards, capacity, resources (cluster and
# default rows must fit the capacity), lanes a shard, rounds.
POD_CUT = {"shards": 4, "capacity": 8_192, "resources": 2_000,
           "per_shard": 256, "rounds": 6}
POD_DCN = (2, 4)
POD_DCN_PER_SHARD = 8
POD_NCCL_ROUNDS = 4
POD_PHASE_LIMIT_S = 60.0
POD_CKPT = CKPT_DIR / "pod.npz"


def pod_world(dev, capacity=CAPACITY, n_resources=N_RESOURCES,
              flight_seconds=128, flow_count=POD_FLOW_COUNT,
              param_count=POD_PARAM_COUNT, degrade=True, flow=None):
    """The main path's configuration as one shard of a pod: the bench's
    resources with DefaultNode rows, its degrade rules (every 20th) and
    system rule, and its flow (every 10th) and param (every 40th) rules
    made cluster-mode with finite counts, so admission binds pod-wide.
    ``flow`` replaces the flow rules. Returns (rows, rule pack, a fresh
    shard state)."""
    from sentinel_tpu_torch.core.registry import NodeRegistry
    from sentinel_tpu_torch.ops import step as S

    reg = NodeRegistry(capacity)
    ent = reg.entrance_row(CTX)
    names = [f"res{i}" for i in range(n_resources)]
    rows = {"cluster": np.array([reg.cluster_row(n) for n in names],
                                np.int32),
            "dn": np.array([reg.default_row(CTX, n, ent) for n in names],
                           np.int32),
            "ruled": np.arange(0, n_resources, 10),
            "param_ruled": np.arange(0, n_resources, 40)}
    if flow is None:
        flow = [F.FlowRule(resource=f"res{i}", count=flow_count,
                           cluster_mode=True)
                for i in range(0, n_resources, 10)]
    param = [P.ParamFlowRule(f"res{i}", param_idx=0, count=param_count,
                             cluster_mode=True)
             for i in range(0, n_resources, 40)]
    deg = ([D.DegradeRule(resource=f"res{i}", count=100, grade=i % 3,
                          time_window=10, min_request_amount=5)
            for i in range(0, n_resources, 20)] if degrade else [])
    ft, _ = F.compile_flow_rules(flow, reg, capacity, device=dev)
    dt, di = D.compile_degrade_rules(deg, reg, capacity, device=dev)
    pt = P.compile_param_rules(param, reg, capacity, device=dev)
    pack = S.RulePack(
        flow=ft, degrade=dt,
        authority=A.compile_authority_rules([], reg, capacity, device=dev),
        system=Y.compile_system_rules([Y.SystemRule(qps=1e12)], device=dev),
        param=pt)
    one = S.make_state(capacity, ft.num_rules, NOW0,
                       degrade=D.make_degrade_state(dt, di),
                       param=P.make_param_state(pt.num_rules, device=dev),
                       device=dev, flight_seconds=flight_seconds)
    return rows, pack, one


def pod_stream(rows, n_shards, per_shard, rounds, seed):
    """Seeded pod batches: half the lanes on the cluster-ruled resources,
    the rest over every resource, one of POD_PARAM_VALUES values at
    param index 0, acquire count 1."""
    rng = np.random.default_rng(seed)
    n_res = rows["cluster"].shape[0]
    out = []
    for _ in range(rounds):
        width = n_shards * per_shard
        buf = make_entry_batch_np(width)
        hot = rng.random(width) < POD_HOT_SHARE
        pick = np.where(hot, rng.choice(rows["ruled"], size=width),
                        rng.integers(0, n_res, size=width))
        buf["cluster_row"][:] = rows["cluster"][pick]
        buf["dn_row"][:] = rows["dn"][pick]
        buf["count"][:] = 1
        buf["param_hash"][:, 0] = rng.integers(1, POD_PARAM_VALUES + 1,
                                               size=width)
        buf["param_present"][:, 0] = True
        out.append(buf)
    return out


def pod_exit_buf(ebuf, reason, seed):
    """Completions of the admitted lanes, from a per-round seed (so card
    and CPU runs given equal verdicts get equal exits)."""
    return exit_buf(np.random.default_rng(seed), ebuf, reason)


def pod_drive(dev, rows, pack, one, stream, n_shards, start_ms=NOW0,
              step_ms=POD_STEP_MS, on_step=None, shadow_rules=None):
    """The one-process pod over a stream with exits; returns (the decisions
    of every round as numpy, the pod). ``on_step(k, now, pod)`` runs
    before each entry step (outside any timing)."""
    from sentinel_tpu_torch.parallel import cluster as PPC

    if shadow_rules is not None and one.shadow is None:
        raise AssertionError("a candidate needs a shard state with a shadow")
    pod = PPC.make_pod_state(n_shards, one)
    entry, exit_ = PPC.make_pod_steps(dev, shadow_rules=shadow_rules)
    decs, now = [], start_ms
    for k, ebuf in enumerate(stream):
        now += step_ms
        if on_step is not None:
            on_step(k, now, pod)
        pod, dec = entry(pod, pack, to_device(ebuf, dev), now)
        decs.append(decisions_np(dec))
        pod = exit_(pod, pack, to_device(pod_exit_buf(
            ebuf, decs[-1]["reason"], 1000 + k), dev), now + 10)
    return decs, pod


def pod_window_pass(pod, now):
    """int64[R]: the pod-global PASS in the window at ``now`` (before a
    step): each shard's rotated window summed over the shards."""
    from sentinel_tpu_torch.ops import step as S
    from sentinel_tpu_torch.ops import window as W
    from sentinel_tpu_torch.parallel import cluster as PPC

    n = pod.cur_threads.shape[0]
    return sum(PPC.pass_counts(W.rotate(PPC.shard(pod.w1, d), now,
                                        S.SPEC_1S)).to(torch.int64)
               for d in range(n)).cpu().numpy()


def pod_full(dev):
    """Part (a): D = 8 shards of the main path's configuration, a pod
    batch of 8,192 for 16 rounds 50 ms apart with exits. The written
    contracts per cluster rule and second; launches, syncs, times."""
    from sentinel_tpu_torch.parallel import cluster as PPC

    rows, pack, one = pod_world(dev)
    stream = pod_stream(rows, POD_SHARDS, POD_PER_SHARD, POD_ROUNDS + 1, 5)
    n, b = POD_SHARDS, POD_PER_SHARD
    ruled_rows = rows["cluster"][rows["ruled"]]
    pre = {}  # round -> the pod-global PASS of each ruled row before it
    # Warm-up round on its own pod (allocations, the kernel's first load).
    pod_drive(dev, rows, pack, one, stream[POD_ROUNDS:], n)
    torch.cuda.synchronize()
    pod = PPC.make_pod_state(n, one)
    entry, exit_ = PPC.make_pod_steps(dev)
    batches = [to_device(e, dev) for e in stream[:POD_ROUNDS]]
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    SYNCS.count = 0
    entry_s = exit_s = 0.0
    now = NOW0 + POD_START_MS
    decs, times = [], []
    for k in range(POD_ROUNDS):
        now += POD_STEP_MS
        if k > 0:
            pre[k] = pod_window_pass(pod, now)[ruled_rows]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pod, dec = entry(pod, pack, batches[k], now)
        reason = dec.reason.cpu().numpy()
        entry_s += time.perf_counter() - t0
        decs.append(reason)
        times.append(now)
        xb = to_device(pod_exit_buf(stream[k], reason, 2000 + k), dev)
        t0 = time.perf_counter()
        pod = exit_(pod, pack, xb, now + 10)
        torch.cuda.synchronize()
        exit_s += time.perf_counter() - t0
    launches = prefix_cuda.launches
    by_shape = dict(prefix_cuda.launches_by_shape)
    syncs = SYNCS.count / POD_ROUNDS
    if launches != 4 * n * POD_ROUNDS:
        raise AssertionError(f"pod path launched the prefix kernel "
                             f"{launches} times in {POD_ROUNDS} steps, not "
                             f"4 x {n} a step")
    if prefix_cuda.tile_launches:
        raise AssertionError("the pod path took the tile walk")
    if syncs > n * HOST_SYNCS_PER_ROUND:
        raise AssertionError(f"{syncs} host syncs per pod step, over "
                             f"{n} x {HOST_SYNCS_PER_ROUND}")

    # The written contracts (docs/SEMANTICS.md:46-50), per cluster rule.
    thr = POD_FLOW_COUNT
    per_sec, step_max = {}, {}
    flow_blocks = param_blocks = 0
    for k, (reason, t) in enumerate(zip(decs, times)):
        lanes = stream[k]["cluster_row"]
        ok = reason == 0
        flow_blocks += int((reason == C.BlockReason.FLOW).sum())
        param_blocks += int((reason == C.BlockReason.PARAM_FLOW).sum())
        per_shard = np.stack([
            np.bincount(lanes[d * b:(d + 1) * b][ok[d * b:(d + 1) * b]],
                        minlength=CAPACITY)[ruled_rows] for d in range(n)])
        step = per_shard.sum(axis=0)
        sec = t // 1000
        per_sec[sec] = per_sec.get(sec, 0) + step
        step_max[sec] = np.maximum(step_max.get(sec, 0), per_shard.max(0))
        if k in pre:
            full = pre[k] >= thr
            if (step[full] > 0).any():
                raise AssertionError(
                    f"round {k}: {int((step[full] > 0).sum())} cluster "
                    "rules admitted after their pod total reached the "
                    "threshold")
    worst = 0
    for sec, total in per_sec.items():
        bound = thr + (n - 1) * step_max[sec]
        if (total > bound).any():
            raise AssertionError(f"second {sec}: a cluster rule admitted "
                                 "over threshold + (D - 1) x its largest "
                                 "per-shard step")
        worst = max(worst, int((total - thr).max()))
    if flow_blocks <= 0 or param_blocks <= 0:
        raise AssertionError(f"cluster rules did not bind: {flow_blocks} "
                             f"flow, {param_blocks} param blocks")

    # The reduction on its own: the last step's contributions, summed.
    prepared = [PPC.prepare(PPC.shard(pod, d), pack, now,
                            cluster_param=True)[1] for d in range(n)]
    reduce_ms = time_ms(lambda: PPC.sum_contributions(prepared), 20)
    out = {
        "shards": n, "lanes_per_shard": b, "rounds": POD_ROUNDS,
        "pod_entry_ms_per_step": entry_s / POD_ROUNDS * 1e3,
        "pod_entry_ms_per_shard": entry_s / POD_ROUNDS / n * 1e3,
        "pod_exit_ms_per_step": exit_s / POD_ROUNDS * 1e3,
        "pod_rule_checks_per_s": n * b * POD_ROUNDS / entry_s,
        "reduction_ms_per_step": reduce_ms,
        "reduction_bytes_per_step": n * PPC.contribution_bytes(prepared[0]),
        "reduction_bytes_per_shard": PPC.contribution_bytes(prepared[0]),
        "host_syncs_per_pod_step": syncs,
        "prefix_launches": launches,
        "prefix_launches_per_pod_step": launches / POD_ROUNDS,
        "prefix_launches_by_shape": {f"K={k},N={m},M={v}": c for (k, m, v), c
                                     in sorted(by_shape.items())},
        "flow_blocks": flow_blocks, "param_blocks": param_blocks,
        "largest_overshoot_over_threshold": worst,
        "contract_checks": {"per_second_bound": True,
                            "stop_after_threshold": len(pre)},
        "pod_state_bytes": tree_bytes(pod),
    }
    return out, pod


def pod_reads(pod):
    """Part (e), reads: the global reads equal the sums of the shards'."""
    from sentinel_tpu_torch.ops import step as S
    from sentinel_tpu_torch.parallel import cluster as PPC

    n = pod.cur_threads.shape[0]
    tele = PPC.global_telemetry_counts(pod)
    views = [S.telemetry_view(PPC.shard(pod, d)) for d in range(n)]
    for f in tele._fields:
        want = sum(getattr(v, f).to(torch.int64) for v in views)
        if not torch.equal(getattr(tele, f), want):
            raise AssertionError(f"global_telemetry_counts.{f} is not the "
                                 "sum of the shards'")
    fl = PPC.global_flight_recorder(pod)
    if not (pod.flight.stamps == fl.stamps).all():
        raise AssertionError("flight stamps differ between shards")
    for f in ("events", "attr", "hist", "slot_attr"):
        want = sum(getattr(PPC.shard(pod.flight, d), f).to(torch.int64)
                   for d in range(n))
        if not torch.equal(getattr(fl, f), want):
            raise AssertionError(f"global_flight_recorder.{f} is not the "
                                 "sum of the shards'")
    seconds = int((fl.stamps >= 0).sum())
    if seconds < 1:
        raise AssertionError("the pod folded no second into its ring")
    return {"telemetry_equal": True, "flight_equal": True,
            "flight_seconds_folded": seconds}


def pod_states_equal(x, y, what):
    """Every leaf equal, float leaves too (no tolerance)."""
    from sentinel_tpu_torch.parallel import cluster as PPC

    for i, (a, b) in enumerate(zip(PPC.tree_leaves(x), PPC.tree_leaves(y),
                                   strict=True)):
        if a.dtype != b.dtype or a.shape != b.shape \
                or not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{what}: leaf {i} differs")


def pod_cut(dev, seed=6, shadow=False):
    """The cut configuration on one device: (rows, pack, one, stream)."""
    c = POD_CUT
    rows, pack, one = pod_world(dev, capacity=c["capacity"],
                                n_resources=c["resources"])
    stream = pod_stream(rows, c["shards"], c["per_shard"], c["rounds"], seed)
    return rows, pack, one, stream


def pod_card_cpu(dev):
    """Part (b): the cut stream on the card and on the CPU; every decision
    and every leaf equal. Returns the card's pod for the checkpoint."""
    runs, packs = {}, {}
    for d in (dev, "cpu"):
        rows, packs[d], one, stream = pod_cut(d)
        runs[d] = pod_drive(d, rows, packs[d], one, stream,
                            POD_CUT["shards"])
    blocked = 0
    for k, (a, b) in enumerate(zip(runs[dev][0], runs["cpu"][0])):
        for f in a:
            if not np.array_equal(a[f], b[f]):
                raise AssertionError(f"pod round {k}: decisions.{f} differ "
                                     "between card and CPU")
        blocked += int((a["reason"] > 0).sum())
    pod_states_equal(runs[dev][1], runs["cpu"][1], "pod card vs CPU")
    if blocked <= 0:
        raise AssertionError("the cut pod stream blocked nothing")
    return {"blocked_decisions": blocked, "decisions_equal": True,
            "state_equal": True}, runs[dev][1], packs[dev]


def pod_two_axes(dev):
    """Part (c): a 2 x 4 pod with one global-scope rule (res0, 10 a
    second) and one pod-scope rule (res10, 6 a second): the bound checks
    of tests/test_namespaces.py:80-135."""
    from sentinel_tpu_torch.parallel import namespaces as PNS

    flow = [F.FlowRule(resource="res0", count=10, cluster_mode=True,
                       cluster_config={"scope": "global"}),
            F.FlowRule(resource="res10", count=6, cluster_mode=True)]
    rows, pack, one = pod_world(dev, capacity=1_024, n_resources=100,
                                flight_seconds=8, flow=flow)
    s, p = POD_DCN
    b = POD_DCN_PER_SHARD
    entry, _ = PNS.make_dcn_pod_steps(dev)

    def run(row, per, t, pod):
        buf = make_entry_batch_np(s * p * b)
        for d in range(s * p):
            buf["cluster_row"][d * b:d * b + per] = rows["cluster"][row]
        buf["count"][:] = 1
        pod, dec = entry(pod, pack, to_device(buf, dev), t)
        r = dec.reason.cpu().numpy().reshape(s, p * b)
        return pod, [int((x == 0).sum()) for x in r]

    pod = PNS.make_dcn_pod_state(s, p, one)
    pod, a1 = run(10, 3, NOW0, pod)           # pod scope: a quota a slice
    if not all(6 <= a <= 6 + (p - 1) * 3 for a in a1):
        raise AssertionError(f"pod-scope rule admitted {a1} per slice")
    pod, a2 = run(10, 3, NOW0 + 1, pod)
    if a2 != [0, 0]:
        raise AssertionError(f"pod-scope rule admitted {a2} after its quota")
    pod, g1 = run(0, 2, NOW0 + 2, pod)        # global scope: one quota
    if not 10 <= sum(g1) <= 10 + (s * p - 1) * 2:
        raise AssertionError(f"global-scope rule admitted {g1}")
    pod, g2 = run(0, 2, NOW0 + 3, pod)
    if sum(g2) != 0:
        raise AssertionError(f"global-scope rule admitted {g2} after its "
                             "quota")
    return {"shape": [s, p], "pod_scope_admitted": a1,
            "global_scope_admitted": g1, "bounds_hold": True}


def pod_nccl(dev):
    """Part (d): torch.distributed with NCCL at world size 1 (a FileStore:
    no network) against the one-process driver at D = 1 on shard 0's
    lanes of the full-width stream; then the all_reduce's own time at the
    full-width contribution."""
    import torch.distributed as dist

    from sentinel_tpu_torch.parallel import cluster as PPC
    from sentinel_tpu_torch.parallel import namespaces as PNS

    store_path = Path(__file__).resolve().parent / "smoke_logs" / "nccl_store"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    if store_path.exists():
        store_path.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1),
                            rank=0, world_size=1)
    try:
        rows, pack, one = pod_world(dev)
        stream = pod_stream(rows, 1, POD_PER_SHARD, POD_NCCL_ROUNDS, 8)
        out = {}
        for kind in ("pod", "dcn"):
            if kind == "pod":
                dentry, dexit = PPC.make_dist_pod_steps(device=dev)
                oentry, oexit = PPC.make_pod_steps(dev)
                pod = PPC.make_pod_state(1, one)
            else:
                dentry, dexit = PNS.make_dist_dcn_pod_steps(1, 1, device=dev)
                oentry, oexit = PNS.make_dcn_pod_steps(dev)
                pod = PNS.make_dcn_pod_state(1, 1, one)
            state = PPC.tree_map(lambda x: x.clone(), one)
            now = NOW0
            for k, ebuf in enumerate(stream):
                now += POD_STEP_MS
                state, ddec = dentry(state, pack, to_device(ebuf, dev), now)
                pod, odec = oentry(pod, pack, to_device(ebuf, dev), now)
                for f in ddec._fields:
                    if not torch.equal(getattr(ddec, f), getattr(odec, f)):
                        raise AssertionError(f"NCCL {kind} round {k}: "
                                             f"decisions.{f} differ")
                xb = to_device(pod_exit_buf(
                    ebuf, ddec.reason.cpu().numpy(), 3000 + k), dev)
                state = dexit(state, pack, xb, now + 10)
                pod = oexit(pod, pack, xb, now + 10)
            index = 0 if kind == "pod" else (0, 0)
            pod_states_equal(state, PPC.shard(pod, index), f"NCCL {kind}")
            out[f"{kind}_equal"] = True
        own = PPC.prepare(state, pack, now, cluster_param=True)[1]
        out["all_reduce_ms"] = time_ms(
            lambda: PPC.all_reduce_contribution(own), 20)
        out["all_reduce_bytes"] = PPC.contribution_bytes(own)
        out["world_size"] = dist.get_world_size()
        out["backend"] = str(dist.get_backend())
    finally:
        dist.destroy_process_group()
    return out


def pod_candidate(dev):
    """Part (e), rollout: at the cut size, a candidate (the cluster rules,
    no breakers) staged pod-wide on a pod whose live rules block nothing;
    its shadow counters summed over the shards must equal the live counts
    of a second pod ENFORCING the candidate on the same stream."""
    from sentinel_tpu_torch.ops import step as S
    from sentinel_tpu_torch.parallel import cluster as PPC

    c = POD_CUT
    rows, cand, cand_one = pod_world(dev, capacity=c["capacity"],
                                     n_resources=c["resources"],
                                     degrade=False)
    _, live, one = pod_world(dev, capacity=c["capacity"],
                             n_resources=c["resources"], flow_count=1e9,
                             param_count=1e9)
    one = one._replace(shadow=S.make_shadow_state(
        c["capacity"], cand, cand_one.degrade, device=dev))
    stream = pod_stream(rows, c["shards"], c["per_shard"], c["rounds"], 9)
    _, shadow_pod = pod_drive(dev, rows, live, one, stream, c["shards"],
                              shadow_rules=cand)
    _, enforcing = pod_drive(dev, rows, cand, cand_one, stream, c["shards"])
    counts = PPC.global_shadow_counts(shadow_pod)
    per_shard = sum(shadow_pod.shadow.counts[d] for d in range(c["shards"]))
    if not torch.equal(counts, per_shard):
        raise AssertionError("global_shadow_counts is not the sum of the "
                             "shards'")
    tele = PPC.global_telemetry_counts(enforcing)
    for name, ch, ev in (("pass", S.SH_WOULD_PASS, C.MetricEvent.PASS),
                         ("block", S.SH_WOULD_BLOCK, C.MetricEvent.BLOCK)):
        if not torch.equal(counts[ch], tele.totals[ev]):
            bad = int((counts[ch] != tele.totals[ev]).sum())
            raise AssertionError(f"pod candidate would-{name} differs from "
                                 f"the enforcing pod on {bad} rows")
    would_block = int(counts[S.SH_WOULD_BLOCK].sum())
    if would_block <= 0:
        raise AssertionError("the pod candidate would block nothing")
    return {"would_pass": int(counts[S.SH_WOULD_PASS].sum()),
            "would_block": would_block, "equals_enforcing_pod": True}


def pod_checkpoint(dev, pod, pack):
    """Part (e), checkpoint: the card pod of part (b) saved, restored
    into a fresh card template, leaf for leaf; both step on equal."""
    from sentinel_tpu_torch.core.checkpoint import (
        restore_pod_checkpoint, save_pod_checkpoint)
    from sentinel_tpu_torch.parallel import cluster as PPC

    POD_CKPT.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    save_pod_checkpoint(pod, str(POD_CKPT))
    save_ms = (time.perf_counter() - t0) * 1e3
    rows, _, one, stream = pod_cut(dev, seed=12)
    template = PPC.make_pod_state(POD_CUT["shards"], one)
    t0 = time.perf_counter()
    restored = restore_pod_checkpoint(template, str(POD_CKPT))
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    pod_states_equal(pod, restored, "restored pod")
    entry, _ = PPC.make_pod_steps(dev)
    now = NOW0 + 5_000
    _, a = entry(pod, pack, to_device(stream[0], dev), now)
    _, b = entry(restored, pack, to_device(stream[0], dev), now)
    if not torch.equal(a.reason, b.reason):
        raise AssertionError("the restored pod decides otherwise")
    return {"save_ms": save_ms, "restore_ms": restore_ms,
            "file_bytes": POD_CKPT.stat().st_size,
            "leaves": len(PPC.tree_leaves(pod)), "restored_equal": True}


def pod_phase(dev):
    """The pod path on the card: (a) full width with the written
    contracts, (b) card = CPU at the cut size, (c) two axes, (d) NCCL at
    world size 1, (e) the pod-wide candidate, the checkpoint and the
    global reads. Counts are zeroed before (a)'s rounds and read after
    them. Prints one ``{"pod": ...}`` line."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    # What earlier phases left running beside the pod's host-bound loop.
    out = {"threads_at_start": sorted(t.name for t in threading.enumerate())}
    parts = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        result = fn(*args)
        parts[f"{name}_s"] = time.perf_counter() - t1
        print(json.dumps({"pod_part": name, "s": parts[f"{name}_s"],
                          "peak_bytes_so_far":
                              torch.cuda.max_memory_allocated()}),
              flush=True)
        return result

    out["full"], full_pod = part("full", pod_full, dev)
    # The reads while the full pod is the only one held, then it goes.
    out["reads"] = part("reads", pod_reads, full_pod)
    del full_pod
    out["card_cpu"], cut_pod, cut_pack = part("card_cpu", pod_card_cpu, dev)
    out["two_axes"] = part("two_axes", pod_two_axes, dev)
    out["nccl"] = part("nccl", pod_nccl, dev)
    out["candidate"] = part("candidate", pod_candidate, dev)
    out["checkpoint"] = part("checkpoint", pod_checkpoint, dev, cut_pod,
                             cut_pack)
    del cut_pod
    out["cut"] = POD_CUT
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"pod": out}), flush=True)
    if out["phase_s"] > POD_PHASE_LIMIT_S:
        raise AssertionError(f"pod phase took {out['phase_s']:.1f} s, over "
                             f"{POD_PHASE_LIMIT_S} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the control plane that rides the once-per-second fold
# ---------------------------------------------------------------------------

CONTROL_WIDTH = 2048
CONTROL_STEP_MS = 250            # four width-2048 batches a simulated second
CONTROL_SECONDS = 17
CONTROL_WARM_S = 4               # seconds before objectives and targets load
CONTROL_OBJECTIVES = tuple(f"res{10 * i}" for i in range(64))
CONTROL_TARGETS = tuple(f"res{1000 + 10 * i}" for i in range(16))
CONTROL_BURN = "res0"            # an objective's resource, tightened to 8/s
CONTROL_BURN_COUNT = 8
CONTROL_BURN_LANES = 64
CONTROL_BURN_SECONDS = (4, 8)
CONTROL_UP = CONTROL_TARGETS[0]  # count 64 under 96/s: promoted to 128
CONTROL_UP_COUNT = 64
CONTROL_UP_LANES = 24
CONTROL_UP_SECONDS = (4, 10)
CONTROL_DOWN = CONTROL_TARGETS[1]  # RT 50 ms against 1 ms: a decrease
CONTROL_DOWN_COUNT = 6000          # that the guardrail aborts
CONTROL_DOWN_LANES = 1024
CONTROL_DOWN_SECONDS = (10, 17)
CONTROL_DOWN_RT_MS = 50
# Drill-speed knobs (``tests/test_adaptive.py``'s, with a one-second
# cadence) and a journal tail that holds the whole run.
CONTROL_KEYS = {
    "csp.sentinel.adaptive.interval.seconds": "1",
    "csp.sentinel.adaptive.shadow.seconds": "1",
    "csp.sentinel.adaptive.canary.seconds": "1",
    "csp.sentinel.adaptive.cooldown.seconds": "4",
    "csp.sentinel.adaptive.abort.backoff.seconds": "30",
    "csp.sentinel.adaptive.step.pct": "1.0",
    "csp.sentinel.adaptive.increase.pct": "1.0",
    "csp.sentinel.adaptive.decrease.pct": "0.5",
    "csp.sentinel.journal.capacity": "4096",
}
CONTROL_ABORT_WINDOWS = 2
CONTROL_PIPE_THREADS = 16
CONTROL_PIPE_WINDOW_S = 4.0
CONTROL_WIRE_CONNS = 4
CONTROL_WIRE_BURST = 16
CONTROL_WIRE_FLOWS = 8
CONTROL_FLEET_LEADERS = 3
CONTROL_FLEET_SECONDS = 3
# A leader's page carries each second's whole resource map and the health
# of every resource the SLO manager baselines, in one u16-framed JSON
# entity (at most 64,000 bytes): a second with thousands of active
# resources cannot be framed and is skipped, loudly (the reference's
# bound). The leaders therefore serve 200 resources.
CONTROL_FLEET_CUT = {"capacity": 8_192, "resources": 200}
CONTROL_PHASE_LIMIT_S = 60.0
CONTROL_DIR = Path(__file__).resolve().parent / "smoke_logs" / "control"
# Read at pump time from the live window (the reference's trace ring does
# the same), so it depends on when the pump ran, not on the device.
TRACE_WINDOW_FIELDS = ("window", "windowAtTrace")


def control_lanes():
    """Per batch: the resource index of every lane. The scenario's
    resources get fixed shares; the rest of each batch is the headline's
    uniform traffic over the other resources (one seeded stream)."""
    rng = np.random.default_rng(41)
    special = {0} | {int(r[3:]) for r in CONTROL_TARGETS}
    pool = np.array([i for i in range(N_RESOURCES) if i not in special])
    out = []
    for s in range(CONTROL_SECONDS):
        for _ in range(1000 // CONTROL_STEP_MS):
            lanes = []
            for res, n, (a, b) in (
                    (CONTROL_BURN, CONTROL_BURN_LANES, CONTROL_BURN_SECONDS),
                    (CONTROL_UP, CONTROL_UP_LANES, CONTROL_UP_SECONDS),
                    (CONTROL_DOWN, CONTROL_DOWN_LANES,
                     CONTROL_DOWN_SECONDS)):
                if a <= s < b:
                    lanes += [int(res[3:])] * n
            rest = CONTROL_WIDTH - len(lanes)
            lanes = np.concatenate([np.array(lanes, np.int64),
                                    rng.choice(pool, size=rest)])
            out.append((s, rng.permutation(lanes)))
    return out


def control_rules(eng):
    """The headline rules with the scenario's three thresholds."""
    counts = {CONTROL_BURN: CONTROL_BURN_COUNT, CONTROL_UP: CONTROL_UP_COUNT,
              CONTROL_DOWN: CONTROL_DOWN_COUNT}
    eng.flow_rules.load_rules([
        F.FlowRule(resource=f"res{i}",
                   count=counts.get(f"res{i}", 1e9))
        for i in range(0, N_RESOURCES, 10)])


def control_objectives(eng):
    from sentinel_tpu_torch.slo.objectives import BurnWindow, SloObjective

    eng.slo.load_objectives([SloObjective(
        resource=r, objective=0.99, min_events=1,
        windows=(BurnWindow(10, 2, 2.0, "page"),
                 BurnWindow(30, 5, 6.0, "ticket")))
        for r in CONTROL_OBJECTIVES])


def control_targets(eng):
    from sentinel_tpu_torch.adaptive.controller import AdaptiveTarget

    eng.adaptive.load_targets([AdaptiveTarget(
        resource=r, max_block_rate=0.05,
        rt_p99_ms=1.0 if r == CONTROL_DOWN else 0.0,
        floor=1.0, ceiling=1e6, min_entries=8) for r in CONTROL_TARGETS])
    eng.adaptive.enable()


class _Hook:
    """A loopback webhook endpoint (``http.server``) that keeps the
    bodies it was sent."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        received = self.received = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                received.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, fmt, *args):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="smoke-webhook-endpoint")
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}/hook"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


class _HookTimer:
    """Times every call of the fold's parts: ``{name: (owner, attr)}``,
    each wrapped in place for the ``with`` block (a call nested in another
    counts in both)."""

    def __init__(self, targets):
        self.targets, self.ms = targets, {name: [] for name in targets}
        self.saved = []

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            orig = getattr(owner, attr)
            self.saved.append((owner, attr, orig))

            def timed(*a, _orig=orig, _ms=self.ms[name], **kw):
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                _ms.append((time.perf_counter() - t0) * 1e3)
                return out

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in self.saved:
            setattr(owner, attr, orig)


def _plain(obj):
    """As the journal file holds it: JSON types only."""
    return json.loads(json.dumps(obj, sort_keys=True, default=str))


def _strip_trace_window(obj):
    if isinstance(obj, dict):
        return {k: _strip_trace_window(v) for k, v in obj.items()
                if k not in TRACE_WINDOW_FIELDS}
    if isinstance(obj, list):
        return [_strip_trace_window(v) for v in obj]
    return obj


def _alerts_view(eng):
    snap = eng.slo.alerts_snapshot()
    snap.pop("webhook")
    return snap


def control_run(dev, lanes, hook_url, journal_path):
    """The scenario on ``dev``: 4 s of headline traffic, then objectives
    on 64 resources and targets on 16 flow rules load, a burst burns
    CONTROL_BURN's objective, the loop promotes CONTROL_UP and sees its
    decrease of CONTROL_DOWN aborted by the guardrail. The fold runs once
    a simulated second. Returns what the card and the CPU must agree on,
    the measurements, and the open engine."""
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.slo.webhook import AlertWebhook

    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    clock = Clock(NOW0)
    eng = SentinelEngine(capacity=CAPACITY, device=dev, clock=clock,
                         journal_path=journal_path)
    eng.rollout.abort_windows = CONTROL_ABORT_WINDOWS
    eng.slo.webhook = AlertWebhook(urls=[hook_url], timeout_ms=2000,
                                   retries=2)
    reg = eng.registry
    ent = reg.entrance_row(CTX)
    cluster = np.array([reg.cluster_row(f"res{i}")
                        for i in range(N_RESOURCES)], np.int32)
    dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                   for i in range(N_RESOURCES)], np.int32)
    load_rules(eng, tight=False)
    control_rules(eng)
    rng = np.random.default_rng(43)
    down_row = cluster[int(CONTROL_DOWN[3:])]
    cuda = dev == "cuda" or getattr(dev, "type", None) == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    decisions, folds, shadow, steps = [], [], [], []
    fired_at = {}
    spill_ms = {"without": [], "with": []}
    prefix_cuda.launches = 0
    launches_total = 0
    from sentinel_tpu_torch.core import engine as engine_mod

    with _HookTimer({"render": (engine_mod, "second_to_dict"),
                     "slo_ingest": (eng.slo, "ingest"),
                     "slo_evaluate": (eng.slo, "evaluate"),
                     "waterfall_roll": (eng.waterfall, "roll"),
                     "population_roll": (eng.population, "roll"),
                     "adaptive_tick": (eng.adaptive, "on_spill")}) as hooks:
        for k, (s, pick) in enumerate(lanes):
            if s == CONTROL_WARM_S and k % (1000 // CONTROL_STEP_MS) == 0:
                control_objectives(eng)
                control_targets(eng)
            clock.now = NOW0 + s * 1000 + (k % (1000 // CONTROL_STEP_MS)) \
                * CONTROL_STEP_MS
            buf = make_entry_batch_np(CONTROL_WIDTH)
            buf["cluster_row"][:] = cluster[pick]
            buf["dn_row"][:] = dn[pick]
            buf["count"][:] = 1
            stage = getattr(eng.rollout.active_set(), "stage", None)
            batch = to_device(buf, dev)
            sync()
            s0, l0 = SYNCS.count, prefix_cuda.launches
            t0 = time.perf_counter()
            reason, _ = eng.harvest_decisions(eng.check_batch(batch))
            entry_ms = (time.perf_counter() - t0) * 1e3
            steps.append((stage, entry_ms, SYNCS.count - s0,
                          prefix_cuda.launches - l0))
            decisions.append(reason.copy())
            # Sample the verdicts now, in order, so the pump never drops a
            # batch behind a slower step.
            eng.traces.drain()
            xb = make_exit_batch_np(CONTROL_WIDTH)
            ok = reason == 0
            xb["cluster_row"][:] = np.where(ok, buf["cluster_row"], -1)
            xb["dn_row"][:] = buf["dn_row"]
            xb["count"][:] = 1
            xb["success"][:] = ok
            xb["rt_ms"][:] = np.where(buf["cluster_row"] == down_row,
                                      CONTROL_DOWN_RT_MS,
                                      rng.integers(1, 90, CONTROL_WIDTH))
            eng.complete_batch(to_device(xb, dev), now_ms=clock.now + 20)
            sync()
            if k % (1000 // CONTROL_STEP_MS) == 1000 // CONTROL_STEP_MS - 1:
                # The once-per-second fold, at the next second's start.
                clock.now = NOW0 + (s + 1) * 1000
                t0 = time.perf_counter()
                eng.slo_refresh(now_ms=clock.now)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                if s:  # the first fold pays first-use costs
                    spill_ms["with" if s >= CONTROL_WARM_S
                             else "without"].append(ms)
                snap = _alerts_view(eng)
                for a in snap["active"]:
                    fired_at.setdefault(a["key"], clock.now)
                folds.append({"t": clock.now, "alerts": snap,
                              "abortSignal": eng.slo.abort_signal(),
                              "adaptive": eng.adaptive.guardrail_state(),
                              "rollout": eng.rollout.guardrail_state()})
                counts = eng.shadow_counts()
                shadow.append(None if counts is None else counts.tolist())
    launches_total = prefix_cuda.launches
    burn_stamp = NOW0 + CONTROL_BURN_SECONDS[0] * 1000 + 500
    agree = {
        "decisions": decisions,
        "folds": folds,
        "shadow": shadow,
        "slo_status": eng.slo.status(),
        "history": _plain(eng.adaptive.history()),
        "adaptive_status": eng.adaptive.status(),
        "live_flow": [(r.resource, r.count)
                      for r in eng.flow_rules.get_rules()],
        "lkg": [(r.resource, r.count)
                for r in eng.adaptive.last_known_good()["flow"]],
        "journal": _plain(eng.journal.replay()),
        "traces": {k: v for k, v in eng.traces.snapshot(limit=0).items()
                   if k != "traces"},
        "why": eng.why_query(CONTROL_BURN, stamp_ms=burn_stamp),
        "why_newest": eng.why_query(CONTROL_BURN),
        "explain": _strip_trace_window(eng.explain_trace(CONTROL_BURN)),
    }
    measured = {"steps": steps, "spill_ms": spill_ms,
                "hook_ms": hooks.ms, "prefix_launches": launches_total,
                "fired_at": fired_at}
    return agree, measured, eng


def _diff(a, b, path="control"):
    """The first path where two nested results differ (None if equal)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return None if np.array_equal(a, b) else path
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return f"{path}: keys {sorted(set(a) ^ set(b))}"
        for k in a:
            d = _diff(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: length {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = _diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} vs {b!r}"


def _p(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def control_scenario(dev, out):
    """Parts (a)-(c): the scenario on the card, then on the CPU; every
    result equal; the card's journal directory recovered in a fresh
    engine; the measurements."""
    from sentinel_tpu_torch.telemetry.journal import ControlPlaneJournal

    lanes = control_lanes()
    hook = _Hook()
    jdir = CONTROL_DIR / "journal"
    jdir.mkdir(parents=True, exist_ok=True)
    for f in jdir.iterdir():
        f.unlink()
    jpath = str(jdir / "audit.jsonl")
    try:
        t0 = time.perf_counter()
        card, measured, card_eng = control_run(dev, lanes, hook.url, jpath)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu, _, cpu_eng = control_run("cpu", lanes, hook.url, "")
        cpu_s = time.perf_counter() - t0
        diff = _diff(card, cpu)
        if diff:
            raise AssertionError(f"control: card and CPU differ at {diff}")
        # The alert arc: the burn fired a page and a ticket, both resolved.
        events = card["folds"][-1]["alerts"]["events"]
        kinds = [(e["type"], e["alert"]["severity"]) for e in events]
        for want in (("fired", "page"), ("resolved", "page"),
                     ("fired", "ticket")):
            if want not in kinds:
                raise AssertionError(f"control: no {want} transition: "
                                     f"{kinds}")
        others = sorted({e["alert"]["resource"] for e in events}
                        - {CONTROL_BURN})
        if others:
            raise AssertionError(f"control: alerts on {others}")
        signals = [f["abortSignal"] for f in card["folds"] if f["abortSignal"]]
        if not signals:
            raise AssertionError("control: the page never reached "
                                 "abort_signal")
        # The loop: one promote of CONTROL_UP (64 -> 128), one guardrail
        # abort of CONTROL_DOWN with the last-known-good rules live.
        hist = card["history"]["events"]
        promotes = [e for e in hist if e["kind"] == "promote"]
        aborts = [e for e in hist if e["kind"] == "abort"]
        if [[(c["resource"], c["from"], c["to"]) for c in e["changes"]]
                for e in promotes] != [[(CONTROL_UP, float(CONTROL_UP_COUNT),
                                         2.0 * CONTROL_UP_COUNT)]]:
            raise AssertionError(f"control: promotions {promotes}")
        if len(aborts) != 1 or "guardrail" not in aborts[0]["reason"] \
                or not aborts[0]["lkgIntact"]:
            raise AssertionError(f"control: aborts {aborts}")
        live = dict(card["live_flow"])
        if live[CONTROL_UP] != 2.0 * CONTROL_UP_COUNT \
                or live[CONTROL_DOWN] != CONTROL_DOWN_COUNT \
                or card["live_flow"] != card["lkg"]:
            raise AssertionError("control: live rules are not the "
                                 "last-known-good set")
        proposed = [c["to"] for e in hist if e["kind"] == "propose"
                    for c in e["changes"] if c["resource"] == CONTROL_DOWN]
        if proposed != [CONTROL_DOWN_COUNT * 0.5]:
            raise AssertionError(f"control: decreases proposed {proposed}")
        if not any(s is not None for s in card["shadow"]):
            raise AssertionError("control: no shadow counters while a "
                                 "candidate was staged")
        why = card["why"]
        if (why["verdict"] or {}).get("reason") != "FLOW" \
                or why["verdict"]["provenance"] is None:
            raise AssertionError(f"control: why_query {why['verdict']}")
        if card["explain"] is None \
                or card["explain"]["verdict"]["reason"] != "FLOW":
            raise AssertionError("control: explain_trace found no FLOW "
                                 "trace")
        # The webhook delivered both engines' transitions.
        n_events = len(events)
        deadline = time.perf_counter() + 10
        while len(hook.received) < 2 * n_events \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        if len(hook.received) != 2 * n_events:
            raise AssertionError(f"control: webhook got "
                                 f"{len(hook.received)} of {2 * n_events}")
        # (c) the card's journal recovers in a fresh engine.
        for eng in (card_eng, cpu_eng):
            eng.close()
        fresh = SentinelEngine(capacity=1024, device=dev, journal_path=jpath)
        try:
            if _plain(fresh.journal.replay()) != card["journal"] \
                    or fresh.journal.last_seq != card["journal"][-1]["seq"]:
                raise AssertionError("control: recovered journal differs")
            if _plain(fresh.adaptive.history()) != card["history"]:
                raise AssertionError("control: recovered decision log "
                                     "differs")
            if _plain(fresh.slo.alerts_snapshot()["events"]) != \
                    _plain(events):
                raise AssertionError("control: recovered alert log differs")
        finally:
            fresh.close()
        files = sorted(jdir.iterdir())
        jbytes = sum(f.stat().st_size for f in files)
        probe = ControlPlaneJournal(lambda: NOW0,
                                    path=str(CONTROL_DIR / "probe.jsonl"))
        fsync_ms = []
        for i in range(32):
            t1 = time.perf_counter()
            probe.record("probe", i=i)
            fsync_ms.append((time.perf_counter() - t1) * 1e3)
        probe.close()
        (CONTROL_DIR / "probe.jsonl").unlink()
    finally:
        hook.stop()
    steps = measured["steps"]

    def by(stage):
        rows = [x for x in steps if x[0] == stage]
        return {"steps": len(rows),
                "entry_ms_p50": _p([x[1] for x in rows], 50),
                "host_syncs_per_step": (sum(x[2] for x in rows) / len(rows)
                                        if rows else None),
                "prefix_launches_per_step":
                    (sum(x[3] for x in rows) / len(rows) if rows else None)}

    out["slo"] = {
        "objectives": len(CONTROL_OBJECTIVES),
        "transitions": kinds,
        "fired_at_ms": {k: v - NOW0 for k, v in measured["fired_at"].items()},
        "burn": card["slo_status"]["burn"][f"{CONTROL_BURN}:availability"],
        "health": {"instance": card["slo_status"]["health"]["instance"],
                   "resources_scored": len(
                       card["slo_status"]["health"]["resources"]),
                   "below_100_while_burning": {
                       r: h for r, h in card["folds"][CONTROL_BURN_SECONDS[0]][
                           "alerts"]["health"]["resources"].items()
                       if h < 100}},
        "abort_signal_folds": len(signals),
        "slo_refresh_ms_p50": _p(measured["spill_ms"]["with"], 50),
        "spill_ms_p50_without_objectives":
            _p(measured["spill_ms"]["without"], 50),
        "spill_ms_p50_with_objectives": _p(measured["spill_ms"]["with"], 50),
        "render_ms_p50": _p(measured["hook_ms"]["render"], 50),
        "renders": len(measured["hook_ms"]["render"]),
        "fold_parts_ms_p50": {k: _p(v, 50)
                              for k, v in measured["hook_ms"].items()},
        "webhook_posts": len(hook.received),
    }
    out["adaptive"] = {
        "targets": len(CONTROL_TARGETS),
        "decisions": [(e["seq"], e["kind"], e.get("candidate"),
                       [(c["resource"], c["to"])
                        for c in e.get("changes", [])])
                      for e in hist if e["kind"] in (
                          "propose", "canary", "promote", "abort")],
        "live_after": {CONTROL_UP: live[CONTROL_UP],
                       CONTROL_DOWN: live[CONTROL_DOWN]},
        "no_candidate": by(None), "shadow": by("shadow"),
        "canary": by("canary"),
    }
    out["journal"] = {
        "records": len(card["journal"]),
        "kinds": sorted({r["kind"] for r in card["journal"]}),
        "file_bytes": jbytes, "files": len(files),
        "bytes_per_record": jbytes / len(card["journal"]),
        "record_ms_p50_with_fsync": _p(fsync_ms, 50),
        "record_ms_p99_with_fsync": _p(fsync_ms, 99),
        "recovered_equal": True,
        "why_reason": why["verdict"]["reason"],
        "why_blocked_that_second": why["verdict"]["blockedThatSecond"],
    }
    out["card_vs_cpu"] = {"equal": True, "batches": len(lanes),
                          "card_s": card_s, "cpu_s": cpu_s}
    return measured["prefix_launches"]


def control_waterfall(dev, out):
    """(d): the pipeline under 16 callers for 4 s on the card, the
    engine an embedded token server answering traced wire requests; every
    pipeline harvest and every fused token batch lands in the sealed
    seconds, each wire request's stages reconcile with its RTT."""
    import socket

    from sentinel_tpu_torch.cluster.constants import MSG_FLOW
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.telemetry.spans import new_trace_context

    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    eng = SentinelEngine(capacity=CAPACITY, device=dev)
    load_rules(eng, tight=False)
    srv = eng.cluster.set_to_server(host="127.0.0.1", port=0)
    svc = srv.service
    svc.rules.load_rules("default", [
        F.FlowRule(resource=f"wf{i}", count=1e9, cluster_mode=True,
                   cluster_config={"flowId": 7100 + i, "thresholdType": 1})
        for i in range(CONTROL_WIRE_FLOWS)])
    harvested = [0]
    harvest = svc.harvest_tokens

    def counted(ticket):
        got = harvest(ticket)
        harvested[0] += 1
        return got

    svc.harvest_tokens = counted
    svc.request_tokens([(7100, 1, False)] * 4)
    harvested[0] = 0
    wf = eng.waterfall
    # Tally every observation under the second the recorder filed it in
    # (its own clock read, captured per thread).
    tally = {"pipeline": {}, "batch": {}, "wire": {}}
    tally_lock = threading.Lock()
    filed = threading.local()
    recorder_now = wf._now_ms

    def now_ms():
        v = recorder_now()
        filed.sec = v - v % 1000
        return v

    def tallied(kind, fn):
        def observe(*a, **kw):
            fn(*a, **kw)
            with tally_lock:
                tally[kind][filed.sec] = tally[kind].get(filed.sec, 0) + 1
        return observe

    wf._now_ms = now_ms
    wf.observe_pipeline = tallied("pipeline", wf.observe_pipeline)
    wf.observe_batch = tallied("batch", wf.observe_batch)
    wf.observe_wire = tallied("wire", wf.observe_wire)
    eng.start_pipeline(max_batch=8, linger_s=0.0002)
    stop = threading.Event()
    errors, pairs, replies = [], [0], [0]

    def caller(i):
        r = np.random.default_rng(100 + i)
        try:
            while not stop.is_set():
                res = f"res{int(r.integers(0, N_RESOURCES))}"
                try:
                    with eng.entry(res):
                        pass
                except st.BlockException:
                    pass
                pairs[0] += 1
        except Exception as ex:  # noqa: BLE001 — failed below
            errors.append(ex)
        finally:
            ctx_mod.replace_context(None)

    def wire(i):
        try:
            with socket.create_connection(("127.0.0.1", srv.bound_port),
                                          timeout=10) as sock:
                reader = ccodec.FrameReader()
                xid = 0
                while not stop.is_set():
                    frames = []
                    for _ in range(CONTROL_WIRE_BURST):
                        xid += 1
                        body = ccodec.encode_flow_request(
                            7100 + xid % CONTROL_WIRE_FLOWS, 1, False)
                        if xid <= CONTROL_WIRE_BURST:
                            # The first burst traced: its spans stay in
                            # the service's bounded span ring.
                            body = ccodec.append_trace_tlv(
                                body, new_trace_context().traceparent())
                        frames.append(ccodec.encode_request(xid, MSG_FLOW,
                                                            body))
                    sock.sendall(b"".join(frames))
                    got = 0
                    while got < CONTROL_WIRE_BURST:
                        data = sock.recv(65536)
                        if not data:
                            raise OSError("server closed")
                        for b in reader.feed(data):
                            if ccodec.decode_response(b).status != 0:
                                raise AssertionError("wire reply not OK")
                            got += 1
                    replies[0] += got
        except Exception as ex:  # noqa: BLE001 — failed below
            errors.append(ex)

    zero_cluster_counts()
    threads = ([threading.Thread(target=caller, args=(i,))
                for i in range(CONTROL_PIPE_THREADS)]
               + [threading.Thread(target=wire, args=(i,))
                  for i in range(CONTROL_WIRE_CONNS)])
    for t in threads:
        t.start()
    time.sleep(CONTROL_PIPE_WINDOW_S)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    eng.stop_pipeline()
    counts = read_cluster_counts()
    srv_batches = harvested[0]
    eng.cluster.stop()
    if errors:
        raise AssertionError(f"control waterfall: {errors[:3]}")
    if counts["acquire"] != srv_batches:
        raise AssertionError(f"control waterfall: {counts['acquire']} "
                             f"acquire launches for {srv_batches} batches")
    pipe = eng.pipeline_stats()
    eng.slo_refresh(now_ms=eng.now_ms() + 2000)
    snap = wf.snapshot(limit=100)
    recent = snap["recent"]
    for r in recent:
        sec = r["timestamp"]
        got = (r["lanes"].get("pipeline", {}).get("queue", {})
               .get("count", 0), r["coalesce"]["batches"], r["rtt"]["count"])
        want = tuple(tally[k].get(sec, 0) for k in ("pipeline", "batch",
                                                     "wire"))
        if got != want:
            raise AssertionError(f"control waterfall: second {sec} sealed "
                                 f"{got}, observed {want}")
    if {s for t in tally.values() for s in t} - {r["timestamp"]
                                                  for r in recent}:
        raise AssertionError("control waterfall: an observed second was "
                             "not sealed")
    pipe_lane = sum(tally["pipeline"].values())
    batches = sum(tally["batch"].values())
    wire_n = sum(tally["wire"].values())
    if pipe_lane != pipe["harvests"] - pipe["failOpenCycles"] \
            or pipe["failOpenCycles"]:
        raise AssertionError(f"control waterfall: pipeline lane {pipe_lane}"
                             f" vs harvests {pipe['harvests']}")
    if batches != srv_batches:
        raise AssertionError(f"control waterfall: {batches} sealed batches "
                             f"vs the batcher's {srv_batches}")
    if wire_n != replies[0] or snap["lateDrops"]:
        raise AssertionError(f"control waterfall: {wire_n} sealed wire "
                             f"requests vs {replies[0]} replies")
    if snap["reconciliation"]["relativeError"] > 1e-6:
        raise AssertionError(f"control waterfall: stages do not reconcile "
                             f"{snap['reconciliation']}")
    trace_ids = {t["traceId"] for t in svc.spans.traces()}
    if not snap["exemplars"] or any(ex["traceId"] not in trace_ids
                                    for ex in snap["exemplars"]):
        raise AssertionError("control waterfall: an exemplar lost its span")
    cum = snap["cumulative"]
    out["waterfall"] = {
        "window_s": CONTROL_PIPE_WINDOW_S, "callers": CONTROL_PIPE_THREADS,
        "pairs": pairs[0], "pipeline_cycles": pipe["cycles"],
        "pipeline_harvests": pipe["harvests"],
        "wire_connections": CONTROL_WIRE_CONNS, "wire_requests": replies[0],
        "fused_batches": srv_batches, "sealed_seconds": len(recent),
        "per_second_equal": True,
        "pipeline_queue_ms": [cum["pipeline"]["queue"]["p50Ms"],
                              cum["pipeline"]["queue"]["p99Ms"]],
        "pipeline_device_ms": [cum["pipeline"]["device"]["p50Ms"],
                               cum["pipeline"]["device"]["p99Ms"]],
        "wire_queue_ms": [cum["wire"]["queue"]["p50Ms"],
                          cum["wire"]["queue"]["p99Ms"]],
        "wire_device_ms": [cum["wire"]["device"]["p50Ms"],
                           cum["wire"]["device"]["p99Ms"]],
        "wire_rtt_ms": [snap["rtt"]["p50Ms"], snap["rtt"]["p99Ms"]],
        "reconciliation": snap["reconciliation"],
        "device_utilization": [r["deviceUtilization"] for r in recent],
        "sentry": {k: [(w["window"], w["firing"]) for w in v]
                   for k, v in snap["sentry"]["burn"].items()},
        "alerts_active": len(eng.slo.alerts_snapshot()["active"]),
        "kernel_launches": {
            "acquire": counts["acquire"],
            "acquire_by_width": counts["acquire_by_width"],
            "prefix": counts["prefix"],
            "prefix_by_shape": {f"K={k},N={n},M={m}": c for (k, n, m), c
                                in sorted(counts["prefix_by_shape"].items())}},
    }
    eng.close()
    return counts


def control_fleet(dev, out):
    """(e): three port leaders (engine + token server each) on loopback
    under one FleetView: every settled (resource, second) fleet sum is
    the sum of the leaders' own timeseries_view cells."""
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.telemetry import fleet as FL

    cap, n_res = CONTROL_FLEET_CUT["capacity"], CONTROL_FLEET_CUT["resources"]
    clock = Clock(NOW0)
    leaders, servers = [], []
    view = None
    try:
        for li in range(CONTROL_FLEET_LEADERS):
            eng = SentinelEngine(capacity=cap, device=dev, clock=clock)
            reg = eng.registry
            ent = reg.entrance_row(CTX)
            cl = np.array([reg.cluster_row(f"res{i}") for i in range(n_res)],
                          np.int32)
            dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                           for i in range(n_res)], np.int32)
            eng.flow_rules.load_rules([
                F.FlowRule(resource=f"res{i}", count=40 + 20 * li)
                for i in range(0, n_res, 10)])
            leaders.append((eng, cl, dn))
            servers.append(ClusterTokenServer(engine=eng, host="127.0.0.1",
                                              port=0).start())
        rng = np.random.default_rng(47)
        for s in range(CONTROL_FLEET_SECONDS):
            for k in range(1000 // CONTROL_STEP_MS):
                clock.now = NOW0 + s * 1000 + k * CONTROL_STEP_MS
                for eng, cl, dn in leaders:
                    pick = rng.integers(0, n_res, CONTROL_WIDTH)
                    buf = make_entry_batch_np(CONTROL_WIDTH)
                    buf["cluster_row"][:] = cl[pick]
                    buf["dn_row"][:] = dn[pick]
                    buf["count"][:] = 1
                    eng.check_batch(to_device(buf, dev))
        clock.now = NOW0 + CONTROL_FLEET_SECONDS * 1000 + 1
        for eng, _, _ in leaders:
            eng.slo_refresh()
        view = FL.FleetView([(f"L{i}", "127.0.0.1", s.bound_port)
                             for i, s in enumerate(servers)],
                            clock=clock, stale_ms=10_000)
        leaders[0][0].fleet = view
        if not view.wait_connected():
            raise AssertionError("control fleet: leaders not connected")
        t0 = time.perf_counter()
        polled = view.poll()
        poll_ms = (time.perf_counter() - t0) * 1e3
        series = view.series()
        truth = [{x["timestamp"]: x["resources"]
                  for x in eng.timeseries_view()["seconds"]}
                 for eng, _, _ in leaders]
        settled = view.settled_through_ms()
        cells = 0
        for sec in series:
            if sec["timestamp"] > settled:
                continue
            for res, cell in sec["resources"].items():
                for f in FL._SUM_FIELDS:
                    want = sum(int(t.get(sec["timestamp"], {}).get(res, {})
                                   .get(f, 0)) for t in truth)
                    if cell["fleet"][f] != want:
                        raise AssertionError(
                            f"control fleet: {res}@{sec['timestamp']}.{f} "
                            f"{cell['fleet'][f]} != {want}")
                cells += 1
        status = view.status()
        skipped = sum(r["secondsSkipped"] for r in status["leaders"].values())
        if status["staleLeaders"] or skipped \
                or len(series) != CONTROL_FLEET_SECONDS or cells == 0:
            raise AssertionError(
                f"control fleet: {len(series)} seconds, {skipped} skipped, "
                f"{status['staleLeaders']} stale, {cells} cells")
        page = FL.leader_fleet_payload(servers[0], 0, 16)
        out["fleet"] = {
            "leaders": CONTROL_FLEET_LEADERS, "cut": CONTROL_FLEET_CUT,
            "seconds": len(series), "cells_checked": cells,
            "sums_equal": True, "ingested": polled,
            "polls": status["polls"],
            "pages": sum(r["polls"] for r in status["leaders"].values()),
            "poll_ms": poll_ms, "page_bytes": len(page),
            "skew_ms": [r["skewMs"] for r in status["leaders"].values()],
            "settled_through_ms": settled - NOW0,
            "fleet_health": status["fleetHealth"],
        }
    finally:
        for eng, _, _ in leaders:
            eng.close()
        for srv in servers:
            srv.stop()
    if leaders and leaders[0][0].fleet is not None:
        raise AssertionError("control fleet: close() left the view")


def control_syncs(dev, out):
    """(f): objectives on 64 resources and 16 enabled, idle targets add
    no host sync and no launch to the main path's entry step."""
    eng, clock, cluster, dn, origin_a = make_engine(dev, tight=False)
    try:
        control_objectives(eng)
        control_targets(eng)
        rng = np.random.default_rng(7)
        res, _ = headline_rounds(eng, clock, cluster, dn, origin_a, rng,
                                 CONTROL_WIDTH, dev)
        eng.slo_refresh(now_ms=clock.now + 1000)
        if res["host_syncs_per_round"] != HOST_SYNCS_PER_ROUND \
                or res["prefix_launches_per_entry_step"] != 4.0:
            raise AssertionError(f"control: hooks changed the step {res}")
        if eng.adaptive.proposal_count:
            raise AssertionError("control: idle targets proposed")
        out["main_path_with_hooks"] = res
    finally:
        eng.close()


def control_phase(dev):
    """The control plane on the card: (a)-(c) the scenario on the card and
    the CPU, (d) the waterfall, (e) fleet federation, (f) no added device
    work, (g) no thread of the phase alive after its engines close.
    Prints one ``{"control": ...}`` line; returns the prefix launches of
    the scenario's card run and the acquire launches of (d)'s token
    server."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    before = {t.ident for t in threading.enumerate()}
    saved = {k: config.get(k) for k in CONTROL_KEYS}
    for k, v in CONTROL_KEYS.items():
        config.set(k, v)
    out = {"reduced": [f"fleet leaders at capacity "
                       f"{CONTROL_FLEET_CUT['capacity']} with "
                       f"{CONTROL_FLEET_CUT['resources']} resources"]}
    parts = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        result = fn(*args)
        parts[f"{name}_s"] = time.perf_counter() - t1
        return result

    try:
        launches = part("scenario", control_scenario, dev, out)
    finally:
        with config._lock:
            for k, v in saved.items():
                if v is None:
                    config._config.pop(k, None)
                else:
                    config._config[k] = v
    wf_counts = part("waterfall", control_waterfall, dev, out)
    part("fleet", control_fleet, dev, out)
    part("syncs", control_syncs, dev, out)
    alive = []
    deadline = time.perf_counter() + 5
    while time.perf_counter() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    if alive:
        raise AssertionError(f"control: threads alive after close: {alive}")
    out["threads_left"] = 0
    out["scenario_prefix_launches"] = launches
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"control": out}), flush=True)
    if out["phase_s"] > CONTROL_PHASE_LIMIT_S:
        raise AssertionError(f"control phase took {out['phase_s']:.1f} s, "
                             f"over {CONTROL_PHASE_LIMIT_S} s")
    return {"prefix": launches, "acquire": wf_counts["acquire"],
            "acquire_by_width": wf_counts["acquire_by_width"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi_line()
    print(json.dumps({"device": name, "count": count, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "numpy": np.__version__}),
          flush=True)
    print(card, flush=True)

    # Both kernels' libraries, one nvcc for each source, started together.
    from concurrent.futures import ThreadPoolExecutor

    from sentinel_tpu_torch.ops import cluster_acquire

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = [pool.submit(m.build) for m in (prefix_cuda,
                                                 cluster_acquire)]
        built = [b.result() for b in builds]
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "libraries": [p.name for p, _ in built]}), flush=True)
    for _, log in built:
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print("ptxas:", line.strip(), flush=True)

    main_shape, max_err = kernel_phase(dev)
    main_results, main_launches, main = main_path_phase(dev)
    profile_phase(dev)
    parity_phase()
    api_phase(dev)
    pipeline_phase(dev)
    _, slot_run = slot_phase(dev)
    boot_phase(dev, main, slot_run)
    main["eng"].close()
    rollout_phase(dev, main_results)
    cluster = cluster_phase(dev)
    pod = pod_phase(dev)
    control_launches = control_phase(dev)

    print(json.dumps({"smoke_wall_s": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "segmented_prefix",
        "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/segmented_prefix.cu",
        "replaces": "sentinel_tpu/ops/pallas_prefix.py:40",
        "replaces_function": "prefix_pallas",
        "design": main_shape["design"],
        "launches": main_launches,
        "bit_equal": True,
        "max_abs_err": max_err,
        "ms": main_shape["kernel_ms"],
        "previous_ms": main_shape["previous_ms"],
        "previous_design": "tile_walk",
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "call_ms": main_shape["call_ms"],
        "library_ms": None,
        "shape": main_shape["shape"],
        "cluster_path_launches": cluster["prefix_launches"],
        "pod_path_launches": pod["full"]["prefix_launches"],
        "pod_path_launches_per_step":
            pod["full"]["prefix_launches_per_pod_step"],
        "control_path_launches": control_launches["prefix"],
    }, dict(acquire_kernel_entry(cluster),
            control_path_launches=control_launches["acquire"],
            control_path_launches_by_width=control_launches[
                "acquire_by_width"])]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
