"""Chip smoke for the PyTorch port (``sentinel_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; none is caught):

1. Device: CUDA must be available; prints the card, the count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compiles ``sentinel_tpu_torch/csrc/segmented_prefix.cu`` (and
   the headers it includes) with nvcc for sm_90a and prints the
   ``-Xptxas -v`` register / shared-memory lines.
3. Kernel vs plain: the segmented-prefix kernel against the plain sort +
   cumsum version on the card, bit-equal, at N in {1, 8, 64, 512, 1000,
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
8. The smoke's wall time, the kernels line, the card line, and the final
   ``{"ok": true, ...}``.

It imports the port only — never JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
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
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import (
    H2D, make_entry_batch_np, make_exit_batch_np, to_device)
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
    cases = [(n, k, m, "random") for n in (1, 8, 64, 512, 1000, 2048, 8192)
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


def main_path_phase(dev):
    """Drive the engine at the headline size; returns (per-width results,
    kernel launches during the measured rounds)."""
    eng, clock, cluster, dn, origin_a = make_engine(dev, tight=False)
    rng = np.random.default_rng(7)
    results = {}
    admitted_tokens = 0
    total_launches = 0

    def check(batch):
        return eng.harvest_decisions(eng.check_batch(batch))[0]

    for width in WIDTHS:
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
        total_launches += launches
        results[width] = {
            "width": width, "rounds": ROUNDS,
            "rule_checks_per_s": width * ROUNDS / entry_s,
            "entry_step_ms": entry_s / ROUNDS * 1e3,
            "exit_step_ms": exit_s / ROUNDS * 1e3,
            "prefix_launches": launches,
            "prefix_launches_per_entry_step": launches / ROUNDS,
            "prefix_design": "block_radix_sort",
            "host_syncs_per_round": syncs / ROUNDS,
        }
        print(json.dumps({"main_path": results[width]}), flush=True)
    # Output check: every admitted token committed PASS to its DefaultNode
    # and ClusterNode rows, and every admitted entry has exited.
    st = eng.state
    passes = int(st.telemetry.totals[0].sum()) + int(st.sec.counts[0].sum())
    if passes != 2 * admitted_tokens:
        raise AssertionError(f"committed PASS {passes} != 2 x admitted "
                             f"tokens {admitted_tokens}")
    if int(st.cur_threads.sum()) != 0:
        raise AssertionError("thread gauges did not return to 0")
    print(json.dumps({"main_path_check": {"admitted_tokens": admitted_tokens,
                                          "committed_pass": passes}}),
          flush=True)
    return results, total_launches


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


def parity_phase():
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
    blocked = 0
    for r, (a, b) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        for f in a:
            if not np.array_equal(a[f], b[f]):
                raise AssertionError(f"round {r}: decisions.{f} differ "
                                     "between cuda and cpu")
        blocked += int((a["reason"] > 0).sum())

    def compare(x, y, path=""):
        for k in x:
            if isinstance(x[k], dict):
                compare(x[k], y[k], f"{path}.{k}")
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

    compare(runs["cuda"][1], runs["cpu"][1])
    print(json.dumps({"parity": {"rounds": PARITY_ROUNDS,
                                 "width": PARITY_WIDTH,
                                 "blocked_decisions": blocked,
                                 "decisions_bit_equal": True,
                                 "int_state_equal": True,
                                 "float_rtol": FLOAT_RTOL}}), flush=True)


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
    print(json.dumps({"pipeline": out}), flush=True)
    return out


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
                      "cuda": torch.version.cuda}), flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    path, log = prefix_cuda.build()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "library": str(path.name)}), flush=True)
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    main_shape, max_err = kernel_phase(dev)
    _, main_launches = main_path_phase(dev)
    profile_phase(dev)
    parity_phase()
    api_phase(dev)
    pipeline_phase(dev)

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
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
