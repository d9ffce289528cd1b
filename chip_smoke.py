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
6. The kernels line, the card line, and the final ``{"ok": true, ...}``.

It imports the port only — never JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# The port itself: a copy of this script outside the repository fails here,
# before it prints anything.
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import (
    make_entry_batch_np, make_exit_batch_np, to_device)
from sentinel_tpu_torch.core.engine import SentinelEngine
from sentinel_tpu_torch.models import authority as A
from sentinel_tpu_torch.models import degrade as D
from sentinel_tpu_torch.models import flow as F
from sentinel_tpu_torch.models import param_flow as P
from sentinel_tpu_torch.models import system as Y
from sentinel_tpu_torch.ops import prefix_cuda
from sentinel_tpu_torch.ops.segment import segmented_prefix_plain
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
