"""Chip smoke for the PyTorch port (``sentinel_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; none is caught):

1. Device: CUDA must be available; prints the card, the count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compiles ``sentinel_tpu_torch/csrc/segmented_prefix.cu`` with
   nvcc for sm_90a and prints the ``-Xptxas -v`` register / shared-memory
   lines.
3. Kernel vs plain: the segmented-prefix kernel against the plain sort +
   cumsum version on the card, bit-equal, at N in {1, 8, 64, 512, 1000,
   2048, 8192}, K in {1, 3}, M in {1, 2}, with the 256 and near-2^24 value
   edges; device times for both (CUDA-graph replay), the kernel's
   per-call time with host dispatch, and the card's bound for the
   function's least work (bytes, or an N log N sort-and-scan).
4. Main path: ``SentinelEngine(capacity=32768)`` with the bench headline
   rules (10,000 resources; flow on every 10th, degrade on every 20th,
   param on every 40th, one system rule), 32 check_batch + complete_batch
   rounds at widths 2048 and 8192 on an advancing clock (bucket and
   second boundaries) plus one mixed-count batch; prints rule-checks/s,
   per-step ms, host syncs per step and kernel launches per entry step;
   requires the kernel to have run.
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


def prefix_bound(n: int, k: int, m: int):
    """Least time the card could take for the function, the larger of:
    its bytes (ids + values read once, prefix + is_first written once)
    over the HBM rate, and its least operations — a sort and a scan,
    K * N * ceil(log2 N) * (M+1) — over the fp32 rate. Returns
    ``(bound_ms, bound_by, algorithm_ops)``; ``algorithm_ops`` is what
    this kernel spends instead: N(N-1)/2 * K * (M+1) compare-adds."""
    nbytes = k * n * (4 + 4 * m + 4 * m + 1)
    ops = k * n * max(1, math.ceil(math.log2(max(n, 2)))) * (m + 1)
    algorithm_ops = n * (n - 1) // 2 * k * (m + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", algorithm_ops
    return t_bytes, "bytes", algorithm_ops


def prefix_case(rng, n: int, k: int, m: int, edge: str, dev):
    ids = rng.integers(0, max(1, n // 4), size=(k, n)).astype(np.int32)
    ids[rng.random((k, n)) < 0.1] = -1
    vals = rng.integers(0, 4, size=(k, n, m)).astype(np.float32)
    if edge == "256":
        vals[:] = rng.integers(250, 257, size=(k, n, m))
    elif edge == "2^24":
        # One segment whose running sum reaches 2^24 - 1 exactly at the
        # last row: a head value, then n - 2 ones, then a trailing 0.
        ids[:, :] = 7
        vals[:] = 0
        vals[:, 0, :] = 2**24 - 1 - (n - 2)
        vals[:, 1:n - 1, :] = 1
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev))


def kernel_phase(dev):
    rng = np.random.default_rng(20261017)
    max_err = 0.0
    main_shape = None
    cases = [(n, k, m, "random") for n in (1, 8, 64, 512, 1000, 2048, 8192)
             for k in (1, 3) for m in (1, 2)]
    cases += [(2048, 3, 2, "256"), (8192, 1, 2, "256"), (64, 1, 1, "2^24"),
              (1000, 3, 2, "2^24")]
    for n, k, m, edge in cases:
        ids, vals = prefix_case(rng, n, k, m, edge, dev)
        prefix, first = prefix_cuda.segmented_prefix_cuda(ids, vals)
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
        reps = 200 if n <= 2048 else 50

        def kernel():
            prefix_cuda.segmented_prefix_cuda(ids, vals)

        def plain():
            for kk in range(k):
                segmented_prefix_plain(ids[kk], vals[kk])

        kernel_ms = device_ms(kernel, reps)
        call_ms = time_ms(kernel, reps)
        plain_ms = device_ms(plain, max(10, reps // 5))
        bound_ms, bound_by, algorithm_ops = prefix_bound(n, k, m)
        row = {"shape": {"N": n, "K": k, "M": m, "values": edge},
               "bit_equal": True, "kernel_ms": kernel_ms,
               "call_ms": call_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "algorithm_ops": algorithm_ops}
        print(json.dumps(row), flush=True)
        if (n, k, m, edge) == (8192, 3, 2, "random"):
            main_shape = row
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
        total_launches += launches
        results[width] = {
            "width": width, "rounds": ROUNDS,
            "rule_checks_per_s": width * ROUNDS / entry_s,
            "entry_step_ms": entry_s / ROUNDS * 1e3,
            "exit_step_ms": exit_s / ROUNDS * 1e3,
            "prefix_launches": launches,
            "prefix_launches_per_entry_step": launches / ROUNDS,
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(rounds):
            one_round(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({"profile": {
        "width": width, "rounds": rounds,
        "wall_ms_per_round": wall_ms / rounds,
        "device_ms_per_round": dev_us / 1e3 / rounds,
        "device_busy_share": dev_us / 1e3 / wall_ms,
        "device_ops_per_round": sum(e.count for e in kernels) / rounds,
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
        "launches": main_launches,
        "bit_equal": True,
        "max_abs_err": max_err,
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "algorithm_ops": main_shape["algorithm_ops"],
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
