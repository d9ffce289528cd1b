"""The two-axis pod and the namespace router on the CPU
(``sentinel_tpu_torch/parallel/namespaces.py``), and the distributed
drivers of both pods over gloo.

The reference's two-axis step (``sentinel_tpu/parallel/namespaces.py:
_dcn_entry`` / ``_dcn_exit``) runs as two nested ``jax.vmap``s, the outer
over ``"dcn"`` and the inner over ``"ici"``
(``tests/test_torch_support.py:jax_pod_steps``), on a 2 x 4 pod of
capacity 128 with 8 lanes a shard; the port's one-process ``[S, P, ...]``
pod must give equal decisions and every state leaf after every step, and
each scenario of ``tests/test_namespaces.py`` keeps its own assertions.
The router must answer as the JAX class does.

The distributed test runs two processes of a gloo group (a ``FileStore``
in a temporary directory, no network; ``tests/test_torch_pod_worker.py``)
and holds ``make_dist_pod_steps`` and ``make_dist_dcn_pod_steps`` to the
one-process drivers bit for bit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sentinel_tpu.core import constants as JC
from sentinel_tpu.parallel import namespaces as JNS

from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core.batch import to_device
from sentinel_tpu_torch.parallel import cluster as PPC
from sentinel_tpu_torch.parallel import namespaces as PNS

from tests.test_torch_pod_worker import flatten, unflatten
from tests.test_torch_support import (
    NOW0, PodTwin, assert_tree_equal, every_lane, jax_to_np, pod_entry_buf,
    pod_exit_buf, pod_world, port_np)

SLICES, PER_SLICE = 2, 4
NDEV = SLICES * PER_SLICE
B = 8
PASS = JC.BlockReason.PASS
ROOT = Path(__file__).resolve().parent.parent


def _twin(**kw):
    rows, pack, one = pod_world(**kw)
    return rows, PodTwin(pack, one, (SLICES, PER_SLICE))


def _per_slice(reason):
    r = reason.reshape(SLICES, PER_SLICE * B)
    return [int((x == PASS).sum()) for x in r]


def test_pod_scope_rule_is_per_slice():
    """tests/test_namespaces.py:80 — each slice enforces the quota on its
    own; the step after, both slices stop."""
    thr, per = 6, 3
    rows, tw = _twin(thr=thr)
    buf = pod_entry_buf(NDEV, B, every_lane(NDEV, B, rows["shared"], per))
    r1, _ = tw.entry(buf, NOW0)
    for a in _per_slice(r1):
        assert thr <= a <= thr + (PER_SLICE - 1) * per
    r2, _ = tw.entry(buf, NOW0 + 1)
    assert _per_slice(r2) == [0, 0]


def test_global_scope_rule_spans_slices():
    """tests/test_namespaces.py:101 — one quota across both slices, spent
    from shard 0 of slice 0 alone."""
    thr = 8
    rows, tw = _twin(thr=thr, scope="global")
    r1, _ = tw.entry(pod_entry_buf(NDEV, B, {i: rows["shared"]
                                             for i in range(thr)}), NOW0)
    assert sum(_per_slice(r1)) == thr
    r2, _ = tw.entry(pod_entry_buf(NDEV, B, every_lane(NDEV, B,
                                                       rows["shared"], 2)),
                     NOW0 + 1)
    assert _per_slice(r2) == [0, 0]


def test_global_scope_bounded_overshoot_then_stop():
    """tests/test_namespaces.py:123."""
    thr, per = 10, 2
    rows, tw = _twin(thr=thr, scope="global")
    buf = pod_entry_buf(NDEV, B, every_lane(NDEV, B, rows["shared"], per))
    r1, _ = tw.entry(buf, NOW0)
    assert thr <= sum(_per_slice(r1)) <= thr + (NDEV - 1) * per
    r2, _ = tw.entry(buf, NOW0 + 1)
    assert sum(_per_slice(r2)) == 0


def test_two_axis_exit_balances_gauges_and_param_stays_pod_scope():
    """tests/test_namespaces.py:163 — entries then exits over the 2 x 4
    pod return every gauge to zero; a cluster param rule (pod scope even
    beside a global flow rule) and occupy borrows ride along."""
    rows, tw = _twin(thr=1e9, param_thr=3, scope="global")
    per = 2
    buf = pod_entry_buf(NDEV, B, every_lane(NDEV, B, rows["shared"], per))
    r, _ = tw.entry(buf, NOW0)
    assert sum(_per_slice(r)) == NDEV * per
    assert (tw.pstate.cur_threads[..., rows["shared"]] == per).all()
    tw.exit(pod_exit_buf(buf, r), NOW0 + 5)
    assert (tw.pstate.cur_threads[..., rows["shared"]] == 0).all()
    pbuf = pod_entry_buf(NDEV, B, every_lane(NDEV, B, rows["pshared"], 1),
                         param=0xBEEF)
    r, _ = tw.entry(pbuf, NOW0 + 10)
    a = _per_slice(r)
    assert all(3 <= x <= PER_SLICE for x in a)  # a quota per slice
    r, _ = tw.entry(pbuf, NOW0 + 11)
    assert _per_slice(r) == [0, 0]


def test_namespace_router_answers_as_the_reference():
    """tests/test_namespaces.py:136 and :147 — the same slice for every
    name, pin and failover, and the same refusal with every slice down."""
    names = [f"ns{i}" for i in range(200)] + ["payments", "orders", "",
                                              "ünïcode"]
    for n_slices in (1, 3, 4, 7):
        j, p = JNS.NamespaceShardMap(n_slices), PNS.NamespaceShardMap(
            n_slices)
        assert p.assignments(names) == j.assignments(names)
        for m in (j, p):
            m.pin("payments", n_slices - 1)
            m.mark_down(n_slices // 2)
        if n_slices > 1:
            assert p.assignments(names) == j.assignments(names)
        for m in (j, p):
            m.mark_up(n_slices // 2)
        assert p.assignments(names) == j.assignments(names)
        for m in (j, p):
            for s in range(n_slices):
                m.mark_down(s)
        for m in (j, p):
            with pytest.raises(RuntimeError):
                m.slice_of("orders")
    spread = {PNS.NamespaceShardMap(4).slice_of(f"ns{i}") for i in range(64)}
    assert len(spread) > 1
    with pytest.raises(ValueError):
        PNS.NamespaceShardMap(0)
    with pytest.raises(ValueError):
        PNS.NamespaceShardMap(3).pin("x", 3)


# ---------------------------------------------------------------------------
# The distributed drivers over gloo
# ---------------------------------------------------------------------------

WORLD = 2
DIST_B = 8
DIST_STEPS = 4


def _one_process(kind, rules_np, one_np, entries, times, exits=None):
    """The one-process driver over the stream: the decisions of every
    step, the exit buffers (each built from its step's verdicts unless
    given) and the final pod state (numpy)."""
    rules = convert.rules_from_numpy(rules_np, "cpu")
    one = convert.state_from_numpy(one_np, "cpu")
    if kind == "pod":
        pod = PPC.make_pod_state(WORLD, one)
        entry, exit_ = PPC.make_pod_steps("cpu")
    else:
        pod = PNS.make_dcn_pod_state(WORLD, 1, one)
        entry, exit_ = PNS.make_dcn_pod_steps("cpu")
    decs, made = [], []
    for k, (ebuf, t) in enumerate(zip(entries, times)):
        pod, dec = entry(pod, rules, to_device(ebuf, "cpu"), int(t))
        decs.append({f: getattr(dec, f).numpy() for f in dec._fields})
        xbuf = (pod_exit_buf(ebuf, decs[-1]["reason"]) if exits is None
                else exits[k])
        made.append(xbuf)
        pod = exit_(pod, rules, to_device(xbuf, "cpu"), int(t) + 20)
    return decs, made, port_np(pod)


def test_distributed_drivers_equal_the_one_process_drivers(tmp_path):
    """Two gloo ranks, one shard each: ``make_dist_pod_steps`` against
    ``make_pod_steps`` at D = 2, and ``make_dist_dcn_pod_steps`` (two
    slices of one shard, a global-scope rule) against
    ``make_dcn_pod_steps``, over four entry + exit steps with a cluster
    flow rule, a cluster param rule and local rules: equal decisions on
    every step and equal final state on every shard. The workers have 90
    s."""
    rows, pack, one = pod_world(thr=7, param_thr=3, local_thr=2)
    _, gpack, _ = pod_world(thr=7, param_thr=3, local_thr=2, scope="global")
    one_np = jax_to_np(one)
    rng = np.random.default_rng(41)
    names = list(rows)
    entries, times = [], []
    for k in range(DIST_STEPS):
        n = WORLD * DIST_B
        buf = pod_entry_buf(WORLD, DIST_B, {
            i: rows[names[j]] for i, j in enumerate(
                rng.integers(0, len(names), size=n))})
        buf["count"][:] = rng.integers(1, 3, size=n) if k == 2 else 1
        buf["prioritized"][:] = rng.random(n) < 0.3
        buf["param_hash"][:, 0] = rng.choice(
            np.array([0xBEEF, 0xCAFE], np.uint32), size=n)
        buf["param_present"][:, 0] = True
        entries.append(buf)
        times.append(NOW0 + 250 * k)
    rules = {"pod": jax_to_np(pack), "dcn": jax_to_np(gpack)}
    pod_decs, exits, pod_np = _one_process("pod", rules["pod"], one_np,
                                           entries, times)
    dcn_decs, _, dcn_np = _one_process("dcn", rules["dcn"], one_np,
                                       entries, times, exits)
    blocked = sum(int((d["reason"] > 0).sum()) for d in pod_decs)
    assert blocked > 0

    inputs = {"times": np.asarray(times, np.int64)}
    inputs.update(flatten(rules["pod"], "pod_rules/"))
    inputs.update(flatten(rules["dcn"], "dcn_rules/"))
    inputs.update(flatten(one_np, "state/"))
    for k, (e, x) in enumerate(zip(entries, exits)):
        inputs.update(flatten(e, f"entry{k}/"))
        inputs.update(flatten(x, f"exit{k}/"))
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_pod_worker", str(r),
         str(WORLD), str(tmp_path)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=90)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, logs

    outs = []
    for r in range(WORLD):
        with np.load(tmp_path / f"out_{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    for kind, decs, pod_state in (("pod", pod_decs, pod_np),
                                  ("dcn", dcn_decs, dcn_np)):
        for k, dec in enumerate(decs):
            for f, want in dec.items():
                got = np.concatenate([o[f"{kind}/dec{k}/{f}"]
                                      for o in outs])
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{kind} {k} {f}")
        for r in range(WORLD):
            index = r if kind == "pod" else (r, 0)
            assert_tree_equal(_index(pod_state, index),
                              unflatten(outs[r], f"{kind}/state/"),
                              rtol=0.0)


def _index(d, i):
    return {k: (_index(v, i) if isinstance(v, dict) else v[i])
            for k, v in d.items()}
