"""The port's module API (``import sentinel_tpu_torch as st``) against the
JAX package's, driven through the same calls.

Each test runs one script of ``entry`` / ``exit`` / rule-push / clock
operations against both packages under their own frozen clocks at the
same epoch: the JAX package's default engine from ``st.reset(capacity=
512)``, the port's from ``reset(capacity=512, device="cpu")``. Every
operation's verdict (pass, paced wait, or the exception's type) must be
equal; at each checkpoint so must ``node_snapshot()``, ``tree_dict()``,
``seal_metrics()`` and the device state (through
``tests/test_torch_support.py``: integers bit-equal, floats within
``FLOAT_RTOL``).

The two engines live for the whole module: the JAX reference compiles
its step once per (width, rule shape), about ten seconds a set on the
CPU, so every test starts by pushing all five rule families (which
re-creates the controller state), moving both clocks at least 100 s on
to a whole second (which clears the windows) and leaving no context behind; a test that fails
leaves fresh engines to the next. The leases and the unruled fast path
commit through each package's background ``StatsCommitter``. The harness
flushes a side's committer whenever six commits are queued, so no flush
is wider than 8 and the JAX reference compiles only widths 1 and 8.
Rate-limiter and borrow waits stay at or under 20 ms, since ``entry()``
really sleeps them.
"""

from __future__ import annotations

import math
import random

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core import constants as JC
from sentinel_tpu.core import context as jctx
from sentinel_tpu.utils import time_util as jtu

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.core import config as pconfig
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core import spi as pspi
from sentinel_tpu_torch.log import record_log as plog
from sentinel_tpu_torch.utils import time_util as ptu

from tests.test_torch_support import (FLOAT_RTOL, assert_tree_equal,
                                      jax_to_np, port_np)

NOW0 = 1_700_000_000_000
CAPACITY = 512
OUT, IN = JC.EntryType.OUT, JC.EntryType.IN
W, RL, WRL = (JC.CONTROL_BEHAVIOR_WARM_UP, JC.CONTROL_BEHAVIOR_RATE_LIMITER,
              JC.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER)
MAX_QUEUED = 6


class Side:
    """One package: its module API, clock, context module and engine."""

    def __init__(self, name, st, tu, ctx):
        self.name = name
        self.st = st
        self.tu = tu
        self.ctx = ctx
        self.eng = None
        self.last = (0, 0)

    def attach(self, eng):
        """Record the (reason, wait_us) of each device-path step."""
        self.eng = eng
        submit = eng._submit_entry

        def recorded(*a, **k):
            self.last = submit(*a, **k)
            return self.last

        eng._submit_entry = recorded

    def rule(self, family, **kw):
        cls = {"flow": "FlowRule", "degrade": "DegradeRule",
               "authority": "AuthorityRule", "system": "SystemRule",
               "param": "ParamFlowRule"}[family]
        if "items" in kw:
            kw["items"] = [self.st.ParamFlowItem(o, c) for o, c in kw["items"]]
        return getattr(self.st, cls)(**kw)

    def bound(self):
        """Keep the queued commits under 8 (the widest JAX flush)."""
        c = self.eng._committer
        if c is not None and max(len(c._entries), len(c._exits)) >= MAX_QUEUED:
            c.flush()


FAMILIES = ("flow", "degrade", "authority", "system", "param")
# Loaded before the JAX reference compiles: the widest rule shapes the
# tests use (two flow rules on one resource, one rule of every other
# per-resource family), so later pushes reuse the compiled steps.
WARM_RULES = dict(
    flow=[dict(resource="_warm", count=1e9), dict(resource="_warm", count=1e9)],
    degrade=[dict(resource="_warm", count=1, time_window=5)],
    authority=[dict(resource="_warm", limit_app="x")],
    param=[dict(resource="_warm", param_idx=0, count=1e9)])


class Pair:
    def __init__(self):
        self.j = Side("jax", jst, jtu, jctx)
        self.p = Side("port", pst, ptu, pctx)
        self.sides = (self.j, self.p)
        self.verdicts = []
        self.broken = False

    def open(self):
        for tu in (jtu, ptu):
            tu.freeze_time(NOW0)
        for ctx in (jctx, pctx):
            ctx.replace_context(None)
            # reset() retires the contexts of an earlier DEFAULT engine
            # only; an engine an earlier test built directly may have left
            # a pooled auto context holding its rows on this thread.
            ctx.bump_generation()
        self.j.attach(jst.reset(capacity=CAPACITY))
        self.p.attach(pst.reset(capacity=CAPACITY, device="cpu"))
        self.rules(**WARM_RULES)
        for s in self.sides:
            s.eng.warmup((1, 8))
        self.broken = False

    def close(self):
        for ctx in (jctx, pctx):
            ctx.replace_context(None)
        self.p.eng.close()
        self.j.eng.close()

    def start(self):
        """A clean slate for the next test on the same engines."""
        self.verdicts = []
        for ctx in (jctx, pctx):
            ctx.replace_context(None)
        now = ptu.current_time_millis()
        assert jtu.current_time_millis() == now
        self.advance(100_000 - now % 100_000 + 100_000)  # whole seconds
        self.rules()

    # -- operations (each applied to both sides, outcomes compared) -------

    def both(self, fn):
        out = [fn(s) for s in self.sides]
        assert out[0] == out[1], (len(self.verdicts), out)
        for s in self.sides:
            s.bound()
        self.verdicts.append(out[1])
        return out[1]

    def load(self, family, *rules, flush=True):
        """Replace one family's rules on both sides (kwargs dicts).

        The committers are flushed first: a lease that a push makes anew
        adds the still-queued passes to its CURRENT bucket, so with a
        queue its bucket split would follow the background flush's
        timing on each side."""
        loader = {"flow": "load_flow_rules", "degrade": "load_degrade_rules",
                  "authority": "load_authority_rules",
                  "system": "load_system_rules",
                  "param": "load_param_flow_rules"}[family]
        for s in self.sides:
            if flush:
                s.eng._flush_committer()
            getattr(s.st, loader)([s.rule(family, **kw) for kw in rules])
            # Compile now: a compile run by a background flush would
            # intern the rules' rows at a moment set by thread timing.
            with s.eng._lock:
                s.eng._ensure_compiled()

    def rules(self, **families):
        """Push all five families (those not named get no rules)."""
        for family in FAMILIES:
            self.load(family, *families.get(family, ()))

    def advance(self, ms):
        for s in self.sides:
            s.tu.advance_time(ms)

    def entry(self, res, ctx=None, origin="", entry_type=OUT, count=1,
              args=(), prioritized=False, error=False, keep=False):
        """One entry (+ exit unless ``keep``) on both sides; returns the
        verdict, or ``(verdict, {side: handle})`` when ``keep``."""
        handles = {}

        def go(s):
            if ctx is not None:
                s.st.context_enter(ctx, origin)
            s.last = (0, 0)
            try:
                h = s.st.entry(res, entry_type, count, args, prioritized)
            except s.st.BlockException as ex:
                if ctx is not None:
                    s.st.exit_context()
                return type(ex).__name__
            verdict = "wait" if s.last[1] > 0 else "pass"
            if keep:
                handles[s.name] = h
                return verdict
            if error:
                s.st.trace(RuntimeError("business error"))
            h.exit()
            if ctx is not None:
                s.st.exit_context()
            return verdict

        v = self.both(go)
        return (v, handles) if keep else v

    def exit(self, handles, error=False):
        def go(s):
            h = handles.get(s.name)
            if h is None:
                return None
            if error:
                h.trace(RuntimeError("business error"))
            h.exit()
            return len(h.context.entry_stack)

        return self.both(go)

    # -- checkpoints --------------------------------------------------------

    def check(self, seal=True):
        """Equal readers and device state on both sides."""
        j, p = self.j.eng, self.p.eng
        _assert_close(p.node_snapshot(), j.node_snapshot(), "node_snapshot")
        _assert_close(p.tree_dict(), j.tree_dict(), "tree_dict")
        if seal:
            jm = [vars(n) for n in j.seal_metrics()]
            pm = [vars(n) for n in p.seal_metrics()]
            _assert_close(pm, jm, "seal_metrics")
        for s in self.sides:
            s.eng._flush_committer()
        with j._lock, p._lock:
            # The flight-recorder ring included: both engines keep one.
            assert_tree_equal(jax_to_np(j._state), port_np(p.state))
            assert_tree_equal(jax_to_np(j._rules), port_np(p.rules))


def _assert_close(got, want, path):
    """Readers' output: same structure; floats within FLOAT_RTOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=FLOAT_RTOL, abs_tol=0), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def engines():
    pr = Pair()
    pr.open()
    yield pr
    pr.close()
    jst.reset(capacity=CAPACITY)
    for tu in (jtu, ptu):
        tu.unfreeze_time()


@pytest.fixture
def pair(engines, request, tmp_path):
    if engines.broken:
        engines.close()
        engines.open()
    pconfig.config.set(pconfig.LOG_DIR, str(tmp_path))
    plog.block_log.close()
    failed = request.session.testsfailed
    engines.start()
    yield engines
    if request.session.testsfailed > failed:
        engines.broken = True
    plog.block_log.close()
    pconfig.config.reset_for_tests()


def _port_twin(**families):
    """A port engine with the lease off: every entry takes the device
    path. The widened host mirrors must match it verdict for verdict."""
    twin = pst.SentinelEngine(CAPACITY, device="cpu")
    twin.lease_enabled = False
    twin._rebuild_leases()
    side = Side("twin", pst, ptu, pctx)
    for family, rules in families.items():
        mgr = getattr(twin, {"flow": "flow_rules", "param": "param_rules"}[family])
        mgr.load_rules([side.rule(family, **kw) for kw in rules])
    return twin


def _twin_verdict(twin, res, args=()):
    """One entry + exit on the twin, in a context of its own: contexts
    cache rows of the engine they were resolved against."""
    pctx.enter("twin_ctx")
    try:
        h = twin.entry(res, OUT, 1, args)
    except pst.BlockException as ex:
        return type(ex).__name__
    else:
        h.exit()
        return "pass"
    finally:
        pctx.replace_context(None)


# ---------------------------------------------------------------------------
# Scenarios (tests/test_lease.py, test_occupy.py, test_degrade.py, contexts)
# ---------------------------------------------------------------------------


def test_lease_admission_stats_and_metric_log(pair):
    """Exact leased admission, its stats on the device, its blocks in the
    metric log and in the port's block log."""
    pair.rules(flow=[dict(resource="fast", count=3)])
    assert "fast" in pair.p.eng._leases
    got = [pair.entry("fast") for _ in range(6)]
    assert got == ["pass"] * 3 + ["FlowException"] * 3
    pair.check(seal=False)
    assert pair.p.eng.node_snapshot()["fast"]["blockQps"] == 3
    pair.advance(1100)  # the window rolls: quota refreshed
    assert pair.entry("fast") == "pass"
    pair.advance(2000)
    pair.check()
    with open(plog.block_log.path) as f:
        assert f.read().count("|1|fast,FlowException,,1") == 3


def test_push_keeps_spent_quota_and_tightest_default_wins(pair):
    pair.rules(flow=[dict(resource="fast", count=3),
                     dict(resource="two", count=10),
                     dict(resource="two", count=4)])
    assert [pair.entry("fast") for _ in range(3)] == ["pass"] * 3
    # A push of another family rebuilds the lease table; the mirror of
    # "fast" carries over and grants nothing again.
    pair.load("degrade", dict(resource="other", count=1, time_window=5))
    assert "fast" in pair.p.eng._leases
    assert pair.entry("fast") == "FlowException"
    got = [pair.entry("two") for _ in range(8)]
    assert got.count("pass") == 4
    pair.check()


def test_newly_eligible_resource_seeds_from_device_and_queue(pair):
    pair.rules(flow=[dict(resource="born", count=3),
                     dict(resource="born", count=3, control_behavior=RL,
                          max_queueing_time_ms=0)])
    assert "born" not in pair.p.eng._leases
    assert pair.entry("born") == "pass"  # device path, one pass committed
    pair.load("flow", dict(resource="born", count=3))
    assert "born" in pair.p.eng._leases
    got = [pair.entry("born") for _ in range(4)]
    assert got == ["pass", "pass", "FlowException", "FlowException"]
    # Unruled traffic still queued in the committer counts once a rule
    # lands. Holding each committer's flush lock keeps the background
    # flush from draining the queue meanwhile (a drained but not yet
    # dispatched batch is counted by neither the queue nor the window).
    locks = [s.eng._committer._flush_lock for s in pair.sides]
    for s in pair.sides:
        s.eng._flush_committer()
    for lock in locks:
        lock.acquire()
    try:
        for _ in range(5):
            assert pair.entry("newly") == "pass"
        assert pair.p.eng.committer.pending() == (5, 5)
        pair.load("flow", dict(resource="born", count=3),
                  dict(resource="newly", count=6), flush=False)
    finally:
        for lock in locks:
            lock.release()
    got = [pair.entry("newly") for _ in range(3)]
    assert got == ["pass", "FlowException", "FlowException"]
    pair.check()


def test_unruled_skip_relate_target_and_system_stand_down(pair):
    pair.rules(flow=[dict(resource="write_db", count=3,
                          strategy=JC.FLOW_STRATEGY_RELATE,
                          ref_resource="read_db")])
    assert "read_db" in pair.p.eng._guarded_resources
    for _ in range(4):  # read_db's window must be visible at once
        assert pair.entry("read_db") == "pass"
    assert pair.entry("write_db") == "FlowException"
    v, handles = pair.entry("free", keep=True)
    assert v == "pass" and handles["port"].leased  # unruled fast path
    pair.exit(handles)
    pair.load("system", dict(qps=1e6))
    assert not pair.p.eng._leases and not pair.p.eng._unruled_fastpath
    v, handles = pair.entry("free", entry_type=IN, keep=True)
    assert v == "pass" and not handles["port"].leased  # device path
    pair.exit(handles)
    pair.load("system")
    assert pair.p.eng._unruled_fastpath
    pair.check()


def test_warmup_lease_matches_device_path(pair):
    rule = dict(resource="w", count=30, control_behavior=W,
                warm_up_period_sec=4)
    pair.rules(flow=[rule])
    assert type(pair.p.eng._leases["w"]).__name__ == "WideLease"
    twin = _port_twin(flow=[rule])
    for sec in range(6):  # the cold second, the ramp, the warm plateau
        for i in range(14):
            if i:
                pair.advance(33)
            assert pair.entry("w") == _twin_verdict(twin, "w"), (sec, i)
        pair.advance(1000 - 13 * 33)
    assert set(pair.verdicts) == {"pass", "FlowException"}
    twin.close()
    pair.check()


def test_param_leases_match_device_and_raise(pair):
    pp = dict(resource="pp", param_idx=0, count=3, burst_count=1)
    pair.rules(
        flow=[dict(resource="fp", count=4)],
        param=[pp, dict(resource="px", param_idx=0, count=2),
               dict(resource="pi", param_idx=0, count=1,
                    items=[("vip", 4.0)]),
               dict(resource="fp", param_idx=0, count=2),
               dict(resource="pm", param_idx=0, count=3)])
    twin = _port_twin(param=[pp])
    rng = random.Random(3)
    for step in range(60):
        pair.advance(rng.choice([0, 50, 200, 1000]))
        v = rng.choice(["a", "b", "c"])
        assert pair.entry("pp", args=[v]) == \
            _twin_verdict(twin, "pp", args=[v]), step
    twin.close()
    assert [pair.entry("px", args=["k"]) for _ in range(3)] == \
        ["pass", "pass", "ParamFlowException"]
    assert pair.entry("px", args=["other"]) == "pass"
    assert pair.entry("px") == "pass"  # no argument: the rule does not apply
    assert [pair.entry("pi", args=["vip"]) for _ in range(6)].count("pass") == 4
    assert [pair.entry("pi", args=["reg"]) for _ in range(3)].count("pass") == 1
    # Flow and param on one resource: param first, then the flow quota.
    got = [pair.entry("fp", args=[v]) for v in "vvvwxy"]
    assert got == ["pass", "pass", "ParamFlowException", "pass", "pass",
                   "FlowException"]
    # A prioritized (device-path) pass consumes the host param mirror.
    assert pair.entry("pm", args=["v"]) == "pass"
    assert pair.entry("pm", args=["v"]) == "pass"
    assert pair.entry("pm", args=["v"], prioritized=True) == "pass"
    assert pair.entry("pm", args=["v"]) == "ParamFlowException"
    pair.check()


def test_prioritized_borrow_waits_and_lands(pair):
    pair.rules(flow=[dict(resource="occ", count=10)])
    for _ in range(10):
        assert pair.entry("occ") == "pass"
    pair.advance(990)  # the 10 passes sit in the expiring bucket
    assert pair.entry("occ") == "FlowException"
    assert pair.entry("occ", prioritized=True) == "wait"  # ~10 ms borrow
    pair.check(seal=False)
    pair.advance(20)  # the borrowed pass lands in the next bucket
    got = [pair.entry("occ") for _ in range(12)]
    assert "pass" in got and "FlowException" in got
    pair.check()


def test_degrade_opens_and_recovers(pair):
    pair.rules(degrade=[dict(resource="er",
                             grade=JC.DEGRADE_GRADE_EXCEPTION_RATIO,
                             count=0.5, time_window=2, min_request_amount=5)])
    for i in range(5):
        assert pair.entry("er", error=(i < 4)) == "pass"
    assert pair.entry("er") == "DegradeException"
    pair.advance(1_500)
    assert pair.entry("er") == "DegradeException"
    pair.advance(501)
    assert pair.entry("er", error=True) == "pass"  # the probe fails...
    assert pair.entry("er") == "DegradeException"  # ...and re-opens
    pair.advance(2_001)
    assert pair.entry("er") == "pass"  # a good probe closes it
    assert pair.entry("er") == "pass"
    pair.check()


def test_context_semantics(pair):
    pair.rules(flow=[dict(resource="guard", count=0)],
               authority=[dict(resource="auth", limit_app="appA",
                               strategy=JC.AUTHORITY_BLACK)])
    # Oversized or empty context names: pass-through, no protection.
    for name in ("x" * (JC.MAX_CONTEXT_NAME_SIZE + 1), ""):
        assert pair.entry("guard", ctx=name) == "pass"
    assert pair.entry("guard") == "FlowException"
    # The origin comes from the context.
    assert pair.entry("auth", ctx="ctx", origin="appA") == \
        "AuthorityException"
    assert pair.entry("auth", ctx="ctx", origin="appB") == "pass"
    # The pooled auto context is reused once its entries drained.
    contexts = []
    for _ in range(2):
        v, handles = pair.entry("pool", keep=True)
        contexts.append(handles["port"].context)
        pair.exit(handles)
        assert pctx.get_context() is None
    assert contexts[0] is contexts[1] and contexts[0].auto_created
    # Nested entries under one context, exited out of order.
    for s in pair.sides:
        s.st.context_enter("nest", "appB")
    v1, outer = pair.entry("outer", keep=True)
    v2, inner = pair.entry("inner", keep=True)
    assert (v1, v2) == ("pass", "pass")
    assert inner["port"].dn_row != outer["port"].dn_row
    assert pair.exit(outer) == 1  # the inner entry stays on the stack
    assert pair.exit(inner, error=True) == 0
    for s in pair.sides:
        s.st.exit_context()
    assert pctx.get_context() is None
    pair.check()


class _DenySlot:
    """Host slot: rejects one resource, counts exits."""

    def __init__(self, st):
        self.st = st
        self.exits = 0

    def on_entry(self, info):
        if info.resource == "denied":
            raise self.st.FlowException(info.resource)

    def on_exit(self, info, rt_ms, error):
        self.exits += 1


def test_spi_host_slot_blocks_and_fast_path_stands_down(pair):
    pair.rules(flow=[dict(resource="fast", count=5)])
    slots = {}
    for s in pair.sides:
        slot = type("Deny", (_DenySlot, s.st.ProcessorSlot), {})(s.st)
        s.st.register_slot(slot)
        slots[s.name] = slot
    try:
        assert pair.entry("denied") == "FlowException"
        v, handles = pair.entry("fast", keep=True)
        assert v == "pass" and not handles["port"].leased
        pair.exit(handles)
        assert [pair.entry("fast") for _ in range(5)].count("pass") == 4
    finally:
        for s in pair.sides:
            s.st.unregister_slot(slots[s.name])
    assert slots["port"].exits == slots["jax"].exits == 5
    pair.check()


# ---------------------------------------------------------------------------
# Differential fuzz over every class of entry()
# ---------------------------------------------------------------------------

FUZZ_RULES = dict(
    flow=[dict(resource="L0", count=3), dict(resource="L1", count=5),
          dict(resource="LP", count=4),
          dict(resource="LW", count=6, control_behavior=W,
               warm_up_period_sec=2),
          dict(resource="R0", count=100, control_behavior=RL,
               max_queueing_time_ms=20),
          dict(resource="R1", count=100, control_behavior=WRL,
               warm_up_period_sec=2, max_queueing_time_ms=20),
          dict(resource="T0", count=2, grade=JC.FLOW_GRADE_THREAD)],
    param=[dict(resource="LP", param_idx=0, count=1)],
    degrade=[dict(resource="D0", grade=JC.DEGRADE_GRADE_EXCEPTION_COUNT,
                  count=1, time_window=1, min_request_amount=2,
                  stat_interval_ms=5000)],
    authority=[dict(resource="A0", limit_app="appA",
                    strategy=JC.AUTHORITY_BLACK)])
FUZZ_RESOURCES = ("L0", "L1", "LP", "LP", "LW", "R0", "R1", "T0", "D0",
                  "D0", "A0", "A0", "U0", "U1", "U2")


def _fuzz(pair, seed, ops=300):
    rng = random.Random(seed)
    pair.rules(**FUZZ_RULES)
    held = []
    for op in range(ops):
        r = rng.random()
        if r < 0.08:
            pair.advance(rng.choice([0, 5, 50, 300, 1000]))
        elif r < 0.16 and held:
            pair.exit(held.pop(rng.randrange(len(held))),
                      error=rng.random() < 0.3)
        elif r < 0.17:
            # A system rule comes and goes: every fast path stands down.
            pair.load("system", *([dict(qps=1e9)] if rng.random() < 0.5
                                  else []))
        else:
            res = rng.choice(FUZZ_RESOURCES)
            ctx = origin = None
            if rng.random() < 0.4:
                ctx, origin = "ctx", rng.choice(["appA", "appB"])
            kw = dict(ctx=ctx, origin=origin or "",
                      entry_type=IN if rng.random() < 0.5 else OUT,
                      args=[rng.randrange(4)] if rng.random() < 0.8 else [],
                      prioritized=(res[0] in "RT" and rng.random() < 0.1),
                      error=rng.random() < 0.3)
            if ctx is None and rng.random() < 0.1 and len(held) < 3:
                v, handles = pair.entry(res, keep=True, **kw)
                if handles:
                    held.append(handles)
            else:
                pair.entry(res, **kw)
        if op % 100 == 99:
            pair.check(seal=False)
    for handles in held:
        pair.exit(handles)
    pair.advance(1000)
    pair.check()
    kinds = set(pair.verdicts)
    assert {"pass", "wait", "FlowException", "ParamFlowException",
            "AuthorityException", "DegradeException"} <= kinds, kinds


@pytest.mark.parametrize("seed", [
    1, 2,
    pytest.param(3, marks=pytest.mark.slow),
    pytest.param(4, marks=pytest.mark.slow),
    pytest.param(5, marks=pytest.mark.slow),
])
def test_differential_fuzz(pair, seed):
    _fuzz(pair, seed)


def test_numpy_batches_keep_the_statistics(pair):
    """C22: the reference's ``check_batch`` / ``complete_batch`` take an
    ``EntryBatch`` / ``ExitBatch`` of numpy arrays (its jit converts
    them), as its own tests build them. The port's passed such a batch on
    unconverted: the step raised, the engine restarted cold and the
    statistics admitted before it were gone. Now both give the same
    ``Decisions`` and state, and the earlier passes survive."""
    from sentinel_tpu.core.batch import EntryBatch as JEntryBatch
    from sentinel_tpu.core.batch import ExitBatch as JExitBatch
    from sentinel_tpu_torch.core.batch import EntryBatch as PEntryBatch
    from sentinel_tpu_torch.core.batch import ExitBatch as PExitBatch
    from sentinel_tpu_torch.core.batch import (make_entry_batch_np,
                                               make_exit_batch_np)

    pair.rules(flow=[dict(resource="nb", count=5)])
    assert [pair.entry("nb") for _ in range(3)] == ["pass"] * 3
    for s in pair.sides:
        s.eng._flush_committer()
    before = pair.p.eng.node_snapshot()["nb"]["passQps"]
    assert before == pair.j.eng.node_snapshot()["nb"]["passQps"] == 3.0

    row = pair.p.eng.registry.cluster_row("nb")
    assert row == pair.j.eng.registry.cluster_row("nb")
    buf = make_entry_batch_np(8)
    buf["cluster_row"][:4] = row
    buf["count"][:4] = 1
    dj = pair.j.eng.check_batch(JEntryBatch(**buf))
    dp = pair.p.eng.check_batch(PEntryBatch(**buf))
    for f in ("reason", "wait_us", "rule_slot"):
        np.testing.assert_array_equal(np.asarray(getattr(dp, f)),
                                      np.asarray(getattr(dj, f)), f)
    passed = int((np.asarray(dp.reason)[:4] == 0).sum())
    assert passed == 2  # the rule's 5, less the three leased passes

    xbuf = make_exit_batch_np(8)
    xbuf["cluster_row"][:passed] = row
    xbuf["count"][:passed] = 1
    xbuf["rt_ms"][:passed] = 7
    xbuf["success"][:passed] = True
    pair.j.eng.complete_batch(JExitBatch(**xbuf))
    pair.p.eng.complete_batch(PExitBatch(**xbuf))
    assert pair.p.eng.node_snapshot()["nb"]["passQps"] == before + passed
    pair.check(seal=False)


def test_trace_snapshot_copies_a_column_that_is_not_a_tensor():
    """C22's trace-ring half: a batch column that is a numpy array or
    another array-like is copied as an array, not read as a tensor."""
    from sentinel_tpu_torch.telemetry.trace_ring import DecisionTraceBuffer

    col = np.arange(4, dtype=np.int32)
    got = DecisionTraceBuffer._snap(col, [])
    col[0] = 9
    assert got.tolist() == [0, 1, 2, 3]
    assert DecisionTraceBuffer._snap([1, 2], []).tolist() == [1, 2]


def test_package_reexports_match_the_reference():
    """C24: the reference's ``metrics`` and ``telemetry`` packages
    re-export their modules' names, and its engine names the param hash
    ``_hash_param``; the reference's own tests import them so
    (``tests/test_observability.py``, ``test_flow_batch_semantics.py``).
    The port's packages exported nothing."""
    import sentinel_tpu.metrics as jmetrics
    import sentinel_tpu.telemetry as jtelemetry
    from sentinel_tpu.core.engine import _hash_param as jhash

    import sentinel_tpu_torch.metrics as pmetrics
    import sentinel_tpu_torch.telemetry as ptelemetry
    from sentinel_tpu_torch.core.engine import _hash_param as phash

    assert pmetrics.__all__ == jmetrics.__all__
    for name in jmetrics.__all__:
        assert getattr(pmetrics, name).__name__ == \
            getattr(jmetrics, name).__name__
    public = [n for n in vars(jtelemetry) if not n.startswith("_")
              and not isinstance(getattr(jtelemetry, n), type(jtelemetry))]
    assert public and all(hasattr(ptelemetry, n) for n in public)
    for n in ("ATTR_REASON_NAMES", "NUM_RT_BUCKETS", "RT_BUCKET_EDGES_MS",
              "OPENMETRICS_CONTENT_TYPE"):
        assert np.array_equal(np.asarray(getattr(ptelemetry, n)),
                              np.asarray(getattr(jtelemetry, n))), n
    for v in ("user-42", 1, 1.0, "1", True, b"1", None):
        assert phash(v) == jhash(v)
