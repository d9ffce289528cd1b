"""The port's slim engine (``sentinel_tpu_torch/core/engine.py``) on the
CPU: ``check_batch`` / ``complete_batch`` against the JAX engine's, the
typed ``BlockException``s of ``entry()``, the device policy (no card and
no explicit device raises), and the import boundary (no module of the
port loads JAX or the JAX package).
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


from sentinel_tpu.core.engine import SentinelEngine as JEngine

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core import exceptions as PX
from sentinel_tpu_torch.core.context import enter as context_enter
from sentinel_tpu_torch.core.context import exit_context
from sentinel_tpu_torch.core.engine import SentinelEngine
from sentinel_tpu_torch.models import authority as PA
from sentinel_tpu_torch.models import degrade as PD
from sentinel_tpu_torch.models import flow as PF
from sentinel_tpu_torch.models import param_flow as PP
from sentinel_tpu_torch.models import system as PY

from tests.test_torch_support import (
    CTX, NOW0, Scenario, assert_decisions_equal, assert_tree_equal,
    jax_entry, jax_exit, jax_to_np, port_np)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_call_context():
    """These tests build engines directly, not through ``reset()``: drop
    the thread's call context and retire the pooled auto context, as
    ``reset()`` does, so no entrance row of an earlier engine (another
    test's, or another file's in the same worker) is reused."""
    from sentinel_tpu_torch.core.context import (bump_generation,
                                                 replace_context)

    replace_context(None)
    bump_generation()
    yield
    replace_context(None)


class _Clock:
    def __init__(self):
        self.now = NOW0

    def __call__(self):
        return self.now


def _port_rules(objs, cls):
    out = []
    for r in objs:
        kw = dict(vars(r))
        if "items" in kw:
            kw["items"] = [PP.ParamFlowItem(i.object, i.count)
                           for i in kw["items"]]
        out.append(cls(**kw))
    return out


def _setup_rows(reg, sc):
    ent = reg.entrance_row(CTX)
    reg.entrance_row("chainCtx")
    for i in range(sc.n_res):
        reg.cluster_row(f"res{i}")
    for i in range(sc.n_res):
        reg.default_row(CTX, f"res{i}", ent)
    for o in ("", "appA", "appB", "appC"):
        reg.origin_id(o)
    for i in range(sc.n_res):
        for o in ("appA", "appB", "appC"):
            reg.origin_row(f"res{i}", o)
    reg.context_id(CTX)
    reg.context_id("chainCtx")


def test_batch_api_matches_jax_engine():
    sc = Scenario()
    clock = _Clock()
    jeng = JEngine(capacity=sc.capacity, clock=clock)
    peng = SentinelEngine(capacity=sc.capacity, device="cpu", clock=clock)
    try:
        _setup_rows(jeng.registry, sc)
        _setup_rows(peng.registry, sc)
        assert peng.registry.to_dict() == jeng.registry.to_dict()
        assert peng.registry.to_dict() == sc.reg.to_dict()
        jeng.flow_rules.load_rules(sc.flow)
        jeng.degrade_rules.load_rules(sc.degrade)
        jeng.param_rules.load_rules(sc.param)
        jeng.authority_rules.load_rules(sc.authority)
        jeng.system_rules.load_rules(sc.system)
        peng.flow_rules.load_rules(_port_rules(sc.flow, PF.FlowRule))
        peng.degrade_rules.load_rules(_port_rules(sc.degrade, PD.DegradeRule))
        peng.param_rules.load_rules(_port_rules(sc.param, PP.ParamFlowRule))
        peng.authority_rules.load_rules(
            _port_rules(sc.authority, PA.AuthorityRule))
        peng.system_rules.load_rules(_port_rules(sc.system, PY.SystemRule))
        rng = np.random.default_rng(12)
        width = 64
        for step in range(6):
            clock.now += int(rng.integers(150, 600))
            if step == 3:
                # A rule push mid-sequence: flow state is re-created on
                # both engines, breaker state survives.
                jeng.flow_rules.load_rules(sc.flow[:-2])
                peng.flow_rules.load_rules(
                    _port_rules(sc.flow[:-2], PF.FlowRule))
            ebuf = sc.entry_batch(rng, width, mixed=(step == 2))
            jdec = jeng.check_batch(jax_entry(ebuf))
            pdec = peng.check_batch(ebuf)
            assert_decisions_equal(jdec, pdec)
            reason, wait = peng.harvest_decisions(pdec)
            jr, jw = jeng.harvest_decisions(jdec)
            np.testing.assert_array_equal(reason, jr)
            np.testing.assert_array_equal(wait, jw)
            clock.now += 7
            xbuf = sc.exit_batch(rng, ebuf, reason, width)
            jeng.complete_batch(jax_exit(xbuf))
            peng.complete_batch(xbuf)
        # Both engines keep the per-second flight recorder by default.
        want = jax_to_np(jeng._state)
        assert "flight" in want
        assert_tree_equal(want, port_np(peng.state))
        assert_tree_equal(jax_to_np(jeng._rules), port_np(peng.rules))
    finally:
        jeng.close()


def test_entry_raises_typed_block_exceptions():
    clock = _Clock()
    eng = SentinelEngine(capacity=64, device="cpu", clock=clock)
    eng.flow_rules.load_rules([PF.FlowRule("f", count=1)])
    eng.authority_rules.load_rules([PA.AuthorityRule("a", limit_app="bad",
                                                     strategy=C.AUTHORITY_BLACK)])
    eng.param_rules.load_rules([PP.ParamFlowRule("p", param_idx=0, count=1)])
    eng.system_rules.load_rules([PY.SystemRule(qps=0)])
    eng.degrade_rules.load_rules([PD.DegradeRule(
        "d", count=1, grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, time_window=10,
        min_request_amount=1)])

    with eng.entry("f"):
        pass
    with pytest.raises(PX.FlowException):
        eng.entry("f")

    # The origin comes from the call context, as in the JAX engine.
    context_enter("ctx_good", "good")
    eng.entry("a").exit()
    exit_context()
    context_enter("ctx_bad", "bad")
    with pytest.raises(PX.AuthorityException):
        eng.entry("a")
    exit_context()

    eng.entry("p", args=("k",)).exit()
    eng.entry("p", args=("other",)).exit()
    with pytest.raises(PX.ParamFlowException):
        eng.entry("p", args=("k",))

    with pytest.raises(PX.SystemBlockException):
        eng.entry("s", entry_type=C.EntryType.IN)
    eng.entry("s", entry_type=C.EntryType.OUT).exit()

    for _ in range(2):
        with pytest.raises(RuntimeError):
            with eng.entry("d"):
                raise RuntimeError("business error")  # traced, not a block
    with pytest.raises(PX.DegradeException):
        eng.entry("d")
    with pytest.raises(ValueError):
        eng.entry("f", count=C.MAX_ACQUIRE_COUNT + 1)


def test_exception_mapping_matches_jax():
    from sentinel_tpu.core import exceptions as JX

    for reason in range(8):
        p = PX.exception_for_reason(reason, "r")
        j = JX.exception_for_reason(reason, "r")
        assert type(p).__name__ == type(j).__name__
        assert PX.reason_for_exception(p) == JX.reason_for_exception(j)


def test_no_card_and_no_device_raises(monkeypatch):
    from sentinel_tpu_torch.ops import step as PS
    from sentinel_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SentinelEngine(capacity=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.make_state(8, 8, NOW0)
    assert resolve_device("cpu") == torch.device("cpu")


# Modules of the st.entry slice that the walk below must reach.
API_MODULES = (
    "sentinel_tpu_torch.core.context", "sentinel_tpu_torch.core.config",
    "sentinel_tpu_torch.core.spi", "sentinel_tpu_torch.core.lease",
    "sentinel_tpu_torch.log.record_log", "sentinel_tpu_torch.native",
    "sentinel_tpu_torch.metrics.metric_node",
    "sentinel_tpu_torch.utils.time_util",
    "sentinel_tpu_torch.rollout.canary", "sentinel_tpu_torch.rollout.manager",
    "sentinel_tpu_torch.datasource.converters",
    "sentinel_tpu_torch.metrics.writer", "sentinel_tpu_torch.metrics.searcher",
    "sentinel_tpu_torch.metrics.timer")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, the native lease ring's loader included,
    imports without JAX or the JAX package; the ring is then built and
    loaded too, and still nothing of JAX is imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sentinel_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'sentinel_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from sentinel_tpu_torch.native import load_lease_ext\n"
        "load_lease_ext()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'sentinel_tpu' or "
        "k.startswith('sentinel_tpu.'))\n"
        f"missing = sorted(set({API_MODULES!r}) - set(names))\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 35 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_only_the_port():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert not any(m == "jax" or m.startswith("jax.") or m == "sentinel_tpu"
                   or m.startswith("sentinel_tpu.") for m in mods), mods
    assert any(m.startswith("sentinel_tpu_torch") for m in mods)


def test_entry_and_handle_signatures_match_jax():
    """The width-1 API takes the JAX package's arguments in its order:
    ``entry(resource, entry_type, count, args, prioritized)``, with the
    origin taken from the call context, and ``EntryHandle`` carries the
    context, the lease flag and the caller's clock read."""
    import inspect

    from sentinel_tpu.core.engine import EntryHandle as JHandle

    from sentinel_tpu_torch.core.engine import EntryHandle

    assert inspect.signature(SentinelEngine.entry) == \
        inspect.signature(JEngine.entry)
    assert inspect.signature(EntryHandle) == inspect.signature(JHandle)
    assert list(inspect.signature(SentinelEngine.entry).parameters) == [
        "self", "resource", "entry_type", "count", "args", "prioritized"]
    for field in ("context", "leased"):
        assert field in EntryHandle.__slots__


def test_system_listener_feeds_the_step_signals():
    """A system rule on load or CPU starts the 1 Hz OS sampler at compile,
    the next step folds its sample into the state, and close() stops it."""
    clock = _Clock()
    eng = SentinelEngine(capacity=64, device="cpu", clock=clock)
    try:
        eng.system_rules.load_rules([PY.SystemRule(highest_system_load=1e9,
                                                   highest_cpu_usage=1.0)])
        with eng.entry("s", C.EntryType.IN):
            pass
        assert eng.system_status._thread is not None
        load, cpu = eng.state.sys_signals.tolist()
        assert load >= 0.0 and -1.0 <= cpu <= 1.0
    finally:
        eng.close()
    assert eng.system_status._thread is None


def test_init_funcs_and_host_slots_of_the_module_api():
    """@init_func runs once the default engine is installed (at once when
    registered after boot); a registered host slot sees every entry."""
    import sentinel_tpu_torch as st

    calls = []
    eng = st.reset(capacity=64, device="cpu")
    try:
        st.init_func()(lambda: calls.append(st.get_engine()))
        assert calls == [eng]

        class Count(st.ProcessorSlot):
            def __init__(self):
                self.seen = []

            def on_entry(self, info):
                self.seen.append((info.resource, info.context_name))

        slot = Count()
        st.register_slot(slot)
        try:
            with st.entry("free"):
                pass
        finally:
            st.unregister_slot(slot)
        assert slot.seen == [("free", C.CONTEXT_DEFAULT_NAME)]
    finally:
        eng.close()
