"""Push properties and the config-seeded instant window (ROADMAP C11) on the
port against the JAX package.

``core/property.py``'s classes run one script in each package and must
log the same events. Then engine pairs, a JAX engine and a port engine
(``device="cpu"``) built under the same ``csp.sentinel.statistic.*`` and
``csp.sentinel.occupy.timeout.ms`` keys, each on its own injected clock
at one epoch, must agree on the seeded window, the occupy cap and the
warnings their constructors log; then on the verdicts of one scripted
stream of ``entry`` / ``exit`` pairs and on the state, the telemetry
counters and ``telemetry_view`` after it. The lease is off in these
pairs, so every entry is a width-1 device step and no committer runs:
the JAX reference compiles two steps per engine. Also the reference's
push scenarios (``tests/test_flow.py:246``, ``:259``,
``tests/test_occupy.py:171``), ``reset_slot_floor``
(``tests/test_param_flow.py:202``), and a push racing the stats
committer. Exact everywhere: the comparisons are integer counters,
int64 stamps and host values.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core import constants as JC
from sentinel_tpu.core import context as jctx
from sentinel_tpu.core import property as jprop
from sentinel_tpu.core.config import config as jconfig
from sentinel_tpu.log.record_log import record_log as jlog
from sentinel_tpu.ops import step as JS

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core import property as pprop
from sentinel_tpu_torch.core.config import config as pconfig
from sentinel_tpu_torch.log.record_log import record_log as plog
from sentinel_tpu_torch.ops import step as PS
from sentinel_tpu_torch.utils import time_util as ptu

from tests.test_torch_support import assert_tree_equal, jax_to_np, port_np

NOW0 = 1_700_000_000_000
CAPACITY = 256
INTERVAL = "csp.sentinel.statistic.interval.ms"
SAMPLES = "csp.sentinel.statistic.sample.count"
OCCUPY = "csp.sentinel.occupy.timeout.ms"
LEASE = "csp.sentinel.lease.enabled"


# ---------------------------------------------------------------------------
# core/property.py
# ---------------------------------------------------------------------------


def _property_script(mod):
    log = []
    prop = mod.DynamicSentinelProperty()
    first = mod.SimplePropertyListener(lambda v: log.append(("first", v)))
    prop.add_listener(first)  # no value yet: no config_load
    log.append(("update", prop.update_value({"intervalMs": 2000}), prop.epoch))
    log.append(("update", prop.update_value({"intervalMs": 2000}), prop.epoch))

    class Loader(mod.PropertyListener):
        def config_update(self, value):
            log.append(("loader.update", value))

        def config_load(self, value):
            log.append(("loader.load", value))

    loader = Loader()
    prop.add_listener(loader)  # a value is present: config_load runs
    log.append(("update", prop.update_value(250), prop.epoch))
    prop.remove_listener(first)
    prop.remove_listener(first)  # a second removal is a no-op
    log.append(("update", prop.update_value(500), prop.epoch))
    log.append(("update", prop.update_value(500), prop.epoch))
    log.append(("value", prop.value))
    # The default config_load forwards to config_update.
    seeded = mod.DynamicSentinelProperty(7)
    seeded.add_listener(mod.SimplePropertyListener(
        lambda v: log.append(("seeded", v))))
    noop = mod.NoOpSentinelProperty()
    noop.add_listener(loader)
    noop.remove_listener(loader)
    log.append(("noop", noop.update_value(1)))
    for call in (lambda: mod.PropertyListener().config_update(1),
                 lambda: mod.SentinelProperty().update_value(1),
                 lambda: mod.SentinelProperty().add_listener(loader),
                 lambda: mod.SentinelProperty().remove_listener(loader)):
        with pytest.raises(NotImplementedError):
            call()
    return log


def test_property_classes_match_the_reference():
    log = _property_script(pprop)
    assert log == _property_script(jprop)
    assert ("update", False, 1) in log and ("loader.load", {"intervalMs": 2000}) in log


# ---------------------------------------------------------------------------
# Engine pairs under config
# ---------------------------------------------------------------------------


class Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


class Twin:
    """A JAX engine and a port engine built under the same config keys,
    each on its own injected clock, with the warnings each constructor
    logged."""

    def __init__(self, monkeypatch, keys, lease=False, capacity=CAPACITY,
                 slot_budget=0):
        self.warnings = {"jax": [], "port": []}
        for name, log in (("jax", jlog), ("port", plog)):
            monkeypatch.setattr(
                log, "warn", lambda msg, *a, _n=name: self.warnings[_n].append(
                    msg % a if a else msg))
        for ctx in (jctx, pctx):
            # A context resolved against an earlier engine holds its rows.
            ctx.replace_context(None)
            ctx.bump_generation()
        self.jclock, self.pclock = Clock(NOW0), Clock(NOW0)
        try:
            for cfg in (jconfig, pconfig):
                for key, value in keys.items():
                    cfg.set(key, str(value))
                cfg.set(LEASE, "true" if lease else "false")
            self.j = jst.SentinelEngine(capacity, clock=self.jclock,
                                        slot_budget=slot_budget)
            self.p = pst.SentinelEngine(capacity, device="cpu",
                                        clock=self.pclock,
                                        slot_budget=slot_budget)
        finally:
            jconfig.reset_for_tests()
            pconfig.reset_for_tests()
        self.sides = (("jax", jst, self.j, self.jclock),
                      ("port", pst, self.p, self.pclock))

    def close(self):
        for ctx in (jctx, pctx):
            ctx.replace_context(None)
        self.p.close()
        self.j.close()

    def geometry(self):
        """(interval ms, sample count, occupy cap), equal on both."""
        got = [(e._spec1.interval_ms, e._spec1.buckets, e._occupy_timeout_ms)
               for _, _, e, _ in self.sides]
        assert got[0] == got[1], got
        return got[1]

    def both(self, fn):
        out = [fn(st, eng, clock) for _, st, eng, clock in self.sides]
        assert out[0] == out[1], out
        return out[1]

    def load(self, flow=(), degrade=(), param=()):
        for _, st, eng, _ in self.sides:
            eng.flow_rules.load_rules([st.FlowRule(**kw) for kw in flow])
            eng.degrade_rules.load_rules(
                [st.DegradeRule(**kw) for kw in degrade])
            eng.param_rules.load_rules(
                [st.ParamFlowRule(**kw) for kw in param])

    def advance(self, ms):
        for _, _, _, clock in self.sides:
            clock.now += ms

    def check_state(self):
        with self.j._lock, self.p._lock:
            assert_tree_equal(jax_to_np(self.j._state), port_np(self.p.state))
            assert_tree_equal(jax_to_np(self.j._rules), port_np(self.p.rules))


def pair_verdict(st, eng, clock, res, count=1, prioritized=False,
                 error=False, hold_ms=0, args=()):
    """One entry + exit on one engine: ``"pass"`` or the exception's type."""
    try:
        h = eng.entry(res, count=count, args=args, prioritized=prioritized)
    except st.BlockException as ex:
        return type(ex).__name__
    clock.now += hold_ms
    if error:
        h.trace(RuntimeError("business error"))
    h.exit()
    return "pass"


STREAM_RULES = dict(
    flow=[dict(resource="q", count=5),
          dict(resource="w", count=10,
               control_behavior=JC.CONTROL_BEHAVIOR_WARM_UP,
               warm_up_period_sec=2),
          dict(resource="rl", count=20,
               control_behavior=JC.CONTROL_BEHAVIOR_RATE_LIMITER,
               max_queueing_time_ms=10)],
    degrade=[dict(resource="d", count=0.5,
                  grade=JC.DEGRADE_GRADE_EXCEPTION_RATIO, time_window=1,
                  min_request_amount=3)])


def stream_ops(seed, n, mean_advance_ms):
    """(resource, count, prioritized, error, advance ms, hold ms) per pair:
    QPS, warm-up, rate-limiter and degraded resources and an unruled one;
    a borrow attempt on the QPS resource now and then."""
    rng = np.random.default_rng(seed)
    names = ("q", "w", "rl", "d", "u")
    ops = []
    for _ in range(n):
        res = names[int(rng.integers(len(names)))]
        ops.append((res, int(rng.integers(1, 3)),
                    res == "q" and rng.random() < 0.02,
                    res == "d" and rng.random() < 0.6,
                    int(rng.integers(0, 2 * mean_advance_ms + 1)),
                    int(rng.integers(0, 40))))
    return ops


def run_stream(twin, ops):
    verdicts = []
    for res, count, prio, err, adv, hold in ops:
        twin.advance(adv)
        verdicts.append(twin.both(lambda st, eng, clock: pair_verdict(
            st, eng, clock, res, count, prio, err, hold)))
    return verdicts


def check_readers(twin):
    """The state, the telemetry counters and telemetry_view, equal."""
    twin.check_state()
    jc, pc = twin.j.telemetry_counts(), twin.p.telemetry_counts()
    assert set(jc) == set(pc)
    for k in jc:
        np.testing.assert_array_equal(pc[k], jc[k], err_msg=k)
    with twin.j._lock, twin.p._lock:
        assert_tree_equal(jax_to_np(JS.telemetry_view(twin.j._state)),
                          port_np(PS.telemetry_view(twin.p.state)))


@pytest.fixture
def twins(monkeypatch):
    made = []

    def make(keys, **kw):
        made.append(Twin(monkeypatch, keys, **kw))
        return made[-1]

    yield make
    for twin in made:
        twin.close()


@pytest.mark.parametrize("keys,want", [
    # Interval not a multiple of the sample count: default geometry.
    ({INTERVAL: 2000, SAMPLES: 3, OCCUPY: 250}, (1000, 2, 250)),
    # Zero: default geometry.
    ({INTERVAL: 0, SAMPLES: 4}, (1000, 2, 500)),
    # A cap above the interval: min(default, interval).
    ({INTERVAL: 2000, SAMPLES: 4, OCCUPY: 3000}, (2000, 4, 500)),
], ids=["not_a_multiple", "zero", "cap_above_interval"])
def test_invalid_config_falls_back_as_the_reference(twins, keys, want):
    """An invalid value: both constructors fall back to the same window
    and cap and log the same one warning; a short stream then agrees under
    the fallen-back values."""
    twin = twins(keys)
    assert twin.geometry() == want
    assert twin.warnings["port"] == twin.warnings["jax"]
    assert len(twin.warnings["port"]) == 1
    twin.load(**STREAM_RULES)
    verdicts = run_stream(twin, stream_ops(5, 60, 20))
    assert "pass" in verdicts and "FlowException" in verdicts
    check_readers(twin)


def test_config_seeded_engines_agree_through_property_pushes(twins):
    """Under 2000 / 4 / 250 both constructors seed those values without a
    warning and a stream agrees; then ``window_geometry_property`` and
    ``occupy_timeout_property`` (tests/test_flow.py:259,
    tests/test_occupy.py:193) retune both engines, an equal second push
    returns False and changes nothing, and the stream agrees again under
    the pushed geometry."""
    twin = twins({INTERVAL: 2000, SAMPLES: 4, OCCUPY: 250})
    assert twin.geometry() == (2000, 4, 250)
    assert twin.warnings == {"jax": [], "port": []}
    twin.load(**STREAM_RULES)
    ops = stream_ops(9, 160, 25)
    run_stream(twin, ops)
    check_readers(twin)

    def push(geometry, cap):
        return twin.both(lambda st, eng, clock: (
            eng.window_geometry_property.update_value(geometry),
            eng.occupy_timeout_property.update_value(cap),
            eng.window_geometry_property.epoch,
            eng.occupy_timeout_property.epoch))

    assert push({"intervalMs": 1000, "sampleCount": 2}, 300) == \
        (True, True, 1, 1)
    assert twin.geometry() == (1000, 2, 300)
    assert push({"intervalMs": 1000, "sampleCount": 2}, 300) == \
        (False, False, 1, 1)
    run_stream(twin, ops)
    check_readers(twin)


def test_sample_count_from_the_environment(monkeypatch, twins):
    """tests/test_flow.py:246: the upper-snake environment form."""
    monkeypatch.setenv("CSP_SENTINEL_STATISTIC_SAMPLE_COUNT", "4")
    twin = twins({})
    assert twin.geometry() == (1000, 4, 500)


def test_occupy_timeout_runtime_tunable(twins):
    """tests/test_occupy.py:171-195 on both engines."""
    twin = twins({})
    twin.load(flow=[dict(resource="occ", count=10)])
    for _ in range(10):
        assert twin.both(lambda st, eng, clock: pair_verdict(
            st, eng, clock, "occ")) == "pass"
    twin.advance(700)  # the next bucket is 300 ms away

    def prioritized(st, eng, clock):
        return pair_verdict(st, eng, clock, "occ", prioritized=True)

    twin.both(lambda st, eng, clock: eng.set_occupy_timeout(100))
    assert twin.both(prioritized) == "FlowException"
    twin.both(lambda st, eng, clock: eng.set_occupy_timeout(500))
    assert twin.both(prioritized) == "pass"

    def refused(st, eng, clock):
        out = []
        for bad in (-1, eng._spec1.interval_ms + 1):
            with pytest.raises(ValueError):
                eng.set_occupy_timeout(bad)
            out.append(eng._occupy_timeout_ms)
        return out

    assert twin.both(refused) == [500, 500]
    assert twin.both(lambda st, eng, clock: (
        eng.occupy_timeout_property.update_value(250),
        eng._occupy_timeout_ms)) == (True, 250)
    twin.check_state()


def test_reset_slot_floor_matches_the_reference(twins):
    """tests/test_param_flow.py:202 on both engines, with a burst of two
    param rules where the reference has four (each slot makes the JAX
    step's compile longer): the ratchet holds the wide param shape after
    the burst; ``reset_slot_floor`` returns the old floor and the next
    dispatch compiles the narrow one."""
    twin = twins({})

    def entry_hot(st, eng, clock):
        return pair_verdict(st, eng, clock, "hot", args=("k",))

    twin.load(param=[dict(resource="hot", param_idx=0, count=2,
                          duration_in_sec=i + 1) for i in range(2)])
    twin.both(entry_hot)
    twin.load(param=[dict(resource="hot", param_idx=0, count=2)])
    twin.both(entry_hot)
    assert twin.both(lambda st, eng, clock: eng._slot_floor["param"]) == 2
    old = twin.both(lambda st, eng, clock: eng.reset_slot_floor())
    assert old["param"] == 2
    twin.both(entry_hot)
    assert twin.both(lambda st, eng, clock: (
        eng._slot_floor["param"],
        tuple(eng._rules.param.rules_by_row.shape))) == (1, (CAPACITY, 1))
    verdicts = [twin.both(entry_hot) for _ in range(6)]
    assert "ParamFlowException" in verdicts
    twin.check_state()


def test_property_push_racing_the_committer_does_not_deadlock():
    """A datasource thread pushing geometry while callers' leased entries
    keep the stats committer flushing: every thread finishes."""
    ptu.freeze_time(NOW0)
    pctx.replace_context(None)
    eng = pst.SentinelEngine(CAPACITY, device="cpu")
    try:
        eng.flow_rules.load_rules([pst.FlowRule(resource="lz", count=1e9)])
        assert "lz" in eng._leases
        stop = threading.Event()
        errors = []

        def caller():
            try:
                while not stop.is_set():
                    with eng.entry("lz"):
                        pass
                    time.sleep(0.0005)  # keep each flush narrow on the CPU
            except Exception as ex:  # noqa: BLE001 — reported below
                errors.append(ex)
            finally:
                pctx.replace_context(None)

        def pusher():
            try:
                for i in range(20):
                    eng.window_geometry_property.update_value(
                        {"intervalMs": 1000 * (1 + i % 2),
                         "sampleCount": 2 * (1 + i % 2)})
                    eng.occupy_timeout_property.update_value(100 + i % 3)
            except Exception as ex:  # noqa: BLE001
                errors.append(ex)

        callers = [threading.Thread(target=caller, daemon=True)
                   for _ in range(3)]
        push = threading.Thread(target=pusher, daemon=True)
        for t in callers:
            t.start()
        push.start()
        push.join(timeout=60)
        stop.set()
        for t in callers:
            t.join(timeout=30)
        assert not push.is_alive() and not any(t.is_alive() for t in callers)
        assert not errors, errors
        assert eng.window_geometry_property.epoch == 20
        assert (eng._spec1.interval_ms, eng._spec1.buckets) == (2000, 4)
        assert eng.committer is not None and eng.committer.failures == 0
    finally:
        eng.close()
        ptu.unfreeze_time()


# ---------------------------------------------------------------------------
# the properties-file layer (ROADMAP C23)
# ---------------------------------------------------------------------------

FILE_KEYS = (INTERVAL, SAMPLES, OCCUPY, "project.name",
             "csp.sentinel.charset", "csp.sentinel.statistic.max.rt",
             "csp.sentinel.flow.cold.factor", "csp.sentinel.api.port",
             "csp.sentinel.metric.file.single.size",
             "csp.sentinel.heartbeat.interval.ms", "no.such.key")


def test_properties_file_seeds_both_packages(monkeypatch, tmp_path):
    """C23: the file named by ``CSP_SENTINEL_CONFIG_FILE`` sits between
    ``set`` and the defaults on both packages: the same ``config.get``
    values, accessors and seeded ``_spec1``; an environment variable still
    overrides the file."""
    path = tmp_path / "sentinel.properties"
    path.write_text("# a comment\n! another\n\n"
                    f"{INTERVAL}=2000\n"
                    f"{SAMPLES}: 4\n"
                    "project.name = from-file\n"
                    "csp.sentinel.charset=GBK\n"
                    "csp.sentinel.statistic.max.rt=3000\n")
    monkeypatch.setenv("CSP_SENTINEL_CONFIG_FILE", str(path))
    try:
        for cfg in (jconfig, pconfig):
            cfg.reset_for_tests()
        got = [pconfig.get(k) for k in FILE_KEYS]
        assert got == [jconfig.get(k) for k in FILE_KEYS]
        assert got[:2] == ["2000", "4"] and got[3] == "from-file"
        assert pconfig.charset() == jconfig.charset() == "GBK"
        assert pconfig.statistic_max_rt() == jconfig.statistic_max_rt() \
            == 3000
        assert pconfig.app_name() == jconfig.app_name() == "from-file"
        twin = Twin(monkeypatch, {})
        try:
            assert twin.geometry()[:2] == (2000, 4)
        finally:
            twin.close()

        # The environment overrides the file, on both.
        monkeypatch.setenv("CSP_SENTINEL_STATISTIC_SAMPLE_COUNT", "5")
        for cfg in (jconfig, pconfig):
            cfg.reset_for_tests()
        assert pconfig.get(SAMPLES) == jconfig.get(SAMPLES) == "5"
        twin = Twin(monkeypatch, {})
        try:
            assert twin.geometry()[:2] == (2000, 5)
        finally:
            twin.close()
    finally:
        monkeypatch.delenv("CSP_SENTINEL_CONFIG_FILE")
        monkeypatch.delenv("CSP_SENTINEL_STATISTIC_SAMPLE_COUNT",
                           raising=False)
        for cfg in (jconfig, pconfig):
            cfg.reset_for_tests()


def test_config_defaults_and_record_log_info_match_the_reference(
        monkeypatch, tmp_path):
    """The accessors the port lacked (``charset``, ``statistic_max_rt``)
    read the reference's defaults with no file, and ``RecordLog.info``
    writes the reference's line."""
    monkeypatch.setenv("CSP_SENTINEL_CONFIG_FILE", str(tmp_path / "absent"))
    try:
        for cfg in (jconfig, pconfig):
            cfg.reset_for_tests()
        assert [pconfig.get(k) for k in FILE_KEYS] == \
            [jconfig.get(k) for k in FILE_KEYS]
        assert pconfig.charset() == jconfig.charset() == "utf-8"
        assert pconfig.statistic_max_rt() == jconfig.statistic_max_rt() \
            == 4900
    finally:
        monkeypatch.delenv("CSP_SENTINEL_CONFIG_FILE")
        for cfg in (jconfig, pconfig):
            cfg.reset_for_tests()
    lines = {"jax": [], "port": []}
    for name, log in (("jax", jlog), ("port", plog)):
        monkeypatch.setattr(log, "write_line",
                            lambda line, _n=name: lines[_n].append(line))
        log.info("loaded %s rules from %s", 3, "file")
    assert [ln.split(" ", 2)[2] for ln in lines["port"]] == \
        [ln.split(" ", 2)[2] for ln in lines["jax"]] == \
        ["INFO loaded 3 rules from file"]
