"""The port's cluster token stack against the JAX package's, on the CPU:
the TLV codec, the rule compiler, the acquire step (the plain form of
the serial admission scan) and ``DefaultTokenService``.

Every comparison is exact: statuses, ``remaining`` / ``wait_ms``, the
window state (int32 counts, int64 starts and bucket lengths) and the
wire bytes are equal, and the scan's float32 ``passed`` is bit-equal:
the plain form rounds as XLA's CPU backend compiles the reference (one
fused multiply-add in the admission test, two roundings in
``remaining``; ``test_acquire_rounding_follows_the_reference`` pins
both). The JAX step runs jitted, as the reference's service runs it.

Both packages' clocks are frozen at the same instant where a service
reads the clock itself (``metrics_snapshot``).
"""

from __future__ import annotations

import json
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sentinel_tpu.cluster import codec as jcodec
from sentinel_tpu.cluster import constants as JCC
from sentinel_tpu.cluster import rules as JR
from sentinel_tpu.cluster import token_service as JT
from sentinel_tpu.models.flow import FlowRule as JFlowRule
from sentinel_tpu.ops import window as JW
from sentinel_tpu.utils import time_util as jtu

from sentinel_tpu_torch import convert
from sentinel_tpu_torch.cluster import codec as pcodec
from sentinel_tpu_torch.cluster import rules as PR
from sentinel_tpu_torch.cluster import token_service as PT
from sentinel_tpu_torch.models.flow import FlowRule as PFlowRule
from sentinel_tpu_torch.ops import cluster_acquire as CA
from sentinel_tpu_torch.utils import time_util as ptu
from sentinel_tpu_torch.utils.fp import fma32

from tests.test_torch_support import assert_tree_equal, jax_to_np

NOW0 = 1_700_000_000_000
FIXTURES = json.loads(
    (Path(__file__).parent / "fixtures" / "tlv" / "fixtures.json")
    .read_text())["fixtures"]


@pytest.fixture()
def frozen_clocks():
    """Both packages' clocks pinned at one instant."""
    for tu in (jtu, ptu):
        tu.freeze_time(NOW0)
    yield
    for tu in (jtu, ptu):
        tu.unfreeze_time()


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


def _encode(codec, f: dict) -> bytes:
    if f["direction"] == "request":
        if f["msg_type"] == codec.MSG_PING:
            entity = codec.encode_ping(f["namespace"])
        elif f["msg_type"] == codec.MSG_FLOW:
            entity = codec.encode_flow_request(
                f["flow_id"], f["count"], f["prioritized"])
        elif f["msg_type"] == codec.MSG_ENTRY:
            entity = codec.encode_entry_request(
                f["resource"], f["origin"], f["count"], f["entry_type"],
                f["prioritized"], f["params"])
        elif f["msg_type"] == codec.MSG_EXIT:
            entity = codec.encode_exit_request(
                f["entry_id"], f["error"], f["count"])
        else:
            entity = codec.encode_param_flow_request(
                f["flow_id"], f["count"], f["params"])
        return codec.encode_request(f["xid"], f["msg_type"], entity)
    entity = b""
    if f["msg_type"] == 1:
        entity = codec.encode_flow_response(f["remaining"], f["wait_ms"])
    elif f["msg_type"] == codec.MSG_ENTRY:
        entity = codec.encode_entry_response(f["entry_id"], f["reason"])
    return codec.encode_response(f["xid"], f["msg_type"], f["status"], entity)


@pytest.mark.parametrize("f", FIXTURES, ids=lambda f: f["name"])
def test_codec_encodes_golden_bytes(f):
    assert _encode(pcodec, f).hex() == f["hex"]
    assert _encode(pcodec, f) == _encode(jcodec, f)


@pytest.mark.parametrize("f", FIXTURES, ids=lambda f: f["name"])
def test_codec_decodes_golden_bytes(f):
    raw = bytes.fromhex(f["hex"])
    (body,) = pcodec.FrameReader().feed(raw)
    if f["direction"] == "request":
        req = pcodec.decode_request(body)
        assert (req.xid, req.msg_type) == (f["xid"], f["msg_type"])
        if f["msg_type"] == 0:
            assert pcodec.decode_ping(req.entity) == f["namespace"]
        elif f["msg_type"] == 1:
            assert pcodec.decode_flow_request(req.entity) == (
                f["flow_id"], f["count"], f["prioritized"])
        elif f["msg_type"] == pcodec.MSG_ENTRY:
            assert pcodec.decode_entry_request(req.entity) == (
                f["resource"], f["origin"], f["count"], f["entry_type"],
                f["prioritized"], f["params"])
        elif f["msg_type"] == pcodec.MSG_EXIT:
            assert pcodec.decode_exit_request(req.entity) == (
                f["entry_id"], f["error"], f["count"])
        else:
            assert pcodec.decode_param_flow_request(req.entity) == (
                f["flow_id"], f["count"], f["params"])
    else:
        resp = pcodec.decode_response(body)
        assert (resp.xid, resp.msg_type, resp.status) == (
            f["xid"], f["msg_type"], f["status"])
        if f["msg_type"] == 1:
            assert pcodec.decode_flow_response(resp.entity) == (
                f["remaining"], f["wait_ms"])
        elif f["msg_type"] == pcodec.MSG_ENTRY:
            assert pcodec.decode_entry_response(resp.entity) == (
                f["entry_id"], f["reason"])


@pytest.mark.parametrize("step", [1, 2, 7, 64, None])
def test_frame_reader_and_scanner_on_partial_and_coalesced_streams(step):
    """Every fixture concatenated, fed in fragments of ``step`` bytes (None:
    one coalesced chunk): ``FrameReader`` and the zero-copy
    ``FrameScanner`` recover every frame, as the JAX package's do."""
    stream = b"".join(bytes.fromhex(f["hex"]) for f in FIXTURES)
    step = step or len(stream)
    want = [bytes.fromhex(f["hex"])[2:] for f in FIXTURES]
    for cls in ("FrameReader", "FrameScanner"):
        port, ref = getattr(pcodec, cls)(), getattr(jcodec, cls)()
        got_p, got_j = [], []
        for i in range(0, len(stream), step):
            chunk = stream[i:i + step]
            got_p.extend(bytes(b) for b in port.feed(chunk))
            got_j.extend(bytes(b) for b in ref.feed(chunk))
        assert got_p == want == got_j, cls


def test_trailing_tlvs_and_extension_entities_match_the_reference():
    """The trace, epoch and map-version TLVs, the span info, and the
    fleet / stream / JSON entities: the same bytes and the same decodes."""
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    for c in (pcodec, jcodec):
        assert c.read_trace_tlv(
            c.append_trace_tlv(c.encode_flow_request(3, 1, False), tp),
            c.FLOW_REQ_SIZE) == tp
    base = pcodec.encode_flow_response(7, 0)
    for epoch in (0, 1, 2**40):
        raw = pcodec.encode_epoch_value(epoch)
        assert raw == jcodec.encode_epoch_value(epoch)
        ent = pcodec.append_epoch_tlv(
            pcodec.append_trace_tlv(base, pcodec.encode_span_info(
                "ef" * 8, NOW0, 1234)), raw)
        assert ent == jcodec.append_epoch_tlv(jcodec.append_trace_tlv(
            base, jcodec.encode_span_info("ef" * 8, NOW0, 1234)), raw)
        assert pcodec.read_epoch_tlv(ent, pcodec.FLOW_RESP_SIZE) == epoch
        assert pcodec.decode_span_info(pcodec.read_trace_tlv(
            ent, pcodec.FLOW_RESP_SIZE)) == ("ef" * 8, NOW0, 1234)
    assert (pcodec.append_map_version_tlv(base, 9)
            == jcodec.append_map_version_tlv(base, 9))
    assert pcodec.read_map_version_tlv(
        pcodec.append_map_version_tlv(base, 9), pcodec.FLOW_RESP_SIZE) == 9
    assert pcodec.read_epoch_tlv(base + b"\x45\x00", 8) is None  # garbled
    params = [1, -2**40, "k", "ünï", True, 2.5, "x" * 300]
    assert (pcodec.encode_param_flow_request(5, 2, params)
            == jcodec.encode_param_flow_request(5, 2, params))
    assert pcodec.decode_param_flow_request(
        pcodec.encode_param_flow_request(5, 2, params)) == (5, 2, params)
    long_name = "é" * 200  # truncated on a character boundary
    assert (pcodec.encode_entry_request(long_name, "o", 1, 0, True, params)
            == jcodec.encode_entry_request(long_name, "o", 1, 0, True, params))
    for op in range(4):
        assert (pcodec.encode_stream_request(op, "s1", "m", 17)
                == jcodec.encode_stream_request(op, "s1", "m", 17))
    assert pcodec.encode_fleet_request(NOW0, -1) == jcodec.encode_fleet_request(
        NOW0, -1)
    doc = {"b": [1, 2], "a": "x"}
    assert pcodec.encode_json_entity(doc) == jcodec.encode_json_entity(doc)
    assert pcodec.decode_json_entity(pcodec.encode_json_entity(doc))[0] == doc


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def _rules(cls, spec, start_id=100):
    """spec: (count, thresholdType, windowIntervalMs, sampleCount) each."""
    return [cls(resource=f"r{i}", count=c, cluster_mode=True,
                cluster_config={"flowId": start_id + i, "thresholdType": tt,
                                "windowIntervalMs": iv, "sampleCount": sc})
            for i, (c, tt, iv, sc) in enumerate(spec)]


RULE_SPEC = [
    (5.0, JCC.THRESHOLD_GLOBAL, 1000, 10),
    (3.0, JCC.THRESHOLD_AVG_LOCAL, 1000, 7),       # indivisible: 143 ms
    (2.5714285373687744, JCC.THRESHOLD_GLOBAL, 7000, 10),
    (4.285714149475098, JCC.THRESHOLD_AVG_LOCAL, 700, 5),
    (0.0, JCC.THRESHOLD_GLOBAL, 2000, 2),
    (40.0, JCC.THRESHOLD_GLOBAL, 500, 10),
]


def test_rules_compile_like_the_reference():
    jm, pm = JR.ClusterFlowRuleManager(), PR.ClusterFlowRuleManager()
    for m, cls in ((jm, JFlowRule), (pm, PFlowRule)):
        m.load_rules("ns-a", _rules(cls, RULE_SPEC[:4]))
        m.load_rules("ns-b", _rules(cls, RULE_SPEC[4:], start_id=200)
                     + [cls(resource="bad", count=1, cluster_mode=True,
                            cluster_config={"flowId": "nope"}),
                        cls(resource="local", count=1)])
    jrt, jst, jslot, jns = jm.compile()
    prt, pst_, pslot, pns = pm.compile("cpu")
    assert (jslot, jns) == (pslot, pns)
    assert jm.thresholds() == pm.thresholds()
    assert jm.namespace_ids() == pm.namespace_ids()
    assert pm.rule_by_flow_id("101").count == jm.rule_by_flow_id(101).count
    assert_tree_equal(jax_to_np(jrt), convert.state_to_numpy(prt))
    assert_tree_equal(jax_to_np(jst), convert.state_to_numpy(pst_))


# ---------------------------------------------------------------------------
# The acquire step: plain scan vs the JAX lax.scan
# ---------------------------------------------------------------------------

_JIT = jax.jit(JT.acquire_step, static_argnames=("max_occupy_ratio",))


def _jax_case(spec, pre):
    """A JAX rule set and a rotated window with ``pre`` = {slot: (PASS,
    WAITING)} already committed at NOW0."""
    m = JR.ClusterFlowRuleManager()
    m.load_rules("default", _rules(JFlowRule, spec))
    rt, st, _, _ = m.compile()
    now = jnp.asarray(NOW0, jnp.int64)
    win = JW.row_rotate(st.win, now)
    for slot, (p, w) in pre.items():
        for ch, v in ((JCC.ClusterFlowEvent.PASS, p),
                      (JCC.ClusterFlowEvent.WAITING, w)):
            win = JW.row_window_add(
                win, now, jnp.asarray([slot], jnp.int32),
                jnp.asarray([int(ch)], jnp.int32),
                jnp.asarray([v], jnp.int32))
    return rt, JR.ClusterMetricState(win=win)


def _both_steps(rt, st, conns, slots, counts, prio, now, ratio):
    jst, js, je = _JIT(st, rt, jnp.asarray(conns, jnp.int32),
                       jnp.asarray(slots, jnp.int32),
                       jnp.asarray(counts, jnp.int32), jnp.asarray(prio),
                       jnp.asarray(now, jnp.int64), max_occupy_ratio=ratio)
    prt, pst_ = convert.cluster_from_numpy(jax_to_np(rt), jax_to_np(st),
                                           "cpu")
    pst2, ps, pe = PT.acquire_step(
        pst_, prt, torch.as_tensor(conns, dtype=torch.int32),
        torch.as_tensor(slots, dtype=torch.int32),
        torch.as_tensor(counts, dtype=torch.int32),
        torch.as_tensor(prio), now, max_occupy_ratio=ratio)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    assert_tree_equal(jax_to_np(jst), convert.state_to_numpy(pst2))
    return np.asarray(js), np.asarray(je)


@pytest.mark.parametrize("width", [1, 8, 64, 256])
def test_plain_acquire_matches_the_jax_scan(width):
    """Seeded lanes over six rules (GLOBAL and AVG_LOCAL with 3 clients,
    an indivisible interval, fractional thresholds) plus unknown (-1) and
    out-of-range (>= num_slots) slots, prioritized lanes and an occupy
    ratio below 1: every status appears at the larger widths."""
    rng = np.random.default_rng(width)
    rt, st = _jax_case(RULE_SPEC, {0: (3, 0), 1: (2, 1), 2: (11, 0),
                                   3: (1, 0), 5: (30, 6)})
    num_slots = int(rt.threshold.shape[0])
    pool = [0, 1, 2, 3, 4, 5, -1, num_slots, num_slots + 3]
    slots = rng.choice(pool, size=width,
                       p=[.16, .16, .12, .12, .08, .2, .06, .05, .05])
    counts = rng.integers(0, 4, size=width)
    prio = rng.random(width) < 0.4
    status, _ = _both_steps(rt, st, [3], slots, counts, prio,
                            NOW0 + int(rng.integers(0, 60)), 0.7)
    if width >= 64:
        assert set(status.tolist()) >= {0, 1, 2, 3}


def test_acquire_rounding_follows_the_reference():
    """Trouble spot: which float32 roundings the reference compiles to.

    * Admission ``(base + used) * scale + cnt <= thr`` is one fused
      multiply-add: base 11 at a 7000 ms interval gives 2.5714285 fused
      and 2.5714288 rounded twice; a threshold of exactly 2.5714285
      admits.
    * ``remaining = thr - passed - cnt`` rounds twice (no fused
      multiply-add): 4.285714149475098 x 5 clients minus passed 1/0.7
      lands at 19.999998, so 19 (18 for a count of 1), not 20.
    * ``1000 / interval`` divides once: 1/7 rounds to 0.14285715, where
      torch's reflected ``1000.0 / t`` (a reciprocal, then a product)
      gives 0.14285713."""
    rt, st = _jax_case(RULE_SPEC, {2: (11, 0), 3: (1, 0)})
    status, extra = _both_steps(rt, st, [5], [2, 3, 3], [1, 0, 1],
                                [False] * 3, NOW0, 1.0)
    assert status.tolist() == [0, 0, 0]
    assert extra.tolist()[1:] == [19, 18]
    t = torch.tensor([7000.0])
    assert (torch.full_like(t, 1000.0) / t).item() == np.float32(1 / 7)
    assert (1000.0 / t).item() != np.float32(1 / 7)


def test_fma32_rounds_once():
    """The plain form's fused multiply-add against exact rationals."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4000) * 3).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (rng.integers(0, 4, 4000)).astype(np.float32)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c)).numpy()
    for i in range(0, 4000, 7):
        x = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        f = np.float32(float(x))
        cands = [np.nextafter(f, np.float32(-np.inf)), f,
                 np.nextafter(f, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best


def test_plain_scan_longest_run_and_out_of_table_lanes():
    """One slot's run of 300 lanes (the dependent chain) beside lanes
    outside the table: the run admits exactly up to its threshold and
    every out-of-table lane is judged alone."""
    n = 300
    slots = torch.zeros(n, dtype=torch.int32)
    slots[::10] = 9  # >= num_slots: known, no table
    slots[5::10] = -1
    counts = torch.ones(n)
    thr = torch.full((n,), 100.0)
    ok, cw, passed = CA.acquire_scan_plain(
        slots, counts, torch.zeros(n), thr, torch.ones(n), slots >= 0,
        torch.zeros(n, dtype=torch.bool), torch.zeros(n), 8, 1.0)
    run = slots == 0
    assert int(ok[run].sum()) == 100
    assert bool(ok[slots == 9].all()) and not bool(ok[slots == -1].any())
    assert float(passed[run][-1]) == 100.0
    assert not bool(cw.any())


# ---------------------------------------------------------------------------
# DefaultTokenService on both packages
# ---------------------------------------------------------------------------


class Services:
    """A JAX and a port ``DefaultTokenService`` fed the same calls."""

    def __init__(self, spec, conns=1, ratio=1.0, max_qps=None):
        kw = {} if max_qps is None else {"max_allowed_qps": max_qps}
        self.j = JT.DefaultTokenService(max_occupy_ratio=ratio, **kw)
        self.p = PT.DefaultTokenService(max_occupy_ratio=ratio,
                                        device="cpu", **kw)
        self.load(spec)
        for _ in range(conns):
            for s in (self.j, self.p):
                s.connections.connect("default")

    def load(self, spec, ns="default", start_id=100):
        self.j.rules.load_rules(ns, _rules(JFlowRule, spec, start_id))
        self.p.rules.load_rules(ns, _rules(PFlowRule, spec, start_id))

    def tokens(self, reqs, now):
        want = self.j.request_tokens(reqs, now_ms=now)
        got = self.p.request_tokens(reqs, now_ms=now)
        assert got == want
        assert_tree_equal(jax_to_np(self.j._state),
                          convert.state_to_numpy(self.p._state))
        return got

    def param(self, flow_id, count, params, now):
        want = self.j.request_param_token(flow_id, count, params, now_ms=now)
        got = self.p.request_param_token(flow_id, count, params, now_ms=now)
        assert got == want
        return got


@pytest.mark.parametrize("seed", [5, 17, 41])
def test_service_matches_the_reference_on_the_fuzz_seeds(seed):
    """``tests/test_token_service_fuzz.py``'s stream: 16 rules (GLOBAL and
    AVG_LOCAL, intervals 500 / 1000 / 2000 ms), 40 batches of width 32
    (unknown-id padding), random advances across bucket and window
    boundaries."""
    rng = np.random.default_rng(seed)
    spec = []
    for _ in range(16):
        thr = float(rng.integers(0, 20))
        interval = int(rng.choice([500, 1000, 2000]))
        ttype = int(rng.choice([JCC.THRESHOLD_GLOBAL, JCC.THRESHOLD_AVG_LOCAL]))
        spec.append((thr, ttype, interval, JCC.DEFAULT_SAMPLE_COUNT))
    svc = Services(spec, conns=int(rng.integers(1, 4)))
    now = NOW0
    statuses = set()
    for _ in range(40):
        now += int(rng.integers(0, 300))
        n = int(rng.integers(4, 33))
        batch = [(100 + int(rng.integers(0, 16)), int(rng.integers(1, 4)),
                  bool(rng.random() < 0.25)) for _ in range(n)]
        batch += [(999, 1, False)] * (32 - n)
        statuses |= {int(r.status) for r in svc.tokens(batch, now)}
    assert statuses >= {0, 1, 2, 3}


def test_service_rule_push_carry_geometry_strings_and_params(frozen_clocks):
    """A rule push mid-stream keeps surviving flows' windows unless their
    bucket geometry changed; string flowIds share the int key space;
    param tokens with duplicate values; the namespace limiter; and
    ``metrics_snapshot`` on frozen clocks."""
    svc = Services(RULE_SPEC[:4], conns=2, ratio=0.5, max_qps=40)
    now = NOW0
    reqs = [(100, 2, False), ("101", 1, True), (102, 1, False),
            (103, 1, True), ("x", 1, False), (None, 0, False)] * 4
    svc.tokens(reqs, now)
    svc.tokens(reqs[:8], now + 40)
    # Push: flow 100 keeps its geometry (carried), 101 moves to a 2000 ms
    # interval (dropped cold), 102 disappears, 105 is new.
    spec2 = [RULE_SPEC[0], (3.0, JCC.THRESHOLD_AVG_LOCAL, 2000, 7),
             (9.0, JCC.THRESHOLD_GLOBAL, 1000, 10), RULE_SPEC[3],
             (1.0, JCC.THRESHOLD_GLOBAL, 1000, 10),
             (2.0, JCC.THRESHOLD_GLOBAL, 1000, 10)]
    svc.load(spec2)
    res = svc.tokens(reqs + [(105, 1, False)] * 3, now + 80)
    assert any(r.status == JCC.TokenResultStatus.TOO_MANY_REQUEST
               for r in res)
    for k in range(3):
        svc.tokens(reqs, now + 1000 * (k + 1) + 7)
    assert svc.p.metrics_snapshot() == svc.j.metrics_snapshot()
    for params, count in (([1, 1, 2], 1), (["a", "a"], 2), ([True, 1], 1),
                          ([2.5, "2.5"], 3), ([7] * 5, 1)):
        for fid in (100, "101", 104, 999, "zz"):
            svc.param(fid, count, params, now + 3500)
    for fid in (100, 103):
        for _ in range(4):
            svc.param(fid, 2, ["hot", "hot"], now + 3600)


def test_service_spans_and_population_feed():
    """Traced requests get a server span in the result and the service's
    ring; the population tracker sees every owned flow's offered load."""
    from sentinel_tpu_torch.telemetry.spans import new_trace_context

    class Pop:
        def __init__(self):
            self.rows = []

        def observe_flows(self, rows):
            self.rows.extend(rows)

    svc = PT.DefaultTokenService(device="cpu")
    svc.rules.load_rules("default", _rules(PFlowRule, RULE_SPEC[:2]))
    svc.population = Pop()
    ctx = new_trace_context()
    res = svc.request_tokens([(100, 1, False, ctx), (101, 2, False)],
                             now_ms=NOW0)
    assert res[0].server_span is not None and res[1].server_span is None
    (span,) = svc.spans.snapshot()["spans"]
    assert span["parentSpanId"] == ctx.span_id
    assert span["name"] == "cluster.token_service"
    assert svc.population.rows == [("default", 100, 1), ("default", 101, 2)]


def test_failed_launch_or_readback_drops_the_state_cold(monkeypatch):
    """A failed step raises (no retry on another form) and drops the
    window state; the next batch recompiles from the rules."""
    svc = PT.DefaultTokenService(device="cpu")
    svc.rules.load_rules("default", _rules(PFlowRule, RULE_SPEC[:1]))
    assert svc.request_token(100, 1, now_ms=NOW0).status == 0

    def boom(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(PT, "acquire_scan", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        svc.request_token(100, 1, now_ms=NOW0)
    assert svc._state is None and svc._compiled_version == -1
    monkeypatch.undo()
    r = svc.request_token(100, 1, now_ms=NOW0)
    assert (r.status, r.remaining) == (0, 4)  # cold: the earlier pass is gone

    class BadEvent:
        def synchronize(self):
            raise RuntimeError("readback failed")

    ticket = svc.dispatch_tokens([(100, 1, False)], now_ms=NOW0)
    with pytest.raises(RuntimeError, match="readback failed"):
        svc.harvest_tokens(ticket._replace(event=BadEvent()))
    assert svc._state is None and svc._compiled_version == -1


def test_service_runs_on_cuda_by_default():
    """No device given: ``cuda``, and a loud error without a card."""
    if torch.cuda.is_available():
        assert PT.DefaultTokenService().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PT.DefaultTokenService()


def test_wrapper_takes_the_plain_form_only_for_cpu_tensors(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel wrapper called for CPU tensors")

    monkeypatch.setattr(CA, "acquire_scan_cuda", boom)
    n = 4
    ok, _, _ = CA.acquire_scan(
        torch.zeros(n, dtype=torch.int32), torch.ones(n), torch.zeros(n),
        torch.full((n,), 2.0), torch.ones(n), torch.ones(n, dtype=torch.bool),
        torch.zeros(n, dtype=torch.bool), torch.zeros(n), 8, 1.0)
    assert ok.tolist() == [True, True, False, False]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        CA.acquire_scan_cuda(
            torch.zeros(n, dtype=torch.int32), torch.ones(n), torch.zeros(n),
            torch.full((n,), 2.0), torch.ones(n),
            torch.ones(n, dtype=torch.bool),
            torch.zeros(n, dtype=torch.bool), torch.zeros(n), 8, 1.0)

