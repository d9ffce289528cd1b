"""The port's decision traces (``sentinel_tpu_torch/telemetry/
trace_ring.py``) against the JAX package's ``DecisionTraceBuffer``.

One JAX engine and one port engine (``device="cpu"``) for the module,
through ``tests/test_torch_api.py``'s harness. Each test gives both
engines a fresh trace buffer, drives the same blocked entries through
``check_batch`` at width 8, drains, and holds ``snapshot()`` equal: every
trace field (resource, origin, reason, rule slot, reason code, count,
window) and the counters, page by page. The cases follow
``tests/test_telemetry.py``'s trace ring tests; the hand-off queue's
drop and the stop semantics are checked on the port alone.
"""

from __future__ import annotations

import numpy as np
import pytest

from sentinel_tpu.core import constants as JC
from sentinel_tpu.telemetry.trace_ring import \
    DecisionTraceBuffer as JDecisionTraceBuffer

from sentinel_tpu_torch.core.batch import make_entry_batch_np
from sentinel_tpu_torch.telemetry import attribution as AT
from sentinel_tpu_torch.telemetry.trace_ring import DecisionTraceBuffer
from sentinel_tpu_torch.utils import time_util as ptu

from tests.test_torch_api import Pair
from tests.test_torch_support import jax_entry

WIDTH = 8


@pytest.fixture(scope="module")
def engines():
    pr = Pair()
    pr.open()
    yield pr
    pr.close()


@pytest.fixture
def pair(engines, request):
    if engines.broken:
        engines.close()
        engines.open()
    failed = request.session.testsfailed
    engines.start()
    yield engines
    if request.session.testsfailed > failed:
        engines.broken = True


def fresh_traces(pair, sample_every, capacity=256):
    for s, cls in ((pair.j, JDecisionTraceBuffer),
                   (pair.p, DecisionTraceBuffer)):
        s.eng.traces.stop()
        s.eng.traces = cls(s.eng, sample_every=sample_every,
                           capacity=capacity)


def check(pair, lanes, sides=None, drain=True):
    """One check_batch of ``[(resource, origin)]`` lanes (padded to
    WIDTH) on both engines (or ``sides``), then a drain of their trace
    buffers."""
    now = ptu.current_time_millis()
    for s in sides or pair.sides:
        reg = s.eng.registry
        parent = reg.entrance_row("ctx")
        buf = make_entry_batch_np(WIDTH)
        for i, (res, origin) in enumerate(lanes):
            cr, dn, orow, oid = reg.resolve_entry(
                res, "ctx", origin, parent, int(JC.EntryType.OUT))
            buf["cluster_row"][i] = cr
            buf["dn_row"][i] = dn
            buf["origin_row"][i] = orow
            buf["origin_id"][i] = oid
            buf["context_id"][i] = reg.context_id("ctx")
            buf["count"][i] = 1
        s.eng.check_batch(jax_entry(buf) if s.name == "jax" else buf,
                          now_ms=now)
        if drain:
            s.eng.traces.drain()


def snapshots(pair, **kw):
    j = pair.j.eng.traces.snapshot(**kw)
    p = pair.p.eng.traces.snapshot(**kw)
    assert p == j
    return p


def test_records_blocked_entries(pair):
    fresh_traces(pair, sample_every=1)
    pair.rules(flow=[dict(resource="t", count=1)])
    check(pair, [("t", "userA")] * 3)
    snap = snapshots(pair)
    assert snap["seenBlocked"] == 2 and snap["recorded"] == 2
    tr = snap["traces"][0]
    assert tr["resource"] == "t" and tr["reason"] == "FLOW"
    assert tr["origin"] == "userA" and tr["ruleSlot"] == 0
    assert tr["reasonCode"] == AT.encode_reason_code(
        int(JC.BlockReason.FLOW), 0)
    assert tr["window"] == {"passQps": 1.0, "blockQps": 2.0,
                            "curThreadNum": 1}
    assert AT.decode_reason_code(tr["reasonCode"]) == (
        int(JC.BlockReason.FLOW), 0)


def test_sampling_capacity_and_pages(pair):
    fresh_traces(pair, sample_every=2, capacity=3)
    pair.rules(flow=[dict(resource="t2", count=0)],
               authority=[dict(resource="a2", limit_app="appB")])
    check(pair, [("t2", "")] * 5 + [("a2", "appA")] * 3)
    snap = snapshots(pair)
    assert snap["seenBlocked"] == 8
    assert snap["recorded"] == 4  # every 2nd blocked entry
    assert len(snap["traces"]) == 3  # the ring's capacity
    assert {t["reason"] for t in snap["traces"]} == {"FLOW", "AUTHORITY"}
    assert snapshots(pair, limit=1)["traces"][0] == snap["traces"][0]
    for limit, offset in ((2, 1), (1, 2), (5, 0), (None, 3), (0, 0)):
        page = snapshots(pair, limit=limit, offset=offset)["traces"]
        assert page == snap["traces"][offset:][:limit]


def test_sampling_disabled(pair):
    fresh_traces(pair, sample_every=0)
    pair.rules(flow=[dict(resource="t3", count=0)])
    check(pair, [("t3", "")] * 4)
    snap = snapshots(pair)
    assert snap["traces"] == [] and snap["seenBlocked"] == 0
    assert pair.p.eng.traces._worker is None


def test_full_hand_off_queue_drops_and_counts(pair):
    fresh_traces(pair, sample_every=1)
    pair.rules(flow=[dict(resource="t4", count=0)])
    traces = pair.p.eng.traces
    traces._ensure_worker = lambda: None  # no pump: the queue fills
    for _ in range(10):
        check(pair, [("t4", "")], sides=[pair.p], drain=False)
    assert traces.snapshot(limit=0)["droppedBatches"] == 2
    traces.drain()
    snap = traces.snapshot(limit=0)
    assert snap["seenBlocked"] == 8 and snap["errors"] == 0


def test_submit_after_stop_starts_no_worker(pair):
    fresh_traces(pair, sample_every=1)
    traces = pair.p.eng.traces
    pair.rules(flow=[dict(resource="t5", count=0)])
    traces.stop()
    check(pair, [("t5", "")], sides=[pair.p], drain=False)
    assert traces._worker is None and traces._queue.qsize() == 0
    traces.start()  # re-armed: the next submit spawns the pump
    check(pair, [("t5", "")], sides=[pair.p])
    assert traces._worker is not None
    assert traces.snapshot(limit=0)["seenBlocked"] == 1


def test_reason_codes_and_channels_match_the_reference():
    from sentinel_tpu.telemetry import attribution as JAT

    for reason in [int(r) for r in JC.BlockReason] + [99]:
        assert AT.reason_channel(reason) == JAT.reason_channel(reason)
        for slot in (-1, 0, 1, 7, 254, 255, 1000):
            code = AT.encode_reason_code(reason, slot)
            assert code == JAT.encode_reason_code(reason, slot)
            assert AT.decode_reason_code(code) == JAT.decode_reason_code(code)
    np.testing.assert_array_equal(AT.REASON_CHANNEL_TABLE,
                                  JAT.REASON_CHANNEL_TABLE)
