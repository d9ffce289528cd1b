"""The pod on the CPU: ``sentinel_tpu_torch/parallel/cluster.py`` against
the live JAX reference.

The reference's pod step (``sentinel_tpu/parallel/cluster.py:_pod_entry``
/ ``_pod_exit``) runs as a ``jax.vmap`` with the named axis ``"pod"``
(``tests/test_torch_support.py:jax_pod_steps``); the port's one-process
pod steps the same ``[D, ...]`` tree. Eight shards of capacity 128, every
batch 16 lanes a shard, all inputs from numpy; after every step the
decisions and every state leaf, float leaves included, must be equal bit
for bit. Each scenario of ``tests/test_pod_parallel.py`` also keeps its
own assertions. One rule pack shape serves every scenario, so the
reference compiles its entry and exit once for the module.

Also: the step's pod inputs on one shard (``entry_step``'s ``extra_*``
and ``shadow_extra_*``, at a window geometry whose per-second scale is
not 1), a pod of one shard against a plain ``entry_step``, the pod tree
against shards stepped one by one, the pod-wide candidate of
``tests/test_rollout.py:440``, the global reads of
``tests/test_telemetry.py:490`` and ``tests/test_timeseries.py:404``,
and the pod checkpoints written by either package restored by the other.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sentinel_tpu.core import checkpoint as JCK
from sentinel_tpu.core import constants as JC
from sentinel_tpu.ops import step as JS
from sentinel_tpu.ops import window as JW
from sentinel_tpu.parallel import cluster as JPC
from sentinel_tpu.telemetry import attribution as JAT

from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core import checkpoint as PCK
from sentinel_tpu_torch.core.batch import to_device
from sentinel_tpu_torch.ops import step as PS
from sentinel_tpu_torch.ops import window as PW
from sentinel_tpu_torch.parallel import cluster as PPC

from tests.test_torch_support import (
    NOW0, POD_CAPACITY, JA, JD, JF, JP, JRegistry, JY, PodTwin,
    assert_decisions_equal, assert_tree_equal, every_lane, jax_entry,
    jax_to_np, pod_entry_buf, pod_exit_buf, pod_world, port_np)

D = 8
B = 16
PASS = JC.BlockReason.PASS


def _admitted(reason) -> int:
    return int((reason == PASS).sum())


def _twin(**kw):
    rows, pack, one = pod_world(**kw)
    return rows, PodTwin(pack, one, (D,))


def _sketch_exact(pod):
    """The sketch sums are exact only while every cell holds an integer
    below 2**24: check that they do."""
    cms = pod.param.cms
    assert bool((cms == cms.round()).all())
    assert float(cms.max()) < 2 ** 24


# ---------------------------------------------------------------------------
# tests/test_pod_parallel.py's scenarios, port against the reference
# ---------------------------------------------------------------------------


def test_global_threshold_bounded_overshoot_then_exits():
    """:103 — step 1 within the staleness bound, step 2 stopped pod-wide;
    then every admitted entry exits and the next second refreshes."""
    thr, per = 10, 4
    rows, tw = _twin(thr=thr)
    buf = pod_entry_buf(D, B, every_lane(D, B, rows["shared"], per))
    r1, _ = tw.entry(buf, NOW0)
    assert thr <= _admitted(r1) <= thr + (D - 1) * min(per, thr)
    tw.exit(pod_exit_buf(buf, r1), NOW0 + 3)
    r2, _ = tw.entry(buf, NOW0 + 5)
    assert _admitted(r2) == 0
    tw.exit(pod_exit_buf(buf, r2), NOW0 + 7)
    r3, _ = tw.entry(buf, NOW0 + 1200)
    assert _admitted(r3) >= thr
    assert int(tw.pstate.cur_threads.sum()) == _admitted(r3)


def test_one_shard_exhausts_the_quota():
    """:123 — quota spent on shard 0 alone blocks every shard."""
    thr = 6
    rows, tw = _twin(thr=thr)
    r1, _ = tw.entry(pod_entry_buf(D, B, {i: rows["shared"]
                                          for i in range(thr)}), NOW0)
    assert _admitted(r1) == thr
    r2, _ = tw.entry(pod_entry_buf(D, B, every_lane(D, B, rows["shared"],
                                                    2)), NOW0 + 1)
    assert _admitted(r2) == 0


def test_quota_refreshes_across_rotation():
    """:146 — a full window later the quota is back pod-wide."""
    rows, tw = _twin(thr=8)
    buf = pod_entry_buf(D, B, every_lane(D, B, rows["shared"], 1))
    for now, want in ((NOW0, D), (NOW0 + 10, 0), (NOW0 + 1100, D)):
        r, _ = tw.entry(buf, now)
        assert _admitted(r) == want, now


def test_local_flow_and_param_rules_stay_per_shard():
    """:160 and :310 — a local flow rule and a local param rule admit
    their threshold on every shard: no coupling through the pod."""
    rows, tw = _twin(local_thr=3, param_local_thr=2)
    r, _ = tw.entry(pod_entry_buf(D, B, every_lane(D, B, rows["local"], 5)),
                    NOW0)
    for d in range(D):
        assert _admitted(r.reshape(D, B)[d]) == 3
    r, _ = tw.entry(pod_entry_buf(D, B, every_lane(D, B, rows["plocal"], 4),
                                  param=0xF00D), NOW0 + 1)
    for d in range(D):
        assert _admitted(r.reshape(D, B)[d]) == 2


def test_exit_balances_every_shards_gauge():
    """:175 — each shard's gauge carries its own entries, and returns to
    zero on exit."""
    rows, tw = _twin(thr=1e9)
    buf = pod_entry_buf(D, B, every_lane(D, B, rows["shared"], 3))
    r, _ = tw.entry(buf, NOW0)
    assert _admitted(r) == D * 3
    assert (tw.pstate.cur_threads[:, rows["shared"]] == 3).all()
    tw.exit(pod_exit_buf(buf, r), NOW0 + 5)
    assert (tw.pstate.cur_threads[:, rows["shared"]] == 0).all()


def test_conservation_over_steps():
    """:195 — six steps admit no more than one server plus the one-step
    staleness, and the pod window holds what was admitted."""
    thr, per = 12, 2
    rows, tw = _twin(thr=thr)
    buf = pod_entry_buf(D, B, every_lane(D, B, rows["shared"], per))
    total = 0
    for k in range(6):
        r, _ = tw.entry(buf, NOW0 + k)
        total += _admitted(r)
    assert total <= thr + (D - 1) * min(per, thr)
    w1 = tw.pstate.w1.counts[:, :, JC.MetricEvent.PASS, rows["shared"]]
    assert int(w1.sum()) == total


def test_occupy_borrows_respect_the_pod_next_window():
    """:215 — prioritized borrows lend within the staleness bound, then
    the whole pod stops lending once the borrows are summed."""
    thr, per = 10, 4
    rows, tw = _twin(thr=thr)
    r0, _ = tw.entry(pod_entry_buf(D, B, {i: rows["shared"]
                                          for i in range(thr)}), NOW0)
    assert _admitted(r0) == thr
    pbuf = pod_entry_buf(D, B, every_lane(D, B, rows["shared"], per),
                         prioritized=True)
    r1, w1 = tw.entry(pbuf, NOW0 + 600)
    granted = int(((r1 == PASS) & (w1 > 0)).sum())
    borrows = int(tw.pstate.occupied_next.sum())
    assert granted == borrows
    assert 1 <= granted <= thr + (D - 1) * per
    r2, _ = tw.entry(pbuf, NOW0 + 610)
    assert _admitted(r2) == 0
    assert int(tw.pstate.occupied_next.sum()) == borrows
    # The borrowed bucket lands in a later step.
    tw.entry(pbuf, NOW0 + 1010)


def test_cluster_param_rule_enforces_the_pod_per_value_quota():
    """:276 — one hot value from every shard is limited pod-wide through
    the summed sketch; another value keeps its quota."""
    thr, per = 6, 3
    rows, tw = _twin(param_thr=thr)
    lanes = every_lane(D, B, rows["pshared"], per)
    r1, _ = tw.entry(pod_entry_buf(D, B, lanes, param=0xBEEF), NOW0)
    assert thr <= _admitted(r1) <= thr + (D - 1) * min(per, thr)
    r2, _ = tw.entry(pod_entry_buf(D, B, lanes, param=0xBEEF), NOW0 + 1)
    assert _admitted(r2) == 0
    r3, _ = tw.entry(pod_entry_buf(D, B, lanes, param=0xCAFE), NOW0 + 2)
    assert _admitted(r3) >= thr
    _sketch_exact(tw.pstate)


def test_cluster_param_full_quota_every_window():
    """:392 — the admission sketch hard-resets at each window: a
    sustained value gets its full quota every window."""
    thr = 8
    rows, tw = _twin(param_thr=thr)
    buf = pod_entry_buf(D, B, every_lane(D, B, rows["pshared"], 2),
                        param=0xD00D)
    for w in range(3):
        t = NOW0 + w * 1000
        a1 = _admitted(tw.entry(buf, t)[0])
        a2 = _admitted(tw.entry(buf, t + 1)[0])
        assert a1 >= thr, (w, a1)
        assert a1 + a2 <= thr + (D - 1) * 2, (w, a1, a2)
    _sketch_exact(tw.pstate)


def test_uneven_traffic_across_shards():
    """:330 — real lanes on four shards, the rest padding."""
    thr, per = 5, 4
    rows, tw = _twin(thr=thr)
    live = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3),
            (2, 0), (2, 1), (7, 0), (7, 1), (7, 2)]
    lanes = {d * B + j: rows["shared"] for d, j in live}
    buf = pod_entry_buf(D, B, lanes)
    r1, _ = tw.entry(buf, NOW0)
    assert thr <= _admitted(r1) <= thr + 3 * per
    pad = np.ones(D * B, bool)
    pad[list(lanes)] = False
    assert (r1[pad] == -1).all()
    assert _admitted(tw.entry(buf, NOW0 + 1)[0]) == 0


def test_breaker_is_per_shard():
    """:420 — a shard whose completions cross the threshold opens its own
    breaker; the other shards stay closed (no reduction for degrade)."""
    rows, tw = _twin(brk_count=3)
    per = 4
    buf = pod_entry_buf(D, B, every_lane(D, B, rows["brk"], per))
    r, _ = tw.entry(buf, NOW0)
    assert _admitted(r) == D * per
    fail = np.zeros(D * B, bool)
    fail[:per] = True
    tw.exit(pod_exit_buf(buf, r, error=fail), NOW0 + 10)
    r, _ = tw.entry(buf, NOW0 + 20)
    reasons = r.reshape(D, B)[:, :per]
    assert (reasons[0] == JC.BlockReason.DEGRADE).all()
    assert (reasons[1:] == PASS).all()


def test_random_stream_with_exits():
    """Five entry + exit rounds of seeded traffic over every resource of
    the pack: mixed acquire counts (the fixpoint loop), prioritized lanes,
    param values, padding, bucket and second boundaries."""
    rows, tw = _twin(thr=20, local_thr=4, param_thr=5, param_local_thr=3)
    rng = np.random.default_rng(17)
    names = list(rows)
    now = NOW0 + 321
    seen = set()
    for k in range(5):
        live = rng.random(D * B) < 0.8
        pick = rng.integers(0, len(names), size=D * B)
        buf = pod_entry_buf(D, B, {i: rows[names[pick[i]]]
                                   for i in range(D * B) if live[i]})
        n_live = int(live.sum())
        buf["count"][live] = (rng.integers(1, 4, size=n_live) if k % 2
                              else 1)
        buf["prioritized"][live] = rng.random(n_live) < 0.3
        buf["param_hash"][live, 0] = rng.choice(
            np.array([0xBEEF, 0xCAFE, 7], np.uint32), size=n_live)
        buf["param_present"][live, 0] = True
        r, _ = tw.entry(buf, now)
        seen |= set(r[r > 0].tolist())
        now += int(rng.integers(100, 400))
        err = rng.random(D * B) < 0.3
        tw.exit(pod_exit_buf(buf, r, error=err), now)
        now += int(rng.integers(50, 300))
    assert {JC.BlockReason.FLOW, JC.BlockReason.PARAM_FLOW} <= seen
    _sketch_exact(tw.pstate)


# ---------------------------------------------------------------------------
# The step's pod inputs on one shard
# ---------------------------------------------------------------------------

SPEC_ODD = JW.WindowSpec(1500, 3)  # per-second scale 1000 / 1500, not 1


def _step_world(reg_rows_out):
    reg = JRegistry(POD_CAPACITY)
    names = ("a", "b", "g", "p", "q")
    rows = {n: reg.cluster_row(n) for n in names}
    reg_rows_out.update(rows)
    flow = [JF.FlowRule("a", count=9, cluster_mode=True),
            JF.FlowRule("b", count=4),
            JF.FlowRule("g", count=12, cluster_mode=True,
                        cluster_config={"scope": "global"})]
    param = [JP.ParamFlowRule("p", param_idx=0, count=5, cluster_mode=True),
             JP.ParamFlowRule("q", param_idx=0, count=3)]
    ft, _ = JF.compile_flow_rules(flow, reg, POD_CAPACITY)
    dt, di = JD.compile_degrade_rules([], reg, POD_CAPACITY)
    pt = JP.compile_param_rules(param, reg, POD_CAPACITY)
    pack = JS.RulePack(
        flow=ft, degrade=dt,
        authority=JA.compile_authority_rules([], reg, POD_CAPACITY),
        system=JY.compile_system_rules([]), param=pt)
    state = JS.make_state(POD_CAPACITY, ft.num_rules, NOW0,
                          degrade=JD.make_degrade_state(dt, di),
                          param=JP.make_param_state(pt.num_rules),
                          spec1=SPEC_ODD)
    # The candidate: the same rules, tighter.
    sflow = [JF.FlowRule("a", count=5, cluster_mode=True),
             JF.FlowRule("b", count=2),
             JF.FlowRule("g", count=6, cluster_mode=True)]
    sft, _ = JF.compile_flow_rules(sflow, reg, POD_CAPACITY)
    spt = JP.compile_param_rules(
        [JP.ParamFlowRule("p", param_idx=0, count=3, cluster_mode=True),
         JP.ParamFlowRule("q", param_idx=0, count=3)], reg, POD_CAPACITY)
    shadow_pack = pack._replace(flow=sft, param=spt)
    state = state._replace(shadow=JS.make_shadow_state(
        POD_CAPACITY, shadow_pack, JD.make_degrade_state(dt, di),
        spec1=SPEC_ODD))
    return pack, shadow_pack, state


def test_entry_step_pod_inputs_match_the_reference():
    """JAX ``entry_step`` and the port's, given the same ``extra_pass``,
    ``extra_next``, ``extra_cms``, their global twins and the shadow's,
    at a 1500 ms / 3-bucket window: equal decisions and state, shadow
    included, over six steps of seeded traffic."""
    rows = {}
    jpack, jshadow, jstate = _step_world(rows)
    prules = convert.rules_from_numpy(jax_to_np(jpack), "cpu")
    pshadow = convert.rules_from_numpy(jax_to_np(jshadow), "cpu")
    pstate = convert.state_from_numpy(jax_to_np(jstate), "cpu")
    jstep = jax.jit(JS.entry_step, static_argnames=("spec1",))
    pspec = PW.WindowSpec(SPEC_ODD.interval_ms, SPEC_ODD.buckets)
    rng = np.random.default_rng(23)
    names = list(rows)
    n, r_rows = 32, POD_CAPACITY
    pr = jpack.param.resource_row.shape[0]
    now = NOW0 + 77
    blocked = 0
    for k in range(6):
        pick = rng.integers(0, len(names), size=n)
        buf = pod_entry_buf(1, n, {i: rows[names[pick[i]]]
                                   for i in range(n)})
        buf["count"][:] = rng.integers(1, 3, size=n) if k % 3 == 2 else 1
        buf["prioritized"][:] = rng.random(n) < 0.4
        buf["param_hash"][:, 0] = rng.choice(
            np.array([0xBEEF, 0xCAFE], np.uint32), size=n)
        buf["param_present"][:, 0] = True
        ex = {
            "extra_pass": rng.integers(0, 6, size=r_rows).astype(np.int32),
            "extra_next": rng.integers(0, 6, size=r_rows).astype(np.int32),
            "extra_pass_global": rng.integers(0, 12, size=r_rows)
            .astype(np.int32),
            "extra_next_global": rng.integers(0, 12, size=r_rows)
            .astype(np.int32),
            "extra_cms": rng.integers(0, 3, size=(pr, 4, 2048))
            .astype(np.float32),
            "shadow_extra_pass": rng.integers(0, 6, size=r_rows)
            .astype(np.int32),
            "shadow_extra_cms": rng.integers(0, 3, size=(pr, 4, 2048))
            .astype(np.float32),
        }
        jstate, jdec = jstep(jstate, jpack, jax_entry(buf), jnp.int64(now),
                             spec1=SPEC_ODD, shadow_rules=jshadow,
                             **{k_: jnp.asarray(v) for k_, v in ex.items()})
        pstate, pdec = PS.entry_step(
            pstate, prules, to_device(buf, "cpu"), now, spec1=pspec,
            shadow_rules=pshadow,
            **{k_: torch.from_numpy(v) for k_, v in ex.items()})
        assert_decisions_equal(jdec, pdec)
        assert_tree_equal(jax_to_np(jstate), port_np(pstate), rtol=0.0)
        blocked += int((np.asarray(jdec.reason) > 0).sum())
        now += int(rng.integers(100, 600))
    assert blocked > 0


def test_one_shard_pod_equals_a_plain_step():
    """A pod of one shard is the plain step: the extras are all zero and
    the pre-rotated window takes the step's restamp (port only)."""
    rows, pack, one = pod_world(thr=6)
    prules = convert.rules_from_numpy(jax_to_np(pack), "cpu")
    pod = convert.state_from_numpy(jax_to_np(
        JPC.make_pod_state(1, one)), "cpu")
    plain = convert.state_from_numpy(jax_to_np(one), "cpu")
    entry, exit_ = PPC.make_pod_steps("cpu")
    rng = np.random.default_rng(3)
    now = NOW0 + 400
    for k in range(4):
        buf = pod_entry_buf(1, B, {i: rows[n] for i, n in enumerate(
            rng.choice(list(rows), size=B))}, param=0xBEEF)
        pod, pdec = entry(pod, prules, to_device(buf, "cpu"), now)
        plain, dec = PS.entry_step(plain, prules, to_device(buf, "cpu"), now)
        for f in dec._fields:
            assert torch.equal(getattr(dec, f), getattr(pdec, f)), f
        xbuf = pod_exit_buf(buf, dec.reason.numpy())
        pod = exit_(pod, prules, to_device(xbuf, "cpu"), now + 20)
        plain = PS.exit_step(plain, prules, to_device(xbuf, "cpu"), now + 20)
        assert_tree_equal(port_np(plain), _index_np(port_np(pod), 0),
                          rtol=0.0)
        now += 450


def _index_np(d, i):
    """Shard ``i`` of a nested numpy dict of a pod."""
    return {k: (_index_np(v, i) if isinstance(v, dict) else v[i])
            for k, v in d.items()}


def test_pod_tree_equals_shards_stepped_one_by_one():
    """The one-process pod writes each shard's step back into its tree:
    the tree equals D plain states put through the same body (prepare,
    the sum, finish) with no tree at all."""
    rows, pack, one = pod_world(thr=10, param_thr=4)
    prules = convert.rules_from_numpy(jax_to_np(pack), "cpu")
    pod = convert.state_from_numpy(jax_to_np(
        JPC.make_pod_state(D, one)), "cpu")
    shards = [convert.state_from_numpy(jax_to_np(one), "cpu")
              for _ in range(D)]
    entry, _ = PPC.make_pod_steps("cpu")
    rng = np.random.default_rng(9)
    for k in range(3):
        now = NOW0 + 600 * k
        buf = pod_entry_buf(D, B, {i: rows[n] for i, n in enumerate(
            rng.choice(list(rows), size=D * B))}, param=0xBEEF)
        pod, pdec = entry(pod, prules, to_device(buf, "cpu"), now)
        prepared = [PPC.prepare(s, prules, now, cluster_param=True)
                    for s in shards]
        total = PPC.sum_contributions([c for _, c in prepared])
        batch = to_device(buf, "cpu")
        decs = []
        for d, (local, own) in enumerate(prepared):
            lane = PPC.tree_map(lambda x: x[d * B:(d + 1) * B], batch)
            shards[d], dec = PPC.finish(local, prules, lane, now, own, total)
            decs.append(dec)
        assert torch.equal(PPC.cat_decisions(decs).reason, pdec.reason)
        got = port_np(pod)
        for d in range(D):
            assert_tree_equal(port_np(shards[d]), _index_np(got, d),
                              rtol=0.0)


# ---------------------------------------------------------------------------
# The pod-wide candidate and the global reads
# ---------------------------------------------------------------------------


def test_pod_wide_candidate_rides_the_reduction():
    """tests/test_rollout.py:440 — a candidate cluster-mode flow rule (10
    a second) and cluster param rule admit against the pod-global shadow
    window and sketch; the live rules block nothing. The shadow counters
    summed over the shards equal the reference's."""
    rows, live, one = pod_world(thr=1e6, param_thr=1e6)
    _, cand, cand_one = pod_world(thr=10, param_thr=4)
    one = one._replace(shadow=JS.make_shadow_state(POD_CAPACITY, cand,
                                                   cand_one.degrade))
    pcand = convert.rules_from_numpy(jax_to_np(cand), "cpu")
    tw = PodTwin(live, one, (D,), shadow_rules=cand, pshadow_rules=pcand)
    per = 4
    lanes = every_lane(D, B, rows["shared"], per)
    lanes.update({d * B + per + j: rows["pshared"]
                  for d in range(D) for j in range(2)})
    buf = pod_entry_buf(D, B, lanes, param=0xBEEF)
    for k in range(4):
        r, _ = tw.entry(buf, NOW0 + k * 7)
        assert (r[r >= 0] == PASS).all()  # live blocks nothing
    jcounts = np.asarray(JPC.global_shadow_counts(jax.tree.map(
        lambda x: x[:, 0], tw.jstate)))
    counts = PPC.global_shadow_counts(tw.pstate).numpy()
    np.testing.assert_array_equal(counts, jcounts)
    row = rows["shared"]
    would_pass = int(counts[PS.SH_WOULD_PASS, row])
    would_block = int(counts[PS.SH_WOULD_BLOCK, row])
    assert would_pass + would_block == 4 * D * per
    assert would_pass <= 10 + (D - 1) * per
    assert would_block > 0
    assert int(counts[PS.SH_LIVE_PASS, row]) == 4 * D * per
    prow = rows["pshared"]
    assert int(counts[PS.SH_WOULD_PASS, prow]) <= 4 + (D - 1) * 2
    assert int(counts[PS.SH_WB_PARAM, prow]) > 0


def test_global_telemetry_and_flight_reads():
    """tests/test_telemetry.py:490 and tests/test_timeseries.py:404 — the
    pod-global telemetry and flight ring are the sums over the shards,
    and equal the reference's reads."""
    rows, tw = _twin(local_thr=2)
    per = 4
    buf = pod_entry_buf(D, B, every_lane(D, B, rows["local"], per))
    r, _ = tw.entry(buf, NOW0)
    blocked = int((r > 0).sum())
    assert blocked == D * (per - 2)
    jpod = jax.tree.map(lambda x: x[:, 0], tw.jstate)
    tele = PPC.global_telemetry_counts(tw.pstate)
    assert_tree_equal(jax_to_np(JPC.global_telemetry_counts(jpod)),
                      port_np(tele), rtol=0.0)
    flow_ch = JAT.ATTR_REASON_NAMES.index("FLOW")
    row = rows["local"]
    assert int(tele.block_by_reason[flow_ch, row]) == blocked
    assert int(tele.totals[JC.MetricEvent.PASS, row]) == 2 * D
    tw.entry(buf, NOW0 + 1000)  # the second rolls: the ring folds
    jpod = jax.tree.map(lambda x: x[:, 0], tw.jstate)
    fl = PPC.global_flight_recorder(tw.pstate)
    assert_tree_equal(jax_to_np(JPC.global_flight_recorder(jpod)),
                      port_np(fl), rtol=0.0)
    slot = int((NOW0 // 1000) % 8)
    assert int(fl.stamps[slot]) == NOW0
    assert int(fl.events[slot, JC.MetricEvent.PASS, row]) == 2 * D
    assert int(fl.events[slot, JC.MetricEvent.BLOCK, row]) == blocked
    assert int(fl.attr[slot, flow_ch, row]) == blocked


# ---------------------------------------------------------------------------
# Pod checkpoints, both ways
# ---------------------------------------------------------------------------


def test_pod_checkpoints_interchange_both_ways(tmp_path):
    """A pod checkpoint the reference writes restores into the port, and
    one the port writes restores into the reference: equal leaves."""
    rows, tw = _twin(thr=64, param_thr=5)
    buf = pod_entry_buf(D, B, every_lane(D, B, rows["shared"], 6))
    buf["cluster_row"][D * B - 1] = rows["pshared"]
    buf["param_hash"][:, 0] = 0xBEEF
    buf["param_present"][:, 0] = True
    tw.entry(buf, NOW0)
    jpod = jax.tree.map(lambda x: x[:, 0], tw.jstate)
    _, pack, one = pod_world(thr=64, param_thr=5)
    jtemplate = JPC.make_pod_state(D, one)
    ptemplate = convert.state_from_numpy(jax_to_np(jtemplate), "cpu")

    jfile = str(tmp_path / "jax_pod.npz")
    JCK.save_pod_checkpoint(jpod, jfile)
    restored = PCK.restore_pod_checkpoint(ptemplate, jfile)
    assert_tree_equal(jax_to_np(jpod), port_np(restored), rtol=0.0)

    pfile = str(tmp_path / "port_pod.npz")
    PCK.save_pod_checkpoint(tw.pstate, pfile)
    back = JCK.restore_pod_checkpoint(jtemplate, pfile)
    assert_tree_equal(jax_to_np(back), port_np(tw.pstate), rtol=0.0)
    assert np.asarray(back.param.key).dtype == np.uint32


def test_restored_pod_keeps_the_global_quota(tmp_path):
    """tests/test_checkpoint_scenarios.py:140 — a pod saturates its quota,
    is saved and restored into a fresh pod: the restored pod grants
    nothing while a cold pod grants again (port only)."""
    rows, pack, one = pod_world(thr=64)
    prules = convert.rules_from_numpy(jax_to_np(pack), "cpu")

    def fresh():
        return convert.state_from_numpy(jax_to_np(
            JPC.make_pod_state(D, one)), "cpu")

    entry, _ = PPC.make_pod_steps("cpu")
    full = to_device(pod_entry_buf(D, B, every_lane(D, B, rows["shared"],
                                                    8)), "cpu")
    pod, dec = entry(fresh(), prules, full, NOW0)
    assert int((dec.reason == PASS).sum()) == 64
    f = str(tmp_path / "pod.npz")
    PCK.save_pod_checkpoint(pod, f)
    restored = PCK.restore_pod_checkpoint(fresh(), f)
    six = to_device(pod_entry_buf(D, B, every_lane(D, B, rows["shared"], 6)),
                    "cpu")
    _, cold = entry(fresh(), prules, six, NOW0 + 1)
    assert int((cold.reason == PASS).sum()) == 48
    _, warm = entry(restored, prules, six, NOW0 + 1)
    assert int((warm.reason == PASS).sum()) == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pod_checkpoint_refuses_a_mismatched_template(tmp_path, writer):
    """tests/test_checkpoint_scenarios.py:171 — a template of another
    capacity is refused, whichever package wrote the file, before any
    value is returned."""
    _, pack, one = pod_world()
    jpod = JPC.make_pod_state(D, one)
    f = str(tmp_path / "pod.npz")
    if writer == "jax":
        JCK.save_pod_checkpoint(jpod, f)
    else:
        PCK.save_pod_checkpoint(
            convert.state_from_numpy(jax_to_np(jpod), "cpu"), f)
    small = JS.make_state(64, pack.flow.num_rules, NOW0,
                          param=JP.make_param_state(
                              pack.param.num_rules), flight_seconds=8)
    template = convert.state_from_numpy(jax_to_np(
        JPC.make_pod_state(D, small._replace(degrade=one.degrade))), "cpu")
    with pytest.raises(ValueError, match="leaf"):
        PCK.restore_pod_checkpoint(template, f)


def test_pod_window_helpers_match_the_reference():
    """``global_pass_counts`` / ``global_next_window`` over a pod's
    rotated ``[D, ...]`` window equal the reference's helpers under a
    vmap over ``"pod"``, after seeded traffic with occupy borrows."""
    rows, tw = _twin(thr=9)
    lanes = every_lane(D, B, rows["shared"], 3)
    tw.entry(pod_entry_buf(D, B, lanes), NOW0 + 100)
    tw.entry(pod_entry_buf(D, B, lanes, prioritized=True), NOW0 + 700)
    now = NOW0 + 720
    jw1 = jax.tree.map(lambda x: x[:, 0], tw.jstate.w1)
    jocc = tw.jstate.occupied_next[:, 0]

    def ref(w, occ):
        w = JW.rotate(w, jnp.int64(now), JS.SPEC_1S)
        extra, local = JPC.global_pass_counts(w, JPC.AXIS)
        return extra, local, JPC.global_next_window(
            w, occ, jnp.int64(now), JPC.AXIS)

    jextra, jlocal, jnext = jax.vmap(ref, axis_name=JPC.AXIS)(jw1, jocc)
    w1 = PPC.tree_map(lambda x: x, tw.pstate.w1)
    rotated = PW.Window(*(torch.stack(parts) for parts in zip(*(
        PW.rotate(PPC.shard(w1, d), now, PS.SPEC_1S) for d in range(D)))))
    extra, local = PPC.global_pass_counts(rotated)
    nxt = PPC.global_next_window(rotated, tw.pstate.occupied_next, now)
    np.testing.assert_array_equal(extra.numpy(), np.asarray(jextra))
    np.testing.assert_array_equal(local.numpy(), np.asarray(jlocal))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
    assert int(np.asarray(jnext).max()) > 0
