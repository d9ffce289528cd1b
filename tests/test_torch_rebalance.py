"""The port's governed shard rebalancer (``cluster/rebalance.py``) against
the JAX package's, on the CPU: the reference's ``tests/test_rebalance.py``
scenarios, each run on both packages over the same fake seat and fleet.

Compared exactly: propose / certify / apply / rollback results, the plans
(``to_dict``), the audit journal's records, and certification's verdict
and fault sha256s (the port certifies on a chaos mesh with
``device="cpu"``). The bench record's rebalance drill (64 slices, A owning
half, campaign seed 0) must certify to its recorded verdict sha256 on the
port. ``engine.rebalancer`` exists and ``set_clock`` resets its timebase.

Left out until the ops plane is ported: the ``rebalance`` command surface
(``transport/handlers.py``).
"""

from __future__ import annotations

import random

import pytest

from tests.test_torch_support import cluster_pkgs

JAX, PORT = cluster_pkgs()
BOTH = (JAX, PORT)

N_SLICES = 8
LEADERS = ("A", "B", "C")
DRILL_VERDICT = \
    "edb88a7434f6109a761faf92025a91d2c3efd80e927f66a5b7e1f135073ea917"


def _mk_map(P, owner, version=5, epochs=None, leaders=LEADERS):
    specs = tuple(P.ha.ClusterServerSpec(m, "127.0.0.1", 0)
                  for m in leaders)
    return P.sharding.ShardMap(
        version=version, n_slices=len(owner), servers=specs,
        slice_owner=tuple(owner),
        slice_epoch=tuple(epochs or (version,) * len(owner)))


class _FakeHA:
    def __init__(self, P, smap):
        self.P = P
        self.shard_map = smap
        self.applied = []
        self.pending = False

    def transition_pending(self):
        return self.pending

    def apply_map(self, smap):
        self.applied.append((smap, self.P.journal.current_cause()))
        self.shard_map = smap


class _FakeFleet:
    def __init__(self, clock, loads, degraded=(), lag_ms=2000):
        self.clock = clock
        self.loads = dict(loads)
        self.degraded = set(degraded)
        self.lag_ms = lag_ms

    def settled_through_ms(self):
        return self.clock() - self.lag_ms

    def status(self):
        return {"leaders": {
            m: {"stale": m in self.degraded, "epochRegressed": False}
            for m in LEADERS}}

    def slice_loads(self, flow_of, n, window_seconds=None,
                    settled_only=True):
        return {"nSlices": n, "seconds": 30,
                "settledThroughMs": self.settled_through_ms(),
                "slices": dict(self.loads), "observedByLeader": {},
                "unattributed": 0}


class Rig:
    """One package's rebalancer over a fake seat, fleet and journal."""

    def __init__(self, P, loads=None, owner=None, degraded=(),
                 lag_ms=2000, now=10_000_000, version=5):
        self.P = P
        self.now = [now]
        clock = lambda: self.now[0]  # noqa: E731
        owner = owner or ["A"] * 5 + ["B", "C", "C"]
        loads = loads if loads is not None else {
            sl: (1000 if owner[sl] == "A" else 50)
            for sl in range(len(owner))}
        self.ha = _FakeHA(P, _mk_map(P, owner, version=version))
        self.fleet = _FakeFleet(clock, loads, degraded=degraded,
                                lag_ms=lag_ms)
        self.journal = P.journal.ControlPlaneJournal(clock, path=None)
        self.rb = P.rebalance.ShardRebalancer(
            ha=self.ha, fleet=self.fleet, journal=self.journal,
            flow_of=lambda r: None, clock=clock, **P.kw)

    def records(self):
        return self.journal.tail(limit=10_000)


def _both(scenario, *args, **kw):
    """Run ``scenario(rig)`` on both packages; returns {name: result}
    after asserting the two results and journals are equal."""
    out, journals = {}, {}
    for P in BOTH:
        rig = Rig(P, *args, **kw)
        out[P.name] = scenario(rig)
        journals[P.name] = rig.records()
    assert out["port"] == out["jax"]
    assert journals["port"] == journals["jax"]
    return out["port"]


def _plan(rig, r):
    return rig.rb.plans[r["plan"]["planId"]]


# -- minimal movement ------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_moves_bounded_by_cap_and_improve_skew(seed):
    rng = random.Random(seed)
    owner = [rng.choice(LEADERS) for _ in range(N_SLICES)]
    loads = {sl: rng.randrange(0, 2000) for sl in range(N_SLICES)}
    cap = PORT.root.core.config.config.rebalance_max_slices_per_epoch()

    def scenario(rig):
        r = rig.rb.propose()
        if not r["ok"]:
            assert r["veto"] == "deadband"
            return r
        plan = _plan(rig, r)
        base = rig.ha.shard_map
        assert 0 < len(plan.moves) <= cap
        for sl in range(N_SLICES):
            if sl in plan.moves:
                assert plan.proposed.slice_owner[sl] == plan.moves[sl][1]
                assert plan.proposed.slice_epoch[sl] == plan.proposed.version
            else:
                assert plan.proposed.slice_owner[sl] == base.slice_owner[sl]
                assert plan.proposed.slice_epoch[sl] == base.slice_epoch[sl]
        assert plan.skew_after <= plan.skew_before
        return r, tuple(plan.proposed)

    _both(scenario, loads=loads, owner=owner)


def test_deadband_vetoes_balanced_cluster():
    def scenario(rig):
        r = rig.rb.propose()
        assert not r["ok"] and r["veto"] == "deadband"
        assert rig.rb.plans_total == 0
        return r

    _both(scenario, loads={sl: 100 for sl in range(N_SLICES)},
          owner=["A", "A", "A", "B", "B", "B", "C", "C"])


# -- envelope --------------------------------------------------------------


def test_cooldown_vetoes_remove_after_apply():
    def scenario(rig):
        r = rig.rb.propose()
        pid = r["plan"]["planId"]
        plan = rig.rb.plans[pid]
        plan.certified = True  # envelope test: no mesh episode
        applied = rig.rb.apply(pid)
        assert applied["ok"]
        moved = set(plan.moves)
        rig.fleet.loads = {sl: (2000 if sl in moved else 10)
                           for sl in range(N_SLICES)}
        rig.now[0] += 1000
        r2 = rig.rb.propose()
        if r2["ok"]:
            assert not moved & set(_plan(rig, r2).moves)
        cooldown = rig.P.root.core.config.config.rebalance_cooldown_ms()
        later = rig.now[0] + 2 * cooldown + 1000
        free = rig.rb.ledger.check(next(iter(sorted(moved))), "A", later)
        assert free is None
        return r, applied, r2, rig.rb.status()

    _both(scenario)


def test_flip_hysteresis_outlasts_plain_cooldown():
    def scenario(rig):
        led, t0 = rig.rb.ledger, rig.now[0]
        led.stamp(3, "B", t0)
        plain = t0 + led.cooldown_ms + 1
        out = (led.check(3, "B", plain), led.check(3, "A", plain),
               led.check(3, "A", t0 + led.flip_cooldown_ms + 1))
        assert out == (None, "hysteresis", None)
        return out

    _both(scenario)


def test_degraded_leader_freezes_skew_plans_but_not_leave():
    def scenario(rig):
        r = rig.rb.propose()
        assert not r["ok"] and r["frozenBy"] == rig.P.envelope.FREEZE_DEGRADED
        r2 = rig.rb.plan_leave("A")
        assert r2["ok"], r2
        plan = _plan(rig, r2)
        assert all(frm == "A" for _sl, (frm, _to) in plan.moves.items())
        assert "A" not in {to for _sl, (_frm, to) in plan.moves.items()}
        return r, r2

    _both(scenario, degraded=("A",))


def test_freeze_precedence_manual_stale_degraded_backoff():
    def scenario(rig):
        E, rb = rig.P.envelope, rig.rb
        rig.fleet.lag_ms = 60_000
        rb.backoff_until_ms = rig.now[0] + 99_999
        rb.manual_frozen = True
        seen = [rb.status()["frozenBy"]]
        rb.manual_frozen = False
        seen.append(rb.status()["frozenBy"])
        rig.fleet.lag_ms = 1000
        seen.append(rb.status()["frozenBy"])
        rig.fleet.degraded = set()
        seen.append(rb.status()["frozenBy"])
        rb.backoff_until_ms = 0
        seen.append(rb.status()["frozen"])
        assert seen == [E.FREEZE_MANUAL, E.FREEZE_STALE, E.FREEZE_DEGRADED,
                        E.FREEZE_BACKOFF, False]
        return seen, rb.metrics_state()

    _both(scenario, degraded=("B",))


def test_mid_handoff_vetoes_all_movement():
    def scenario(rig):
        rig.ha.pending = True
        r = rig.rb.propose()
        assert not r["ok"] and rig.rb.plans_total == 0
        return r

    _both(scenario)


def test_apply_requires_certification_and_fresh_base():
    def scenario(rig):
        pid = rig.rb.propose()["plan"]["planId"]
        r = rig.rb.apply(pid)
        assert not r["ok"] and r["veto"] == "certification"
        rig.rb.plans[pid].certified = True
        rig.ha.shard_map = rig.ha.shard_map._replace(
            version=rig.ha.shard_map.version + 1)
        r2 = rig.rb.apply(pid)
        assert not r2["ok"] and r2["veto"] == "stale-plan"
        return r, r2

    _both(scenario)


def test_rollback_restores_exact_prior_ownership():
    def scenario(rig):
        before = rig.ha.shard_map
        pid = rig.rb.propose()["plan"]["planId"]
        rig.rb.plans[pid].certified = True
        assert rig.rb.apply(pid)["ok"]
        assert rig.ha.shard_map.slice_owner != before.slice_owner
        r = rig.rb.rollback()
        assert r["ok"]
        assert rig.ha.shard_map.slice_owner == before.slice_owner
        assert rig.ha.shard_map.version > before.version
        assert rig.rb.rollbacks_total == 1
        return r, tuple(rig.ha.shard_map), [c for _m, c in rig.ha.applied]

    _both(scenario)


# -- certification ---------------------------------------------------------


def _cert_view(c):
    cert = dict(c["cert"])
    return c["ok"], cert


def test_broken_plan_certification_fires_slice_conservation():
    def scenario(rig):
        pid = rig.rb.propose()["plan"]["planId"]
        plan = rig.rb.plans[pid]
        plan.proposed = plan.proposed._replace(
            slice_epoch=rig.ha.shard_map.slice_epoch)  # the bug under test
        r = rig.rb.certify(pid, campaign_seed=7, seconds=6, max_faults=2)
        assert not r["ok"]
        invs = {v["invariant"] for v in r["cert"]["violations"]}
        assert "slice_conservation" in invs
        assert rig.rb.backoff_until_ms > rig.now[0]
        assert rig.rb.status()["frozenBy"] == rig.P.envelope.FREEZE_BACKOFF
        certs = rig.journal.tail(kind="rebalanceCertify")
        assert certs[-1]["ok"] is False
        assert certs[-1]["causeSeq"] == plan.propose_seq
        return _cert_view(r)

    _both(scenario)


def test_certified_plan_applies_with_full_journal_chain():
    def scenario(rig):
        pid = rig.rb.propose()["plan"]["planId"]
        c = rig.rb.certify(pid, campaign_seed=7, seconds=6, max_faults=2)
        assert c["ok"], c
        a = rig.rb.apply(pid)
        assert a["ok"], a
        _smap, cause = rig.ha.applied[-1]
        assert cause == a["applySeq"]
        chain = rig.journal.chain(a["applySeq"])
        assert [rec["kind"] for rec in chain[:3]] == [
            "rebalanceApply", "rebalanceCertify", "rebalancePropose"]
        assert all(rec["actor"] == "rebalancer" for rec in chain[:3])
        return _cert_view(c), a, rig.rb.plans[pid].to_dict()

    _both(scenario)


def test_bench_drill_plan_certifies_to_the_recorded_sha():
    """The bench record's rebalance drill: 3 leaders on a 64-slice ring,
    A owning slices 0-31, uniform per-slice load; the plan moves 0 and 2
    to B and 1 and 3 to C, and certification (campaign seed 0) replays
    to the recorded verdict sha256 on both packages."""
    owner = ["A" if i < 32 else ("B" if i < 48 else "C") for i in range(64)]

    def scenario(rig):
        r = rig.rb.propose()
        assert r["ok"], r
        plan = _plan(rig, r)
        assert {sl: f"{a}->{b}" for sl, (a, b) in plan.moves.items()} == {
            0: "A->B", 1: "A->C", 2: "A->B", 3: "A->C"}
        c = rig.rb.certify(r["plan"]["planId"], campaign_seed=0)
        assert c["ok"] and c["cert"]["verdictSha256"] == DRILL_VERDICT
        return _cert_view(c)

    _both(scenario, owner=owner, loads={sl: 1000 for sl in range(64)},
          version=2)


@pytest.mark.slow
def test_certification_replays_bit_identically():
    rig = Rig(PORT)
    pid = rig.rb.propose()["plan"]["planId"]
    c1 = rig.rb.certify(pid, campaign_seed=11)
    rig.rb.backoff_until_ms = 0
    c2 = rig.rb.certify(pid, campaign_seed=11)
    assert c1["cert"]["verdictSha256"] == c2["cert"]["verdictSha256"]
    assert c1["cert"]["faultSha256"] == c2["cert"]["faultSha256"]
    c3 = rig.rb.certify(pid, campaign_seed=12)
    assert (c3["cert"]["verdictSha256"], c3["cert"]["faultSha256"]) != (
        c1["cert"]["verdictSha256"], c1["cert"]["faultSha256"])


# -- autoscaling -----------------------------------------------------------


def test_join_folds_new_seat_through_same_pipeline():
    def scenario(rig):
        r = rig.rb.plan_join("D", "127.0.0.1", 0)
        assert r["ok"], r
        pid = r["plan"]["planId"]
        plan = rig.rb.plans[pid]
        assert all(to == "D" for _sl, (_frm, to) in plan.moves.items())
        c = rig.rb.certify(pid, campaign_seed=3, seconds=6, max_faults=2)
        assert c["ok"], c
        a = rig.rb.apply(pid)
        assert a["ok"], a
        assert set(rig.ha.shard_map.slices_of("D")) == set(plan.moves)
        kinds = [rec["kind"] for rec in rig.journal.chain(a["applySeq"])]
        assert kinds[:3] == ["rebalanceApply", "rebalanceCertify",
                             "rebalancePropose"]
        return r, _cert_view(c), a

    _both(scenario)


def test_leave_drains_cap_slices_and_drops_empty_seat():
    def scenario(rig):
        r = rig.rb.plan_leave("C")
        assert r["ok"], r
        plan = _plan(rig, r)
        assert set(plan.moves) == {6, 7}
        assert plan.proposed.server_for("C") is None
        assert "C" not in plan.proposed.slice_owner
        return r

    _both(scenario, owner=["A", "A", "A", "B", "B", "B", "C", "C"])


# -- the engine hook ---------------------------------------------------------


def test_engine_rebalancer_resets_with_set_clock():
    from sentinel_tpu_torch.core.engine import SentinelEngine

    eng = SentinelEngine(capacity=64, device="cpu", clock=lambda: 5_000_000,
                         journal_path="")
    try:
        rb = eng.rebalancer
        assert isinstance(rb, PORT.rebalance.ShardRebalancer)
        assert rb._device().type == "cpu"
        assert rb.status()["mapVersion"] is None  # no HA seat yet
        rb.ledger.stamp(3, "B", 5_000_000)
        rb.backoff_until_ms = 9_999_999
        eng.set_clock(lambda: 1_000)
        assert rb.backoff_until_ms == 0
        assert rb.ledger.check(3, "A", 1_000) is None
    finally:
        eng.close()


# -- slow: the live three-leader drill on the chaos mesh ----------------------


def _live_drill(P):
    import os
    import shutil
    import tempfile

    config = P.root.core.config.config
    slice_of = P.sharding.slice_of
    workdir = tempfile.mkdtemp(prefix="sentinel-rebalance-drill-")
    clock = P.clock.SimClock(config.chaos_epoch_ms())
    history = P.inv.History()
    n = 8
    flows, seen, fid = {}, set(), 9000
    while len(flows) < 7 and fid < 60_000:
        sl = slice_of(fid, n)
        if sl not in seen:
            flows[fid] = 9.0
            seen.add(sl)
        fid += 1
    mesh = P.mesh.ChaosMesh(clock, history, workdir, leaders=LEADERS,
                            n_slices=n, flows=flows, **P.kw)
    try:
        slots = sorted(seen)
        hot, cool = set(slots[:5]), set(slots[5:])
        mesh.rebalance({"A": sorted(hot), "B": sorted(cool),
                        "C": [sl for sl in range(n) if sl not in seen]},
                       {sl: 2 for sl in range(n)}, version=2)
        journal = P.journal.ControlPlaneJournal(
            clock.now_ms, path=os.path.join(workdir, "journal-ctl.jsonl"))
        mesh.hosts["A"].journal = journal
        mesh.seats["A"].state.journal = journal
        for sec in range(6):
            for f in sorted(flows):
                for _ in range(4 if slice_of(f, n) in hot else 1):
                    mesh.request(f, sec)
            clock.advance(1000)

        class _MeshFleet:
            def settled_through_ms(self):
                return clock.now_ms() - 1000

            def status(self):
                return {"leaders": {m: {"stale": False,
                                        "epochRegressed": False}
                                    for m in LEADERS}}

            def slice_loads(self, flow_of, n_slices, window_seconds=None,
                            settled_only=True):
                loads = {}
                for ev in history.of("verdict"):
                    if ev["status"] in ("pass", "block"):
                        s = slice_of(ev["flow"], n_slices)
                        loads[s] = loads.get(s, 0) + 1
                return {"nSlices": n_slices, "seconds": 6,
                        "settledThroughMs": self.settled_through_ms(),
                        "slices": loads, "observedByLeader": {},
                        "unattributed": 0}

        def apply_all(smap):
            for mid in mesh.leader_order:
                mesh.seats[mid].apply_map(smap)
            mesh.router.apply_map(smap)

        rb = P.rebalance.ShardRebalancer(
            ha=mesh.seats["A"], fleet=_MeshFleet(), journal=journal,
            flow_of=lambda r: None, clock=clock.now_ms, apply_via=apply_all,
            **P.kw)
        skew0 = rb.sense()["skew"]
        r = rb.propose()
        pid = r["plan"]["planId"]
        c = rb.certify(pid, campaign_seed=5, seconds=6, max_faults=2)
        a = rb.apply(pid)
        assert c["ok"] and a["ok"], (c, a)
        plan = rb.plans[pid]
        assert mesh.seats["A"].shard_map.version == plan.proposed.version
        smap_recs = [rec for rec in journal.tail(kind="shardMapApply")
                     if rec.get("version") == plan.proposed.version]
        kinds = [rec["kind"] for rec in journal.chain(smap_recs[-1]["seq"])]
        assert kinds[:4] == ["shardMapApply", "rebalanceApply",
                             "rebalanceCertify", "rebalancePropose"]
        assert rb.sense()["skew"] < skew0
        return (r, _cert_view(c), a, plan.to_dict(),
                history.of("verdict"))
    finally:
        mesh.stop()
        shutil.rmtree(workdir, ignore_errors=True)


@pytest.mark.slow
def test_live_three_leader_drill_matches_the_jax_package():
    got = [_live_drill(P) for P in BOTH]
    assert got[1] == got[0]
