"""The port's chaos package (``sentinel_tpu_torch/chaos/``) against the JAX
package's, on the CPU: the reference's ``tests/test_chaos_campaign.py``
scenarios run on both packages with the same seeds.

Every comparison is exact: the invariant checkers' violations on the
reference's hand-built histories, the fault schedules, the shrinker's
minimal sets, and each episode's verdict and fault sha256s, schedule,
counts and fault log (the port's mesh runs its leaders with
``device="cpu"``). The slot-storm campaign's verdict and tenancy shas
match too. The 200-episode campaign that must reproduce the bench record's
``verdict_sha256`` / ``fault_sha256`` is ``slow``, as are the counterparts
of the reference's own slow tests.

Left out until their modules are ported: the datasource flap seam
(``datasource/base.py``) and the exporter's chaos families
(``telemetry/exporter.py``).
"""

from __future__ import annotations

import os

import pytest

from tests.test_torch_support import cluster_pkgs, strip_keys

JAX, PORT = cluster_pkgs()
BOTH = (JAX, PORT)

THRESHOLDS = {9000: (6.0, 1000), 9001: (6.0, 1000)}
DIVISOR = 2

# The bench record's 200-episode campaign (seed 14).
ANCHOR_VERDICT = \
    "622bf231f908917061f7ec5cd2fad01ccb7bb58c58ab042ac745088d298e2429"
ANCHOR_FAULT = \
    "54a2a745b8957ce598748cfff3fb5fddcd46624efbfc83906e92405cbadc4d44"


def _viol(vs):
    return [v.to_dict() for v in vs]


# -- the invariant checkers on the reference's hand-built histories ----------


def _h_clean(P):
    h = P.inv.History()
    h.add("offered", op=0, flow=9000, sec=0)
    h.add("grant", op=0, flow=9000, leader="A", win=0)
    h.add("fence", scope=0, epoch=1, accepted=True)
    h.add("verdict", op=0, flow=9000, status="pass", by="A", sec=0)
    h.add("journal", leader="A", seqs=[1, 2, 3])
    return [("check_all", h, False)]


def _h_conservation(P):
    h = P.inv.History()
    h.add("offered", op=0, flow=9000, sec=0)
    h.add("offered", op=1, flow=9000, sec=0)
    h.add("verdict", op=0, flow=9000, status="pass", by="A", sec=0)
    h2 = P.inv.History()
    h2.add("offered", op=0, flow=9000, sec=0)
    h2.add("verdict", op=0, flow=9000, status="granted??", by="A", sec=0)
    return [("check_conservation", h, True),
            ("check_conservation", h2, True)]


def _h_no_stranded(P):
    out = []
    h = P.inv.History()
    h.add("offered", op=0, flow=9000, sec=0)
    out.append(("check_no_stranded", h, True))
    h = P.inv.History()
    h.add("offered", op=0, flow=9000, sec=0)
    h.add("verdict", op=0, flow=9000, status="pass", by="A", sec=0)
    out.append(("check_no_stranded", h, False))
    h = P.inv.History()
    h.add("offered", op=0, flow=9000, sec=0)
    h.add("verdict", op=0, flow=9000, status="pass", by="A", sec=0)
    h.add("verdict", op=0, flow=9000, status="dropped", by=None, sec=0)
    out.append(("check_no_stranded", h, True))
    return out


def _h_shed(P):
    h = P.inv.History()
    h.add("offered", op=0, flow=9000, sec=0)
    h.add("grant", op=0, flow=9000, leader="A", win=0)
    h.add("shedBy", op=0, flow=9000, leader="A")
    h.add("verdict", op=0, flow=9000, status="shed", by="A", sec=0)
    h2 = P.inv.History()
    h2.add("grant", op=0, flow=9000, leader="B", win=0)
    h2.add("shedBy", op=0, flow=9000, leader="A")
    return [("check_shed_not_half_admitted", h, True),
            ("check_shed_not_half_admitted", h2, False)]


def _h_overadmission(P):
    h = P.inv.History()
    for i in range(7):
        h.add("grant", op=i, flow=9000, leader="A", win=1000)
    h2 = P.inv.History()
    for i in range(4):
        h2.add("grant", op=i, flow=9000, leader="A", win=1000)
    h2.add("transfer", flow=9000, slice=6, frm="A", to="B", win=1000)
    for i in range(4, 10):
        h2.add("grant", op=i, flow=9000, leader="B", win=1000)
    h3 = P.inv.History()
    h3.events = [dict(ev) for ev in h2.events]
    h3.add("grant", op=10, flow=9000, leader="B", win=1000)
    return [("check_overadmission", h, True),
            ("check_overadmission", h2, False),
            ("check_overadmission", h3, True),
            ("check_slice_conservation", h3, False)]


def _h_degraded(P):
    h = P.inv.History()
    for i in range(3):
        h.add("degradedGrant", op=i, flow=9000, win=0)
    h2 = P.inv.History()
    h2.events = [dict(ev) for ev in h.events]
    h2.add("degradedGrant", op=3, flow=9000, win=0)
    return [("check_degraded_bound", h, False),
            ("check_degraded_bound", h2, True)]


def _h_epoch(P):
    h = P.inv.History()
    h.add("fence", scope=4, epoch=3, accepted=True)
    h.add("fence", scope=4, epoch=2, accepted=False)
    h2 = P.inv.History()
    h2.events = [dict(ev) for ev in h.events]
    h2.add("fence", scope=4, epoch=2, accepted=True)
    return [("check_epoch_monotone", h, False),
            ("check_epoch_monotone", h2, True)]


def _h_journal(P):
    h = P.inv.History()
    h.add("journal", leader="A", seqs=[1, 2, 5, 9])
    h2 = P.inv.History()
    h2.events = [dict(ev) for ev in h.events]
    h2.add("journal", leader="B", seqs=[1, 2, 2])
    return [("check_journal_monotone", h, False),
            ("check_journal_monotone", h2, True)]


def _h_slice_map(P):
    """A map that double-assigns a slice, and a move without an epoch
    bump (the broken-plan shapes ``slice_conservation`` vetoes)."""
    h = P.inv.History()
    h.add("shardMap", version=1, n=2, owners={"A": [0, 1], "B": [1]},
          epochs={0: 1, 1: 1}, flows={9000: 0})
    h2 = P.inv.History()
    h2.add("shardMap", version=1, n=2, owners={"A": [0], "B": [1]},
           epochs={0: 1, 1: 1}, flows={9000: 0})
    h2.add("shardMap", version=2, n=2, owners={"B": [0, 1]},
           epochs={0: 1, 1: 1}, flows={9000: 0})
    return [("check_slice_conservation", h, True),
            ("check_slice_conservation", h2, True)]


def _h_slots(P):
    h = P.inv.History()
    h.add("slotAdmit", slot=0, gen=1, resource="r")
    h.add("slotVerdict", slot=0, gen=1, resource="r", sec=0)
    h.add("slotEvict", slot=0, gen=1, resource="r", spilledPass=2)
    h.add("slotRehydrate", slot=1, gen=2, resource="r", fromRecord=True,
          graftedPass=3, stalePass=0)
    h.add("slotAdmit", slot=1, gen=2, resource="r")
    h.add("slotVerdict", slot=0, gen=1, resource="r", sec=1)
    return [("check_slot_conservation", h, True)]


HISTORIES = {
    "clean": _h_clean, "conservation": _h_conservation,
    "no_stranded": _h_no_stranded, "shed_not_half_admitted": _h_shed,
    "overadmission": _h_overadmission, "degraded_bound": _h_degraded,
    "epoch_monotone": _h_epoch, "journal_monotone": _h_journal,
    "slice_conservation": _h_slice_map, "slot_conservation": _h_slots,
}


@pytest.mark.parametrize("case", sorted(HISTORIES))
def test_checkers_fire_as_the_jax_package(case):
    """Each checker fires (or stays quiet) on the reference's histories,
    with violations equal to the JAX package's, field for field."""
    got = {}
    for P in BOTH:
        got[P.name] = []
        for fn, hist, fires in HISTORIES[case](P):
            check = getattr(P.inv, fn)
            vs = check(hist, THRESHOLDS, DIVISOR)
            assert bool(vs) == fires, (P, case, fn, _viol(vs))
            got[P.name].append(_viol(vs))
    assert got["port"] == got["jax"]


def test_checker_registry_matches():
    names = [[name for name, _ in P.inv.CHECKERS] for P in BOTH]
    assert names[0] == names[1]
    assert len(names[1]) == 9


# -- scheduler, initial assignment, shrinker ---------------------------------


@pytest.mark.parametrize("seed,index", [(14, 0), (14, 3), (15, 3), (7, 11)])
def test_schedules_equal_the_jax_package(seed, index):
    for seconds, faults in ((12, 6), (8, 4), (2, 6), (1, 6)):
        scheds = [P.sched.FaultScheduler(seconds=seconds, max_faults=faults)
                  .schedule(seed, index) for P in BOTH]
        assert scheds[1] == scheds[0]
    assert PORT.sched.episode_seed(seed, index) \
        == JAX.sched.episode_seed(seed, index)
    s = PORT.sched.FaultScheduler(seconds=12, max_faults=6)
    assert s.schedule(seed, index) == s.schedule(seed, index)  # pure
    assert PORT.sched.FaultScheduler(seconds=1).schedule(seed, index) == []


def test_initial_assignment_handles_colliding_flow_slices():
    flows = {9000: 6.0, 9002: 6.0}  # both hash to slice 6 (N=8)
    assert PORT.sharding.slice_of(9000, 8) == PORT.sharding.slice_of(9002, 8)
    got = [P.mesh.initial_assignment(("A", "B", "C"), flows, 8)
           for P in BOTH]
    assert got[1] == got[0]
    owners = [m for m, sls in got[1].items() for s in sls if s == 6]
    assert owners == ["A"]
    assert sorted(s for sls in got[1].values() for s in sls) == list(range(8))
    assert PORT.mesh.DEFAULT_FLOWS == JAX.mesh.DEFAULT_FLOWS


def test_ddmin_minimizes_as_the_jax_package():
    items = list(range(12))
    for pred in (lambda s: 3 in s and 7 in s, lambda s: 5 in s,
                 lambda s: len(s) >= 3 and 11 in s):
        got = [P.shrink.ddmin(pred, items) for P in BOTH]
        assert got[1] == got[0]
    minimal, _ = PORT.shrink.ddmin(lambda s: 3 in s and 7 in s, items)
    assert sorted(minimal) == [3, 7]


# -- the real mesh: episode shas on both packages ----------------------------


def _episode(P, index, seed=14, **kw):
    c = P.campaign.ChaosCampaign(campaign_seed=seed, episodes=1, **kw,
                                 **P.kw)
    return c.run_episode(index)


def _episode_view(r):
    return {"schedule": r.schedule, "verdict": r.verdict_sha256,
            "fault": r.fault_sha256, "violations": _viol(r.violations),
            "ops": r.ops, "grants": r.grants, "faultLog": r.fault_log,
            "firstViolationSec": r.first_violation_sec}


@pytest.mark.parametrize("index", range(5))
def test_campaign_episode_shas_match_the_jax_package(index):
    """Seed 14's first five episodes at the campaign's defaults (12 s, 3
    requests per flow per second): same schedule, fault log, verdict and
    fault sha256s, counts, and no violation."""
    j, p = (_episode(P, index) for P in BOTH)
    assert _episode_view(p) == _episode_view(j)
    assert p.violations == []
    assert p.ops == 12 * 3 * 3


def test_episode_replays_bit_identically():
    c = PORT.campaign.ChaosCampaign(campaign_seed=7, episodes=1, seconds=8,
                                    per_second=3, device="cpu")
    a, b = c.run_episode(0), c.run_episode(0)
    assert _episode_view(a) == _episode_view(b)
    assert a.violations == [] and a.ops == 8 * 3 * 3 and a.grants > 0
    assert _episode_view(a) == _episode_view(_episode(JAX, 0, seed=7,
                                                      seconds=8,
                                                      per_second=3))


def test_small_campaign_reports_equal_the_jax_package():
    reports = {}
    for P in BOTH:
        before = P.chaos.counters()
        rep = P.campaign.ChaosCampaign(campaign_seed=14, episodes=3,
                                       seconds=8, per_second=3,
                                       **P.kw).run()
        after = P.chaos.counters()
        assert after["episodes"] - before["episodes"] == 3
        assert after["faultsFired"] > before["faultsFired"]
        assert P.chaos.last_report() is rep
        reports[P.name] = {k: v for k, v in rep.items()
                           if k not in ("wallSeconds", "episodesPerSec")}
    assert reports["port"] == reports["jax"]
    assert reports["port"]["violations"] == 0
    assert reports["port"]["ops"] == 3 * 8 * 3 * 3


def test_reintroduced_known_bug_is_caught_and_shrunk_as_the_jax_package():
    """Degraded-mode amnesty put back: the campaign catches it, shrinks
    the schedule to at most 3 faults, and the bundle (journal joins
    included, ephemeral ports aside) equals the JAX package's."""
    bundles = {}
    for P in BOTH:
        assert "degraded-amnesty" in P.regressions.KNOWN
        c = P.campaign.ChaosCampaign(campaign_seed=7, episodes=4, seconds=8,
                                     per_second=5, stop_on_violation=True,
                                     **P.kw)
        with P.regressions.reintroduce("degraded-amnesty"):
            report = c.run()
        assert not P.regressions.reintroduced("degraded-amnesty")
        assert report["violations"] >= 1 and len(report["bundles"]) == 1
        bundle = report["bundles"][0]
        assert {v["invariant"] for v in bundle["violations"]} \
            == {"degraded_bound"}
        assert 1 <= len(bundle["minimalSchedule"]) <= 3
        for seat in ("A", "B", "C"):
            j = bundle["journal"][seat]
            assert j["lastSeq"] > 0 and j["tail"] and j["chain"]
            assert j["mapInForce"]["kind"] == "shardMapApply"
        assert c.run_episode(bundle["episode"]).violations == []
        bundles[P.name] = strip_keys(bundle)
    assert bundles["port"] == bundles["jax"]


# -- seams ---------------------------------------------------------------------


def test_torn_checkpoint_write_seam(tmp_path):
    """Error mode keeps the good file, garbage mode publishes a torn one
    that either package's restore rejects as one ValueError."""
    P = PORT
    rules = P.rules.ClusterFlowRuleManager()
    rules.load_rules("default", [P.flow.FlowRule(
        resource="r", count=5, cluster_mode=True,
        cluster_config={"flowId": 900, "thresholdType": 0})])
    svc = P.service(rules)
    svc.request_token(900)
    path = str(tmp_path / "torn.ck")
    P.ckpt.save_cluster_checkpoint(svc, path)
    with P.resilience.FaultInjector(seed=1) as inj:
        inj.arm("checkpoint.torn.write", "error", times=1)
        with pytest.raises(P.resilience.FaultInjected):
            P.ckpt.save_cluster_checkpoint(svc, path)
        assert P.ckpt.restore_cluster_checkpoint(P.service(rules), path) == 1
        inj.arm("checkpoint.torn.write", "garbage", times=1)
        P.ckpt.save_cluster_checkpoint(svc, path)
    for Q in BOTH:
        jrules = Q.rules.ClusterFlowRuleManager()
        jrules.load_rules("default", [Q.flow.FlowRule(
            resource="r", count=5, cluster_mode=True,
            cluster_config={"flowId": 900, "thresholdType": 0})])
        with pytest.raises(ValueError, match="corrupted or truncated"):
            Q.ckpt.restore_cluster_checkpoint(Q.service(jrules), path)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".ckpt.tmp")]


def test_journal_disk_full_seam_degrades_then_restart_resumes(tmp_path):
    got = {}
    for P in BOTH:
        path = str(tmp_path / f"j-{P.name}.jsonl")
        j = P.journal.ControlPlaneJournal(lambda: 1000, path=path)
        j.record("ruleLoad", family="flow")
        with P.resilience.FaultInjector(seed=1) as inj:
            inj.arm("journal.disk.full", "error", times=1)
            assert j.record("ruleLoad", family="flow") == 2
        stats = j.stats()
        assert not stats["durable"] and stats["lastSeq"] == 2
        j.close()
        j2 = P.journal.ControlPlaneJournal(lambda: 2000, path=path)
        seq = j2.record("ruleLoad", family="flow")
        seqs = [r["seq"] for r in j2.replay()]
        assert seq > 1 and seqs == sorted(set(seqs))
        j2.close()
        got[P.name] = (seq, seqs)
    assert got["port"] == got["jax"]


# -- the slot-table storm campaign ----------------------------------------------


def test_slot_storm_episodes_match_the_jax_package():
    """``SlotStormCampaign`` (seed 7, 5 s): both faults land, the episode
    replays, and its verdict and tenancy shas equal the JAX package's."""
    from sentinel_tpu.core.context import replace_context as jreplace
    from sentinel_tpu_torch.core.context import (
        bump_generation,
        replace_context,
    )

    results = {}
    try:
        for P in BOTH:
            if P is PORT:
                replace_context(None)
                bump_generation()
            else:
                jreplace(None)
            camp = P.slot_storm.SlotStormCampaign(campaign_seed=7,
                                                  episodes=2, seconds=5,
                                                  **P.kw)
            r0, r1 = camp.run_episode(0), camp.run_episode(1)
            results[P.name] = [(r.verdict_sha256, r.tenancy_sha256,
                                _viol(r.violations), r.entries,
                                {k: r.status.get(k) for k in (
                                    "stormsTotal", "evictionsTotal",
                                    "rehydrationsTotal", "spillTornTotal")})
                               for r in (r0, r1)]
            assert not r0.violations and not r1.violations
            assert r0.entries == 5 * camp.per_second
            assert sum(r.status["stormsTotal"] for r in (r0, r1)) >= 2
            if P is PORT:
                again = camp.run_episode(0)
                assert (again.verdict_sha256, again.tenancy_sha256) \
                    == (r0.verdict_sha256, r0.tenancy_sha256)
    finally:
        replace_context(None)
        bump_generation()
        jreplace(None)
    assert results["port"] == results["jax"]


# -- slow: the whole campaigns ----------------------------------------------------


@pytest.mark.slow
def test_medium_campaign_zero_violations():
    report = PORT.campaign.ChaosCampaign(campaign_seed=14, episodes=25,
                                         device="cpu").run()
    assert report["episodesRun"] == 25 and report["violations"] == 0


@pytest.mark.slow
def test_campaign_200_episodes_reproduces_the_bench_anchors():
    """The bench record's acceptance campaign on the port's CPU run:
    seed 14, 200 episodes, 0 violations and both campaign sha256s."""
    report = PORT.campaign.ChaosCampaign(campaign_seed=14, episodes=200,
                                         device="cpu").run()
    assert report["episodesRun"] == 200 and report["violations"] == 0
    assert report["verdictSha256"] == ANCHOR_VERDICT
    assert report["faultSha256"] == ANCHOR_FAULT


@pytest.mark.slow
def test_slot_storm_campaign_100_episodes():
    from sentinel_tpu_torch.core.context import (
        bump_generation,
        replace_context,
    )

    try:
        rep = PORT.slot_storm.SlotStormCampaign(
            campaign_seed=20, episodes=100, seconds=6, device="cpu").run()
    finally:
        replace_context(None)
        bump_generation()
    assert rep["episodes"] == 100
    assert rep["violations"] == 0, rep["firstViolation"]
