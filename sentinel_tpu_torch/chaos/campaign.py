"""The chaos campaign: seed-replayable episodes, continuous invariant
checking, auto-shrinking counterexamples, forensic bundles.

An episode is a pure function of ``(campaign_seed, episode_index)``:
fresh mesh in a throwaway workdir, the scheduled faults of
``FaultScheduler.schedule``, a fixed per-second workload, the
``SimClock`` program-advanced timebase injected into every
timing-sensitive component (never the process clock — a campaign can
run beside a live engine), and a seeded ``FaultInjector`` whose
per-point RNG streams cannot interfere.
Re-running any episode from its seed reproduces the fault firing
sequence and the verdict stream BIT-IDENTICALLY (sha256 oracles, held to
the JAX package's on the same seeds).

A violation triggers :func:`~sentinel_tpu_torch.chaos.shrink.ddmin` over the
episode's schedule and comes back as a forensic bundle: the violation,
the minimal still-failing schedule, and each seat's audit-journal join
(tail + causeSeq chain + the shard map in force at the violation
second) — a committed-artifact repro, not a flaky log line.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional

from sentinel_tpu_torch import chaos as _pkg
from sentinel_tpu_torch.chaos.invariants import History, check_all
from sentinel_tpu_torch.chaos.mesh import DEFAULT_FLOWS, ChaosMesh
from sentinel_tpu_torch.chaos.scheduler import FaultScheduler, episode_seed
from sentinel_tpu_torch.chaos.shrink import ddmin
from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.resilience import FaultInjector
from sentinel_tpu_torch.simulator.clock import SimClock


class EpisodeResult(NamedTuple):
    index: int
    seed: int
    schedule: List[dict]
    verdict_sha256: str
    fault_sha256: str
    violations: List
    ops: int
    grants: int
    fault_log: List[tuple]
    journals: Dict[str, dict]
    first_violation_sec: Optional[int]

    def to_dict(self) -> dict:
        return {
            "episode": self.index, "episodeSeed": self.seed,
            "schedule": self.schedule,
            "verdictSha256": self.verdict_sha256,
            "faultSha256": self.fault_sha256,
            "violations": [v.to_dict() for v in self.violations],
            "ops": self.ops, "grants": self.grants,
            "firstViolationSec": self.first_violation_sec,
        }


def _sha(lines) -> str:
    import hashlib

    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode("utf-8"))
        h.update(b"\n")
    return h.hexdigest()


class ChaosCampaign:
    """N seed-replayable episodes over the full seam set."""

    def __init__(self, campaign_seed: int = 0, episodes: Optional[int] = None,
                 seconds: Optional[int] = None, per_second: int = 3,
                 max_faults: Optional[int] = None,
                 leaders=("A", "B", "C"), n_slices: int = 8,
                 flows: Optional[Dict[int, float]] = None,
                 regressions=(), shrink: bool = True,
                 stop_on_violation: bool = True,
                 shrink_max_runs: int = 64, device=None):
        from sentinel_tpu_torch.utils.device import resolve_device

        # Every episode's mesh runs its leaders here (cuda by default).
        self.device = resolve_device(device)
        self.campaign_seed = int(campaign_seed)
        self.episodes = int(episodes if episodes is not None
                            else config.chaos_episodes())
        self.seconds = int(seconds if seconds is not None
                           else config.chaos_seconds_per_episode())
        self.per_second = max(1, int(per_second))
        self.max_faults = int(max_faults if max_faults is not None
                              else config.chaos_max_faults())
        self.leaders = tuple(leaders)
        self.n_slices = int(n_slices)
        self.flows = dict(flows) if flows else dict(DEFAULT_FLOWS)
        self.regressions = tuple(regressions)
        self.shrink = bool(shrink)
        self.stop_on_violation = bool(stop_on_violation)
        self.shrink_max_runs = int(shrink_max_runs)
        self.epoch_ms = config.chaos_epoch_ms()
        self.scheduler = FaultScheduler(
            leaders=self.leaders, flows=self.flows, n_slices=self.n_slices,
            seconds=self.seconds, max_faults=self.max_faults)

    # -- one episode -------------------------------------------------------

    def episode_schedule(self, index: int) -> List[dict]:
        return self.scheduler.schedule(self.campaign_seed, index)

    def run_episode(self, index: int,
                    schedule: Optional[List[dict]] = None) -> EpisodeResult:
        sched = (self.episode_schedule(index) if schedule is None
                 else list(schedule))
        seed = episode_seed(self.campaign_seed, index)
        workdir = tempfile.mkdtemp(prefix="sentinel-chaos-")
        clock = SimClock(self.epoch_ms)
        history = History()
        mesh = None
        violations: List = []
        first_violation_sec: Optional[int] = None
        journals: Dict[str, dict] = {}
        try:
            # scope_thread: the whole fault surface fires on THIS episode
            # thread — a live host engine's own threads can neither eat
            # the schedule's fault budget (replay drift) nor suffer its
            # faults (blast-radius bleed).
            with FaultInjector(seed=seed, scope_thread=True) as injector:
                mesh = ChaosMesh(clock, history, workdir,
                                 leaders=self.leaders,
                                 n_slices=self.n_slices, flows=self.flows,
                                 device=self.device)
                by_sec: Dict[int, List[dict]] = {}
                for act in sched:
                    by_sec.setdefault(int(act["at"]), []).append(act)
                restores: Dict[int, List[str]] = {}
                flow_order = sorted(self.flows)
                for sec in range(self.seconds):
                    for mid in restores.pop(sec, ()):
                        mesh.link_up[mid] = True
                        mesh.log_fault("link.up", mid, sec=sec)
                    for act in by_sec.get(sec, ()):
                        up_at = mesh.apply_action(act, injector, sec)
                        if up_at is not None:
                            restores.setdefault(min(up_at, self.seconds),
                                                []).append(act["leader"])
                    for fid in flow_order:
                        for _ in range(self.per_second):
                            mesh.request(fid, sec)
                    violations = check_all(history, mesh.thresholds,
                                           mesh.divisor)
                    if violations:
                        first_violation_sec = sec
                        break
                    clock.advance(1000)
                mesh.collect_journals()
                if not violations:
                    violations = check_all(history, mesh.thresholds,
                                           mesh.divisor)
                    if violations and first_violation_sec is None:
                        first_violation_sec = self.seconds - 1
                stamp = self.epoch_ms + 1000 * (first_violation_sec or 0)
                journals = mesh.journal_snapshot(stamp)
                fault_log = list(mesh.fault_log)
                verdict_sha = _sha(
                    f"{ev['op']}:{ev['flow']}:{ev['status']}:{ev['by']}"
                    f":{ev.get('wire')}"
                    for ev in history.of("verdict"))
                fault_sha = _sha(repr(entry) for entry in fault_log)
                ops = len(history.of("offered"))
                grants = len(history.of("grant"))
        finally:
            if mesh is not None:
                mesh.stop()
            shutil.rmtree(workdir, ignore_errors=True)
        return EpisodeResult(index, seed, sched, verdict_sha, fault_sha,
                             violations, ops, grants, fault_log, journals,
                             first_violation_sec)

    # -- shrinking + forensics ---------------------------------------------

    def shrink_episode(self, index: int, schedule: List[dict]):
        """ddmin the schedule to a minimal still-failing subset; returns
        ``(minimal_schedule, final_result, runs)``."""
        def predicate(subset) -> bool:
            return bool(self.run_episode(index, schedule=subset).violations)

        minimal, runs = ddmin(predicate, schedule,
                              max_runs=self.shrink_max_runs)
        final = self.run_episode(index, schedule=minimal)
        return minimal, final, runs

    def shrink_and_bundle(self, index: int,
                          result: Optional[EpisodeResult] = None):
        """The public repro surface (campaign loop AND the `chaos
        op=shrink` ops command): replay episode ``index`` (or take the
        caller's just-run ``result``), ddmin its schedule if it
        violates, and return ``(forensic_bundle, shrink_runs)`` —
        ``(None, 0)`` for a clean episode."""
        if result is None:
            result = self.run_episode(index)
        if not result.violations:
            return None, 0
        minimal, final, runs = self.shrink_episode(index, result.schedule)
        return self._bundle(result, minimal, final, runs), runs

    def _bundle(self, result: EpisodeResult, minimal: List[dict],
                final: EpisodeResult, runs: int) -> dict:
        return {
            "campaignSeed": self.campaign_seed,
            "episode": result.index,
            "episodeSeed": result.seed,
            "violations": [v.to_dict() for v in result.violations],
            "schedule": result.schedule,
            "minimalSchedule": minimal,
            "minimalViolations": [v.to_dict() for v in final.violations],
            "shrinkSteps": runs,
            "verdictSha256": result.verdict_sha256,
            "faultSha256": result.fault_sha256,
            "firstViolationSec": result.first_violation_sec,
            # The forensic join: each seat's journal tail, the
            # causeSeq walk from its newest record, and the shard map
            # in force at the violation second.
            "journal": result.journals,
        }

    # -- the campaign ------------------------------------------------------

    def run(self) -> dict:
        import contextlib

        from sentinel_tpu_torch.chaos.regressions import reintroduce

        t0 = time.perf_counter()
        results: List[EpisodeResult] = []
        bundles: List[dict] = []
        shrink_steps = 0
        with contextlib.ExitStack() as stack:
            for name in self.regressions:
                stack.enter_context(reintroduce(name))
            for i in range(self.episodes):
                res = self.run_episode(i)
                results.append(res)
                _pkg._count(episodes=1, faultsFired=len(res.fault_log),
                            violations=len(res.violations))
                if res.violations:
                    if self.shrink:
                        bundle, runs = self.shrink_and_bundle(i, result=res)
                        shrink_steps += runs
                        _pkg._count(shrinkSteps=runs)
                        bundles.append(bundle)
                    else:
                        bundles.append(self._bundle(res, res.schedule,
                                                    res, 0))
                    if self.stop_on_violation:
                        break
        wall = max(time.perf_counter() - t0, 1e-9)
        report = {
            "campaignSeed": self.campaign_seed,
            "episodesPlanned": self.episodes,
            "episodesRun": len(results),
            "secondsPerEpisode": self.seconds,
            "perSecond": self.per_second,
            "maxFaults": self.max_faults,
            "regressions": list(self.regressions),
            "ops": sum(r.ops for r in results),
            "grants": sum(r.grants for r in results),
            "faultsFired": sum(len(r.fault_log) for r in results),
            "violations": sum(len(r.violations) for r in results),
            "shrinkSteps": shrink_steps,
            "bundles": bundles,
            "wallSeconds": round(wall, 3),
            "episodesPerSec": round(len(results) / wall, 3),
            "firstEpisode": results[0].to_dict() if results else None,
            "verdictSha256": _sha(r.verdict_sha256 for r in results),
            "faultSha256": _sha(r.fault_sha256 for r in results),
        }
        _pkg._set_last_report(report)
        return report
