"""Deterministic chaos campaign engine (port of ``sentinel_tpu/chaos/``:
the FoundationDB move applied to the sharded mesh).

The repo's safety story lives in docs/SEMANTICS.md as prose proofs and
in hand-written chaos tests that explore exactly the schedules their
authors imagined. This package closes the gap with a GENERATOR:

* :mod:`~sentinel_tpu_torch.chaos.mesh` — a real in-process multi-leader
  sharded mesh (``ClusterHAManager`` seats with loopback reactors,
  real checkpoint/journal files, the real ``ShardedTokenClient`` walk)
  driven single-threaded on a program-advanced clock, so every episode
  is a pure function of its inputs.
* :mod:`~sentinel_tpu_torch.chaos.scheduler` — ``FaultScheduler``: composes
  randomized fault schedules over the ``resilience/faults.py`` seams
  plus the mesh-level actions (crash, rebalance, link loss, clock
  skew); each schedule is a pure function of
  ``(campaign_seed, episode_index)``.
* :mod:`~sentinel_tpu_torch.chaos.invariants` — the SEMANTICS.md bounds as
  executable checkers over an episode's recorded history.
* :mod:`~sentinel_tpu_torch.chaos.shrink` — delta-debugging: a violating
  schedule is minimized to the smallest still-failing subset.
* :mod:`~sentinel_tpu_torch.chaos.campaign` — ties it together; violations
  come back as forensic bundles joined with the seats' audit journals.
* :mod:`~sentinel_tpu_torch.chaos.regressions` — known-fixed bugs a test can
  deliberately put back (the shrinker's proof-of-life).

Device: the mesh's leaders, the campaign's episodes and the slot storm's
engine run on the ``device`` they are given — ``cuda`` by default, which
raises with no card. Every verdict comes from the injected ``SimClock``,
never from wall time, so an episode's verdict and fault sha256s are the
same on the card, on the CPU and in the JAX package.

This module stays import-light: the exporter reads :func:`counters`
on every scrape, and the ops command reads :func:`last_report`.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counters = {
    "episodes": 0,       # episodes completed in this process
    "violations": 0,     # invariant violations detected
    "faultsFired": 0,    # injector fires + mesh actions executed
    "shrinkSteps": 0,    # shrinker re-runs spent minimizing schedules
}
_last_report = None


def counters() -> dict:
    """Process-wide chaos counters (the ``sentinel_tpu_chaos_*``
    exporter families' source)."""
    with _lock:
        return dict(_counters)


def _count(**deltas) -> None:
    with _lock:
        for k, v in deltas.items():
            _counters[k] += int(v)


def last_report():
    """The newest campaign report run in this process (ops surface)."""
    return _last_report


def _set_last_report(report) -> None:
    global _last_report
    _last_report = report


def run_campaign(*args, **kwargs):
    """Convenience: :class:`~sentinel_tpu_torch.chaos.campaign.ChaosCampaign`
    built and run in one call (the bench / ops-command entry point)."""
    from sentinel_tpu_torch.chaos.campaign import ChaosCampaign

    return ChaosCampaign(*args, **kwargs).run()
