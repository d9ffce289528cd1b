"""The comparison that decides ``correct``: what the program produced
against the plain reference, after the window has closed.

``Replay`` runs the reference over the same rounds, from the same seed, and
counts every verdict (reason and wait) that differs from the program's as
it goes. ``compare`` then counts the committed statistics that differ:
running totals by event and node, the sealed seconds of the flight ring,
the thread gauges, the breakers, and anything the program committed
outside the deployment's nodes. The sum is the one number compared; its
limit is 0 (an exact comparison: every quantity is an integer or a
verdict).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench.generator import Traffic
from portbench.reference import R_PASS, Reference

LIMIT = 0


class Replay:
    """The reference driven round by round as the program was."""

    def __init__(self, cfg: Dict, traffic: Traffic, t0_ms: int,
                 lowered: bool = False):
        self.model = Reference(cfg, lowered=lowered)
        self.traffic = traffic
        self.t0 = int(t0_ms)
        self.rounds = 0
        self.verdicts_differ = 0

    def _round(self, r: int):
        """One round of the reference; returns its (reason, wait)."""
        lanes = self.traffic.entries(r)
        now = self.t0 + r * self.traffic.step_ms
        reason, wait = self.model.entry(now, lanes.resource, lanes.origin,
                                        lanes.key, lanes.count)
        ex = self.traffic.exits(r)
        self.model.exit(now, lanes.resource, lanes.origin, lanes.count,
                        reason == R_PASS, ex.rt_ms, ex.error)
        return reason, wait

    def run(self, rounds: int, verdicts: List[np.ndarray],
            waits: List[Tuple[np.ndarray, np.ndarray]]) -> None:
        """Advance ``rounds`` rounds, counting where the reference's verdict
        differs from the program's ``verdicts[r]`` (reference codes) or
        ``waits[r]`` (lanes with a non-zero wait, and the waits)."""
        for r in range(self.rounds, self.rounds + rounds):
            reason, wait = self._round(r)
            self.verdicts_differ += int(np.count_nonzero(
                verdicts[r] != reason))
            lanes_w, vals_w = waits[r]
            both = np.union1d(lanes_w, np.flatnonzero(wait))
            prog = np.zeros(both.size, np.int64)
            prog[np.searchsorted(both, lanes_w)] = vals_w
            self.verdicts_differ += int(np.count_nonzero(prog != wait[both]))
        self.rounds += rounds

    def verdicts(self, rounds: int) -> Tuple[List, List]:
        """Advance ``rounds`` rounds and return the reference's own
        verdicts and waits in the program's record format (the control
        put in the program's place)."""
        out_v, out_w = [], []
        for r in range(self.rounds, self.rounds + rounds):
            reason, wait = self._round(r)
            out_v.append(reason.astype(np.int8))
            nz = np.flatnonzero(wait)
            out_w.append((nz, wait[nz]))
        self.rounds += rounds
        return out_v, out_w


def compare(prog: Dict, ref: Dict, ring_seconds: int) -> Dict[str, int]:
    """Differing statistics between two snapshots (``Reference.snapshot``
    layout; the program's adds ``outside``). Sealed seconds are compared
    over the last ``ring_seconds`` seconds the reference sealed, which the
    program's ring holds; the ring may also hold the last stepped second,
    sealed by a metric-timer tick after the last round moved the clock
    on, which then equals the reference's staged second."""
    out = {}
    out["totals"] = int(np.count_nonzero(prog["totals"] != ref["totals"]))
    sealed = sorted(ref["seconds"])[-ring_seconds:] if ring_seconds else []
    seconds = 0
    for s in sealed:
        want = ref["seconds"][s]
        got = prog["seconds"].get(s)
        seconds += (int(np.count_nonzero(want)) or 1) if got is None \
            else int(np.count_nonzero(got != want))
    stamp, staged = ref["staging"]
    for s, got in prog["seconds"].items():
        if s == stamp:
            seconds += int(np.count_nonzero(got != staged))
        elif s not in ref["seconds"]:
            seconds += 1
    out["seconds"] = seconds
    out["threads"] = int(np.count_nonzero(prog["threads"] != ref["threads"]))
    pb, rb = prog["breakers"], ref["breakers"]
    out["breakers"] = (int(np.count_nonzero(np.any(pb != rb, axis=1)))
                       if pb.shape == rb.shape else max(len(pb), len(rb), 1))
    out["outside"] = int(prog.get("outside", 0))
    return out
