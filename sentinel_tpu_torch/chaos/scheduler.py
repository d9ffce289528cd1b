"""Seedable fault-schedule generation (port of
``sentinel_tpu/chaos/scheduler.py``).

A schedule is a PURE FUNCTION of ``(campaign_seed, episode_index)``:
:func:`episode_seed` derives a stable per-episode seed (sha256, no
``hash()`` — process-stable), and :class:`FaultScheduler` draws the
schedule from a ``random.Random`` over that seed while simulating the
plan's cluster state (who is crashed, who owns how many slices) with
the SAME rules the mesh executes, so every generated action is valid
at its scheduled second.

Every action is self-contained — a ``rebalance`` carries the FULL new
assignment and the moved slices' epochs, a ``crash`` on an already-dead
seat is a no-op — so ANY subset of a schedule is executable, which is
exactly what the delta-debugging shrinker needs.
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List

from sentinel_tpu_torch.chaos.mesh import DEFAULT_FLOWS, initial_assignment

# Every kind the mesh can execute; docs/OPERATIONS.md "Chaos campaign"
# documents the catalogue.
ACTION_KINDS = (
    "conn.drop", "conn.stall", "halfopen", "stale.epoch", "link.down",
    "crash", "rebalance", "publish", "torn.publish", "ckpt.crash",
    "journal.full", "journal.restart", "flap", "map.split", "zombie",
    "router.stale", "skew", "overload",
)

# Skew draws: bounded to less than one window so a leader's timebase
# stays monotone against the 1 s request cadence (one skew per leader per
# episode; the window-keyed invariant checkers absorb the boundary
# shifts).
_SKEWS = (-400, 300, 700, 900)


def episode_seed(campaign_seed: int, episode_index: int) -> int:
    digest = hashlib.sha256(
        f"{int(campaign_seed)}:{int(episode_index)}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


class FaultScheduler:
    def __init__(self, leaders=("A", "B", "C"), flows=None, n_slices: int = 8,
                 seconds: int = 12, max_faults: int = 6):
        self.leaders = tuple(leaders)
        self.flows = dict(flows) if flows else dict(DEFAULT_FLOWS)
        self.n_slices = int(n_slices)
        self.seconds = int(seconds)
        self.max_faults = max(1, int(max_faults))

    def schedule(self, campaign_seed: int, episode_index: int) -> List[dict]:
        if self.seconds <= 1:
            # A 1-second episode drives only sec 0 and faults fire from
            # sec 1 — an honestly EMPTY schedule, never actions the
            # episode loop can silently skip.
            return []
        rng = random.Random(episode_seed(campaign_seed, episode_index))
        assignment = initial_assignment(self.leaders, self.flows,
                                        self.n_slices)
        crashed: set = set()
        skewed: set = set()
        epochs: Dict[int, int] = {sl: 1 for sl in range(self.n_slices)}
        version = 1
        n = rng.randint(1, self.max_faults)
        # Draw the firing seconds first and plan IN TIME ORDER, so the
        # plan's simulated cluster state matches execution order.
        ats = sorted(rng.randrange(1, max(2, self.seconds - 1))
                     for _ in range(n))
        actions: List[dict] = []
        for at in ats:
            choices = ["conn.drop", "conn.stall", "halfopen", "stale.epoch",
                       "link.down", "publish", "torn.publish", "ckpt.crash",
                       "journal.full", "journal.restart", "flap",
                       "map.split", "zombie", "router.stale", "skew",
                       "overload"]
            alive = [m for m in self.leaders if m not in crashed]
            if len(alive) > 1:
                choices.append("crash")
            rebal_from = [m for m in self.leaders
                          if (m in crashed and assignment.get(m))
                          or (m not in crashed
                              and len(assignment.get(m, ())) >= 2)]
            if rebal_from and len(alive) >= (1 if crashed else 2):
                choices.append("rebalance")
            kind = rng.choice(choices)
            if kind == "skew":
                fresh = [m for m in self.leaders if m not in skewed]
                if not fresh:
                    kind = "publish"
            if kind == "rebalance":
                frm = rng.choice(sorted(rebal_from))
                to_cands = [m for m in alive if m != frm]
                if not to_cands:
                    kind = "publish"
            if kind == "crash":
                victim = rng.choice(sorted(alive))
                crashed.add(victim)
                actions.append({"at": at, "kind": "crash",
                                "leader": victim})
            elif kind == "rebalance":
                to = rng.choice(sorted(to_cands))
                moved = (list(assignment[frm]) if frm in crashed
                         else [max(assignment[frm])])
                version += 1
                for sl in moved:
                    epochs[sl] = version
                assignment[to] = sorted(set(assignment.get(to, [])) |
                                        set(moved))
                assignment[frm] = sorted(set(assignment.get(frm, [])) -
                                         set(moved))
                actions.append({
                    "at": at, "kind": "rebalance", "frm": frm, "to": to,
                    "assignment": {m: list(s)
                                   for m, s in assignment.items()},
                    "epochs": {int(sl): version for sl in moved},
                    "version": version})
            elif kind == "skew":
                mid = rng.choice(sorted(fresh))
                skewed.add(mid)
                actions.append({"at": at, "kind": "skew", "leader": mid,
                                "ms": rng.choice(_SKEWS)})
            elif kind == "link.down":
                mid = rng.choice(sorted(alive)) if alive else self.leaders[0]
                actions.append({"at": at, "kind": "link.down",
                                "leader": mid,
                                "secs": rng.randint(1, 3)})
            elif kind in ("conn.drop", "conn.stall", "halfopen",
                          "stale.epoch"):
                mid = rng.choice(sorted(alive)) if alive else self.leaders[0]
                actions.append({"at": at, "kind": kind, "leader": mid,
                                "times": rng.randint(1, 4)})
            elif kind == "overload":
                mid = rng.choice(sorted(alive)) if alive else self.leaders[0]
                actions.append({"at": at, "kind": "overload", "leader": mid,
                                "qps": rng.choice((1, 2, 5))})
            elif kind in ("publish", "journal.restart"):
                mid = rng.choice(sorted(alive)) if alive else self.leaders[0]
                actions.append({"at": at, "kind": kind, "leader": mid})
            elif kind == "journal.full":
                actions.append({"at": at, "kind": kind,
                                "times": rng.randint(1, 3)})
            elif kind == "flap":
                mid = rng.choice(sorted(self.leaders))
                actions.append({"at": at, "kind": kind, "leader": mid,
                                "times": 1})
            elif kind == "map.split":
                actions.append({"at": at, "kind": kind,
                                "after": rng.randrange(len(self.leaders))})
            else:  # torn.publish / ckpt.crash / zombie / router.stale
                actions.append({"at": at, "kind": kind})
        return actions
