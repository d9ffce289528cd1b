"""The SEMANTICS.md safety bounds as executable invariant checkers (port
of ``sentinel_tpu/chaos/invariants.py``).

Every checker is a pure function over an episode's recorded
:class:`History` — no live mesh access — so the same checkers run (a)
continuously during a campaign episode, (b) after it, and (c) in unit
tests against HAND-BUILT violating histories (a checker that cannot
fire is decoration; the tests prove each one can).

The catalogue (docs/SEMANTICS.md "Invariant catalogue" maps each to
its prose proof):

* ``conservation`` — pass + block + shed + dropped == offered, per flow
* ``no_stranded`` — every offered op gets exactly ONE terminal verdict
  (no stranded tickets/replies after connection death)
* ``shed_not_half_admitted`` — a leader that shed an op consumed
  nothing for it (shed is pre-admission)
* ``overadmission`` — per (flow, window): effective wire grants <=
  threshold + the handoff margin (grants already standing in the
  window at each ownership transfer) — the per-slice fencing bound
* ``degraded_bound`` — per (flow, window): degraded grants <= the
  per-client share (threshold / divisor)
* ``epoch_monotone`` — the client fence never ACCEPTS an epoch below
  one it already accepted for the same slice lane
* ``journal_monotone`` — each seat's durable journal seq stream is
  strictly increasing, including across crash/restart recovery
* ``slice_conservation`` — every slice has exactly one owner at every
  fence epoch (a move without an epoch bump cannot fence the donor),
  and per-slice over-admission stays within the summed grants-since-
  last-publish bound — the invariant the shard rebalancer
  certifies a plan against before apply
* ``slot_conservation`` — the slot-table admission ledger:
  per device slot, admits and evicts strictly alternate at strictly
  increasing generations; every ``slotVerdict`` is attributed to
  exactly ONE (resource, generation) — the slot's standing tenant at
  that point in the stream, never a stale or future occupant of a
  reused slot; and every evict→rehydrate round trip conserves window
  state (grafted + stale window passes never exceed the pass count
  spilled at eviction, and a TORN spill can only rehydrate cold)

Deliberate asymmetries (also in SEMANTICS.md): a verdict granted
server-side whose reply is lost (half-open swallow, fence rejection)
is recorded as ``grantVoid`` — quota was consumed but no request was
admitted, so it counts toward NEITHER conservation's pass column NOR
the over-admission bound (the lost-reply double-count stance).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, NamedTuple, Tuple


class Violation(NamedTuple):
    invariant: str
    detail: str
    flow: object = None
    second: object = None

    def to_dict(self) -> dict:
        return {"invariant": self.invariant, "detail": self.detail,
                "flow": self.flow, "second": self.second}


class History:
    """An episode's ordered event log. Events are plain dicts with an
    ``e`` kind tag — hand-buildable in tests, hashable for replay
    oracles, and cheap to scan."""

    __slots__ = ("events",)

    # Terminal verdict categories (the conservation columns).
    TERMINAL = ("pass", "block", "shed", "dropped")

    def __init__(self):
        self.events: List[dict] = []

    def add(self, e: str, **fields) -> dict:
        fields["e"] = e
        self.events.append(fields)
        return fields

    def of(self, kind: str) -> List[dict]:
        return [ev for ev in self.events if ev["e"] == kind]


def check_conservation(history: History, thresholds, divisor) \
        -> List[Violation]:
    offered = Counter(ev["flow"] for ev in history.of("offered"))
    out: List[Violation] = []
    verdicts = history.of("verdict")
    by_flow: Dict[object, Counter] = defaultdict(Counter)
    for ev in verdicts:
        if ev["status"] not in History.TERMINAL:
            out.append(Violation(
                "conservation",
                f"op {ev.get('op')} carries unknown terminal status "
                f"{ev['status']!r}", flow=ev.get("flow"),
                second=ev.get("sec")))
            continue
        by_flow[ev["flow"]][ev["status"]] += 1
    for flow, n_offered in sorted(offered.items(), key=lambda kv: str(kv[0])):
        got = sum(by_flow[flow].values())
        if got != n_offered:
            out.append(Violation(
                "conservation",
                f"flow {flow}: offered {n_offered} != "
                f"pass+block+shed+dropped {got} ({dict(by_flow[flow])})",
                flow=flow))
    return out


def check_no_stranded(history: History, thresholds, divisor) \
        -> List[Violation]:
    offered = [ev["op"] for ev in history.of("offered")]
    verdict_ops = Counter(ev["op"] for ev in history.of("verdict"))
    out: List[Violation] = []
    for op in offered:
        n = verdict_ops.get(op, 0)
        if n == 0:
            out.append(Violation(
                "no_stranded", f"op {op} never received a terminal "
                "verdict (stranded ticket/reply)"))
        elif n > 1:
            out.append(Violation(
                "no_stranded", f"op {op} received {n} terminal verdicts"))
    return out


def check_shed_not_half_admitted(history: History, thresholds, divisor) \
        -> List[Violation]:
    granted_at = {(ev["op"], ev["leader"])
                  for ev in history.events
                  if ev["e"] in ("grant", "grantVoid")}
    out: List[Violation] = []
    for ev in history.of("shedBy"):
        if (ev["op"], ev["leader"]) in granted_at:
            out.append(Violation(
                "shed_not_half_admitted",
                f"leader {ev['leader']} shed op {ev['op']} AND consumed "
                "quota for it (half-admitted shed)", flow=ev.get("flow")))
    return out


def check_overadmission(history: History,
                        thresholds: Dict[int, Tuple[float, int]],
                        divisor) -> List[Violation]:
    """Per (flow, window): effective wire grants <= threshold + margin.

    The margin is credited at each ownership TRANSFER of the flow's
    slice: everything already granted in the transfer's window (and the
    one before it — restored stale rows rotate across the boundary) may
    be re-admitted by the recipient up to the grants-since-last-publish
    bound, so the allowance grows by the standing count. This is a
    deliberately LOOSE (sound) version of the SEMANTICS.md per-slice
    fencing bound: correct code can never exceed it, and an unfenced
    double-granting donor blows through it within one window."""
    counts: Dict[tuple, int] = defaultdict(int)
    margins: Dict[tuple, float] = defaultdict(float)
    for ev in history.events:
        if ev["e"] == "grant":
            counts[(ev["flow"], ev["win"])] += 1
        elif ev["e"] == "transfer":
            flow, win = ev["flow"], ev["win"]
            interval = max(1, int(thresholds.get(flow, (0, 1000))[1]))
            standing = counts[(flow, win)] + counts[(flow, win - interval)]
            for w in (win, win + interval):
                margins[(flow, w)] += standing
    out: List[Violation] = []
    for (flow, win), n in sorted(counts.items(), key=str):
        info = thresholds.get(flow)
        if info is None:
            continue
        allowed = float(info[0]) + margins.get((flow, win), 0.0)
        if n > allowed + 1e-9:
            out.append(Violation(
                "overadmission",
                f"flow {flow} window {win}: {n} wire grants > "
                f"threshold {info[0]} + margin "
                f"{margins.get((flow, win), 0.0)}", flow=flow))
    return out


def check_degraded_bound(history: History,
                         thresholds: Dict[int, Tuple[float, int]],
                         divisor: int) -> List[Violation]:
    counts: Dict[tuple, int] = defaultdict(int)
    for ev in history.of("degradedGrant"):
        counts[(ev["flow"], ev["win"])] += 1
    out: List[Violation] = []
    for (flow, win), n in sorted(counts.items(), key=str):
        info = thresholds.get(flow)
        if info is None:
            continue
        share = float(info[0]) / max(1, int(divisor))
        if n > share + 1e-9:
            out.append(Violation(
                "degraded_bound",
                f"flow {flow} window {win}: {n} degraded grants > "
                f"per-client share {share} (threshold {info[0]} / "
                f"divisor {divisor})", flow=flow))
    return out


def check_epoch_monotone(history: History, thresholds, divisor) \
        -> List[Violation]:
    hi: Dict[object, int] = {}
    out: List[Violation] = []
    for ev in history.of("fence"):
        if not ev.get("accepted"):
            continue
        scope, epoch = ev.get("scope"), int(ev["epoch"])
        if epoch < hi.get(scope, 0):
            out.append(Violation(
                "epoch_monotone",
                f"slice {scope}: accepted epoch {epoch} below the "
                f"lane's high-water mark {hi[scope]} (fence regression)"))
        hi[scope] = max(hi.get(scope, 0), epoch)
    return out


def check_journal_monotone(history: History, thresholds, divisor) \
        -> List[Violation]:
    out: List[Violation] = []
    for ev in history.of("journal"):
        seqs = list(ev.get("seqs") or ())
        for a, b in zip(seqs, seqs[1:]):
            if b <= a:
                out.append(Violation(
                    "journal_monotone",
                    f"seat {ev.get('leader')}: durable journal seq "
                    f"{b} after {a} (non-monotone across "
                    "crash/restart)"))
                break
    return out


def check_slice_conservation(history: History,
                             thresholds: Dict[int, Tuple[float, int]],
                             divisor) -> List[Violation]:
    """Every slice has exactly one owner at every fence epoch, and
    per-slice over-admission stays within the summed grants-since-
    last-publish bound (the invariant the shard rebalancer
    certifies a plan against before it may touch the live mesh).

    Evidence is the ``shardMap`` events each map application records
    (full ownership + per-slice epochs + the flow->slice attribution):

    * structurally, each map must assign every slice to exactly one
      leader — a plan that drops or double-assigns a slice fires here
      before a single request is even driven;
    * across maps, one (slice, fence epoch) pair never names two
      different owners — a move that reuses the standing epoch cannot
      fence the donor (both seats grant at a fence the client
      accepts), which is exactly the broken-plan shape certification
      exists to veto;
    * per (slice, window): total wire grants <= the sum of the slice's
      per-flow allowances (threshold + transfer margin, the same
      arithmetic as ``overadmission``) — the per-slice fold of the
      SEMANTICS.md fencing bound, keyed by window interval so flows on
      different cadences never share a window key."""
    out: List[Violation] = []
    maps = history.of("shardMap")
    flow_slice: Dict[int, int] = {}
    owner_at: Dict[tuple, object] = {}  # (slice, epoch) -> owner
    for ev in maps:
        n = int(ev.get("n", 0))
        owners = ev.get("owners") or {}
        claimed: Dict[int, list] = defaultdict(list)
        for mid in sorted(owners):
            for sl in owners[mid]:
                claimed[int(sl)].append(mid)
        for sl in range(n):
            mids = claimed.get(sl, [])
            if len(mids) != 1:
                out.append(Violation(
                    "slice_conservation",
                    f"map v{ev.get('version')}: slice {sl} has "
                    f"{len(mids)} owners ({mids if mids else 'none'})",
                    second=ev.get("sec")))
        epochs = {int(k): int(v)
                  for k, v in (ev.get("epochs") or {}).items()}
        for sl, mids in sorted(claimed.items()):
            if len(mids) != 1 or sl not in epochs:
                continue
            key = (sl, epochs[sl])
            prev = owner_at.setdefault(key, mids[0])
            if prev != mids[0]:
                out.append(Violation(
                    "slice_conservation",
                    f"slice {sl} changed owner {prev} -> {mids[0]} at "
                    f"the SAME fence epoch {epochs[sl]} (a move without "
                    "an epoch bump cannot fence the donor)",
                    second=ev.get("sec")))
        for f, sl in (ev.get("flows") or {}).items():
            flow_slice[int(f)] = int(sl)
    if not flow_slice:
        return out
    counts: Dict[tuple, int] = defaultdict(int)
    margins: Dict[tuple, float] = defaultdict(float)
    for ev in history.events:
        if ev["e"] == "grant":
            counts[(ev["flow"], ev["win"])] += 1
        elif ev["e"] == "transfer":
            flow, win = ev["flow"], ev["win"]
            interval = max(1, int(thresholds.get(flow, (0, 1000))[1]))
            standing = counts[(flow, win)] + counts[(flow, win - interval)]
            for w in (win, win + interval):
                margins[(flow, w)] += standing
    got: Dict[tuple, int] = defaultdict(int)
    allowed: Dict[tuple, float] = defaultdict(float)
    for (flow, win), n_grants in counts.items():
        info = thresholds.get(flow)
        sl = flow_slice.get(int(flow))
        if info is None or sl is None:
            continue
        key = (sl, int(info[1]), win)
        got[key] += n_grants
        allowed[key] += float(info[0]) + margins.get((flow, win), 0.0)
    for key in sorted(got, key=str):
        if got[key] > allowed[key] + 1e-9:
            sl, _interval, win = key
            out.append(Violation(
                "slice_conservation",
                f"slice {sl} window {win}: {got[key]} wire grants > "
                f"summed per-flow allowance {allowed[key]} (per-slice "
                "grants-since-last-publish bound)"))
    return out


def check_slot_conservation(history: History, thresholds, divisor) \
        -> List[Violation]:
    """The slot-table admission ledger (core/slots.py).

    Scans the ordered event stream once, replaying tenancy:

    * ``slotAdmit``/``slotEvict`` strictly alternate per slot, the
      evict names the standing tenant's exact (resource, generation),
      and admit generations are strictly increasing per slot.
    * ``slotVerdict`` attribution: the verdict's (resource, slot, gen)
      must equal the slot's standing tenant — a reused slot must never
      book a verdict against the evicted resource's series (the
      generation-leak defense made executable).
    * ``slotRehydrate`` conservation: ``graftedPass + stalePass`` never
      exceeds the ``spilledPass`` recorded by that resource's most
      recent untorn evict (window passes are a subset of the cumulative
      passes spilled), a from-record graft requires such an evict to
      exist, and a TORN evict forces the next rehydrate cold
      (``fromRecord`` false, nothing grafted).
    """
    out: List[Violation] = []
    standing: Dict[int, Tuple[object, int]] = {}   # slot -> (resource, gen)
    last_gen: Dict[int, int] = {}                  # slot -> last admit gen
    last_evict: Dict[object, dict] = {}            # resource -> evict event
    pending_graft: Dict[int, dict] = {}            # slot -> rehydrate event
    for ev in history.events:
        kind = ev["e"]
        if kind == "slotAdmit":
            slot, gen, res = int(ev["slot"]), int(ev["gen"]), ev["resource"]
            if slot in standing:
                out.append(Violation(
                    "slot_conservation",
                    f"slot {slot}: admit of {res!r}@g{gen} while "
                    f"{standing[slot][0]!r}@g{standing[slot][1]} still "
                    "standing (admits/evicts must alternate)",
                    second=ev.get("sec")))
            if slot in last_gen and gen <= last_gen[slot]:
                out.append(Violation(
                    "slot_conservation",
                    f"slot {slot}: admit generation g{gen} not above the "
                    f"previous admit g{last_gen[slot]} (generations must "
                    "strictly increase per slot)"))
            graft = pending_graft.pop(slot, None)
            if graft is not None and (graft["resource"] != res
                                      or int(graft["gen"]) != gen):
                out.append(Violation(
                    "slot_conservation",
                    f"slot {slot}: rehydrate of {graft['resource']!r}"
                    f"@g{graft['gen']} not claimed by the admit that "
                    f"followed it ({res!r}@g{gen})"))
            standing[slot] = (res, gen)
            last_gen[slot] = gen
        elif kind == "slotEvict":
            slot, gen, res = int(ev["slot"]), int(ev["gen"]), ev["resource"]
            cur = standing.pop(slot, None)
            if cur is None:
                out.append(Violation(
                    "slot_conservation",
                    f"slot {slot}: evict of {res!r}@g{gen} from an "
                    "unoccupied slot"))
            elif cur != (res, gen):
                out.append(Violation(
                    "slot_conservation",
                    f"slot {slot}: evict names {res!r}@g{gen} but the "
                    f"standing tenant is {cur[0]!r}@g{cur[1]}"))
            last_evict[res] = ev
        elif kind == "slotRehydrate":
            slot, res = int(ev["slot"]), ev["resource"]
            grafted = int(ev.get("graftedPass", 0))
            stale = int(ev.get("stalePass", 0))
            prior = last_evict.get(res)
            if ev.get("fromRecord"):
                if prior is None:
                    out.append(Violation(
                        "slot_conservation",
                        f"{res!r}: rehydrate claims a spill record but no "
                        "evict of that resource precedes it"))
                elif prior.get("torn"):
                    out.append(Violation(
                        "slot_conservation",
                        f"{res!r}: rehydrate claims a spill record but the "
                        "most recent evict was TORN (a torn spill must "
                        "rehydrate cold)"))
                elif grafted + stale > int(prior.get("spilledPass", 0)):
                    out.append(Violation(
                        "slot_conservation",
                        f"{res!r}: rehydrate grafted {grafted}+{stale} "
                        f"window passes > {prior.get('spilledPass')} "
                        "passes spilled at eviction (round-trip must "
                        "conserve window state)"))
            elif grafted or stale:
                out.append(Violation(
                    "slot_conservation",
                    f"{res!r}: cold rehydrate (no record) reports "
                    f"grafted={grafted} stale={stale} — nothing may be "
                    "grafted without a spill record"))
            pending_graft[slot] = ev
        elif kind == "slotVerdict":
            slot, gen, res = int(ev["slot"]), int(ev["gen"]), ev["resource"]
            if slot < 0:
                # Cold-lane verdict: attributed to the COLD generation,
                # never to device-slot tenancy — but it must SAY so.
                if gen >= 0:
                    out.append(Violation(
                        "slot_conservation",
                        f"{res!r}: cold-lane verdict (slot {slot}) claims "
                        f"device generation g{gen}", second=ev.get("sec")))
                continue
            cur = standing.get(slot)
            if cur is None:
                out.append(Violation(
                    "slot_conservation",
                    f"slot {slot}: verdict for {res!r}@g{gen} booked "
                    "against an unoccupied slot", second=ev.get("sec")))
            elif cur != (res, gen):
                out.append(Violation(
                    "slot_conservation",
                    f"slot {slot}: verdict for {res!r}@g{gen} but the "
                    f"standing tenant is {cur[0]!r}@g{cur[1]} (every "
                    "verdict must attribute to exactly one "
                    "(resource, generation))", second=ev.get("sec")))
    return out


CHECKERS = (
    ("conservation", check_conservation),
    ("no_stranded", check_no_stranded),
    ("shed_not_half_admitted", check_shed_not_half_admitted),
    ("overadmission", check_overadmission),
    ("degraded_bound", check_degraded_bound),
    ("epoch_monotone", check_epoch_monotone),
    ("journal_monotone", check_journal_monotone),
    ("slice_conservation", check_slice_conservation),
    ("slot_conservation", check_slot_conservation),
)


def check_all(history: History, thresholds: Dict[int, Tuple[float, int]],
              divisor: int) -> List[Violation]:
    out: List[Violation] = []
    for _name, fn in CHECKERS:
        out.extend(fn(history, thresholds, divisor))
    return out
