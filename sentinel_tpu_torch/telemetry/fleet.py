"""Fleet telemetry federation: N leaders -> one exact mesh-wide view (port
of ``sentinel_tpu/telemetry/fleet.py``; the wire page is the reference's
byte for byte, so either package's collector federates either package's
leaders).

Every other telemetry layer (attribution, flight recorder, spans, SLO
health) is per-process. This module is the mesh-wide half:

* **Leader side** — :func:`leader_fleet_payload` renders one page of a
  leader's per-second flight-recorder spill (COMPLETE seconds strictly
  after the caller's cursor), its instance health, and its shard
  ownership as the ``fleetTelemetry`` wire reply (``MSG_FLEET`` —
  served by both frontends through ``process_control_frame``, so the
  reactor's zero-copy path carries it for free). Pages are bounded to
  fit the u16 frame; the cursor loops for more.
* **Collector side** — :class:`FleetView` polls N leaders over plain
  token-client sockets and federates their pages into an EXACT
  fleet-wide per-second series keyed by (stamp, resource, leader):
  per-leader cells are stored verbatim (bit-exact — federation never
  re-aggregates device numbers, it only sums them at read time), with
  per-leader staleness and clock-skew tracking, and fleet health as
  the composition (min) of the SLO engine's instance healths.

Exactness contract (docs/SEMANTICS.md "Fleet-series exactness"): the
fleet sum for (resource, stamp) equals the arithmetic sum of each
leader's own ``timeseries_view`` cell for that second — COMPLETE
seconds only; a second is *settled* fleet-wide once every non-stale
leader's cursor has advanced past it (``settled_through_ms``).
In-progress seconds remain per-leader only — the one asymmetry.

Clocks: everything here rides an injected clock (the collector is
usually handed ``engine.now_ms``) — ``tests/test_torch_fleet.py`` pins
that no wall clock is read in this module, the same determinism stance
as the journal.

``FleetView.slice_loads`` is the shard rebalancer's per-slice fold
(``cluster/rebalance.py``), attributed through ``cluster/sharding.py:
slice_of``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional

# Frame body budget for one fleetTelemetry reply entity: the TLV frame
# length field is u16; leave headroom for the response head + epoch TLV.
MAX_ENTITY_BYTES = 64_000

# Page-loop bound per poll cycle: a freshly attached collector catching
# up on a long-retained leader pulls at most this many pages per poll
# (the next poll continues from the cursor — bounded work per tick).
MAX_PAGES_PER_POLL = 8

_SUM_FIELDS = ("pass", "block", "success", "exception", "rtSumMs",
               "occupiedPass")


class LeaderSpec(NamedTuple):
    name: str
    host: str
    port: int


# -- leader side --------------------------------------------------------------


def leader_fleet_payload(server, since_ms: int, max_seconds: int) -> bytes:
    """One encoded ``fleetTelemetry`` reply entity for this leader:
    complete seconds strictly after ``since_ms`` (at most
    ``max_seconds``, further shrunk to fit the frame), instance health,
    and shard ownership. The caller stamps the epoch TLV behind it."""
    from sentinel_tpu_torch.cluster import codec
    from sentinel_tpu_torch.core.config import config as _cfg
    from sentinel_tpu_torch.telemetry.timeseries import second_to_dict

    engine = server.engine
    cap = _cfg.fleet_max_seconds()
    k = max(1, min(int(max_seconds) if max_seconds > 0 else cap, cap))
    # Fold + spill first so the answer is current through the newest
    # complete second, then page on the COMPACT records and render only
    # the served page (a catching-up collector must not pay an
    # O(retention) JSON render per 16-second page).
    engine.slo_refresh()
    recs = engine.timeseries.query(start_ms=int(since_ms) + 1)
    metas = engine._device_metas()
    service = server.service
    shard = getattr(service, "shard", None)
    base = {
        "v": 1,
        "leader": _cfg.cluster_ha_machine_id() or _cfg.app_name(),
        "nowMs": engine.now_ms(),
        "epoch": int(getattr(service, "epoch", 0)),
        "shard": ({
            "mapVersion": int(shard.version),
            "nSlices": int(shard.n_slices),
            "slices": {str(sl): int(ep)
                       for sl, ep in sorted(shard.epochs.items())},
        } if shard is not None else None),
        "health": engine.slo.health_scores(),
        "lastStampMs": max(engine.timeseries.last_stamp_ms,
                           recs[-1].stamp_ms if recs else -1),
    }
    while True:
        page = [second_to_dict(r, metas) for r in recs[:k]]
        payload = dict(base)
        payload["seconds"] = page
        payload["moreAfterMs"] = (page[-1]["timestamp"]
                                  if len(recs) > len(page) and page
                                  else None)
        entity = codec.encode_json_entity(payload)
        if len(entity) <= MAX_ENTITY_BYTES:
            return entity
        if k > 1:
            k = k // 2
            continue
        # A SINGLE second too fat for the frame: skip it LOUDLY rather
        # than stall the cursor forever — the page names the skipped
        # stamp so the collector advances past it and counts the drop.
        payload["seconds"] = []
        payload["skippedSecondMs"] = recs[0].stamp_ms
        payload["moreAfterMs"] = (recs[0].stamp_ms if len(recs) > 1
                                  else None)
        return codec.encode_json_entity(payload)


def leader_population_payload(server) -> bytes:
    """One encoded population page for this leader: the
    namespace telescope's mergeable sketches, current through the spill
    fold, sized to the same frame budget as a telemetry page. Served
    through the SAME ``MSG_FLEET`` message — a request with the
    ``max_seconds == -1`` sentinel selects this page, so a pre-telescope
    server transparently answers with a normal seconds page instead
    (the missing ``population`` key marks it unsupported client-side)."""
    from sentinel_tpu_torch.cluster import codec
    from sentinel_tpu_torch.core.config import config as _cfg

    engine = server.engine
    tracker = getattr(engine, "population", None) if engine is not None \
        else None
    if engine is not None:
        engine.slo_refresh()  # fold first: the page is current
    payload = {
        "v": 1,
        "leader": _cfg.cluster_ha_machine_id() or _cfg.app_name(),
        "nowMs": engine.now_ms() if engine is not None else 0,
        "epoch": int(getattr(server.service, "epoch", 0)),
        "population": (tracker.page(max_bytes=MAX_ENTITY_BYTES - 512)
                       if tracker is not None and tracker.enabled
                       else None),
    }
    return codec.encode_json_entity(payload)


# -- collector side -----------------------------------------------------------


class _LeaderState:
    __slots__ = ("spec", "client", "cursor_ms", "last_stamp_ms",
                 "last_ok_ms", "skew_ms", "polls", "errors", "unsupported",
                 "health", "shard", "epoch", "max_epoch", "epoch_regressed",
                 "seconds_ingested", "seconds_skipped", "remote_name",
                 "population", "population_at_ms", "population_polls",
                 "population_errors", "population_unsupported")

    def __init__(self, spec: LeaderSpec, client):
        self.spec = spec
        self.client = client
        self.cursor_ms = 0
        self.last_stamp_ms = -1
        self.last_ok_ms = -1   # collector clock at last successful payload
        self.skew_ms: Optional[int] = None
        self.polls = 0
        self.errors = 0
        self.unsupported = False
        self.health: Optional[Dict] = None
        self.shard: Optional[Dict] = None
        self.epoch = 0
        self.max_epoch = 0          # high-water epoch ever reported
        self.epoch_regressed = False
        self.seconds_ingested = 0
        self.seconds_skipped = 0   # fat seconds the leader couldn't frame
        self.remote_name: Optional[str] = None
        self.population: Optional[Dict] = None  # latest page, VERBATIM
        self.population_at_ms = -1
        self.population_polls = 0
        self.population_errors = 0
        self.population_unsupported = False


class FleetView:
    """Federates N leaders' fleetTelemetry pages into one exact view.

    ``leaders``: iterable of (name, host, port) tuples or dicts with
    those keys — ``name`` is the collector-side identity every series
    cell is keyed by (the wire payload's self-reported id is kept as
    ``remoteName`` for cross-checking). ``clock`` is a callable
    returning ms on the collector's timebase (``engine.now_ms``).
    """

    def __init__(self, leaders, clock,
                 stale_ms: Optional[int] = None,
                 history_seconds: Optional[int] = None,
                 max_seconds: Optional[int] = None,
                 client_factory=None):
        from sentinel_tpu_torch.core.config import config as _cfg

        self._clock = clock
        self.stale_ms = int(stale_ms if stale_ms is not None
                            else _cfg.fleet_stale_ms())
        self.history_seconds = int(history_seconds if history_seconds
                                   is not None
                                   else _cfg.fleet_history_seconds())
        self.max_seconds = int(max_seconds if max_seconds is not None
                               else _cfg.fleet_max_seconds())
        if client_factory is None:
            client_factory = self._default_client
        self._lock = threading.Lock()
        # stamp -> resource -> leader name -> the leader's cell, stored
        # VERBATIM (bit-exactness: sums are computed at read time from
        # unmodified per-leader cells).
        self._store: "OrderedDict[int, Dict[str, Dict[str, Dict]]]" = \
            OrderedDict()
        self._leaders: "OrderedDict[str, _LeaderState]" = OrderedDict()
        self.poll_count = 0
        self.poll_errors = 0
        # Validate EVERY spec before starting ANY client: a bad spec
        # halfway through must not leak already-started reader threads
        # (the caller sees the raise and has nothing to stop).
        specs: List[LeaderSpec] = []
        for spec in leaders:
            if isinstance(spec, dict):
                spec = LeaderSpec(str(spec["name"]), str(spec["host"]),
                                  int(spec["port"]))
            else:
                spec = LeaderSpec(str(spec[0]), str(spec[1]), int(spec[2]))
            if any(s.name == spec.name for s in specs):
                raise ValueError(f"duplicate leader name {spec.name!r}")
            specs.append(spec)
        if not specs:
            raise ValueError("FleetView needs at least one leader")
        try:
            for spec in specs:
                self._leaders[spec.name] = _LeaderState(
                    spec, client_factory(spec.host, spec.port))
        except Exception:
            self.stop()  # a factory failure stops the clients it started
            raise

    @staticmethod
    def _default_client(host: str, port: int):
        from sentinel_tpu_torch.cluster.client import ClusterTokenClient

        return ClusterTokenClient(host, port, namespace="fleet").start()

    def wait_connected(self, timeout_s: float = 5.0) -> bool:
        """Best-effort wait until every leader socket is up (drills).
        Event-wait only — no clock read (the bound is poll-counted)."""
        ev = threading.Event()
        for _ in range(max(1, int(timeout_s / 0.05))):
            if all(ls.client.is_connected()
                   for ls in self._leaders.values()):
                return True
            ev.wait(0.05)
        return all(ls.client.is_connected() for ls in self._leaders.values())

    # -- polling -----------------------------------------------------------

    def poll(self) -> Dict[str, int]:
        """One scrape cycle: pull every leader's unserved complete
        seconds (bounded pages per leader). Returns seconds ingested
        per leader name."""
        out: Dict[str, int] = {}
        for name, ls in list(self._leaders.items()):
            out[name] = self._poll_leader(ls)
        self.poll_count += 1
        return out

    def _poll_leader(self, ls: _LeaderState) -> int:
        if ls.unsupported:
            return 0
        ingested = 0
        for _ in range(MAX_PAGES_PER_POLL):
            payload = ls.client.request_fleet_telemetry(
                since_ms=ls.cursor_ms, max_seconds=self.max_seconds)
            ls.polls += 1
            if payload is None:
                ls.errors += 1
                self.poll_errors += 1
                return ingested
            if payload.get("unsupported"):
                # A stock (pre-fleet) server answered BAD_REQUEST: stop
                # asking — the leader row reports it instead of erroring
                # forever.
                ls.unsupported = True
                return ingested
            ingested += self._ingest(ls, payload)
            if payload.get("moreAfterMs") is None:
                break
        return ingested

    def poll_population(self) -> Dict[str, bool]:
        """One population scrape: pull every leader's current
        telescope page and store it VERBATIM (merging happens at read
        time from unmodified pages — the bit-exactness stance the
        telemetry cells already take). Returns per-leader success."""
        out: Dict[str, bool] = {}
        for name, ls in list(self._leaders.items()):
            if ls.population_unsupported:
                out[name] = False
                continue
            page = ls.client.request_population_page()
            ls.population_polls += 1
            if page is None:
                ls.population_errors += 1
                out[name] = False
                continue
            if page.get("unsupported"):
                ls.population_unsupported = True
                out[name] = False
                continue
            with self._lock:
                ls.population = page
                ls.population_at_ms = self._clock()
            out[name] = True
        return out

    def fleet_population(self, slot_budget: Optional[int] = None,
                         budgets: Optional[List[int]] = None) -> Dict:
        """The fleet-wide telescope: per-leader page summaries plus the
        EXACT merge of every stored page (CMS cell-wise add, HLL
        register max, Space-Saving union with summed floors — see
        docs/SEMANTICS.md). ``slot_budget`` adds an admission-readiness
        report over the merged page; ``budgets`` adds the projection
        curve the dashboard charts."""
        from sentinel_tpu_torch.telemetry import population as pop

        with self._lock:
            pages = []
            leaders: Dict[str, Dict] = {}
            for name, ls in self._leaders.items():
                row: Dict = {
                    "polls": ls.population_polls,
                    "errors": ls.population_errors,
                    "unsupported": ls.population_unsupported,
                    "atMs": ls.population_at_ms,
                }
                if ls.population:
                    pages.append(ls.population)
                    row.update(pop.page_summary(ls.population))
                leaders[name] = row
        merged = pop.merge_pages(pages) if pages else {}
        win_s = max(1, int(merged.get("geom", {}).get("windowMs", 1000))
                    // 1000) if merged else 1
        out: Dict = {
            "leaders": leaders,
            "pagesMerged": len(pages),
            "merged": merged,
            "summary": pop.page_summary(merged) if merged else {},
        }
        if merged and slot_budget is not None:
            out["report"] = pop.report_from_page(merged, slot_budget, win_s)
        if merged and budgets:
            out["curve"] = pop.projection_curve(merged, budgets, win_s)
        return out

    def _ingest(self, ls: _LeaderState, payload: Dict) -> int:
        name = ls.spec.name
        now = int(self._clock())
        with self._lock:
            ls.last_ok_ms = now
            ls.remote_name = payload.get("leader")
            ls.epoch = int(payload.get("epoch") or 0)
            # Leader-restart blind spot: a leader
            # that restarted with a stale epoch looks exactly like an
            # idle-but-alive one on the series alone. Track the
            # high-water epoch so status() can say which it is; the
            # flag clears once the leader re-earns (or re-learns) an
            # epoch at least as new as any it ever reported.
            if ls.epoch < ls.max_epoch:
                ls.epoch_regressed = True
            else:
                ls.max_epoch = ls.epoch
                ls.epoch_regressed = False
            ls.health = payload.get("health")
            ls.shard = payload.get("shard")
            # Signed skew: positive = the leader's clock runs ahead of
            # the collector's (one-way latency rides inside it; the
            # bound is what matters for settling seconds, not the sign).
            ls.skew_ms = int(payload.get("nowMs", now)) - now
            last = payload.get("lastStampMs")
            if isinstance(last, int) and last > ls.last_stamp_ms:
                ls.last_stamp_ms = last
            skipped = payload.get("skippedSecondMs")
            if skipped is not None and int(skipped) > ls.cursor_ms:
                # The leader could not frame this second (too fat for
                # the wire page): advance past it LOUDLY rather than
                # stall the cursor on it forever.
                ls.cursor_ms = int(skipped)
                ls.seconds_skipped += 1
            n = 0
            for sec in payload.get("seconds") or ():
                stamp = int(sec["timestamp"])
                if stamp <= ls.cursor_ms:
                    continue  # replay: first ingest wins
                ls.cursor_ms = stamp
                if stamp > ls.last_stamp_ms:
                    ls.last_stamp_ms = stamp
                cell_map = self._store.setdefault(stamp, {})
                for res, cell in (sec.get("resources") or {}).items():
                    cell_map.setdefault(res, {})[name] = cell
                ls.seconds_ingested += 1
                n += 1
            # Sort BEFORE evicting: stamp order across leaders is not
            # insertion order, and a straggler older than the store's
            # front must be the one evicted — popping first under the
            # stale order would drop an in-window second and keep the
            # out-of-window straggler.
            if n:
                self._store = OrderedDict(sorted(self._store.items()))
            while len(self._store) > self.history_seconds:
                self._store.popitem(last=False)
        return n

    # -- read surfaces -----------------------------------------------------

    @staticmethod
    def _sum_cells(cells: Dict[str, Dict]) -> Dict:
        """The exact fleet cell: arithmetic sum of the per-leader cells
        (ints summed, RT-bucket vectors summed element-wise, per-reason
        maps merged by sum) — nothing re-derived, nothing rounded."""
        fleet: Dict = {f: 0 for f in _SUM_FIELDS}
        fleet["blockByReason"] = {}
        fleet["rtBuckets"] = []
        for cell in cells.values():
            for f in _SUM_FIELDS:
                fleet[f] += int(cell.get(f, 0))
            for reason, v in (cell.get("blockByReason") or {}).items():
                fleet["blockByReason"][reason] = \
                    fleet["blockByReason"].get(reason, 0) + int(v)
            buckets = cell.get("rtBuckets") or []
            if len(buckets) > len(fleet["rtBuckets"]):
                fleet["rtBuckets"].extend(
                    [0] * (len(buckets) - len(fleet["rtBuckets"])))
            for i, v in enumerate(buckets):
                fleet["rtBuckets"][i] += int(v)
        return fleet

    def series(self, resource: Optional[str] = None,
               limit: Optional[int] = None,
               since_ms: Optional[int] = None) -> List[Dict]:
        """The federated per-second series, chronological: each second
        carries the exact fleet sum AND the per-leader split per
        resource (keyed by (resource, leader); slice ownership rides
        ``status()``'s per-leader block)."""
        with self._lock:
            items = [(t, {res: dict(leaders)
                          for res, leaders in cell_map.items()})
                     for t, cell_map in self._store.items()]
        if since_ms is not None:
            items = [it for it in items if it[0] > since_ms]
        if limit is not None and limit >= 0:
            items = items[-limit:] if limit > 0 else []
        out = []
        for stamp, cell_map in items:
            resources = {}
            for res, leaders in cell_map.items():
                if resource is not None and res != resource:
                    continue
                resources[res] = {"fleet": self._sum_cells(leaders),
                                  "leaders": leaders}
            if resource is not None and not resources:
                continue
            out.append({"timestamp": stamp, "resources": resources})
        return out

    def slice_loads(self, flow_of, n_slices: int,
                    window_seconds: Optional[int] = None,
                    settled_only: bool = True) -> Dict:
        """Fold the federated series to SLICE granularity:
        per-slice offered load (pass + block) over the newest
        ``window_seconds`` settled seconds, attributed through
        ``flow_of(resource) -> flowId`` and the one ``slice_of``
        implementation — no second hash. Resources without a flowId
        (local-only rules) are counted in ``unattributed`` rather than
        silently dropped, so a skew computed from this fold can always
        be audited against the raw series. ``observedByLeader`` is the
        load each leader actually SERVED over the window (historical
        routing, not current ownership — the rebalancer recomputes
        leader loads from slice loads x the current map)."""
        from sentinel_tpu_torch.cluster.sharding import slice_of

        n = int(n_slices)
        horizon = self.settled_through_ms() if settled_only else None
        secs = self.series()
        if horizon is not None and horizon >= 0:
            secs = [s for s in secs if s["timestamp"] <= horizon]
        if window_seconds is not None and window_seconds > 0:
            secs = secs[-int(window_seconds):]
        slices: Dict[int, int] = {}
        by_leader: Dict[str, int] = {}
        unattributed = 0
        for sec in secs:
            for res, cell in sec["resources"].items():
                fid = flow_of(res)
                sl = slice_of(int(fid), n) if fid is not None else None
                for mid, c in (cell.get("leaders") or {}).items():
                    load = int(c.get("pass", 0)) + int(c.get("block", 0))
                    by_leader[mid] = by_leader.get(mid, 0) + load
                    if sl is None:
                        unattributed += load
                    else:
                        slices[sl] = slices.get(sl, 0) + load
        return {
            "nSlices": n,
            "seconds": len(secs),
            "settledThroughMs": horizon if horizon is not None else -1,
            "slices": slices,
            "observedByLeader": by_leader,
            "unattributed": unattributed,
        }

    def _stale(self, ls: _LeaderState, now: int) -> bool:
        """Stale = out of CONTACT (no successful payload inside the
        bound) — an idle-but-alive leader answers every poll with zero
        new seconds and is NOT stale; a dead/partitioned one is. Data
        age rides beside it as ``stalenessMs``."""
        return ls.last_ok_ms < 0 or now - ls.last_ok_ms > self.stale_ms

    def settled_through_ms(self) -> int:
        """Newest stamp every non-stale leader's cursor has passed:
        fleet sums at or before it can no longer change (complete-
        seconds-only + per-leader monotone cursors). Stale leaders
        don't hold the frontier back — their staleness is reported
        instead (the blast-radius stance: a dead leader degrades ITS
        slices, not the whole fleet's visibility)."""
        now = int(self._clock())
        live = [ls.cursor_ms for ls in self._leaders.values()
                if not self._stale(ls, now)]
        return min(live) if live else -1

    def fleet_health(self) -> Optional[int]:
        """Composition of the SLO engine's instance healths: the fleet is as
        healthy as its least healthy reporting leader."""
        scores = [int(ls.health["instance"])
                  for ls in self._leaders.values()
                  if ls.health and "instance" in ls.health]
        return min(scores) if scores else None

    def status(self) -> Dict:
        now = int(self._clock())
        with self._lock:
            leaders = {}
            for name, ls in self._leaders.items():
                leaders[name] = {
                    "host": ls.spec.host,
                    "port": ls.spec.port,
                    "connected": ls.client.is_connected(),
                    "remoteName": ls.remote_name,
                    "cursorMs": ls.cursor_ms,
                    "lastStampMs": ls.last_stamp_ms,
                    "stalenessMs": (now - ls.last_stamp_ms
                                    if ls.last_stamp_ms >= 0 else None),
                    "lastContactMs": ls.last_ok_ms,
                    # Age of last CONTACT (successful payload), not of
                    # data: "idle but alive" has a small contactAgeMs
                    # and an old lastStampMs; "dead" has both old.
                    "contactAgeMs": (now - ls.last_ok_ms
                                     if ls.last_ok_ms >= 0 else None),
                    "stale": self._stale(ls, now),
                    "skewMs": ls.skew_ms,
                    "polls": ls.polls,
                    "errors": ls.errors,
                    "unsupported": ls.unsupported,
                    "secondsIngested": ls.seconds_ingested,
                    "secondsSkipped": ls.seconds_skipped,
                    "epoch": ls.epoch,
                    "maxEpochSeen": ls.max_epoch,
                    "epochRegressed": ls.epoch_regressed,
                    "health": ls.health,
                    "slicesOwned": (sorted(int(s) for s in
                                           (ls.shard or {}).get("slices", {}))
                                    if ls.shard else []),
                    "mapVersion": (ls.shard or {}).get("mapVersion"),
                }
            retained = len(self._store)
        stale = sum(1 for v in leaders.values() if v["stale"])
        return {
            "leaders": leaders,
            "leaderCount": len(leaders),
            "staleLeaders": stale,
            "fleetHealth": self.fleet_health(),
            "retainedSeconds": retained,
            "settledThroughMs": self.settled_through_ms(),
            "staleAfterMs": self.stale_ms,
            "polls": self.poll_count,
            "pollErrors": self.poll_errors,
        }

    def stop(self) -> None:
        for ls in self._leaders.values():
            try:
                ls.client.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
