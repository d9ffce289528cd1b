"""Sharded multi-leader cluster flow control (port of
``sentinel_tpu/cluster/sharding.py``; "Designing Scalable Rate Limiting
Systems" is the blueprint: shard-by-key-space with explicit
rebalancing).

One leader owning the whole flowId space caps cluster admission at one
socket and makes every flow share one blast radius. This module
partitions the key space into a FIXED ring of hash slices (the ring
size never changes for a cluster's lifetime; ownership does):

* :func:`slice_of` — THE one flowId→slice routing helper. Client and
  server must agree byte-for-byte on the mapping or fencing is
  meaningless, so the package has no other implementation of the hash
  (``telemetry/population.py`` imports this one).
* :class:`ShardMap` — the datasource-pushed assignment: which leader
  owns each slice, under WHICH per-slice epoch. Epochs fence each
  slice's leadership independently (a rebalance of slice 3 must not
  invalidate slice 7's standing leader), extending the global
  ``EpochFence`` term to a per-slice term.
* :class:`ShardState` — a leader's server-side view: owned slices with
  their epochs plus the map version. Requests for unowned slices are
  answered with the ``WRONG_SLICE`` wire status carrying the current
  map version, so a stale client self-heals without a config push.
* :class:`ShardedTokenClient` — client-side slice routing: hash the
  flowId, route to the owning leader over a per-leader pipelined
  socket pool, walk the other leaders on WRONG_SLICE (adopting the one
  that answers as a learned override until the next map), and degrade
  PER SLICE: losing leader B starts B's slices' failover-deadline
  clock while A's slices keep serving at full fidelity. Degraded
  verdicts come from the same per-client :class:`DegradedQuota` share
  math as — the sum-of-shares bound holds per flow regardless of
  which slice degraded.

Rebalancing rides the checkpoint grafting path (``core/checkpoint.py``
slice-filtered ``save/restore_cluster_checkpoint``): a handoff
publishes the donor's flowId-keyed rows for the moving slice, fences
the donor (its later replies carry a now-stale slice epoch and are
rejected), and warm-starts the recipient — over-admission across a
handoff bounded by the grants since the donor's last publish, exactly
the single-seat proof applied per slice (docs/SEMANTICS.md
"Per-slice fencing bound").
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

from sentinel_tpu_torch.cluster.constants import TokenResultStatus
from sentinel_tpu_torch.cluster.state import SliceEpochFence
from sentinel_tpu_torch.cluster.token_service import TokenResult
from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.utils import time_util

# 64-bit golden-ratio (Fibonacci) multiplier — the ONE slice-hash
# constant, in this module only: client-side routing and server-side
# ownership checks must agree byte-for-byte, so there is exactly one
# implementation.
_SLICE_MIX = 0x9E3779B97F4A7C15

# Default marker: each pooled socket builds its HealthGate from config
# (``ClusterTokenClient``'s own default). ``health_gate=None`` disables
# the per-leader breaker — the stance timing-sensitive drills take on
# loaded CI boxes, same as the raw client.
_CONFIG_GATE = object()


def slice_of(flow_id: int, n_slices: int) -> int:
    """flowId -> slice in ``[0, n_slices)``.

    Fibonacci hashing rather than a bare modulus so sequential flowIds
    (the common allocation pattern) spread across the ring instead of
    striping, and the mapping stays stable across processes and Python
    versions (no ``hash()``)."""
    x = (int(flow_id) * _SLICE_MIX) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return int(x % int(n_slices))


class ShardMap(NamedTuple):
    """Datasource-pushed slice assignment (the ``shardMap`` converter's
    output): every slice's owning leader and per-slice fencing epoch.
    ``version`` orders whole maps (stale pushes ignored); the per-slice
    ``slice_epoch`` — NOT one global term — is what fences each slice's
    leadership on the wire."""

    version: int
    n_slices: int
    servers: tuple                 # ClusterServerSpec, every leader seat
    slice_owner: Tuple[str, ...]   # [n_slices] machine_id per slice
    slice_epoch: Tuple[int, ...]   # [n_slices] fencing epoch per slice
    clients: Tuple[str, ...] = ()  # client machine ids (share divisor)
    namespace: str = "default"
    request_timeout_ms: int = 2000

    def server_for(self, machine_id: str):
        for s in self.servers:
            if s.machine_id == machine_id:
                return s
        return None

    def slices_of(self, machine_id: str) -> Tuple[int, ...]:
        return tuple(i for i, mid in enumerate(self.slice_owner)
                     if mid == machine_id)

    def epochs_of(self, machine_id: str) -> Dict[int, int]:
        return {i: int(self.slice_epoch[i])
                for i, mid in enumerate(self.slice_owner)
                if mid == machine_id}

    def assignment(self) -> Dict[str, Tuple[int, ...]]:
        """{machine_id: owned slices} for EVERY seat in ``servers`` —
        seats owning nothing still appear (the rebalancer's fold-in
        target set), unlike ``slices_of`` which is per-seat."""
        out: Dict[str, Tuple[int, ...]] = {
            s.machine_id: () for s in self.servers}
        for mid in out:
            out[mid] = self.slices_of(mid)
        return out

    def with_moves(self, moves: Dict[int, str],
                   version: Optional[int] = None) -> "ShardMap":
        """Minimal-movement successor map: ``moves`` is {slice: new
        owner}.  Only moved slices change owner, and ONLY moved slices
        get their fencing epoch bumped (to the new version — per-slice
        fencing means untouched slices keep serving without a grant
        round-trip).  ``version`` defaults to ``self.version + 1``."""
        new_version = int(version) if version is not None \
            else int(self.version) + 1
        owner = list(self.slice_owner)
        epoch = list(self.slice_epoch)
        for sl, mid in moves.items():
            sl = int(sl)
            if owner[sl] != mid:
                owner[sl] = mid
                epoch[sl] = new_version
        return self._replace(version=new_version, slice_owner=tuple(owner),
                             slice_epoch=tuple(epoch))


class ShardState(NamedTuple):
    """A leader's server-side slice ownership (``DefaultTokenService.
    set_shard``): replaced wholesale on every map application, read
    lock-free on the dispatch path."""

    n_slices: int
    version: int
    epochs: Dict[int, int]  # owned slice -> fencing epoch

    def epoch_for_flow(self, flow_id) -> Optional[int]:
        """The owned slice's epoch for this flow, or None when the flow
        hashes outside this leader's slices (-> WRONG_SLICE)."""
        try:
            fid = int(flow_id)
        except (TypeError, ValueError):
            return None
        return self.epochs.get(slice_of(fid, self.n_slices))


class _LeaderHealth:
    """Per-leader lost->degraded state machine (the failover-
    deadline clock, one instance per leader so only the LOST leader's
    slices ever degrade)."""

    __slots__ = ("lost_at_ms", "degraded_since_ms")

    def __init__(self):
        self.lost_at_ms = -1
        self.degraded_since_ms = -1


class ShardedTokenClient:
    """Token client over a :class:`ShardMap`: one pipelined socket per
    DISTINCT leader, flowId-hash routing, per-slice failover.

    Request walk for a flow in slice S (owner = learned override, else
    the map's): try the owner; on WRONG_SLICE or FAIL walk the OTHER
    leaders in map order — a leader that answers with a real verdict
    after a WRONG_SLICE becomes S's learned owner (self-healing on a
    stale map, no config push needed). OVERLOADED backs the leader off
    for its retry-after window exactly as the failover client does. A verdict-free walk
    advances only THIS leader's lost->degraded clock; past the failover
    deadline the flow is served from the per-client
    :class:`~sentinel_tpu_torch.cluster.ha.DegradedQuota` share — while every
    other leader's slices keep full-fidelity verdicts.

    Fencing is per slice: every inner client shares one
    :class:`SliceEpochFence` and derives each response's fence scope
    from the request's flowId via :func:`slice_of` (the server stamps
    only the epoch — both sides recompute the slice with the shared
    helper, which is why there is only one implementation).
    """

    serves_degraded = True  # keeps client_if_active() routing to us

    def __init__(self, smap: ShardMap,
                 request_timeout_s: Optional[float] = None,
                 failover_deadline_ms: Optional[int] = None,
                 degraded=None,
                 fence: Optional[SliceEpochFence] = None,
                 thresholds_fn: Optional[Callable[[], Dict]] = None,
                 reconnect_interval_s: Optional[float] = None,
                 connect_timeout_s: float = 1.0,
                 health_gate=_CONFIG_GATE,
                 spans=None, clock=None):
        from sentinel_tpu_torch.cluster.ha import DegradedQuota

        # Clock-injection seam (the SentinelEngine(clock=) discipline —
        # every backoff / lost->degraded / failover-stamp
        # read goes through _now(), so the chaos campaign drives the
        # routing state machines on its program-advanced timebase with
        # NO process-global clock freeze. None = the process clock.
        self._now = (clock if clock is not None
                     else time_util.current_time_millis)

        # Cross-leader span stitching: with a SpanCollector
        # attached, any walk that does more than hit the owner (a
        # WRONG_SLICE self-heal hop, a failover walk, a degraded
        # verdict) records one ``cluster.slice_walk`` span whose hop
        # list shows the whole route — joined to the caller's trace
        # when the acquire rides one, sampled standalone otherwise.
        self.spans = spans

        if not smap.servers:
            raise ValueError("sharded client needs at least one leader")
        self.fence = fence or SliceEpochFence()
        self.failover_deadline_ms = int(
            failover_deadline_ms if failover_deadline_ms is not None
            else config.cluster_ha_failover_deadline_ms())
        if reconnect_interval_s is None:
            reconnect_interval_s = config.cluster_ha_reconnect_ms() / 1000.0
        self._reconnect_interval_s = reconnect_interval_s
        self._connect_timeout_s = connect_timeout_s
        self._health_gate_opt = health_gate
        self.degraded = degraded or DegradedQuota(
            divisor=len(smap.clients) if smap.clients else None,
            thresholds_fn=thresholds_fn)
        self._lock = threading.Lock()
        self._pool: Dict[str, object] = {}        # machine_id -> client
        self._health: Dict[str, _LeaderHealth] = {}
        self._backoff_until_ms: Dict[str, int] = {}
        self._learned: Dict[int, str] = {}        # slice -> machine_id
        self._started = False
        self.map = smap
        self.failover_count = 0          # learned-override adoptions
        self.last_failover_ms = -1
        self.wrong_slice_count = 0
        self.stale_map_version_seen = 0  # highest version a reply named
        self.overloaded_count = 0
        self.degraded_entry_count = 0
        self.degraded_total_ms = 0
        self.socket_reuse_count = 0      # map changes that kept a socket
        self._request_timeout_s = (
            request_timeout_s if request_timeout_s is not None
            else max(smap.request_timeout_ms, 1) / 1000.0)
        self._rebuild_pool(smap)

    # -- pool / map lifecycle ----------------------------------------------

    def _make_client(self, spec):
        from sentinel_tpu_torch.cluster.client import ClusterTokenClient

        n = self.map.n_slices

        def scope_fn(flow_id):
            try:
                return slice_of(int(flow_id), n)
            except (TypeError, ValueError):
                return None

        kw = {}
        if self._health_gate_opt is not _CONFIG_GATE:
            kw["health_gate"] = self._health_gate_opt
        return ClusterTokenClient(
            spec.host, spec.port, self.map.namespace,
            request_timeout_s=self._request_timeout_s,
            reconnect_interval_s=self._reconnect_interval_s,
            epoch_fence=self.fence,
            connect_timeout_s=self._connect_timeout_s,
            fence_scope_fn=scope_fn, **kw)

    def _rebuild_pool(self, smap: ShardMap) -> None:
        """(Re)build the per-leader pool for ``smap``, REUSING the live
        socket of any leader whose host:port is unchanged — the failover
        client's same-target reuse extended to the pool, so a rebalance
        that only moves slices never causes a reconnect storm. Caller
        holds ``_lock`` (or is the constructor)."""
        old = self._pool
        fresh: Dict[str, object] = {}
        for spec in smap.servers:
            cur = old.pop(spec.machine_id, None)
            if cur is not None and cur.host == spec.host \
                    and cur.port == spec.port:
                cur.request_timeout_s = self._request_timeout_s
                fresh[spec.machine_id] = cur
                if self._started:
                    self.socket_reuse_count += 1
            else:
                if cur is not None:
                    cur.stop()
                c = self._make_client(spec)
                if self._started:
                    c.start()
                fresh[spec.machine_id] = c
            self._health.setdefault(spec.machine_id, _LeaderHealth())
            self._backoff_until_ms.setdefault(spec.machine_id, 0)
        for mid, gone in old.items():  # leaders dropped from the map
            gone.stop()
            self._health.pop(mid, None)
            self._backoff_until_ms.pop(mid, None)
        self._pool = fresh

    def apply_map(self, smap: ShardMap) -> bool:
        """Adopt a newer map in place (socket-hygiene path). Returns
        False when the map cannot be adopted (stale version, or a
        different ring size — the ring is fixed for a cluster's
        lifetime) and the caller should rebuild the client."""
        with self._lock:
            if smap.version < self.map.version:
                return False
            if smap.n_slices != self.map.n_slices:
                return False
            self._request_timeout_s = max(smap.request_timeout_ms, 1) / 1000.0
            self.map = smap
            # Map epochs are wire-grade evidence: observe them now so a
            # deposed donor is fenced the moment the map lands, not only
            # after the new owner's first reply.
            for sl, ep in enumerate(smap.slice_epoch):
                self.fence.observe(ep, sl)
            self._learned.clear()  # fresh map supersedes learned routes
            self.degraded.divisor = max(
                1, len(smap.clients) if smap.clients
                else config.cluster_ha_degraded_divisor())
            self._rebuild_pool(smap)
            return True

    def start(self) -> "ShardedTokenClient":
        with self._lock:
            self._started = True
            for c in self._pool.values():
                c.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._started = False
            clients = list(self._pool.values())
        for c in clients:
            c.stop()
        now = self._now()
        with self._lock:
            for h in self._health.values():  # close open degraded spells
                if h.degraded_since_ms >= 0:
                    self.degraded_total_ms += max(
                        0, now - h.degraded_since_ms)
                h.degraded_since_ms = -1
                h.lost_at_ms = -1

    def is_connected(self) -> bool:
        return any(c.is_connected() for c in self._pool.values())

    @property
    def health_gate(self):
        """The mapped first leader's breaker (resilience_stats shape)."""
        first = self.map.servers[0].machine_id
        c = self._pool.get(first)
        return c.health_gate if c is not None else None

    @property
    def targets(self) -> List[str]:
        return [f"{s.host}:{s.port}" for s in self.map.servers]

    # -- degraded bookkeeping (per leader) ---------------------------------

    def _note_served(self, mid: str) -> None:
        h = self._health.get(mid)
        if h is None:
            return
        with self._lock:
            if h.degraded_since_ms >= 0:
                self.degraded_total_ms += max(
                    0, self._now() - h.degraded_since_ms)
            h.degraded_since_ms = -1
            h.lost_at_ms = -1

    def _degraded_now(self, mid: str) -> bool:
        h = self._health.get(mid)
        if h is None:
            return False
        now = self._now()
        with self._lock:
            if h.degraded_since_ms >= 0:
                return True
            if h.lost_at_ms < 0:
                h.lost_at_ms = now
                return False
            if now - h.lost_at_ms >= self.failover_deadline_ms:
                h.degraded_since_ms = now
                return True
            return False

    def is_degraded(self) -> bool:
        return any(h.degraded_since_ms >= 0 for h in self._health.values())

    def degraded_slices(self) -> int:
        """Slices whose EFFECTIVE owner is currently in a degraded
        spell — the blast radius of whatever leaders are down."""
        down = {mid for mid, h in self._health.items()
                if h.degraded_since_ms >= 0}
        if not down:
            return 0
        return sum(1 for sl, mid in enumerate(self.map.slice_owner)
                   if self._learned.get(sl, mid) in down)

    def degraded_seconds(self) -> float:
        total = self.degraded_total_ms
        now = self._now()
        for h in self._health.values():
            if h.degraded_since_ms >= 0:
                total += max(0, now - h.degraded_since_ms)
        return total / 1000.0

    def _note_overload(self, mid: str, retry_after_ms: int) -> None:
        backoff = max(int(retry_after_ms),
                      config.overload_client_backoff_ms())
        with self._lock:
            self.overloaded_count += 1
            self._backoff_until_ms[mid] = (
                self._now() + backoff)

    # -- requests ----------------------------------------------------------

    def _owner_of(self, sl: int) -> str:
        mid = self._learned.get(sl)
        if mid is not None and mid in self._pool:
            return mid
        return self.map.slice_owner[sl]

    def _walk_order(self, sl: int) -> List[str]:
        owner = self._owner_of(sl)
        order = [owner]
        for s in self.map.servers:
            if s.machine_id != owner:
                order.append(s.machine_id)
        return order

    def _route(self, flow_id, fn, degraded_fn,
               timeout_s: Optional[float] = None,
               trace=None) -> TokenResult:
        """The per-slice walk shared by flow and param acquires; ``fn``
        is ``(client, remaining_timeout) -> TokenResult``."""
        try:
            fid = int(flow_id)
        except (TypeError, ValueError):
            return TokenResult(TokenResultStatus.FAIL)
        sl = slice_of(fid, self.map.n_slices)
        owner = self._owner_of(sl)
        hops: Optional[list] = [] if self.spans is not None else None
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        now_ms = self._now()
        overload_hint = backed_off = None
        owner_alive = False  # owner answered OVERLOADED / is in backoff
        for mid in self._walk_order(sl):
            c = self._pool.get(mid)
            if c is None or not c.is_connected():
                continue
            if self._backoff_until_ms.get(mid, 0) > now_ms:
                backed_off = self._backoff_until_ms[mid] - now_ms
                if mid == owner:
                    owner_alive = True
                if hops is not None:
                    hops.append({"leader": mid, "event": "backed_off"})
                continue
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
            tr = fn(c, remaining)
            if tr.status == TokenResultStatus.WRONG_SLICE:
                # This leader does not own the slice (our map is stale
                # somewhere): note how stale and walk on — the true
                # owner is one of the remaining leaders.
                self.wrong_slice_count += 1
                if tr.wait_ms > self.stale_map_version_seen:
                    self.stale_map_version_seen = tr.wait_ms
                if hops is not None:
                    hops.append({"leader": mid, "event": "wrong_slice",
                                 "mapVersion": int(tr.wait_ms)})
                continue
            if tr.status == TokenResultStatus.OVERLOADED:
                # The reply round-tripped the wire: THIS leader is alive
                # (sustained overload is not failover), so reset
                # its — and only its — lost->degraded clock.
                self._note_served(mid)
                self._note_overload(mid, tr.wait_ms)
                overload_hint = tr.wait_ms
                if mid == owner:
                    owner_alive = True
                if hops is not None:
                    hops.append({"leader": mid, "event": "overloaded"})
                continue
            if tr.status != TokenResultStatus.FAIL:
                self._note_served(mid)
                if hops is not None:
                    hops.append({"leader": mid, "event": "served"})
                if mid != owner:
                    # Self-heal: this leader answered for a slice our
                    # map routes elsewhere — adopt it until the next
                    # map push confirms (or corrects) the move.
                    with self._lock:
                        self._learned[sl] = mid
                        self.failover_count += 1
                        self.last_failover_ms = \
                            self._now()
                    self._record_walk(trace, fid, sl, owner, hops,
                                      "self-healed", served_by=mid)
                else:
                    self._record_walk(trace, fid, sl, owner, hops,
                                      "served", served_by=mid)
                return tr
            # FAIL: dead/partitioned/stale-fenced — walk on.
            if hops is not None:
                hops.append({"leader": mid, "event": "fail"})
        # No verdict anywhere for this slice: only ITS owner's clock
        # advances — other leaders' slices are untouched (per-slice
        # failover, the tentpole's blast-radius contract). An OVERLOADED
        # answer from a NON-owner must not mask the owner's death (a
        # survivor's frontend sheds before its slice check, so it sheds
        # for slices it doesn't even own): the owner's clock runs unless
        # the owner ITSELF proved alive this walk (answered OVERLOADED,
        # or sits inside the backoff window such an answer opened).
        if not owner_alive and self._degraded_now(owner):
            self.degraded_entry_count += 1
            result = degraded_fn()
            if result is not None:
                self._record_walk(trace, fid, sl, owner, hops, "degraded")
                return result
        self._record_walk(trace, fid, sl, owner, hops,
                          "overloaded" if (overload_hint is not None
                                           or backed_off is not None)
                          else "fail")
        if overload_hint is not None or backed_off is not None:
            return TokenResult(
                TokenResultStatus.OVERLOADED,
                wait_ms=int(overload_hint if overload_hint is not None
                            else backed_off))
        return TokenResult(TokenResultStatus.FAIL)

    def _record_walk(self, trace, fid: int, sl: int, owner: str,
                     hops: Optional[list], outcome: str,
                     served_by: Optional[str] = None) -> None:
        """One ``cluster.slice_walk`` span per INTERESTING walk (a
        WRONG_SLICE self-heal hop, a failover/degraded walk) — so the
        trace of a sharded acquire shows the whole route, not just the
        hop that finally answered. Boring owner-answered walks record
        nothing (the steady state must stay span-free)."""
        spans = self.spans
        if spans is None or hops is None:
            return
        boring = (outcome == "served" and served_by == owner
                  and len(hops) == 1)
        if boring:
            return
        from sentinel_tpu_torch.telemetry.spans import Span

        if trace is not None:
            ctx, parent = trace.child(), trace.span_id
        else:
            ctx, parent = spans.sample(), ""
            if ctx is None:
                return
        spans.record(Span("cluster.slice_walk", ctx,
                          parent_span_id=parent,
                          attrs={"flowId": fid, "slice": sl,
                                 "owner": owner, "outcome": outcome,
                                 "servedBy": served_by or "",
                                 "hops": list(hops)}).finish())

    def request_token(self, flow_id, count: int = 1,
                      prioritized: bool = False,
                      timeout_s: Optional[float] = None,
                      gate_neutral: bool = False,
                      trace=None) -> TokenResult:
        return self._route(
            flow_id,
            lambda c, t: c.request_token(flow_id, count, prioritized,
                                         timeout_s=t,
                                         gate_neutral=gate_neutral,
                                         trace=trace),
            lambda: self.degraded.acquire(flow_id, count),
            timeout_s=timeout_s, trace=trace)

    def request_param_token(self, flow_id, count, params,
                            timeout_s: Optional[float] = None,
                            gate_neutral: bool = False,
                            trace=None) -> TokenResult:
        # Param degraded verdicts stay un-partitioned (no local mirror
        # for per-key global buckets): None -> FAIL -> rule fallback,
        # same stance as the failover client.
        return self._route(
            flow_id,
            lambda c, t: c.request_param_token(flow_id, count, params,
                                               timeout_s=t,
                                               gate_neutral=gate_neutral,
                                               trace=trace),
            lambda: None,
            timeout_s=timeout_s, trace=trace)

    def request_tokens_pipelined(self, requests: Sequence[Tuple],
                                 timeout_s: Optional[float] = None,
                                 gate_neutral: bool = False):
        """Batched acquires routed per slice: the batch is split by
        owning leader, each leader's share rides ITS pipelined socket
        (one coalesced write per leader), results reassemble in request
        order. Mis-routed requests come back WRONG_SLICE — the caller
        retries per-request through :meth:`request_token`'s healing walk
        (keeping the batched fast path allocation-lean)."""
        n = len(requests)
        if n == 0:
            return []
        by_leader: Dict[str, List[int]] = {}
        out: List[Optional[TokenResult]] = [None] * n
        for i, req in enumerate(requests):
            try:
                fid = int(req[0])
            except (TypeError, ValueError):
                out[i] = TokenResult(TokenResultStatus.FAIL)
                continue
            mid = self._owner_of(slice_of(fid, self.map.n_slices))
            by_leader.setdefault(mid, []).append(i)
        for mid, idxs in by_leader.items():
            c = self._pool.get(mid)
            if c is None:
                for i in idxs:
                    out[i] = TokenResult(TokenResultStatus.FAIL)
                continue
            results = c.request_tokens_pipelined(
                [requests[i][:3] for i in idxs], timeout_s=timeout_s,
                gate_neutral=gate_neutral)
            for i, tr in zip(idxs, results):
                out[i] = tr
        return out

    # -- stats -------------------------------------------------------------

    def failover_stats(self) -> dict:
        """The ha_stats() merge shape (superset of the failover
        client's) + the ``shard`` routing block the exporter and
        dashboard consume."""
        now = self._now()
        leaders = {}
        for spec in self.map.servers:
            mid = spec.machine_id
            c = self._pool.get(mid)
            h = self._health.get(mid)
            leaders[mid] = {
                "target": f"{spec.host}:{spec.port}",
                "connected": bool(c is not None and c.is_connected()),
                "degraded": bool(h is not None
                                 and h.degraded_since_ms >= 0),
                "slices": sum(1 for m in self.map.slice_owner
                              if m == mid),
            }
        return {
            "failoverCount": self.failover_count,
            "lastFailoverMs": self.last_failover_ms,
            "degraded": self.is_degraded(),
            "degradedEntries": self.degraded_entry_count,
            "degradedSeconds": round(self.degraded_seconds(), 3),
            "activeTarget": self.targets[0],
            "targets": self.targets,
            "degradedQuota": self.degraded.snapshot(),
            "overloadedCount": self.overloaded_count,
            "targetsBackedOff": sum(
                1 for t in self._backoff_until_ms.values() if t > now),
            "staleEpochRejected": self.fence.stale_rejected_count,
            "shard": {
                "mode": "client",
                "mapVersion": self.map.version,
                "nSlices": self.map.n_slices,
                "wrongSliceRejected": self.wrong_slice_count,
                "staleMapVersionSeen": self.stale_map_version_seen,
                "degradedSlices": self.degraded_slices(),
                "learnedOverrides": len(self._learned),
                "socketReuse": self.socket_reuse_count,
                "leaders": leaders,
            },
        }
