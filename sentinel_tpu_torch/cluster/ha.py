"""Cluster token-server high availability (port of
``sentinel_tpu/cluster/ha.py``; upstream analog: embedded-mode
``ClusterStateManager`` + the dashboard's cluster assign map — SURVEY.md
§"sentinel-cluster").

Four cooperating pieces close the single-token-server availability gap:

* **Embedded mode-flipping** — :class:`ClusterHAManager` drives an
  instance's CLIENT<->SERVER role from a :class:`ClusterMap` (pushed by
  any datasource through the ``clusterMap`` converter in
  ``datasource/converters.py``), draining the old role cleanly: an
  outgoing leader publishes a final window checkpoint before its
  listener closes.
* **Epoch-fenced leadership** — every leadership term carries a
  monotonic epoch (the map's, or minted above everything observed).
  Servers stamp it into each token response as a trailing TLV old peers
  ignore (``codec.TLV_EPOCH``); clients share one
  :class:`~sentinel_tpu_torch.cluster.state.EpochFence` and reject responses
  below its high-water mark, so a deposed leader can never double-grant
  quota (split-brain fencing).
* **Client failover** — :class:`FailoverTokenClient` walks the map's
  ordered server list (leader first) using the existing
  ``RetryPolicy``/``HealthGate`` primitives per target; past the
  ``csp.sentinel.cluster.ha.failover.deadline.ms`` budget with no
  server reachable it enters **degraded-quota mode**: verdicts come
  from :class:`DegradedQuota`, a per-client share of the global
  threshold (sum of shares <= global threshold — proof in
  docs/SEMANTICS.md), not full-local amnesty.
* **State-preserving recovery** — a promoted leader warm-starts its
  per-flow windows from the checkpoint the old leader published
  (``core/checkpoint.py`` ``save_cluster_checkpoint`` — periodically
  via :class:`~sentinel_tpu_torch.core.checkpoint.CheckpointTimer` and on
  graceful drain), bounding failover over-admission to the grants made
  since the last publish.

Device: every leader this module promotes builds its
``DefaultTokenService`` on the manager's device — ``cuda`` unless the
caller (or the owning engine) says otherwise; with no card and no device
the manager's constructor raises. On ``cuda`` the pre-bind warm-up
launches the acquire kernel, and a failure to build or launch it raises
out of the promotion: the seat is not promoted (``apply_map`` retries),
never bound with a service whose first token would fail.
"""

from __future__ import annotations

import contextlib
import socket
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from sentinel_tpu_torch.telemetry.journal import causing as journal_causing
from sentinel_tpu_torch.telemetry.journal import current_cause as journal_cause

# Known-fixed-bug reintroduction flags (chaos shrinker proof-of-life).
# Bound ONCE at import: the check sits on the degraded-mode
# request path, and a deployment that strips the chaos tooling must
# keep serving with the seam permanently off.
try:
    from sentinel_tpu_torch.chaos.regressions import (
        reintroduced as _chaos_reintroduced,
    )
except ImportError:  # chaos package absent: the fixed behavior, always
    def _chaos_reintroduced(_name: str) -> bool:
        return False

from sentinel_tpu_torch.cluster.state import (
    CLUSTER_CLIENT,
    CLUSTER_SERVER,
    ClusterStateManager,
    EpochFence,
)
from sentinel_tpu_torch.cluster.token_service import TokenResult
from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.utils import time_util


class ClusterServerSpec(NamedTuple):
    """One token-server seat in the cluster map."""

    machine_id: str
    host: str
    port: int


class ClusterMap(NamedTuple):
    """Datasource-pushed leadership assignment (the ``clusterMap``
    converter's output): WHO is the leader this epoch, the ordered
    failover list, and the client membership that sizes the
    degraded-quota share."""

    epoch: int
    servers: Tuple[ClusterServerSpec, ...]  # [0] = leader, rest standbys
    clients: Tuple[str, ...] = ()           # client machine ids (share divisor)
    namespace: str = "default"
    request_timeout_ms: int = 2000

    def leader(self) -> Optional[ClusterServerSpec]:
        return self.servers[0] if self.servers else None

    def server_for(self, machine_id: str) -> Optional[ClusterServerSpec]:
        for s in self.servers:
            if s.machine_id == machine_id:
                return s
        return None


def default_machine_id() -> str:
    """This instance's identity in cluster maps: the config override, or
    ``hostname@pid`` (unique per process, the upstream machineId shape)."""
    import os

    cfg = config.cluster_ha_machine_id()
    if cfg:
        return cfg
    return f"{socket.gethostname()}@{os.getpid()}"


class DegradedQuota:
    """Per-client share admission while no leader is reachable.

    Each flow's share is ``global_threshold / divisor`` where ``divisor``
    is the fleet's client count (from the cluster map, or the
    ``csp.sentinel.cluster.ha.degraded.divisor`` config): with every
    client running the same divisor >= the true client count, the sum of
    all clients' degraded admissions per window is <= the global
    threshold — bounded degradation instead of full-local amnesty
    (docs/SEMANTICS.md "Degraded-quota bound").

    Thresholds come from a callable (the engine's local copy of the
    cluster rules — in the reference deployment model the same rule
    object is pushed everywhere, so the local count IS the global
    threshold) or a static ``{flowId: (threshold, intervalMs)}`` dict.
    Admission reuses :class:`~sentinel_tpu_torch.core.lease.LocalLease` — the
    host-side mirror ring already proven against the device window math.
    """

    def __init__(self, divisor: Optional[int] = None,
                 thresholds: Optional[Dict[int, Tuple[float, int]]] = None,
                 thresholds_fn: Optional[Callable[[], Dict]] = None):
        self.divisor = max(1, int(divisor if divisor is not None
                                  else config.cluster_ha_degraded_divisor()))
        self._static = thresholds
        self._fn = thresholds_fn
        self._lock = threading.Lock()
        self._buckets: Dict[int, tuple] = {}  # fid -> (share, interval, lease)
        self.granted_count = 0
        self.blocked_count = 0

    def thresholds(self) -> Dict[int, Tuple[float, int]]:
        if self._fn is not None:
            return self._fn() or {}
        return self._static or {}

    def acquire(self, flow_id, count: int = 1,
                now_ms: Optional[int] = None) -> Optional[TokenResult]:
        """OK/BLOCKED against this client's share, or None when the flow
        is unknown here (caller degrades to its local fallback)."""
        from sentinel_tpu_torch.cluster.constants import TokenResultStatus
        from sentinel_tpu_torch.core.lease import LocalLease

        try:
            fid = int(flow_id)
        except (TypeError, ValueError):
            return None
        info = self.thresholds().get(fid)
        if info is None:
            return None
        thr, interval_ms = float(info[0]), max(1, int(info[1]))
        if _chaos_reintroduced("degraded-amnesty"):
            # Known-fixed bug, deliberately reintroducible (chaos
            # shrinker proof-of-life): the pre-share behavior
            # granted every degraded verdict, voiding the sum-of-shares
            # bound the chaos campaign's invariant checker enforces.
            with self._lock:
                self.granted_count += 1
            return TokenResult(TokenResultStatus.OK)
        share = thr / self.divisor
        now = now_ms if now_ms is not None else time_util.current_time_millis()
        with self._lock:
            cached = self._buckets.get(fid)
            if cached is None or cached[0] != share or cached[1] != interval_ms:
                # One bucket spanning the whole interval: the provable
                # per-window bound needs interval-aligned accounting, not
                # a sliding approximation.
                cached = (share, interval_ms,
                          LocalLease([share], interval_ms, buckets=1))
                self._buckets[fid] = cached
            ok = cached[2].try_acquire(int(count), now)
            if ok:
                self.granted_count += 1
            else:
                self.blocked_count += 1
        return TokenResult(TokenResultStatus.OK if ok
                           else TokenResultStatus.BLOCKED)

    def snapshot(self) -> dict:
        with self._lock:
            return {"divisor": self.divisor,
                    "grantedCount": self.granted_count,
                    "blockedCount": self.blocked_count,
                    "flows": len(self._buckets)}


class FailoverTokenClient:
    """Token client over an ORDERED server list (leader first).

    One inner :class:`~sentinel_tpu_torch.cluster.client.ClusterTokenClient`
    per target, each with its own ``HealthGate`` breaker and a snappy
    reconnect ``RetryPolicy`` (``csp.sentinel.cluster.ha.reconnect.ms``
    base) so a standby promotion lands inside the failover deadline.
    Every request goes to the first CONNECTED target in map order; a
    FAIL (timeout, stale epoch, disconnect) walks to the next. With no
    target connected, requests FAIL (local fallback) for at most
    ``failover.deadline.ms`` after connectivity loss — the reconnectors'
    race window — then the client enters degraded-quota mode and serves
    per-client-share verdicts wire-free until any target reconnects.
    """

    serves_degraded = True  # keeps client_if_active() routing to us

    def __init__(self, targets: List[Tuple[str, int]],
                 namespace: str = "default",
                 request_timeout_s: float = 2.0,
                 failover_deadline_ms: Optional[int] = None,
                 degraded: Optional[DegradedQuota] = None,
                 epoch_fence: Optional[EpochFence] = None,
                 reconnect_interval_s: Optional[float] = None,
                 connect_timeout_s: float = 1.0):
        from sentinel_tpu_torch.cluster.client import ClusterTokenClient

        if not targets:
            raise ValueError("failover client needs at least one target")
        self.namespace = namespace
        self.fence = epoch_fence or EpochFence()
        self.failover_deadline_ms = int(
            failover_deadline_ms if failover_deadline_ms is not None
            else config.cluster_ha_failover_deadline_ms())
        if reconnect_interval_s is None:
            reconnect_interval_s = config.cluster_ha_reconnect_ms() / 1000.0
        self.degraded = degraded or DegradedQuota()
        self._clients = [
            ClusterTokenClient(host, port, namespace,
                               request_timeout_s=request_timeout_s,
                               reconnect_interval_s=reconnect_interval_s,
                               epoch_fence=self.fence,
                               connect_timeout_s=connect_timeout_s)
            for host, port in targets]
        self._lock = threading.Lock()
        self._active_idx = 0
        self.failover_count = 0
        self.last_failover_ms = -1
        # Overload backoff: a target that replied OVERLOADED
        # is skipped for its retry-after window instead of being walked
        # into again on every entry — and an overloaded reply is NOT a
        # failure toward the lost->degraded clock (the server is alive,
        # just saturated; hammering it with failover traffic is exactly
        # the collapse amplification this layer exists to prevent).
        self._backoff_until_ms = [0] * len(targets)
        self.overloaded_count = 0
        # Degraded-mode accounting: _lost_at_ms marks total connectivity
        # loss (-1 = connected recently); _degraded_since_ms marks the
        # deadline expiring; degraded_total_ms accumulates closed spells.
        self._lost_at_ms = -1
        self._degraded_since_ms = -1
        self.degraded_total_ms = 0
        self.degraded_entry_count = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FailoverTokenClient":
        for c in self._clients:
            c.start()
        return self

    def stop(self) -> None:
        for c in self._clients:
            c.stop()
        self._note_connected()  # close any open degraded spell

    def is_connected(self) -> bool:
        return any(c.is_connected() for c in self._clients)

    @property
    def health_gate(self):
        """The ACTIVE target's breaker (resilience_stats surface)."""
        return self._clients[self._active_idx].health_gate

    @property
    def targets(self) -> List[str]:
        return [f"{c.host}:{c.port}" for c in self._clients]

    # -- degraded-mode bookkeeping ----------------------------------------

    def _note_connected(self) -> None:
        with self._lock:
            if self._degraded_since_ms >= 0:
                self.degraded_total_ms += max(
                    0, time_util.current_time_millis()
                    - self._degraded_since_ms)
            self._degraded_since_ms = -1
            self._lost_at_ms = -1

    def _degraded_now(self) -> bool:
        """Advance the lost->degraded state machine; True once the
        failover deadline has fully elapsed with no connection."""
        now = time_util.current_time_millis()
        with self._lock:
            if self._degraded_since_ms >= 0:
                return True
            if self._lost_at_ms < 0:
                self._lost_at_ms = now
                return False
            if now - self._lost_at_ms >= self.failover_deadline_ms:
                self._degraded_since_ms = now
                return True
            return False

    def is_degraded(self) -> bool:
        return self._degraded_since_ms >= 0

    def degraded_seconds(self) -> float:
        total = self.degraded_total_ms
        if self._degraded_since_ms >= 0:
            total += max(0, time_util.current_time_millis()
                         - self._degraded_since_ms)
        return total / 1000.0

    def failover_stats(self) -> dict:
        now = time_util.current_time_millis()
        return {
            "failoverCount": self.failover_count,
            "lastFailoverMs": self.last_failover_ms,
            "degraded": self.is_degraded(),
            "degradedEntries": self.degraded_entry_count,
            "degradedSeconds": round(self.degraded_seconds(), 3),
            "activeTarget": self.targets[self._active_idx],
            "targets": self.targets,
            "degradedQuota": self.degraded.snapshot(),
            "overloadedCount": self.overloaded_count,
            "targetsBackedOff": sum(
                1 for t in self._backoff_until_ms if t > now),
        }

    # -- requests ----------------------------------------------------------

    def _note_failover(self, idx: int) -> None:
        with self._lock:
            if idx != self._active_idx:
                self._active_idx = idx
                self.failover_count += 1
                self.last_failover_ms = time_util.current_time_millis()

    def _note_overload(self, idx: int, retry_after_ms: int) -> None:
        backoff = max(int(retry_after_ms),
                      config.overload_client_backoff_ms())
        with self._lock:
            self.overloaded_count += 1
            self._backoff_until_ms[idx] = (
                time_util.current_time_millis() + backoff)

    def _request(self, fn, degraded_fn,
                 timeout_s: Optional[float] = None) -> TokenResult:
        from sentinel_tpu_torch.cluster.constants import TokenResultStatus

        # The caller's timeout is a budget for the WHOLE walk, not per
        # target: each attempt gets only what remains, so one data-path
        # entry never blocks N x its deadline budget when several
        # targets are up but unresponsive during a transition.
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        now_ms = time_util.current_time_millis()
        overload_hint = backed_off = None
        for idx, c in enumerate(self._clients):
            if not c.is_connected():
                continue
            if self._backoff_until_ms[idx] > now_ms:
                # Inside this target's overload-backoff window: skip it
                # without touching the wire (the retry-after contract).
                backed_off = self._backoff_until_ms[idx] - now_ms
                continue
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
            tr = fn(c, remaining)
            if tr.status == TokenResultStatus.OVERLOADED:
                # First-class overload: back this target off for the
                # server's retry-after hint and walk on. NOT a failure
                # toward failover/degraded — the reply itself proves the
                # server is alive.
                self._note_overload(idx, tr.wait_ms)
                overload_hint = tr.wait_ms
                continue
            if tr.status != TokenResultStatus.FAIL:
                self._note_failover(idx)
                self._note_connected()
                return tr
            # FAIL: breaker-open, timeout, garbage, or stale epoch —
            # walk on to the next target in map order.
        if overload_hint is not None or backed_off is not None:
            # Every reachable target is shedding (or still inside its
            # backoff window): report OVERLOADED so the engine degrades
            # this entry to the local lease/fallback path. A fresh
            # OVERLOADED reply resets the lost->degraded clock (the
            # fleet is reachable); a backoff-only round leaves the clock
            # alone — no new evidence either way.
            if overload_hint is not None:
                self._note_connected()
            return TokenResult(
                TokenResultStatus.OVERLOADED,
                wait_ms=int(overload_hint if overload_hint is not None
                            else backed_off))
        # No target produced a verdict. That includes the half-open case
        # (connected to a partitioned leader): a round with zero
        # verdicts advances the lost->degraded clock; any success resets
        # it, so one transient timeout never reaches degraded mode — the
        # full failover deadline must elapse verdict-free first.
        if self._degraded_now():
            self.degraded_entry_count += 1
            result = degraded_fn()
            if result is not None:
                return result
        return TokenResult(TokenResultStatus.FAIL)

    def request_token(self, flow_id, count: int = 1,
                      prioritized: bool = False,
                      timeout_s: Optional[float] = None,
                      gate_neutral: bool = False,
                      trace=None) -> TokenResult:
        return self._request(
            lambda c, t: c.request_token(flow_id, count, prioritized,
                                         timeout_s=t,
                                         gate_neutral=gate_neutral,
                                         trace=trace),
            lambda: self.degraded.acquire(flow_id, count),
            timeout_s=timeout_s)

    def request_param_token(self, flow_id, count, params,
                            timeout_s: Optional[float] = None,
                            gate_neutral: bool = False,
                            trace=None) -> TokenResult:
        # Param-flow degraded verdicts are NOT share-partitioned (per-key
        # global buckets have no local mirror): degraded mode returns
        # None -> FAIL -> the rule's configured local fallback.
        return self._request(
            lambda c, t: c.request_param_token(flow_id, count, params,
                                               timeout_s=t,
                                               gate_neutral=gate_neutral,
                                               trace=trace),
            lambda: None,
            timeout_s=timeout_s)


class ClusterHAManager:
    """Drives one instance's cluster role from datasource-pushed
    :class:`ClusterMap`s (the embedded-mode ``ClusterStateManager``
    pattern): ``apply_map`` flips CLIENT<->SERVER, epoch-fences each
    term, publishes/restores window checkpoints across the handoff, and
    ignores maps older than the one applied (a delayed datasource push
    must not resurrect a deposed leader)."""

    def __init__(self, engine=None, state: Optional[ClusterStateManager] = None,
                 machine_id: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_period_s: Optional[float] = None,
                 server_host: str = "0.0.0.0", device=None):
        from sentinel_tpu_torch.utils.device import resolve_device

        self.engine = engine
        # The device every leader term's token service runs on: the
        # caller's, else the owning engine's, else cuda (raises with no
        # card).
        self.device = resolve_device(
            device if device is not None
            else getattr(engine, "device", None))
        self.state = state if state is not None else (
            engine.cluster if engine is not None else ClusterStateManager())
        self.machine_id = machine_id or default_machine_id()
        self.checkpoint_path = (checkpoint_path
                                or config.cluster_ha_checkpoint_path())
        self.checkpoint_period_s = (
            checkpoint_period_s if checkpoint_period_s is not None
            else config.cluster_ha_checkpoint_period_ms() / 1000.0)
        self.server_host = server_host
        self.map: Optional[ClusterMap] = None
        # Sharded assignment (cluster/sharding.py): the last
        # ShardMap applied, plus handoff accounting. A manager follows
        # EITHER plain cluster maps or shard maps; apply_map dispatches
        # on the pushed type.
        self.shard_map = None
        self.handoffs = 0
        self.checkpoints_published = 0
        self.rows_restored = 0
        self._lock = threading.RLock()
        self._ckpt_timer = None
        # Failed-transition retry cadence (apply_map): the datasource
        # property never re-fires an unchanged map, so retries are ours.
        self.retry_delay_s = config.cluster_ha_reconnect_ms() / 1000.0
        self._retry_timer = None
        self.state.ha = self
        # Audit-journal back-pointers: each map apply links
        # to the previous one, so the journal shows the assignment
        # history as one causal chain per kind.
        self._map_jseq = None
        self._shard_jseq = None

    def _journal(self):
        return getattr(self.engine, "journal", None) \
            if self.engine is not None else None

    # -- datasource wiring -------------------------------------------------

    def watch(self, prop) -> None:
        """Subscribe to a datasource property whose converter is
        ``cluster_map_from_json`` (datasource/converters.py)."""
        from sentinel_tpu_torch.core.property import SimplePropertyListener

        prop.add_listener(SimplePropertyListener(self.apply_map))

    def apply_map(self, cmap: Optional[ClusterMap]) -> None:
        if cmap is None:
            return
        from sentinel_tpu_torch.cluster.sharding import ShardMap

        if isinstance(cmap, ShardMap):
            self.apply_shard_map(cmap)
            return
        from sentinel_tpu_torch.log.record_log import record_log

        with self._lock:
            if self.map is not None and cmap.epoch < self.map.epoch:
                record_log.warn(
                    "ignoring stale cluster map epoch %d (< applied %d)",
                    cmap.epoch, self.map.epoch)
                return
            # The wire is a map source too: responses stamped with a
            # higher epoch prove a newer term exists, so a delayed map
            # below the fence must not promote a leader the whole
            # fleet's fences would reject.
            if cmap.epoch < self.state.fence.highest_seen:
                record_log.warn(
                    "ignoring stale cluster map epoch %d (< observed %d)",
                    cmap.epoch, self.state.fence.highest_seen)
                return
            leader = cmap.leader()
            mine = cmap.server_for(self.machine_id)
            # The apply record lands BEFORE the transition it drives,
            # and the transition runs under causing(seq): the haRoleFlip
            # the transition commits links back to this map — the
            # journal's "why did this seat flip" answer.
            j = self._journal()
            jseq = j.record(
                "clusterMapApply", epoch=int(cmap.epoch),
                leader=leader.machine_id if leader else None,
                servers=[s.machine_id for s in cmap.servers],
                cause_seq=self._map_jseq) if j is not None else None
            try:
                with (journal_causing(jseq) if j is not None
                      else contextlib.nullcontext()):
                    if leader is not None and mine is not None \
                            and mine.machine_id == leader.machine_id:
                        self._become_server(cmap, mine)
                    else:
                        self._become_client(cmap)
                self._map_jseq = jseq
            except Exception as ex:  # noqa: BLE001 — transition must retry
                # Do NOT commit the map: the datasource property caches
                # its value and never re-fires for an unchanged map, so
                # a swallowed transition failure (e.g. EADDRINUSE from a
                # lingering listener) would otherwise strand this seat
                # NOT_STARTED until a human bumps the epoch — in the
                # subsystem built to survive exactly that. Retry on a
                # timer instead; newer maps win via the epoch guards.
                record_log.warn(
                    "cluster map epoch %d transition failed: %r — "
                    "retrying in %.1fs", cmap.epoch, ex, self.retry_delay_s)
                self._schedule_retry(cmap)
                return
            self.map = cmap

    def _schedule_retry(self, cmap: ClusterMap) -> None:
        with self._lock:
            if self._retry_timer is not None:
                # Latest map wins: never leave a newer failed map
                # unretried behind an older pending retry.
                self._retry_timer.cancel()
            t = threading.Timer(self.retry_delay_s, self._retry_apply,
                                args=(cmap,))
            t.daemon = True
            self._retry_timer = t
            t.start()

    def _retry_apply(self, cmap: ClusterMap) -> None:
        with self._lock:
            self._retry_timer = None
        self.apply_map(cmap)

    def transition_pending(self) -> bool:
        """True while a failed map transition awaits its retry timer —
        this seat is MID-HANDOFF and must not be a rebalance donor or
        recipient (the rebalancer's veto input)."""
        with self._lock:
            return self._retry_timer is not None

    # -- role transitions --------------------------------------------------

    def _become_server(self, cmap: ClusterMap, me: ClusterServerSpec) -> None:
        from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
        from sentinel_tpu_torch.core import checkpoint as ckpt
        from sentinel_tpu_torch.log.record_log import record_log

        srv = self.state.token_server
        if srv is not None and self.state.mode == CLUSTER_SERVER \
                and srv.epoch == cmap.epoch and not srv.crashed:
            return  # already this term's leader — no churn
        service = DefaultTokenService(rules=self.state.server_rules(),
                                      epoch=cmap.epoch, device=self.device)
        if srv is not None and self.checkpoint_path:
            # In-process re-promotion (same seat, new term — including a
            # crashed server's rebuild): the freshest window state lives
            # in the OLD service, not on disk. Publish it BEFORE the
            # restore below reads the file, or the new term would warm-
            # start from the last periodic snapshot and re-admit every
            # grant made since (the teardown publish inside set_to_server
            # lands only after the restore already ran).
            try:
                ckpt.save_cluster_checkpoint(srv.service, self.checkpoint_path)
                self.checkpoints_published += 1
            except Exception as ex:  # noqa: BLE001 — best-effort pre-drain
                record_log.warn("pre-promotion checkpoint failed: %r", ex)
        if self.checkpoint_path:
            try:
                self.rows_restored += ckpt.restore_cluster_checkpoint(
                    service, self.checkpoint_path)
            except FileNotFoundError:
                pass  # first leader of a fresh cluster: cold start
            except ValueError as ex:
                record_log.warn("cluster checkpoint not restored: %s", ex)
        # Warm the service BEFORE binding the port: on the card the probe
        # builds and launches the acquire kernel, so the very first
        # post-promotion token does not pay for it. A no-rule probe
        # (flow None -> NO_RULE_EXISTS) consumes no flow's quota.
        self._warm_up(service)
        # set_to_server tears the old role down first (on_server_teardown
        # publishes the outgoing leader's final checkpoint).
        self.state.set_to_server(host=self.server_host, port=me.port,
                                 service=service, epoch=cmap.epoch)
        if self.checkpoint_path:
            self._ckpt_timer = ckpt.CheckpointTimer(
                service, self.checkpoint_path,
                period_s=self.checkpoint_period_s,
                save=ckpt.save_cluster_checkpoint).start()

    @staticmethod
    def _warm_up(service) -> None:
        """The pre-bind probe. Best-effort on the CPU; on a CUDA service
        any failure (the acquire kernel failed to build, load or launch)
        raises, so the seat is not promoted with a service whose first
        token would fail."""
        from sentinel_tpu_torch.log.record_log import record_log

        try:
            service.request_tokens([(None, 0, False)])
        except Exception as ex:  # noqa: BLE001 — best-effort on the CPU only
            if service.device.type == "cuda":
                raise
            record_log.warn("token-service warm-up failed: %r", ex)

    def _become_client(self, cmap: ClusterMap) -> None:
        # No-churn guard (mirror of _become_server's): a map change that
        # leaves this seat a client of the SAME server list must not
        # tear down the live failover client — dropping its sockets
        # mid-traffic fails in-flight requests fleet-wide and zeroes the
        # failover/degraded counters the exporter publishes as
        # monotonic _total series.
        cur = self.state.token_client
        if (self.state.mode == CLUSTER_CLIENT
                and isinstance(cur, FailoverTokenClient)
                and cur.targets == [f"{s.host}:{s.port}"
                                    for s in cmap.servers]
                and cur.namespace == cmap.namespace):
            # The CURRENT map decides the divisor — falling back to the
            # config default when it lists no clients, exactly as a
            # freshly built client would (behavior must not depend on
            # map-push history).
            cur.degraded.divisor = max(1, len(cmap.clients)
                                       if cmap.clients
                                       else config.cluster_ha_degraded_divisor())
            for inner in cur._clients:  # timeout is read per request
                inner.request_timeout_s = max(cmap.request_timeout_ms,
                                              1) / 1000.0
            self.state.epoch = int(cmap.epoch)
            self.state.fence.observe(cmap.epoch)
            return
        if self.engine is not None:
            thresholds_fn = self.engine.cluster_degraded_thresholds
        else:
            # Engine-less participant (standalone HA seat): degraded
            # shares come from the staged server rules it would serve
            # with as leader — same rule objects, same thresholds.
            thresholds_fn = self.state.server_rules().thresholds
        divisor = len(cmap.clients) if cmap.clients else None
        client = FailoverTokenClient(
            [(s.host, s.port) for s in cmap.servers],
            namespace=cmap.namespace,
            request_timeout_s=max(cmap.request_timeout_ms, 1) / 1000.0,
            degraded=DegradedQuota(divisor=divisor,
                                   thresholds_fn=thresholds_fn),
            epoch_fence=self.state.fence)
        # set_client tears the old role down first (a deposed leader
        # drains: on_server_teardown publishes its final checkpoint).
        self.state.set_client(client)
        self.state.epoch = int(cmap.epoch)
        self.state.fence.observe(cmap.epoch)

    # -- sharded multi-leader assignment (cluster/sharding.py) -------------

    def apply_shard_map(self, smap) -> None:
        """Adopt a :class:`~sentinel_tpu_torch.cluster.sharding.ShardMap`:
        become (or stay) the leader of the slices it assigns this seat —
        publishing handoff checkpoints for slices LOST and warm-starting
        slices GAINED — or route as a sharded client of the leader set.

        Chaos seams: ``cluster.shard.map.split`` (an armed error makes
        this seat sit out the push — the fleet splits across map
        versions, which per-slice fencing + WRONG_SLICE self-healing
        must absorb) and ``cluster.shard.donor.zombie`` (a donor that
        neither publishes nor fences — its stale-epoch replies must be
        fence-rejected fleet-wide)."""
        from sentinel_tpu_torch.cluster.state import SliceEpochFence
        from sentinel_tpu_torch.log.record_log import record_log
        from sentinel_tpu_torch.resilience import faults

        with self._lock:
            cur = self.shard_map
            if cur is not None and smap.version < cur.version:
                record_log.warn(
                    "ignoring stale shard map version %d (< applied %d)",
                    smap.version, cur.version)
                return
            if cur is not None and smap.n_slices != cur.n_slices:
                record_log.warn(
                    "rejecting shard map version %d: ring size %d != "
                    "applied %d (the slice ring is fixed for a cluster's "
                    "lifetime)", smap.version, smap.n_slices, cur.n_slices)
                return
            try:
                faults.fire("cluster.shard.map.split")
            except OSError:
                record_log.warn(
                    "shard map version %d not applied (map.split fault): "
                    "seat stays on version %s", smap.version,
                    cur.version if cur else None)
                return
            # Per-slice terms need a per-slice fence; swap the global
            # fence in before any role runs under this map (duck-typed:
            # EpochFence callers keep working through scope=None).
            if not isinstance(self.state.fence, SliceEpochFence):
                self.state.fence = SliceEpochFence()
            mine = smap.epochs_of(self.machine_id)
            spec = smap.server_for(self.machine_id)
            srv = self.state.token_server
            cur_shard = (srv.service.shard
                         if srv is not None and not srv.crashed
                         and self.state.mode == CLUSTER_SERVER else None)
            if cur_shard is not None and set(cur_shard.epochs) - set(mine):
                # This seat is a DONOR under the new map (losing one or
                # more slices — possibly all of them). Zombie seam: when
                # armed, the donor neither publishes nor fences; it
                # keeps granting the moved slices at their old epochs,
                # and the fleet's per-slice fences must reject those
                # late replies (pinned by the chaos suite).
                try:
                    faults.fire("cluster.shard.donor.zombie")
                except OSError:
                    record_log.warn(
                        "shard map version %d ignored (donor.zombie "
                        "fault): still serving %d deposed slice(s)",
                        smap.version,
                        len(set(cur_shard.epochs) - set(mine)))
                    return
            j = self._journal()
            # An ambient cause (the rebalancer applying under
            # ``causing(applySeq)``) outranks the per-kind back-pointer:
            # the apply record then chains propose -> certify -> apply ->
            # shardMapApply -> haRoleFlip instead of just map-to-map.
            cause = journal_cause()
            jseq = j.record(
                "shardMapApply", version=int(smap.version),
                nSlices=int(smap.n_slices),
                role="server" if (mine and spec is not None) else "client",
                slicesOwned=sorted(int(s) for s in mine),
                sliceEpochs={str(s): int(e) for s, e in sorted(mine.items())},
                cause_seq=cause if cause is not None
                else self._shard_jseq) if j is not None else None
            try:
                with (journal_causing(jseq) if j is not None
                      else contextlib.nullcontext()):
                    if mine and spec is not None:
                        self._become_shard_server(smap, spec, mine)
                    else:
                        self._become_shard_client(smap)
                self._shard_jseq = jseq
            except Exception as ex:  # noqa: BLE001 — transition must retry
                record_log.warn(
                    "shard map version %d transition failed: %r — "
                    "retrying in %.1fs", smap.version, ex,
                    self.retry_delay_s)
                self._schedule_retry(smap)
                return
            self.shard_map = smap
            self.state.epoch = int(max(smap.slice_epoch, default=0))

    def _slice_ckpt_base(self) -> Optional[str]:
        return config.cluster_shard_handoff_path() or self.checkpoint_path

    def _slice_ckpt_path(self, slice_id: int) -> str:
        """The shared per-slice handoff file: donor publishes, recipient
        restores — the slice-granular twin of the shared
        checkpoint file."""
        return f"{self._slice_ckpt_base()}.s{int(slice_id):03d}"

    def _publish_slice(self, service, slice_id: int, epoch: int,
                       n_slices: int) -> None:
        from sentinel_tpu_torch.core import checkpoint as ckpt
        from sentinel_tpu_torch.resilience import faults

        if not self._slice_ckpt_base():
            return  # no shared handoff storage configured: cold handoffs
        # Handoff-stall seam (delay mode): a slow NFS / pod eviction
        # stalling the publish — the recipient may warm-start from an
        # OLDER file; the over-admission bound degrades gracefully to
        # grants-since-THAT-publish, never breaks.
        faults.fire("cluster.shard.handoff.stall")
        ckpt.save_cluster_checkpoint(
            service, self._slice_ckpt_path(slice_id),
            slices=(slice_id,), n_slices=n_slices, epoch=epoch)
        self.checkpoints_published += 1

    def _become_shard_server(self, smap, me, mine) -> None:
        """Leader-side map application; ``mine`` is {slice: epoch}.
        (The donor-zombie seam fires in apply_shard_map, before any
        transition; reaching here means the map IS being applied.)"""
        from sentinel_tpu_torch.cluster.sharding import ShardState
        from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
        from sentinel_tpu_torch.core import checkpoint as ckpt
        from sentinel_tpu_torch.log.record_log import record_log

        srv = self.state.token_server
        same_seat = (srv is not None and self.state.mode == CLUSTER_SERVER
                     and not srv.crashed and srv.bound_port == me.port)
        old_shard = srv.service.shard if srv is not None else None
        if same_seat and old_shard is not None:
            service = srv.service
            lost = sorted(set(old_shard.epochs) - set(mine))
            gained = sorted(set(mine) - set(old_shard.epochs))
            for sl in lost:
                # Publish BEFORE fencing ourselves out: grants between
                # this publish and set_shard below are the (bounded)
                # handoff over-admission margin.
                try:
                    self._publish_slice(service, sl,
                                        old_shard.epochs.get(sl, 0),
                                        smap.n_slices)
                    self.handoffs += 1
                except Exception as ex:  # noqa: BLE001 — best-effort drain
                    record_log.warn(
                        "slice %d handoff publish failed: %r", sl, ex)
            for sl in gained if self._slice_ckpt_base() else ():
                try:
                    self.rows_restored += ckpt.restore_cluster_checkpoint(
                        service, self._slice_ckpt_path(sl),
                        slices=(sl,), n_slices=smap.n_slices)
                    self.handoffs += 1
                except FileNotFoundError:
                    pass  # no donor publish yet: slice starts cold
                except ValueError as ex:
                    record_log.warn(
                        "slice %d handoff not restored: %s", sl, ex)
            service.set_shard(ShardState(smap.n_slices, smap.version,
                                         dict(mine)))
            for sl, ep in mine.items():
                self.state.fence.observe(ep, sl)
            return
        # Fresh promotion (was a client / NOT_STARTED / crashed / moved
        # port): build a service, warm-start every owned slice, bind.
        service = DefaultTokenService(rules=self.state.server_rules(),
                                      device=self.device)
        if srv is not None and old_shard is not None:
            # In-process re-promotion: the freshest rows live in the OLD
            # service — publish its slices before restoring (the flat
            # leader's same-seat argument, per slice).
            for sl, ep in old_shard.epochs.items():
                try:
                    self._publish_slice(srv.service, sl, ep,
                                        old_shard.n_slices)
                except Exception as ex:  # noqa: BLE001
                    record_log.warn(
                        "pre-promotion slice %d publish failed: %r", sl, ex)
        elif (srv is not None and not srv.crashed
              and self.state.mode == CLUSTER_SERVER):
            # A FLAT leader adopting its first shard map owned
            # the WHOLE key space: publish EVERY ring slice from the
            # live flat service — the slices this seat keeps warm-start
            # below, and the ones handed to other leaders graft on THEIR
            # restore. Skipping this would cold-start every flow
            # mid-window, voiding the grants-since-publish bound for the
            # whole migration. Files carry the flat term (the successor
            # epochs supersede it on their first periodic publish).
            flat_epoch = int(getattr(srv.service, "epoch", 0))
            for sl in range(int(smap.n_slices)):
                try:
                    self._publish_slice(srv.service, sl, flat_epoch,
                                        smap.n_slices)
                except Exception as ex:  # noqa: BLE001
                    record_log.warn(
                        "flat-migration slice %d publish failed: %r",
                        sl, ex)
        service.set_shard(ShardState(smap.n_slices, smap.version,
                                     dict(mine)))
        for sl in sorted(mine) if self._slice_ckpt_base() else ():
            try:
                self.rows_restored += ckpt.restore_cluster_checkpoint(
                    service, self._slice_ckpt_path(sl),
                    slices=(sl,), n_slices=smap.n_slices)
            except FileNotFoundError:
                pass  # cold slice
            except ValueError as ex:
                record_log.warn("slice %d not restored: %s", sl, ex)
        self._warm_up(service)  # pre-bind kernel build and launch
        self.state.set_to_server(host=self.server_host, port=me.port,
                                 service=service,
                                 epoch=int(max(mine.values())))
        service.set_shard(ShardState(smap.n_slices, smap.version,
                                     dict(mine)))  # epoch overwritten above
        for sl, ep in mine.items():
            self.state.fence.observe(ep, sl)
        if self._slice_ckpt_base():
            self._ckpt_timer = ckpt.CheckpointTimer(
                service, "<per-slice>", period_s=self.checkpoint_period_s,
                save=self._shard_timer_save).start()
        return

    def _shard_timer_save(self, service, _path) -> None:
        """Periodic publish for a sharded leader: one handoff file per
        OWNED slice, each fenced at its own epoch — the files a
        successor warm-starts from after a crash (grants since the last
        tick = the per-slice over-admission margin)."""
        shard = service.shard
        if shard is None:
            return
        for sl, ep in shard.epochs.items():
            self._publish_slice(service, sl, ep, shard.n_slices)

    def _become_shard_client(self, smap) -> None:
        from sentinel_tpu_torch.cluster.sharding import ShardedTokenClient

        cur = self.state.token_client
        if (self.state.mode == CLUSTER_CLIENT
                and isinstance(cur, ShardedTokenClient)
                and cur.apply_map(smap)):
            # Same client, new map: sockets for unchanged leaders were
            # reused in place (no reconnect storm on a rebalance — the
            # same-target pin extended to the per-leader pool).
            return
        if self.engine is not None:
            thresholds_fn = self.engine.cluster_degraded_thresholds
        else:
            thresholds_fn = self.state.server_rules().thresholds
        client = ShardedTokenClient(
            smap, fence=self.state.fence, thresholds_fn=thresholds_fn,
            # Walk spans join the engine's span collector so
            # a sharded client's self-heal/failover routes stitch into
            # the same traces the entry path samples.
            spans=getattr(self.engine, "spans", None)
            if self.engine is not None else None)
        self.state.set_client(client)

    # -- checkpoint plumbing -----------------------------------------------

    def on_server_teardown(self, server) -> None:
        """ClusterStateManager teardown hook: graceful drain publishes
        the outgoing leader's final window checkpoint (a crashed server
        already lost its listener — publishing its last state is still
        correct and only tightens the successor's margin)."""
        if self._ckpt_timer is not None:
            self._ckpt_timer.stop()
            self._ckpt_timer = None
        from sentinel_tpu_torch.log.record_log import record_log

        shard = getattr(server.service, "shard", None)
        if shard is not None:
            # Sharded drain: one final publish per owned slice, each
            # fenced at its own epoch — the successors' warm-start.
            try:
                self._shard_timer_save(server.service, None)
            except Exception as ex:  # noqa: BLE001 — drain is best-effort
                record_log.warn("shard drain checkpoint failed: %r", ex)
            return
        if not self.checkpoint_path:
            return
        from sentinel_tpu_torch.core import checkpoint as ckpt

        try:
            ckpt.save_cluster_checkpoint(server.service, self.checkpoint_path)
            self.checkpoints_published += 1
        except Exception as ex:  # noqa: BLE001 — drain is best-effort
            record_log.warn("drain checkpoint failed: %r", ex)

    def publish_checkpoint(self) -> None:
        """One immediate checkpoint publish (ops / tests): per owned
        slice on a sharded leader, the single shared file otherwise."""
        srv = self.state.token_server
        if srv is None:
            return
        if getattr(srv.service, "shard", None) is not None:
            self._shard_timer_save(srv.service, None)
            return
        if self.checkpoint_path:
            from sentinel_tpu_torch.core import checkpoint as ckpt

            ckpt.save_cluster_checkpoint(srv.service, self.checkpoint_path)
            self.checkpoints_published += 1

    def stats(self) -> dict:
        # Deliberately lock-free: apply_map holds self._lock across a
        # whole promotion (restore I/O + warm-up + bind), and the
        # /metrics scrape must not hang on it at exactly the moment
        # operators are watching a failover. Plain attribute reads are
        # atomic; a scrape racing a flip just sees the old values.
        cmap = self.map
        smap = self.shard_map
        return {
            "machineId": self.machine_id,
            "mapEpoch": cmap.epoch if cmap else None,
            "shardMapVersion": smap.version if smap else None,
            "handoffs": self.handoffs,
            "checkpointsPublished": self.checkpoints_published,
            "rowsRestored": self.rows_restored,
        }

    def stop(self) -> None:
        with self._lock:
            if self._retry_timer is not None:
                self._retry_timer.cancel()
                self._retry_timer = None
        self.state.stop()
