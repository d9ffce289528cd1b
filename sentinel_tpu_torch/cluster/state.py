"""Cluster role management (port of ``sentinel_tpu/cluster/state.py``;
reference: ``core:cluster/ClusterStateManager.java`` — SURVEY.md §2.4): an
instance is NOT_STARTED, a token CLIENT, or an (embedded) token SERVER;
the ops plane can flip roles at runtime.

The HA manager (``cluster/ha.py``) is not ported yet: ``ha`` stays None,
and every use of it stands behind the reference's own None checks. The
owning engine sets ``journal``, so every committed role flip records a
``haRoleFlip`` (a standalone manager leaves it None and skips the audit).
A server this manager starts runs its token service on the owning
engine's device.
"""

from __future__ import annotations

import threading
from typing import Optional

CLUSTER_NOT_STARTED = -1
CLUSTER_CLIENT = 0
CLUSTER_SERVER = 1

_ROLE_NAMES = {CLUSTER_NOT_STARTED: "NOT_STARTED", CLUSTER_CLIENT: "CLIENT",
               CLUSTER_SERVER: "SERVER"}


class EpochFence:
    """Monotonic leadership-epoch tracker (cluster/ha.py split-brain
    fence): one per instance, shared by every token client the instance
    runs AND consulted when the instance itself becomes a server, so no
    role this process ever plays can fall behind an epoch it has already
    observed. ``observe`` returns False for a stale epoch — the caller
    must reject the response it rode in on."""

    def __init__(self):
        self._lock = threading.Lock()
        self.highest_seen = 0
        self.stale_rejected_count = 0

    def observe(self, epoch: int, scope=None) -> bool:
        """``scope`` is accepted (and ignored) so the global fence and
        the sharded :class:`SliceEpochFence` are drop-in interchangeable
        on the token-client response path."""
        epoch = int(epoch)
        with self._lock:
            if epoch < self.highest_seen:
                self.stale_rejected_count += 1
                return False
            self.highest_seen = epoch
            return True

    def mint(self) -> int:
        """Next epoch strictly above everything observed (manual server
        flips with no datasource-assigned epoch)."""
        with self._lock:
            self.highest_seen += 1
            return self.highest_seen


class SliceEpochFence:
    """Per-slice leadership-epoch fence (cluster/sharding.py).

    Sharded clusters fence each hash slice's leadership INDEPENDENTLY:
    slice 3 moving from leader A (epoch 2) to leader B (epoch 3) must
    not invalidate leader C's epoch-1 replies for slice 7. ``observe``
    therefore keys its high-water mark by ``scope`` (the slice id the
    caller derived from the request's flowId via the shared
    ``sharding.slice_of`` helper); ``scope=None`` tracks a separate
    global lane, so the fence still duck-types :class:`EpochFence` for
    un-scoped callers. Rejection semantics per slice are exactly the
    single-seat fence's."""

    def __init__(self):
        self._lock = threading.Lock()
        self._highest = {}  # scope -> highest epoch observed
        self.stale_rejected_count = 0

    @property
    def highest_seen(self) -> int:
        """Max over every slice (the ops-glance / ha_stats shape)."""
        with self._lock:
            return max(self._highest.values(), default=0)

    def observe(self, epoch: int, scope=None) -> bool:
        epoch = int(epoch)
        key = None if scope is None else int(scope)
        with self._lock:
            if epoch < self._highest.get(key, 0):
                self.stale_rejected_count += 1
                return False
            self._highest[key] = epoch
            return True

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._highest)


class ClusterStateManager:
    def __init__(self):
        self._lock = threading.RLock()
        self.mode = CLUSTER_NOT_STARTED
        self.token_client = None
        self.token_server = None
        self.last_modified = 0
        # Ops-plane staged configs (reference: ClusterClientConfigManager /
        # ClusterServerConfigManager — dynamic properties the dashboard
        # writes BEFORE flipping the mode via setClusterMode).
        # requestTimeout is in MILLISECONDS (reference units).
        self.client_config = {"serverHost": None, "serverPort": None,
                              "requestTimeout": 200, "namespace": "default"}
        self.server_config = {"port": 0, "maxAllowedQps": 30000.0}
        # Cluster rules survive server re-applies (config changes rebuild
        # the service, not the rule set — reference rule managers are
        # namespace-keyed properties independent of the transport).
        self._server_rules = None
        # HA plumbing (cluster/ha.py): the per-instance epoch fence every
        # client this manager starts shares, the last leadership epoch
        # this instance applied, a mode-flip counter for ops, and the
        # optional ClusterHAManager driving this instance from a cluster
        # map (set by ClusterHAManager.__init__).
        self.fence = EpochFence()
        self.epoch = 0
        self.mode_flips = 0
        self.ha = None
        # Control-plane audit journal: set by the owning
        # engine; role flips record through it (standalone managers
        # leave it None and skip the audit).
        self.journal = None
        # The owning engine (set by SentinelEngine.__init__): servers
        # this manager starts serve THIS engine's MSG_ENTRY bridge and
        # fleetTelemetry payloads. None (standalone managers) keeps the
        # historical lazy default-engine resolution.
        self.engine = None

    def _journal_flip(self, role_name: str, **fields) -> None:
        """One ``haRoleFlip`` audit record per committed role change.
        causeSeq rides the thread-local ``causing()`` context: an HA
        map apply wraps its transition, so the flip links back to the
        cluster/shard-map record that drove it."""
        j = self.journal
        if j is None:
            return
        try:
            j.record("haRoleFlip", role=role_name, epoch=self.epoch,
                     modeFlips=self.mode_flips, **fields)
        except Exception:  # noqa: BLE001 — audit must not break a flip
            pass

    def server_rules(self):
        from sentinel_tpu_torch.cluster.rules import ClusterFlowRuleManager

        with self._lock:
            if self._server_rules is None:
                self._server_rules = ClusterFlowRuleManager()
            return self._server_rules

    def apply_mode(self, mode: int) -> None:
        """Flip role from the staged configs (``setClusterMode`` handler).

        Reference: ``ModifyClusterModeCommandHandler`` →
        ``ClusterStateManager.applyState``.
        """
        import time as _time

        with self._lock:
            if mode == CLUSTER_CLIENT:
                host = self.client_config.get("serverHost")
                port = self.client_config.get("serverPort")
                if not host or not port:
                    raise ValueError(
                        "client config not set: POST cluster/client/modifyConfig first")
                tv = self.client_config.get("requestTimeout")
                timeout_s = (200.0 if tv is None else float(tv)) / 1000.0
                self.set_to_client(str(host), int(port),
                                   str(self.client_config.get("namespace")
                                       or "default"),
                                   request_timeout_s=timeout_s)
            elif mode == CLUSTER_SERVER:
                from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

                service = DefaultTokenService(
                    rules=self.server_rules(),
                    max_allowed_qps=float(self.server_config["maxAllowedQps"]),
                    device=getattr(self.engine, "device", None))
                self.set_to_server(port=int(self.server_config["port"]),
                                   service=service)
            elif mode == CLUSTER_NOT_STARTED:
                self.stop()
            else:
                raise ValueError(f"invalid mode {mode}")
            self.last_modified = int(_time.time() * 1000)

    def set_to_client(self, host: str, port: int,
                      namespace: str = "default",
                      request_timeout_s: float = 2.0) -> None:
        """Flip to CLIENT: connect to a remote token server.

        The old role is torn down first (a staticly-configured port must be
        free for re-binds); if starting the new role fails the manager drops
        to NOT_STARTED rather than reporting a role that isn't running.
        """
        from sentinel_tpu_torch.cluster.client import ClusterTokenClient

        with self._lock:
            self._teardown()
            self.mode = CLUSTER_NOT_STARTED
            self.token_client = ClusterTokenClient(
                host, port, namespace,
                request_timeout_s=request_timeout_s,
                epoch_fence=self.fence).start()
            self.mode = CLUSTER_CLIENT
            self.mode_flips += 1
            self._journal_flip("CLIENT", target=f"{host}:{port}")

    def set_client(self, client) -> None:
        """Flip to CLIENT with a pre-built token client (the HA layer's
        FailoverTokenClient, or any object with the token-client
        protocol). The client is started here; teardown semantics match
        :meth:`set_to_client`."""
        with self._lock:
            self._teardown()
            self.mode = CLUSTER_NOT_STARTED
            self.token_client = client.start()
            self.mode = CLUSTER_CLIENT
            self.mode_flips += 1
            self._journal_flip("CLIENT",
                               targets=getattr(client, "targets", None))

    def set_to_server(self, host: str = "0.0.0.0", port: int = 0,
                      service=None, epoch: Optional[int] = None) -> "object":
        """Flip to SERVER: run the embedded token server; returns it.

        ``epoch`` fences this leadership term (cluster/ha.py): None mints
        the next epoch above everything this instance has observed
        (manual flips); datasource-driven flips pass the cluster map's
        epoch. epoch 0 keeps the pre-HA wire format (no epoch TLV).

        Failure semantics mirror :meth:`set_to_client`: a failed bind leaves
        the manager honestly NOT_STARTED, never claiming a dead role.
        """
        from sentinel_tpu_torch.cluster.server import ClusterTokenServer

        with self._lock:
            self._teardown()
            self.mode = CLUSTER_NOT_STARTED
            if epoch is None:
                epoch = self.fence.mint() if self.epoch or self.ha else 0
            else:
                self.fence.observe(epoch)
            self.token_server = ClusterTokenServer(
                service=service, host=host, port=port,
                engine=self.engine).start()
            self.token_server.service.epoch = int(epoch)
            # Bind the namespace telescope: leader-side flowId traffic
            # stages into the SAME tracker the engine's spill fold
            # rolls, so one population page covers both key axes.
            self.token_server.service.population = getattr(
                self.engine, "population", None)
            self.epoch = int(epoch)
            self.mode = CLUSTER_SERVER
            self.mode_flips += 1
            self._journal_flip("SERVER",
                               port=self.token_server.bound_port)
            return self.token_server

    def _teardown(self):
        if self.token_client is not None:
            self.token_client.stop()
            self.token_client = None
        if self.token_server is not None:
            # Graceful drain: give the HA layer a last chance to publish
            # the outgoing leader's window checkpoint BEFORE the listener
            # closes, so the successor warm-starts losing at most the
            # in-flight batch (crashes skip this — that is the bounded
            # over-admission margin the chaos suite asserts).
            if self.ha is not None:
                self.ha.on_server_teardown(self.token_server)
            self.token_server.stop()
            self.token_server = None

    def stop(self) -> None:
        with self._lock:
            had_role = self.mode != CLUSTER_NOT_STARTED
            self._teardown()
            self.mode = CLUSTER_NOT_STARTED
            if had_role:  # a no-op stop (engine close) is not a flip
                self._journal_flip("NOT_STARTED")

    def client_if_active(self):
        """The connected token client, or None (drives the fallback path).

        A client that ``serves_degraded`` (the HA FailoverTokenClient)
        is active even while disconnected: it answers from its per-client
        degraded-quota share instead of handing the engine full-local
        amnesty, so it must stay on the cluster-check path.

        Deliberately lock-free: this sits on the data path's per-entry
        cluster check, and role flips hold ``_lock`` across slow work
        (graceful-drain checkpoint fsyncs, listener binds) — the hot
        path must not stall behind a failover. A torn read during a
        flip at worst returns a stopping client (its request FAILs ->
        local fallback, the same thing the flip causes anyway)."""
        client = self.token_client
        if self.mode == CLUSTER_CLIENT and client is not None \
                and (client.is_connected()
                     or getattr(client, "serves_degraded", False)):
            return client
        return None

    def ha_stats(self) -> dict:
        """One ops view of the HA layer: role, leadership epoch, failover
        and degraded-mode counters (resilience command + /metrics gauges).
        Works for plain (non-HA) deployments too — counters just stay 0.

        Lock-free for the same reason as :meth:`client_if_active`: the
        resilience command and /metrics scrape must not hang on a role
        flip's drain I/O at exactly the moment operators are watching a
        failover; a racing scrape just reports the pre-flip values."""
        mode = self.mode
        srv, cli = self.token_server, self.token_client
        epoch = self.epoch
        flips = self.mode_flips
        if srv is not None:
            epoch = getattr(srv.service, "epoch", epoch)
        out = {
            "role": mode,
            "roleName": _ROLE_NAMES.get(mode, str(mode)),
            "epoch": int(max(epoch, self.fence.highest_seen)),
            "modeFlips": flips,
            "staleEpochRejected": self.fence.stale_rejected_count,
            "failoverCount": 0,
            "degraded": False,
            "degradedEntries": 0,
            "degradedSeconds": 0.0,
            "overloadedCount": 0,
            "targetsBackedOff": 0,
        }
        stats_fn = getattr(cli, "failover_stats", None)
        if stats_fn is not None:
            out.update(stats_fn())
        if srv is not None:
            # A sharded leader reports its slice ownership here (a
            # sharded CLIENT's block rides failover_stats() above).
            snap_fn = getattr(srv.service, "shard_snapshot", None)
            snap = snap_fn() if snap_fn is not None else None
            if snap is not None:
                out["shard"] = snap
        if self.ha is not None:
            out["manager"] = self.ha.stats()
        return out

    def shard_stats(self) -> Optional[dict]:
        """The shard block of :meth:`ha_stats` (slice ownership for a
        leader, routing/degraded-slice state for a sharded client), or
        None when this instance is not part of a sharded cluster."""
        return self.ha_stats().get("shard")

    def overload_stats(self) -> Optional[dict]:
        """The embedded token server's frontend overload snapshot
        (queue depth/bounds, shed counters), or None when this instance
        is not currently a server. Lock-free like :meth:`ha_stats`."""
        srv = self.token_server
        if srv is None:
            return None
        return srv.overload_stats()

    def wire_stats(self) -> Optional[dict]:
        """The embedded token server's reactor wire-path snapshot
        (connections, coalesced batch sizes, RTT split, outbuf sheds),
        or None when this instance is not a server — or serves through
        the legacy thread-per-connection frontend. Lock-free like
        :meth:`ha_stats`."""
        srv = self.token_server
        if srv is None:
            return None
        return srv.wire_stats()
