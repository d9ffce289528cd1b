"""A REAL in-process multi-leader sharded mesh, driven deterministically
(port of ``sentinel_tpu/chaos/mesh.py``).

Every load-bearing component is the production one: ``ClusterHAManager``
seats flip roles and publish/restore REAL checkpoint files, each seat's
control-plane mutations land in a REAL crash-safe ``ControlPlaneJournal``
file, admission runs through REAL ``DefaultTokenService`` device steps,
and routing/fencing/degraded-mode decisions are the REAL
``ShardedTokenClient`` walk over the real ``SliceEpochFence`` and
``DegradedQuota``. Leaders run their loopback wire reactors (listeners
bound on ephemeral ports), but the campaign's request path replaces the
router's socket pool with :class:`LoopbackConn` — a deterministic
in-process conduit that calls each leader's service directly, fires the
same chaos seams the wire path fires, and judges reply epochs exactly
like ``ClusterTokenClient._epoch_stale``.

Determinism: the mesh is driven by ONE thread on a program-advanced
``SimClock``, injected into every timing-sensitive component — the
router via ``ShardedTokenClient(clock=)``, the degraded quota via its
``now_ms`` parameter, the journals via their clock callable, the
services via per-request ``now_ms`` — so the verdict stream and fault
firing sequence are a pure function of ``(campaign_seed,
episode_index)`` WITHOUT touching the process clock (a campaign may run
beside a live engine; nothing global is frozen). Nothing in this
package reads a wall clock.

Device: every seat's token service runs on the mesh's ``device`` (the
seats' ``ClusterStateManager`` and ``ClusterHAManager`` get it
explicitly); ``cuda`` by default, which raises with no card.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from sentinel_tpu_torch.chaos.invariants import History
from sentinel_tpu_torch.cluster.constants import THRESHOLD_GLOBAL, TokenResultStatus
from sentinel_tpu_torch.cluster.ha import (
    ClusterHAManager,
    ClusterServerSpec,
    DegradedQuota,
)
from sentinel_tpu_torch.cluster.sharding import ShardedTokenClient, ShardMap, slice_of
from sentinel_tpu_torch.cluster.state import CLUSTER_SERVER, ClusterStateManager
from sentinel_tpu_torch.cluster.token_service import TokenResult
from sentinel_tpu_torch.models.flow import FlowRule
from sentinel_tpu_torch.resilience import faults
from sentinel_tpu_torch.telemetry.journal import ControlPlaneJournal

_FAIL = TokenResult(TokenResultStatus.FAIL)

# Terminal category per wire status (the conservation columns).
_SHED = (TokenResultStatus.OVERLOADED, TokenResultStatus.TOO_MANY_REQUEST)

# The default campaign flow set: three flows whose slices land distinct
# on the default 8-ring (slices 6, 4, 0). ONE definition — the
# scheduler's plan simulation, the mesh, and the campaign must plan,
# build, and drive the same flows or initial_assignment diverges.
DEFAULT_FLOWS = {9000: 6.0, 9001: 6.0, 9003: 6.0}


def initial_assignment(leaders, flows, n_slices) -> Dict[str, List[int]]:
    """The episode's starting slice ownership: flows' slices round-robin
    across the leaders, spare slices to the LAST leader (so it alone can
    donate voluntarily). Two flows hashing into the SAME slice place it
    once (first flow's leader keeps it) — every slice has exactly one
    owner, whatever flow set a campaign is built with. One
    implementation shared by the mesh and the scheduler's plan
    simulation — they must never diverge."""
    leaders = tuple(leaders)
    assign: Dict[str, List[int]] = {m: [] for m in leaders}
    placed: set = set()
    for fid in sorted(flows):
        sl = slice_of(fid, n_slices)
        if sl in placed:
            continue
        assign[leaders[len(placed) % len(leaders)]].append(sl)
        placed.add(sl)
    for sl in range(n_slices):
        if sl not in placed:
            assign[leaders[-1]].append(sl)
    return {m: sorted(set(s)) for m, s in assign.items()}


class _SeatHost:
    """The engine stand-in a seat's HA manager needs: an audit journal
    riding the campaign clock, degraded thresholds, no span collector."""

    def __init__(self, journal, thresholds_fn):
        self.journal = journal
        self.cluster_degraded_thresholds = thresholds_fn
        self.spans = None


class _RecordingQuota(DegradedQuota):
    """The real per-client share math, with every degraded grant
    recorded into the episode history (the degraded-bound checker's
    evidence)."""

    def __init__(self, mesh, **kw):
        super().__init__(**kw)
        self._mesh = mesh

    def acquire(self, flow_id, count: int = 1, now_ms=None):
        mesh = self._mesh
        if now_ms is None:
            now_ms = mesh.clock.now_ms()  # campaign timebase, no freeze
        r = super().acquire(flow_id, count, now_ms)
        if r is not None:
            now = mesh.clock.now_ms()
            interval = mesh.interval_of(int(flow_id))
            if r.status == TokenResultStatus.OK:
                mesh.history.add("degradedGrant", op=mesh.current_op,
                                 flow=int(flow_id),
                                 win=now - now % interval)
            mesh.served_by = "degraded"
        return r


class LoopbackConn:
    """Deterministic loopback conduit to one seat's token service —
    the token-client protocol the ``ShardedTokenClient`` walk expects,
    minus the socket. Fires the wire path's chaos seams
    (``cluster.reactor.conn.{drop,stall}``, ``cluster.ha.halfopen``,
    ``cluster.ha.stale.epoch``) and judges reply epochs against the
    router's shared per-slice fence exactly like the real client."""

    def __init__(self, mesh: "ChaosMesh", mid: str, spec: ClusterServerSpec):
        self.mesh = mesh
        self.mid = mid
        self.host = spec.host
        self.port = spec.port
        self.request_timeout_s = 2.0

    # -- token-client protocol (pool duck type) ---------------------------

    def start(self):
        return self

    def stop(self) -> None:
        pass

    def is_connected(self) -> bool:
        mesh = self.mesh
        if not mesh.link_up.get(self.mid, True):
            return False
        state = mesh.seats[self.mid].state
        srv = state.token_server
        return (srv is not None and not srv.crashed
                and state.mode == CLUSTER_SERVER)

    def request_token(self, flow_id, count: int = 1,
                      prioritized: bool = False, timeout_s=None,
                      gate_neutral: bool = False, trace=None) -> TokenResult:
        mesh = self.mesh
        try:
            fid = int(flow_id)
        except (TypeError, ValueError):
            return _FAIL
        op = mesh.current_op
        sl = slice_of(fid, mesh.n_slices)
        try:
            mesh.fire_targeted("cluster.reactor.conn.stall", self.mid)
        except OSError:
            mesh.log_fault("conn.stall", self.mid, op=op)
            return _FAIL
        try:
            mesh.fire_targeted("cluster.reactor.conn.drop", self.mid)
        except OSError:
            mesh.log_fault("conn.drop", self.mid, op=op)
            return _FAIL
        srv = mesh.seats[self.mid].state.token_server
        if srv is None or srv.crashed:
            return _FAIL
        now = mesh.clock.now_ms() + mesh.skew_ms.get(self.mid, 0)
        r = srv.service.request_token(fid, count, prioritized, now_ms=now)
        granted = r.status == TokenResultStatus.OK
        win = now - now % mesh.interval_of(fid)
        # Stale-epoch replay seam: the armed garbage payload REPLACES
        # this reply's epoch stamp (a deposed term replayed on the wire).
        replayed = mesh.mutate_targeted("cluster.ha.stale.epoch",
                                        self.mid, b"\x01")
        epoch = r.epoch
        if replayed != b"\x01":
            epoch = int.from_bytes(replayed[:8], "big") if replayed else 0
            mesh.log_fault("stale.epoch", self.mid, op=op)
        # Half-open swallow: the server did the work (and consumed quota
        # on OK) but the reply never lands — the client sees a timeout.
        swallowed = mesh.mutate_targeted("cluster.ha.halfopen",
                                         self.mid, b"\x01") != b"\x01"
        if swallowed:
            mesh.log_fault("halfopen", self.mid, op=op)
            if granted:
                mesh.history.add("grantVoid", op=op, flow=fid,
                                 leader=self.mid, win=win)
            return _FAIL
        # Per-slice fence, exactly the client's stance: unstamped
        # replies pass unfenced; a stamped reply below the lane's
        # high-water mark is a deposed term — reject it as FAIL.
        if epoch is not None and int(epoch) > 0 \
                and r.status != TokenResultStatus.WRONG_SLICE:
            ok = mesh.fence.observe(int(epoch), sl)
            mesh.history.add("fence", scope=sl, epoch=int(epoch),
                             accepted=bool(ok))
            if not ok:
                if granted:
                    mesh.history.add("grantVoid", op=op, flow=fid,
                                     leader=self.mid, win=win)
                return _FAIL
        if granted:
            mesh.history.add("grant", op=op, flow=fid, leader=self.mid,
                             win=win)
        if r.status in _SHED:
            mesh.history.add("shedBy", op=op, flow=fid, leader=self.mid)
        if r.status != TokenResultStatus.FAIL:
            mesh.served_by = self.mid
        return r

    def request_param_token(self, flow_id, count, params, timeout_s=None,
                            gate_neutral: bool = False, trace=None):
        return self.request_token(flow_id, count)

    def request_tokens_pipelined(self, requests, timeout_s=None,
                                 gate_neutral: bool = False):
        return [self.request_token(*req[:3]) for req in requests]


class ChaosMesh:
    """N HA seats + one sharded router, built fresh per episode."""

    def __init__(self, clock, history: History, workdir: str,
                 leaders=("A", "B", "C"), n_slices: int = 8,
                 flows: Optional[Dict[int, float]] = None,
                 interval_ms: int = 1000,
                 failover_deadline_ms: int = 1500,
                 clients=("chaos-c1", "chaos-c2"), device=None):
        from sentinel_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.clock = clock
        self.history = history
        self.workdir = workdir
        self.leader_order = tuple(leaders)
        self.n_slices = int(n_slices)
        self.flows = dict(flows) if flows else dict(DEFAULT_FLOWS)
        self.interval_ms = int(interval_ms)
        self.clients = tuple(clients)
        self.thresholds = {fid: (thr, self.interval_ms)
                           for fid, thr in self.flows.items()}
        self.divisor = len(self.clients)
        # -- episode state --------------------------------------------------
        self.current_op: Optional[int] = None
        self.served_by: Optional[str] = None
        self.skew_ms: Dict[str, int] = {}
        self.link_up: Dict[str, bool] = {m: True for m in leaders}
        self.crashed: set = set()
        self.fault_target: Dict[str, str] = {}
        self.fault_log: List[tuple] = []
        self._next_op = 0
        self._router_skip = 0
        # -- seats ----------------------------------------------------------
        rules = [FlowRule(resource=f"res-{fid}", count=thr,
                          cluster_mode=True,
                          cluster_config={"flowId": fid,
                                          "thresholdType": THRESHOLD_GLOBAL})
                 for fid, thr in sorted(self.flows.items())]
        # Specs carry port 0: every promotion binds an EPHEMERAL loopback
        # listener (the reactor runs; nothing routes traffic through it),
        # so episodes can never collide on ports and a seat that flips to
        # client mode dials a dead port instead of another seat's wire.
        self.specs = {m: ClusterServerSpec(m, "127.0.0.1", 0)
                      for m in leaders}
        self.seats: Dict[str, ClusterHAManager] = {}
        self.hosts: Dict[str, _SeatHost] = {}
        base = os.path.join(workdir, "handoff.ck")
        for mid in leaders:
            state = ClusterStateManager(device=self.device)
            state.server_rules().load_rules("default", rules)
            journal = ControlPlaneJournal(
                self.clock.now_ms,
                path=os.path.join(workdir, f"journal-{mid}.jsonl"))
            host = _SeatHost(journal, state.server_rules().thresholds)
            state.journal = journal
            mgr = ClusterHAManager(engine=host, state=state, machine_id=mid,
                                   checkpoint_path=base,
                                   checkpoint_period_s=3600.0,
                                   server_host="127.0.0.1",
                                   device=self.device)
            # A failed transition must never retry mid-episode on a wall
            # timer (nondeterministic); episodes are short and newer maps
            # win anyway.
            mgr.retry_delay_s = 3600.0
            self.seats[mid] = mgr
            self.hosts[mid] = host
        # -- initial map + router -------------------------------------------
        self.assignment = initial_assignment(self.leader_order, self.flows,
                                             self.n_slices)
        self.slice_epochs = {sl: 1 for sl in range(self.n_slices)}
        self.map_version = 1
        self.current_map = self._build_map()
        self._record_map_event()
        for mid in self.leader_order:
            self.seats[mid].apply_map(self.current_map)
        quota = _RecordingQuota(self, divisor=self.divisor,
                                thresholds=dict(self.thresholds))
        self.router = ShardedTokenClient(
            self.current_map, failover_deadline_ms=failover_deadline_ms,
            degraded=quota, health_gate=None, clock=self.clock.now_ms)
        self.fence = self.router.fence
        self.router._pool = {
            mid: LoopbackConn(self, mid, self.specs[mid])
            for mid in self.leader_order}

    # -- helpers -----------------------------------------------------------

    def interval_of(self, fid: int) -> int:
        return int(self.thresholds.get(fid, (0, self.interval_ms))[1])

    def _build_map(self) -> ShardMap:
        owner = [self.leader_order[-1]] * self.n_slices
        for mid, sls in self.assignment.items():
            for sl in sls:
                owner[sl] = mid
        return ShardMap(
            version=self.map_version, n_slices=self.n_slices,
            servers=tuple(self.specs[m] for m in self.leader_order),
            slice_owner=tuple(owner),
            slice_epoch=tuple(self.slice_epochs[sl]
                              for sl in range(self.n_slices)),
            clients=self.clients)

    def _record_map_event(self) -> None:
        """Evidence for the ``slice_conservation`` checker: the full
        ownership/epoch picture at every map adoption, plus the flowId →
        slice attribution (via the one ``slice_of``) so per-slice
        over-admission can be folded from the grant stream."""
        self.history.add(
            "shardMap", version=int(self.map_version), n=int(self.n_slices),
            owners={m: list(sls) for m, sls in self.assignment.items()},
            epochs={int(sl): int(ep)
                    for sl, ep in self.slice_epochs.items()},
            flows={int(fid): slice_of(fid, self.n_slices)
                   for fid in sorted(self.flows)})

    def fire_targeted(self, point: str, mid: str) -> None:
        if self.fault_target.get(point) in (None, mid):
            faults.fire(point)

    def mutate_targeted(self, point: str, mid: str, data: bytes) -> bytes:
        if self.fault_target.get(point) in (None, mid):
            return faults.mutate(point, data)
        return data

    def log_fault(self, kind: str, *args, **kw) -> None:
        self.fault_log.append((kind, args, tuple(sorted(kw.items()))))

    # -- the driven request path -------------------------------------------

    def request(self, fid: int, sec: int) -> str:
        op = self._next_op
        self._next_op += 1
        self.current_op = op
        self.served_by = None
        self.history.add("offered", op=op, flow=fid, sec=sec)
        r = self.router.request_token(fid)
        if r.status == TokenResultStatus.OK:
            status = "pass"
        elif r.status == TokenResultStatus.BLOCKED:
            status = "block"
        elif r.status in _SHED:
            status = "shed"
        else:
            status = "dropped"
        self.history.add("verdict", op=op, flow=fid, status=status,
                         by=self.served_by, sec=sec, wire=int(r.status))
        return status

    # -- scheduled actions -------------------------------------------------

    def apply_action(self, action: dict, injector, sec: int) -> Optional[int]:
        """Execute one schedule item; returns a link-restore second for
        ``link.down`` (the campaign re-raises the link), else None."""
        kind = action["kind"]
        mid = action.get("leader")
        self.log_fault("act:" + kind, mid or "", sec=sec)
        if kind == "conn.drop":
            self.fault_target["cluster.reactor.conn.drop"] = mid
            injector.arm("cluster.reactor.conn.drop", "error",
                         times=action.get("times", 1))
        elif kind == "conn.stall":
            self.fault_target["cluster.reactor.conn.stall"] = mid
            injector.arm("cluster.reactor.conn.stall", "error",
                         times=action.get("times", 1))
        elif kind == "halfopen":
            self.fault_target["cluster.ha.halfopen"] = mid
            injector.arm("cluster.ha.halfopen", "garbage", garbage=b"",
                         times=action.get("times", 1))
        elif kind == "stale.epoch":
            self.fault_target["cluster.ha.stale.epoch"] = mid
            injector.arm("cluster.ha.stale.epoch", "garbage",
                         garbage=(1).to_bytes(8, "big"),
                         times=action.get("times", 1))
        elif kind == "link.down":
            self.link_up[mid] = False
            return sec + int(action.get("secs", 1))
        elif kind == "crash":
            seat = self.seats[mid]
            srv = seat.state.token_server
            if srv is not None and not srv.crashed \
                    and seat.state.mode == CLUSTER_SERVER:
                srv._fault_crash()
                self.crashed.add(mid)
        elif kind == "publish":
            try:
                self.seats[mid].publish_checkpoint()
            except Exception:  # noqa: BLE001 — torn/fenced publish: logged
                self.log_fault("publish.failed", mid, sec=sec)
        elif kind == "torn.publish":
            injector.arm("checkpoint.torn.write", "garbage", times=1)
        elif kind == "ckpt.crash":
            injector.arm("checkpoint.torn.write", "error", times=1)
        elif kind == "journal.full":
            injector.arm("journal.disk.full", "error",
                         times=action.get("times", 1))
        elif kind == "journal.restart":
            host = self.hosts[mid]
            host.journal.close()
            host.journal = ControlPlaneJournal(
                self.clock.now_ms,
                path=os.path.join(self.workdir, f"journal-{mid}.jsonl"))
            self.seats[mid].state.journal = host.journal
        elif kind == "flap":
            self.fault_target["datasource.flap"] = mid
            injector.arm("datasource.flap", "error",
                         times=action.get("times", 1))
        elif kind == "map.split":
            injector.arm("cluster.shard.map.split", "error",
                         after=action.get("after", 0), times=1)
        elif kind == "zombie":
            injector.arm("cluster.shard.donor.zombie", "error", times=1)
        elif kind == "router.stale":
            self._router_skip += 1
        elif kind == "skew":
            try:
                faults.fire("cluster.leader.clock.skew")
            except OSError:
                self.log_fault("skew.vetoed", mid, sec=sec)
            else:
                self.skew_ms[mid] = int(action.get("ms", 0))
        elif kind == "overload":
            srv = self.seats[mid].state.token_server
            if srv is not None and not srv.crashed:
                srv.service.limiter.max_allowed_qps = float(
                    action.get("qps", 2))
        elif kind == "rebalance":
            self.rebalance(action["assignment"], action["epochs"],
                           action["version"])
        else:
            raise ValueError(f"unknown chaos action kind {kind!r}")
        return None

    def rebalance(self, assignment: Dict[str, List[int]],
                  epochs: Dict[int, int], version: int) -> None:
        """Adopt a FULL new assignment (the action is self-contained so
        any shrunken subset of a schedule stays executable): push to
        every live seat (flap/split/zombie seams apply), then to the
        router unless a ``router.stale`` action is pending — recording
        one ``transfer`` event per flow whose slice changed hands."""
        new_assign = {m: sorted(int(s) for s in sls)
                      for m, sls in assignment.items()}
        old_owner = {sl: mid for mid, sls in self.assignment.items()
                     for sl in sls}
        new_owner = {sl: mid for mid, sls in new_assign.items()
                     for sl in sls}
        now = self.clock.now_ms()
        for fid in sorted(self.flows):
            sl = slice_of(fid, self.n_slices)
            if old_owner.get(sl) != new_owner.get(sl):
                self.history.add(
                    "transfer", flow=fid, slice=sl,
                    frm=old_owner.get(sl), to=new_owner.get(sl),
                    win=now - now % self.interval_of(fid))
        self.assignment = new_assign
        self.slice_epochs.update({int(s): int(e) for s, e in epochs.items()})
        self.map_version = max(self.map_version + 1, int(version))
        self.current_map = self._build_map()
        self._record_map_event()
        for mid in self.leader_order:
            if mid in self.crashed:
                continue  # a dead seat gets no pushes (it is dead)
            try:
                self.fire_targeted("datasource.flap", mid)
            except OSError:
                self.log_fault("flap", mid)
                continue
            self.seats[mid].apply_map(self.current_map)
        if self._router_skip > 0:
            self._router_skip -= 1
            self.log_fault("router.stale", "")
        else:
            self.router.apply_map(self.current_map)

    # -- episode-end surfaces ----------------------------------------------

    def collect_journals(self) -> None:
        """Append each seat's DURABLE seq stream to the history (the
        journal-monotonicity checker's evidence; replay() reads the file
        set, so records from before a mid-episode restart are covered)."""
        for mid in self.leader_order:
            seqs = [int(r.get("seq", 0))
                    for r in self.hosts[mid].journal.replay()]
            self.history.add("journal", leader=mid, seqs=seqs)

    def journal_snapshot(self, stamp_ms: int) -> Dict[str, dict]:
        """The forensic join: per seat, the journal tail, the
        causeSeq walk from its newest record, and the shard map in force
        at the violation stamp — the ``why`` discipline applied to
        a chaos verdict."""
        out = {}
        for mid in self.leader_order:
            j = self.hosts[mid].journal
            out[mid] = {
                "lastSeq": j.last_seq,
                "tail": j.tail(limit=16),
                "chain": j.chain(j.last_seq) if j.last_seq else [],
                "mapInForce": j.in_force(
                    stamp_ms, ("shardMapApply", "clusterMapApply")),
            }
        return out

    def stop(self) -> None:
        self.router.stop()
        for mid in self.leader_order:
            try:
                self.seats[mid].stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
            self.hosts[mid].journal.close()
