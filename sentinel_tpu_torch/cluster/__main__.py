"""Alone-mode cluster token server: ``python -m sentinel_tpu_torch.cluster``
(port of ``sentinel_tpu/cluster/__main__.py``).

Reference: ``sentinel-cluster-server-default``'s standalone deployment
(``SentinelDefaultTokenServer`` run outside any app process) plus the
``sentinel-demo-cluster-server-alone`` wiring (SURVEY.md §2.4, §2.7):
a dedicated token-server process whose per-namespace cluster flow rules
come from a dynamic file datasource, so rule edits land without restart
— the same property-push path an embedded server uses.

Rules file format — one JSON object mapping namespace to its rule list
(each rule a flow-rule dict as produced by ``datasource/converters.py``,
with ``clusterMode`` + ``clusterConfig.flowId``):

    {
      "ns-a": [{"resource": "getUser", "count": 100, "clusterMode": true,
                "clusterConfig": {"flowId": 1, "thresholdType": 1}}],
      "ns-b": []
    }

A namespace removed from the file is unloaded (its flows stop resolving,
clients get NO_RULE_EXISTS and fall back local — the reference's designed
failure mode).

Device policy: the token service (and, in HA mode, every leader term's
service) runs on ``cuda``; with no card and no ``--device`` the process
exits non-zero with :func:`resolve_device`'s error. ``--device cpu`` runs
the plain CPU path when asked for.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

from sentinel_tpu_torch.cluster.constants import DEFAULT_MAX_ALLOWED_QPS
from sentinel_tpu_torch.cluster.server import ClusterTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.core.property import SimplePropertyListener
from sentinel_tpu_torch.datasource.base import FileRefreshableDataSource
from sentinel_tpu_torch.datasource.converters import flow_rule_from_dict
from sentinel_tpu_torch.models.flow import FlowRule
from sentinel_tpu_torch.utils.device import resolve_device

# The reference's default token-server port (ClusterConstants).
DEFAULT_PORT = 18730


def parse_namespace_rules(text: str) -> Dict[str, List[FlowRule]]:
    """``{namespace: [flow-rule dict, ...]}`` JSON → FlowRule lists."""
    raw = json.loads(text)
    if not isinstance(raw, dict):
        raise ValueError("rules file must be a JSON object "
                         "{namespace: [rules...]}")
    out: Dict[str, List[FlowRule]] = {}
    for ns, items in raw.items():
        if not isinstance(items, list):
            raise ValueError(f"namespace {ns!r} must map to a rule list")
        out[ns] = [flow_rule_from_dict(d) for d in items]
    return out


class StandaloneHAParticipant:
    """One seat of an HA token-server group (``--cluster-map``): the
    cluster-map file decides which seat leads each epoch; this process
    binds the token port only while it IS the leader, warm-starting from
    the shared checkpoint, and otherwise stands by as a client watching
    the map. Rules come from the same per-namespace rules file in every
    seat, staged into the manager's persistent rule set so a promotion
    serves the identical rule universe the old leader did."""

    def __init__(self, map_path: str, machine_id: str,
                 rules_path: str = None, checkpoint_path: str = None,
                 refresh_ms: int = 3000, host: str = "0.0.0.0",
                 device=None):
        from sentinel_tpu_torch.cluster.ha import ClusterHAManager
        from sentinel_tpu_torch.cluster.state import ClusterStateManager
        from sentinel_tpu_torch.datasource.converters import (
            any_cluster_map_from_json)

        self.device = resolve_device(device)
        self.state = ClusterStateManager(device=self.device)
        self.ha = ClusterHAManager(state=self.state, machine_id=machine_id,
                                   checkpoint_path=checkpoint_path,
                                   server_host=host, device=self.device)
        self._rules_source = None
        if rules_path is not None:
            self._rules_source = FileRefreshableDataSource(
                rules_path, converter=parse_namespace_rules,
                recommend_refresh_ms=refresh_ms)
            self._rules_source.property.add_listener(
                SimplePropertyListener(self._apply_rules))
        self._map_source = FileRefreshableDataSource(
            map_path, converter=any_cluster_map_from_json,
            recommend_refresh_ms=refresh_ms)
        self.ha.watch(self._map_source.property)

    def _apply_rules(self, ns_rules: Dict[str, List[FlowRule]]) -> None:
        mgr = self.state.server_rules()
        for gone in set(mgr.namespaces()) - set(ns_rules):
            if mgr.get_rules(gone):
                mgr.load_rules(gone, [])
        for ns, rules in ns_rules.items():
            mgr.load_rules(ns, rules)

    def start(self) -> "StandaloneHAParticipant":
        # Rules land BEFORE the first map apply so a leader's very first
        # bind already serves (and checkpoint-restores) the full rule
        # set; both initial loads fail fast, same stance as the plain
        # standalone server.
        if self._rules_source is not None:
            value = self._rules_source.load_config()
            self._rules_source.property.update_value(value)
            self._rules_source.start(initial_load=False)
        value = self._map_source.load_config()
        self._map_source.property.update_value(value)
        self._map_source.start(initial_load=False)
        return self

    def refresh(self) -> None:
        """One deterministic poll of both files (tests / ops)."""
        if self._rules_source is not None:
            self._rules_source.refresh(force=True)
        self._map_source.refresh(force=True)

    def stop(self) -> None:
        self._map_source.close()
        if self._rules_source is not None:
            self._rules_source.close()
        self.ha.stop()


class StandaloneTokenServer:
    """TLV token server + file-fed per-namespace cluster rules."""

    def __init__(self, port: int = DEFAULT_PORT, host: str = "0.0.0.0",
                 rules_path: str = None,
                 refresh_ms: int = 3000,
                 max_allowed_qps: float = DEFAULT_MAX_ALLOWED_QPS,
                 device=None):
        self.service = DefaultTokenService(max_allowed_qps=max_allowed_qps,
                                           device=device)
        self.server = ClusterTokenServer(self.service, host=host, port=port)
        self._source = None
        if rules_path is not None:
            self._source = FileRefreshableDataSource(
                rules_path, converter=parse_namespace_rules,
                recommend_refresh_ms=refresh_ms)
            self._source.property.add_listener(
                SimplePropertyListener(self._apply))

    @property
    def bound_port(self) -> int:
        return self.server.bound_port

    def _apply(self, ns_rules: Dict[str, List[FlowRule]]) -> None:
        mgr = self.service.rules
        for gone in set(mgr.namespaces()) - set(ns_rules):
            if mgr.get_rules(gone):  # skip already-empty: no listener churn
                mgr.load_rules(gone, [])
        for ns, rules in ns_rules.items():
            mgr.load_rules(ns, rules)

    def start(self) -> "StandaloneTokenServer":
        if self._source is not None:
            # Fail FAST on a missing/malformed rules file at startup: a
            # server that silently binds with zero rules disables cluster
            # limiting fleet-wide (every acquire -> NO_RULE_EXISTS ->
            # local fallback) with no error anywhere. The validated value
            # itself is pushed (no second, error-swallowing read to race);
            # later edits stay lenient — the poll loop logs and keeps the
            # last good rules.
            value = self._source.load_config()  # raises on bad file
            self._source.property.update_value(value)
            self._source.start(initial_load=False)
        # Warm the service before binding the port, as an HA leader does
        # (cluster/ha.py:_warm_up): on the card the probe loads and
        # launches the acquire kernel, so the first client's token does
        # not pay for it. A no-rule probe consumes no flow's quota.
        self.service.request_tokens([(None, 0, False)])
        self.server.start()
        return self

    def stop(self) -> None:
        self.server.stop()
        if self._source is not None:
            self._source.close()

    def refresh(self) -> None:
        """One deterministic rules-file poll (tests)."""
        if self._source is not None:
            self._source.refresh(force=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m sentinel_tpu_torch.cluster",
        description="standalone Sentinel cluster token server")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--rules", required=True,
                   help="JSON file: {namespace: [flow rules...]}")
    p.add_argument("--refresh-ms", type=int, default=3000,
                   help="rules file poll interval")
    p.add_argument("--max-allowed-qps", type=float,
                   default=DEFAULT_MAX_ALLOWED_QPS,
                   help="per-namespace self-protection cap")
    p.add_argument("--cluster-map", default=None,
                   help="HA mode: cluster-map JSON file (epoch + ordered "
                        "server seats); this process leads only while the "
                        "map says so")
    p.add_argument("--machine-id", default=None,
                   help="this seat's machineId in the cluster map "
                        "(default: csp.sentinel.cluster.ha.machine.id "
                        "or hostname@pid)")
    p.add_argument("--ha-checkpoint", default=None,
                   help="shared window-checkpoint path for HA warm starts "
                        "(default: csp.sentinel.cluster.ha.checkpoint.path)")
    p.add_argument("--device", default=None,
                   help="torch device of the token service (default: cuda; "
                        "with no card the process exits unless --device "
                        "cpu asks for the CPU path)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as ex:
        p.error(str(ex))

    if args.cluster_map:
        from sentinel_tpu_torch.cluster.ha import default_machine_id

        machine_id = args.machine_id or default_machine_id()
        part = StandaloneHAParticipant(
            map_path=args.cluster_map, machine_id=machine_id,
            rules_path=args.rules, checkpoint_path=args.ha_checkpoint,
            refresh_ms=args.refresh_ms, host=args.host, device=device)
        part.start()
        print(f"HA participant {machine_id} role="
              f"{part.state.ha_stats()['roleName']} "
              f"epoch={part.state.ha_stats()['epoch']}", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            part.stop()
        return 0

    srv = StandaloneTokenServer(
        port=args.port, host=args.host, rules_path=args.rules,
        refresh_ms=args.refresh_ms, max_allowed_qps=args.max_allowed_qps,
        device=device)
    srv.start()
    loaded = {ns: len(srv.service.rules.get_rules(ns))
              for ns in srv.service.rules.namespaces()}
    print(f"token server listening on {args.host}:{srv.bound_port} "
          f"namespaces={loaded}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
