"""Namespace-scoped cluster rule management (port of
``sentinel_tpu/cluster/rules.py``; reference:
``cluster-server:flow/rule/ClusterFlowRuleManager.java`` — namespace →
property → flowId → rule; SURVEY.md §2.4).

Rules arrive as ordinary :class:`~sentinel_tpu.models.flow.FlowRule`s whose
``cluster_config`` dict carries the reference's ``ClusterFlowConfig`` fields
(``flowId``, ``thresholdType``, ``fallbackToLocalWhenFail``, ``sampleCount``,
``windowIntervalMs``). They compile to SoA tensors + a RowWindow whose
per-row bucket length encodes each rule's window geometry. The tensors
live on the device :meth:`ClusterFlowRuleManager.compile` is given (the
token service's), over the row windows of ``ops/window.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.cluster import constants as CC
from sentinel_tpu_torch.models.flow import FlowRule
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.utils.shapes import round_up as _round_up


def cluster_thresholds(rules) -> Dict[int, Tuple[float, int]]:
    """flowId -> (raw threshold, windowIntervalMs) from flow rules that
    carry a cluster ``flowId`` — THE single derivation of the
    degraded-quota share base (cluster/ha.py). The SEMANTICS.md
    sum-of-shares bound assumes every client computes the SAME share,
    so engine-attached clients (engine ``_cluster_threshold_map``) and
    engine-less standalone seats (:meth:`ClusterFlowRuleManager.thresholds`)
    both go through this helper."""
    out: Dict[int, Tuple[float, int]] = {}
    for r in rules:
        cc = getattr(r, "cluster_config", None) or {}
        if cc.get("flowId") is None:
            continue
        try:
            fid = int(cc["flowId"])
        except (TypeError, ValueError):
            continue
        try:
            interval = int(cc.get("windowIntervalMs",
                                  CC.DEFAULT_WINDOW_INTERVAL_MS))
        except (TypeError, ValueError):
            interval = CC.DEFAULT_WINDOW_INTERVAL_MS
        out[fid] = (float(r.count), interval)
    return out


class ClusterRuleTensors(NamedTuple):
    flow_id: torch.Tensor         # int64[CR]
    threshold: torch.Tensor       # f32[CR] raw count
    threshold_type: torch.Tensor  # int32[CR] AVG_LOCAL | GLOBAL
    interval_ms: torch.Tensor     # int64[CR]
    namespace_id: torch.Tensor    # int32[CR] (feeds the namespace conn count)

    @property
    def num_rules(self) -> int:
        return self.flow_id.shape[0]


class ClusterMetricState(NamedTuple):
    """The server-global sliding windows: one RowWindow row per flow rule."""

    win: W.RowWindow  # [CR, B, NUM_CLUSTER_EVENTS]


def make_metric_state(rt: ClusterRuleTensors, bucket_ms: np.ndarray,
                      buckets: int) -> ClusterMetricState:
    return ClusterMetricState(
        win=W.make_row_window(rt.num_rules, buckets, CC.NUM_CLUSTER_EVENTS,
                              bucket_ms, rt.flow_id.device))


class ClusterFlowRuleManager:
    """flowId-keyed registry across namespaces; wholesale swap per namespace."""

    def __init__(self):
        self._lock = threading.RLock()
        self._by_namespace: Dict[str, List[FlowRule]] = {}
        self._namespace_ids: Dict[str, int] = {}
        # flowId-keyed lookup maps, rebuilt on every load with the SAME
        # int-coercion as compile() — a rule loaded with flowId "123" must
        # serve request_token(123) (string/int mismatch was a lookup miss).
        self._rule_of_flow_id: Dict[int, FlowRule] = {}
        self._ns_of_flow_id: Dict[int, str] = {}
        self.version = 0
        self._listeners = []

    def namespace_id(self, namespace: str) -> int:
        with self._lock:
            nid = self._namespace_ids.get(namespace)
            if nid is None:
                nid = len(self._namespace_ids)
                self._namespace_ids[namespace] = nid
            return nid

    def namespaces(self) -> List[str]:
        with self._lock:
            return list(self._by_namespace)

    def namespace_ids(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._namespace_ids)

    def load_rules(self, namespace: str, rules: List[FlowRule]) -> None:
        """Replace one namespace's rule set (property push semantics)."""
        valid = []
        for r in rules:
            cc = r.cluster_config or {}
            try:
                int(cc.get("flowId"))
            except (TypeError, ValueError):
                continue  # missing or non-numeric flowId: drop the rule
            if r.is_valid() and r.cluster_mode:
                valid.append(r)
        with self._lock:
            self._by_namespace[namespace] = valid
            self.namespace_id(namespace)
            rule_of, ns_of = {}, {}
            for ns, rs in self._by_namespace.items():
                for r in rs:
                    fid = int((r.cluster_config or {})["flowId"])
                    rule_of[fid] = r
                    ns_of[fid] = ns
            self._rule_of_flow_id, self._ns_of_flow_id = rule_of, ns_of
            self.version += 1
            listeners = list(self._listeners)
        for fn in listeners:
            fn()

    def get_rules(self, namespace: Optional[str] = None) -> List[FlowRule]:
        with self._lock:
            if namespace is not None:
                return list(self._by_namespace.get(namespace, []))
            return [r for rs in self._by_namespace.values() for r in rs]

    def rule_by_flow_id(self, flow_id: int) -> Optional[FlowRule]:
        try:
            flow_id = int(flow_id)
        except (TypeError, ValueError):
            return None
        with self._lock:
            return self._rule_of_flow_id.get(flow_id)

    def namespace_of_flow_id(self, flow_id: int) -> Optional[str]:
        try:
            flow_id = int(flow_id)
        except (TypeError, ValueError):
            return None
        with self._lock:
            return self._ns_of_flow_id.get(flow_id)

    def add_listener(self, fn) -> None:
        with self._lock:
            self._listeners.append(fn)

    def thresholds(self) -> Dict[int, Tuple[float, int]]:
        """flowId -> (raw threshold, windowIntervalMs) for every loaded
        rule — the share base for cluster/ha.py's DegradedQuota when an
        HA participant runs from the staged server rules (engine-less
        standalone deployments)."""
        with self._lock:
            return cluster_thresholds(self._rule_of_flow_id.values())

    # -- compilation -------------------------------------------------------

    def compile(self, device="cpu") -> Tuple[ClusterRuleTensors,
                                             ClusterMetricState,
                                             Dict[int, int], Dict[int, str]]:
        """-> (tensors and a fresh metric state on ``device``, flowId ->
        slot, flowId -> ns)."""
        with self._lock:
            items = [(ns, r) for ns, rs in self._by_namespace.items() for r in rs]
            ns_ids = dict(self._namespace_ids)
        cr = _round_up(max(len(items), 1), 8)
        flow_id = np.full(cr, -1, np.int64)
        threshold = np.zeros(cr, np.float32)
        threshold_type = np.zeros(cr, np.int32)
        interval_ms = np.zeros(cr, np.int64)
        namespace_id = np.full(cr, -1, np.int32)
        bucket_ms = np.zeros(cr, np.int64)
        slot_of: Dict[int, int] = {}
        ns_of: Dict[int, str] = {}
        max_samples = 1
        for i, (ns, r) in enumerate(items):
            cc = r.cluster_config or {}
            samples = max(1, int(cc.get("sampleCount", CC.DEFAULT_SAMPLE_COUNT)))
            interval = int(cc.get("windowIntervalMs", CC.DEFAULT_WINDOW_INTERVAL_MS))
            max_samples = max(max_samples, samples)
            flow_id[i] = int(cc["flowId"])
            threshold[i] = r.count
            threshold_type[i] = int(cc.get("thresholdType", CC.THRESHOLD_AVG_LOCAL))
            interval_ms[i] = interval
            namespace_id[i] = ns_ids[ns]
            slot_of[int(cc["flowId"])] = i
            ns_of[int(cc["flowId"])] = ns
        # The RowWindow bucket COUNT is shared (= the finest sampleCount);
        # every rule's span must still cover its own interval, so each row's
        # bucket length is ceil(interval / shared-count) — rounding UP so an
        # indivisible interval (e.g. 1000ms / 7 samples) yields a span ≥ the
        # configured interval instead of refreshing quota early. Rules asking
        # for coarser sampling just get finer buckets — same totals.
        for i, (ns, r) in enumerate(items):
            cc = r.cluster_config or {}
            interval = int(cc.get("windowIntervalMs", CC.DEFAULT_WINDOW_INTERVAL_MS))
            bucket_ms[i] = max(1, -(-interval // max_samples))
        rt = ClusterRuleTensors(*(
            torch.from_numpy(a).to(device)
            for a in (flow_id, threshold, threshold_type, interval_ms,
                      namespace_id)))
        return rt, make_metric_state(rt, bucket_ms, max_samples), slot_of, ns_of
