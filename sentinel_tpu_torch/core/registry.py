"""Host-side node registry: names -> rows of the stats tensor.

The reference builds a live object graph of nodes (``core:node/``:
``ClusterNode`` per resource, ``DefaultNode`` per (context, resource),
per-origin ``StatisticNode``s inside each ClusterNode, ``EntranceNode`` per
context, plus the global ``Constants.ENTRY_NODE`` — SURVEY.md §1/§2.1).

TPU-native design: every node is simply a *row* of the shared
``[rows, buckets, events]`` stats tensor. This registry is the host-side
allocator and name table: it interns resource/context/origin strings, hands
out rows, and keeps the parent links needed to render the call tree for the
ops plane (``tree``/``jsonTree`` command handlers).

Capacity is fixed per compile (SURVEY.md §7 hard part #4): when full, new
resources get row -1, which the engine treats as pass-through — the exact
semantics of the reference's ``MAX_SLOT_CHAIN_SIZE`` cap in ``CtSph``.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from sentinel_tpu_torch.core.constants import EntryType, ResourceType

KIND_ROOT = 0
KIND_ENTRY = 1  # global ENTRY_NODE (all inbound traffic)
KIND_ENTRANCE = 2  # per-context entrance node
KIND_CLUSTER = 3  # per-resource ClusterNode
KIND_DEFAULT = 4  # per-(context, resource) DefaultNode
KIND_ORIGIN = 5  # per-(resource, origin) StatisticNode

ORIGIN_ID_NONE = -3

ROOT_ROW = 0
ENTRY_ROW = 1


@dataclass
class NodeMeta:
    row: int
    kind: int
    resource: str = ""
    context: str = ""
    origin: str = ""
    parent_row: int = -1
    entry_type: int = int(EntryType.OUT)
    resource_type: int = int(ResourceType.COMMON)
    children: List[int] = field(default_factory=list)


class NodeRegistry:
    """Thread-safe allocator of stats-tensor rows for nodes."""

    def __init__(self, capacity: int = 16384):
        self.capacity = capacity
        self._lock = threading.RLock()
        self.meta: List[NodeMeta] = []
        self._cluster: Dict[str, int] = {}
        self._default: Dict[Tuple[str, str], int] = {}
        self._origin: Dict[Tuple[str, str], int] = {}
        self._entrance: Dict[str, int] = {}
        self._origin_ids: Dict[str, int] = {}
        self._context_ids: Dict[str, int] = {}
        # Capacity-exhaustion accounting: registration past capacity is a
        # LOUD counted degrade (pass-through row -1), never a raise mid-
        # admission — ``overflow_count`` counts it,
        # and the throttled warn keeps a miss-storm out of the logs.
        self.overflow_count = 0
        self._overflow_logged_ms = 0.0
        # fixed rows
        self._alloc(KIND_ROOT, resource="machine-root")
        self._alloc(KIND_ENTRY, resource="__entry_node__", parent_row=ROOT_ROW)
        self.version = 0  # bumped on any allocation (for cache invalidation)
        # entry() row-resolution memo: (resource, context, origin, parent,
        # entry_type) -> (cluster, dn, origin_row, origin_id). Rows are
        # interned append-only and never freed, so entries never go stale;
        # a wholesale registry swap (checkpoint restore) swaps the memo
        # with it. Reads are lock-free (GIL-atomic dict get); writes
        # happen under ``_lock`` inside ``resolve_entry``.
        self._resolve_memo: Dict[Tuple, Tuple[int, int, int, int]] = {}

    # -- interning ---------------------------------------------------------

    def origin_id(self, origin: str) -> int:
        if not origin:
            return ORIGIN_ID_NONE
        with self._lock:
            oid = self._origin_ids.get(origin)
            if oid is None:
                oid = len(self._origin_ids)
                self._origin_ids[origin] = oid
            return oid

    def context_id(self, context: str) -> int:
        with self._lock:
            cid = self._context_ids.get(context)
            if cid is None:
                cid = len(self._context_ids)
                self._context_ids[context] = cid
            return cid

    # -- allocation --------------------------------------------------------

    def _alloc(self, kind: int, **kw) -> int:
        if len(self.meta) >= self.capacity:
            self._note_overflow(kind, kw.get("resource", ""))
            return -1
        row = len(self.meta)
        self.meta.append(NodeMeta(row=row, kind=kind, **kw))
        parent = self.meta[row].parent_row
        if parent >= 0:
            self.meta[parent].children.append(row)
        self.version = getattr(self, "version", 0) + 1
        return row

    def _note_overflow(self, kind: int, resource: str) -> None:
        """Count + throttled-log a registration refused at capacity.

        Callers already treat row -1 as pass-through (the reference's
        MAX_SLOT_CHAIN_SIZE stance); this makes the degrade OBSERVABLE:
        a silent -1 looks identical to healthy traffic until someone
        notices a resource with no stats. monotonic() is a log-throttle
        duration source only, never a recorded timestamp."""
        import time

        self.overflow_count += 1
        now = time.monotonic()
        if now - self._overflow_logged_ms >= 1.0:
            self._overflow_logged_ms = now
            logging.getLogger("sentinel_tpu_torch").warning(
                "node registry FULL (capacity=%d): %r (kind=%d) degrades "
                "to pass-through; overflow_count=%d",
                self.capacity, resource, kind, self.overflow_count)

    def cluster_row(self, resource: str, entry_type: int = int(EntryType.OUT),
                    resource_type: int = 0) -> int:
        """ClusterNode row for a resource (created on first touch)."""
        with self._lock:
            row = self._cluster.get(resource)
            if row is None:
                row = self._alloc(KIND_CLUSTER, resource=resource,
                                  entry_type=entry_type, resource_type=resource_type)
                if row >= 0:
                    self._cluster[resource] = row
            return row

    def entrance_row(self, context: str) -> int:
        # Lock-free hit: dict reads are GIL-atomic and entrance rows are
        # never freed, so a present entry is immutable truth (hot path —
        # every fresh context resolves its entrance once).
        row = self._entrance.get(context)
        if row is not None:
            return row
        with self._lock:
            row = self._entrance.get(context)
            if row is None:
                row = self._alloc(KIND_ENTRANCE, resource=context, context=context,
                                  parent_row=ROOT_ROW)
                if row >= 0:
                    self._entrance[context] = row
            return row

    def default_row(self, context: str, resource: str, parent_row: int) -> int:
        """DefaultNode row for (context, resource); parent = caller node."""
        with self._lock:
            key = (context, resource)
            row = self._default.get(key)
            if row is None:
                row = self._alloc(KIND_DEFAULT, resource=resource, context=context,
                                  parent_row=parent_row)
                if row >= 0:
                    self._default[key] = row
            return row

    def origin_row(self, resource: str, origin: str) -> int:
        if not origin:
            return -1
        with self._lock:
            key = (resource, origin)
            row = self._origin.get(key)
            if row is None:
                cluster = self.cluster_row(resource)
                row = self._alloc(KIND_ORIGIN, resource=resource, origin=origin,
                                  parent_row=cluster)
                if row >= 0:
                    self._origin[key] = row
            return row

    def resolve_entry(self, resource: str, context: str, origin: str,
                      parent_row: int, entry_type: int
                      ) -> Tuple[int, int, int, int]:
        """One-shot resolution of every row ``entry()`` needs:
        ``(cluster_row, dn_row, origin_row, origin_id)``, memoized.

        Collapses four locked lookups (~5µs measured) into one lock-free
        dict hit (~0.5µs) on the per-entry fast path. A full registry
        (cluster_row -1) is memoized too: rows are never freed, so a full
        registry stays full for this instance's lifetime."""
        key = (resource, context, origin, parent_row, entry_type)
        hit = self._resolve_memo.get(key)
        if hit is not None:
            return hit
        with self._lock:
            cluster = self.cluster_row(resource, entry_type)
            dn = self.default_row(context, resource, parent_row)
            orow = self.origin_row(resource, origin)
            oid = self.origin_id(origin)
            out = (cluster, dn, orow, oid)
            # Bounded: unlike rows (capacity-capped), the KEY space is
            # caller-controlled — per-request origins or deep chains could
            # otherwise grow host memory forever, and a full registry
            # (cluster -1) would keep memoizing misses after allocation
            # stopped. Past the cap the slow path still works, unmemoized.
            if cluster >= 0 and len(self._resolve_memo) < 8 * self.capacity:
                self._resolve_memo[key] = out
        return out

    # -- lookups for the ops plane ----------------------------------------

    def to_dict(self) -> Dict:
        """Serializable snapshot (checkpoint/warm-restart support)."""
        from dataclasses import asdict

        with self._lock:
            return {
                "capacity": self.capacity,
                "meta": [asdict(m) for m in self.meta],
                "cluster": dict(self._cluster),
                # Tuple keys as JSON-native triples — names are arbitrary
                # user strings, so no in-band delimiter is safe.
                "default": [[c, r, v] for (c, r), v in self._default.items()],
                "origin": [[r, o, v] for (r, o), v in self._origin.items()],
                "entrance": dict(self._entrance),
                "origin_ids": dict(self._origin_ids),
                "context_ids": dict(self._context_ids),
            }

    @classmethod
    def from_dict(cls, d: Dict) -> "NodeRegistry":
        reg = cls(int(d["capacity"]))
        with reg._lock:
            reg.meta = [NodeMeta(**m) for m in d["meta"]]
            reg._cluster = dict(d["cluster"])
            reg._default = {(c, r): v for c, r, v in d["default"]}
            reg._origin = {(r, o): v for r, o, v in d["origin"]}
            reg._entrance = dict(d["entrance"])
            reg._origin_ids = dict(d["origin_ids"])
            reg._context_ids = dict(d["context_ids"])
        return reg

    def resources(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._cluster)

    def get_cluster_row(self, resource: str) -> Optional[int]:
        return self._cluster.get(resource)

    def rows_in_use(self) -> int:
        return len(self.meta)
