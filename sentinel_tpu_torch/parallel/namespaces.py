"""Cross-slice namespace sharding over a two-axis pod (port of
``sentinel_tpu/parallel/namespaces.py``).

Two layers, as in the reference:

* **Device layer.** The pod is ``n_slices`` slices of ``per_slice``
  shards (the reference's ``("dcn", "ici")`` mesh). Cluster rules choose
  their reduction's scope per rule: the default pod scope sums within a
  slice only (each slice enforces its own quota: a sharded namespace),
  while ``cluster_config={"scope": "global"}`` rules sum over every shard
  of every slice, so one quota spans the slices. The param sketch stays
  pod scope even for global-scope rules, as in the reference. Breakers
  and local rules stay per shard; a staged candidate is not carried (the
  reference's two-axis step takes none).
* **Host layer.** :class:`NamespaceShardMap` assigns namespaces to
  slices (explicit pins or a stable sha1 hash) so host frontends route
  each namespace's traffic to the slice that owns its windows; a slice
  going down fails over to the next live one.

The drivers mirror ``parallel/cluster.py``'s and share its per-shard body:
:func:`make_dcn_pod_steps` steps a ``[S, P, ...]`` pod in one process
(:func:`make_dcn_pod_state`; lane ``i`` of the ``[S * P * B]`` batch goes
to shard ``i // B`` in slice-major order), reducing on the device;
:func:`make_dist_dcn_pod_steps` steps one shard per process, reducing
with ``all_reduce`` over one ``new_group`` per slice and over the whole
group. The reference's ``make_dcn_mesh`` (a ``jax`` mesh over the first
``n_slices * per_slice`` devices) has no counterpart: the one-process
pod's shape is its state's two leading axes, and the distributed driver
checks its group's size against ``n_slices * per_slice``.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.ops import step as S
from sentinel_tpu_torch.parallel.cluster import (
    Contribution,
    _lane_slices,
    _on,
    all_reduce_contribution,
    cat_decisions,
    check_backend,
    finish,
    prepare,
    shard,
    sum_contributions,
    write_back,
)
from sentinel_tpu_torch.utils.device import resolve_device
from sentinel_tpu_torch.utils.tree import tree_map

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


# ---------------------------------------------------------------------------
# Host layer: namespace -> slice routing
# ---------------------------------------------------------------------------


class NamespaceShardMap:
    """namespace -> slice assignment (the reference's ConnectionGroup,
    host side)."""

    def __init__(self, n_slices: int):
        if n_slices <= 0:
            raise ValueError("need at least one slice")
        self.n_slices = n_slices
        self._lock = threading.Lock()
        self._pins: Dict[str, int] = {}
        self._down: set = set()

    def _hash_slice(self, namespace: str) -> int:
        digest = hashlib.sha1(namespace.encode("utf-8")).digest()
        return int.from_bytes(digest[:4], "big") % self.n_slices

    def slice_of(self, namespace: str) -> int:
        """Owning slice: an explicit pin wins, else the stable hash; a
        down slice fails over deterministically to the next live one."""
        with self._lock:
            s = self._pins.get(namespace, self._hash_slice(namespace))
            if s not in self._down:
                return s
            for step in range(1, self.n_slices):
                cand = (s + step) % self.n_slices
                if cand not in self._down:
                    return cand
            raise RuntimeError("all slices down")

    def pin(self, namespace: str, slice_id: int) -> None:
        if not (0 <= slice_id < self.n_slices):
            raise ValueError(f"slice {slice_id} out of range")
        with self._lock:
            self._pins[namespace] = slice_id

    def mark_down(self, slice_id: int) -> None:
        with self._lock:
            self._down.add(slice_id)

    def mark_up(self, slice_id: int) -> None:
        with self._lock:
            self._down.discard(slice_id)

    def assignments(self, namespaces: List[str]) -> Dict[str, int]:
        return {ns: self.slice_of(ns) for ns in namespaces}


# ---------------------------------------------------------------------------
# Device layer: two-axis pod steps
# ---------------------------------------------------------------------------


def make_dcn_pod_state(n_slices: int, per_slice: int,
                       one: S.SentinelState) -> S.SentinelState:
    """Every leaf of ``one`` copied to leading ``[n_slices, per_slice]``
    axes."""
    return tree_map(
        lambda x: x.reshape((1, 1) + tuple(x.shape))
        .expand((n_slices, per_slice) + tuple(x.shape)).contiguous(), one)


def _global(c: Contribution) -> Contribution:
    """The part of a contribution that scope="global" rules sum over every
    slice: the window counts, not the sketch."""
    return Contribution(passes=c.passes, next_use=c.next_use)


def make_dcn_pod_steps(device=None, cluster_param: bool = True,
                       global_scope: bool = True):
    """``(entry_step, exit_step)`` over a one-process ``[S, P, ...]`` pod
    on ``device`` (``cuda`` unless given). ``global_scope=False`` drops
    the cross-slice sums (a pod whose cluster rules are all pod scope),
    as in the reference."""
    from sentinel_tpu_torch.core import spi

    device = resolve_device(device)
    checkers = spi.device_checkers()

    def entry(pod: S.SentinelState, rules: S.RulePack, batch, now_ms):
        _on(pod, device)
        n_slices, per_slice = pod.cur_threads.shape[:2]
        keys = [(s, p) for s in range(n_slices) for p in range(per_slice)]
        lanes = _lane_slices(batch, len(keys))
        prepared = [prepare(shard(pod, k), rules, now_ms,
                            cluster_param=cluster_param) for k in keys]
        by_slice = [sum_contributions([prepared[s * per_slice + p][1]
                                       for p in range(per_slice)])
                    for s in range(n_slices)]
        world = (sum_contributions([_global(c) for _, c in prepared])
                 if global_scope else None)
        decs = []
        for i, (s, p) in enumerate(keys):
            local, own = prepared[i]
            new, dec = finish(local, rules, lanes[i], now_ms, own,
                              by_slice[s], global_total=world,
                              extra_checkers=checkers)
            write_back(shard(pod, (s, p)), new)
            decs.append(dec)
        return pod, cat_decisions(decs)

    def exit_(pod: S.SentinelState, rules: S.RulePack, batch, now_ms):
        _on(pod, device)
        n_slices, per_slice = pod.cur_threads.shape[:2]
        keys = [(s, p) for s in range(n_slices) for p in range(per_slice)]
        for k, lane in zip(keys, _lane_slices(batch, len(keys))):
            write_back(shard(pod, k),
                       S.exit_step(shard(pod, k), rules, lane, now_ms))
        return pod

    return entry, exit_


def make_dist_dcn_pod_steps(n_slices: int, per_slice: int, group=None,
                            device=None, cluster_param: bool = True,
                            global_scope: bool = True):
    """``(entry_step, exit_step)`` for one shard of a two-axis pod whose
    shards are the processes of ``group`` (the default group when None):
    group rank ``r`` is shard ``(r // per_slice, r % per_slice)``. Every
    process must call this together (it creates one group per slice).
    Options as :func:`make_dcn_pod_steps`."""
    import torch.distributed as dist

    from sentinel_tpu_torch.core import spi

    device = resolve_device(device)
    check_backend(group, device)
    world = dist.get_world_size(group)
    if n_slices <= 0 or per_slice <= 0 or world != n_slices * per_slice:
        raise ValueError(f"a {n_slices} x {per_slice} pod needs "
                         f"{n_slices * per_slice} processes, the group has "
                         f"{world}")
    ranks = [r if group is None else dist.get_global_rank(group, r)
             for r in range(world)]
    slice_groups = [dist.new_group(ranks[s * per_slice:(s + 1) * per_slice])
                    for s in range(n_slices)]
    mine = slice_groups[dist.get_rank(group) // per_slice]
    checkers = spi.device_checkers()

    def entry(state: S.SentinelState, rules: S.RulePack, batch, now_ms):
        _on(state, device)
        local, own = prepare(state, rules, now_ms,
                             cluster_param=cluster_param)
        pod_total = all_reduce_contribution(own, mine)
        world_total = (all_reduce_contribution(_global(own), group)
                       if global_scope else None)
        return finish(local, rules, batch, now_ms, own, pod_total,
                      global_total=world_total, extra_checkers=checkers,
                      occupy_timeout_ms=C.DEFAULT_OCCUPY_TIMEOUT_MS)

    def exit_(state: S.SentinelState, rules: S.RulePack, batch, now_ms):
        _on(state, device)
        return S.exit_step(state, rules, batch, now_ms)

    return entry, exit_
