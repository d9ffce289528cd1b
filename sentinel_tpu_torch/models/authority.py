"""Authority rules: per-resource origin allow/deny lists (port of
``sentinel_tpu/models/authority.py``).

Origins are interned to int ids host-side, so the device check is a
vectorized membership test of ``batch.origin_id`` against a padded
``int32[AR, K]`` id table. Requests with an empty origin always pass;
WHITE passes iff the origin is listed, BLACK iff it is not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import EntryBatch
from sentinel_tpu_torch.core.registry import NodeRegistry
from sentinel_tpu_torch.core.rule_manager import RuleManager
from sentinel_tpu_torch.ops.window import gather
from sentinel_tpu_torch.utils.device import resolve_device
from sentinel_tpu_torch.utils.shapes import round_up as _round_up

MIN_ORIGIN_SLOTS = 4

_NO_ORIGIN = -100  # padding id that never equals a real interned origin


@dataclass
class AuthorityRule:
    resource: str
    limit_app: str  # comma-separated origin names
    strategy: int = C.AUTHORITY_WHITE
    candidate_set: Optional[str] = None
    rollout_stage: Optional[str] = None

    def is_valid(self) -> bool:
        return bool(self.resource) and bool(self.limit_app) and self.strategy in (
            C.AUTHORITY_WHITE,
            C.AUTHORITY_BLACK,
        )

    def origins(self) -> List[str]:
        return [o.strip() for o in self.limit_app.split(",") if o.strip()]


class AuthorityRuleTensors(NamedTuple):
    resource_row: torch.Tensor  # int32[AR]
    strategy: torch.Tensor      # int32[AR]
    origin_ids: torch.Tensor    # int32[AR, K] padded with _NO_ORIGIN
    rules_by_row: torch.Tensor  # int32[R, S] rule ids per ClusterNode row

    @property
    def num_rules(self) -> int:
        return self.resource_row.shape[0]

    @property
    def slots(self) -> int:
        return self.rules_by_row.shape[1]


def compile_authority_rules(
    rules: List[AuthorityRule],
    registry: NodeRegistry,
    num_rows: int,
    min_slots: int = 0,
    device=None,
) -> AuthorityRuleTensors:
    device = resolve_device(device)
    valid = [r for r in rules if r.is_valid()]
    ar = _round_up(len(valid), 8)
    k = max(
        MIN_ORIGIN_SLOTS,
        _round_up(max((len(r.origins()) for r in valid), default=1), 4),
    )
    res_row = np.full(ar, -1, np.int32)
    strategy = np.zeros(ar, np.int32)
    origin_ids = np.full((ar, k), _NO_ORIGIN, np.int32)
    by_row: Dict[int, List[int]] = {}

    for i, r in enumerate(valid):
        row = registry.cluster_row(r.resource)
        res_row[i] = row
        strategy[i] = r.strategy
        for j, origin in enumerate(r.origins()[:k]):
            origin_ids[i, j] = registry.origin_id(origin)
        if row >= 0:
            by_row.setdefault(row, []).append(i)

    # 0 slots when no rules (the per-slot loop vanishes); ``min_slots`` is
    # the engine's ratchet, as in the JAX package.
    s = max(min_slots, max((len(v) for v in by_row.values()), default=0))
    rules_by_row = np.full((num_rows, s), -1, np.int32)
    for row, ids in by_row.items():
        rules_by_row[row, : len(ids)] = ids

    t = lambda a: torch.as_tensor(a, device=device)
    return AuthorityRuleTensors(
        resource_row=t(res_row),
        strategy=t(strategy),
        origin_ids=t(origin_ids),
        rules_by_row=t(rules_by_row),
    )


class AuthorityRuleManager(RuleManager):
    """Wholesale-swap registry (reference: ``AuthorityRuleManager``)."""


class AuthorityVerdict(NamedTuple):
    blocked: torch.Tensor  # bool[N]
    slot: torch.Tensor     # int32[N] first-blocking rule slot (-1 = not blocked)


def check_authority(
    rt: AuthorityRuleTensors,
    batch: EntryBatch,
    candidate: torch.Tensor,  # bool[N]
) -> AuthorityVerdict:
    """Vectorized ``AuthorityRuleChecker.passCheck``."""
    n = batch.size
    dev = batch.cluster_row.device
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    first_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    has_origin = batch.origin_id >= 0

    for k in range(rt.slots):
        rule_id = gather(rt.rules_by_row[:, k], batch.cluster_row, -1)
        has_rule = rule_id >= 0
        ids = gather(rt.origin_ids, rule_id, _NO_ORIGIN)  # [N, K]
        member = (ids == batch.origin_id[:, None]).any(dim=1) & has_origin
        strat = gather(rt.strategy, rule_id, C.AUTHORITY_WHITE)
        ok = torch.where(strat == C.AUTHORITY_WHITE, member, ~member)
        # Empty-origin requests always pass (reference checker's early out).
        applicable = has_rule & candidate & has_origin
        slot_blocked = applicable & (~ok)
        first_slot = torch.where(slot_blocked & (~blocked), k, first_slot)
        blocked = blocked | slot_blocked

    return AuthorityVerdict(blocked=blocked, slot=first_slot)
