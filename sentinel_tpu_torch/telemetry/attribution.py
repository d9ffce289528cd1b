"""Block-reason attribution + RT histogram geometry (the part of
``sentinel_tpu/telemetry/attribution.py`` the fused step uses).

Reason channels: the per-(reason, node row) staging counter carries one
channel per blockable family, in :data:`ATTR_REASON_VALUES` order. Slot
bins split blocks by the first-blocking rule slot. RT buckets are
log2-spaced response-time histogram edges (``le`` semantics, last bucket
is +Inf).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import constants as C

ATTR_REASON_VALUES: Tuple[int, ...] = (
    int(C.BlockReason.FLOW),
    int(C.BlockReason.DEGRADE),
    int(C.BlockReason.SYSTEM),
    int(C.BlockReason.AUTHORITY),
    int(C.BlockReason.PARAM_FLOW),
    int(C.BlockReason.CUSTOM),
)
NUM_ATTR_REASONS = len(ATTR_REASON_VALUES)

# Channel per BlockReason value (-1 = unattributed: PASS, WAIT).
REASON_CHANNEL_TABLE = np.full((max(int(v) for v in C.BlockReason) + 1,),
                               -1, np.int32)
for _ch, _v in enumerate(ATTR_REASON_VALUES):
    REASON_CHANNEL_TABLE[_v] = _ch

SLOT_BIN_MAX_EXACT = 8                     # bins 0..7 are exact slot indices
SLOT_BIN_OVERFLOW = SLOT_BIN_MAX_EXACT     # slot >= 8
SLOT_BIN_UNKNOWN = SLOT_BIN_MAX_EXACT + 1  # slot -1 (remote / unattributed)
NUM_SLOT_BINS = SLOT_BIN_MAX_EXACT + 2


def slot_bin_index(slot: torch.Tensor) -> torch.Tensor:
    """int32[N] slot bin per rule-slot value."""
    binned = torch.clamp(slot, max=SLOT_BIN_OVERFLOW)
    return torch.where(slot < 0, SLOT_BIN_UNKNOWN, binned).to(torch.int32)


RT_BUCKET_EDGES_MS: Tuple[int, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
NUM_RT_BUCKETS = len(RT_BUCKET_EDGES_MS) + 1  # + overflow (+Inf)


def rt_bucket_index(rt_ms: torch.Tensor) -> torch.Tensor:
    """int32[N] histogram bucket per response time: bucket b counts
    ``rt <= edge_b``; the last bucket is the +Inf overflow."""
    edges = torch.tensor(RT_BUCKET_EDGES_MS, dtype=torch.int32,
                         device=rt_ms.device)
    return (rt_ms[:, None] > edges[None, :]).sum(dim=1).to(torch.int32)
