"""Block-reason attribution + RT histogram geometry (the part of
``sentinel_tpu/telemetry/attribution.py`` the fused step and the decision
traces use).

Reason channels: the per-(reason, node row) staging counter carries one
channel per blockable family, in :data:`ATTR_REASON_VALUES` order. Slot
bins split blocks by the first-blocking rule slot. RT buckets are
log2-spaced response-time histogram edges (``le`` semantics, last bucket
is +Inf).
"""

from __future__ import annotations

from typing import Sequence, Tuple

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
ATTR_REASON_NAMES: Tuple[str, ...] = tuple(
    C.BlockReason(v).name for v in ATTR_REASON_VALUES)
NUM_ATTR_REASONS = len(ATTR_REASON_VALUES)

# Channel index for a BlockReason value (-1 for PASS / WAIT).
_CHANNEL_OF = {v: i for i, v in enumerate(ATTR_REASON_VALUES)}


def reason_channel(reason: int) -> int:
    return _CHANNEL_OF.get(int(reason), -1)


# Channel per BlockReason value (-1 = unattributed: PASS, WAIT).
REASON_CHANNEL_TABLE = np.full((max(int(v) for v in C.BlockReason) + 1,),
                               -1, np.int32)
for _v, _ch in _CHANNEL_OF.items():
    REASON_CHANNEL_TABLE[_v] = _ch

# Rule-slot field width in the packed reason code; one slot value is
# reserved for "unknown".
_SLOT_BITS = 8
MAX_SLOT_CODE = (1 << _SLOT_BITS) - 2


def encode_reason_code(reason: int, slot: int) -> int:
    """``family x first-blocking-slot`` packed as one int: slot -1
    (unknown) encodes as the reserved top value; reason 0 (PASS) is 0."""
    if reason == 0:
        return 0
    s = MAX_SLOT_CODE + 1 if slot < 0 else min(int(slot), MAX_SLOT_CODE)
    return (int(reason) << _SLOT_BITS) | s


def decode_reason_code(code: int) -> Tuple[int, int]:
    """Inverse of :func:`encode_reason_code` -> ``(reason, slot)``."""
    if code == 0:
        return 0, -1
    slot = code & ((1 << _SLOT_BITS) - 1)
    return code >> _SLOT_BITS, (-1 if slot > MAX_SLOT_CODE else slot)

SLOT_BIN_MAX_EXACT = 8                     # bins 0..7 are exact slot indices
SLOT_BIN_OVERFLOW = SLOT_BIN_MAX_EXACT     # slot >= 8
SLOT_BIN_UNKNOWN = SLOT_BIN_MAX_EXACT + 1  # slot -1 (remote / unattributed)
NUM_SLOT_BINS = SLOT_BIN_MAX_EXACT + 2
SLOT_BIN_LABELS: Tuple[str, ...] = tuple(
    [str(i) for i in range(SLOT_BIN_MAX_EXACT)] + ["8+", "unknown"])


def slot_bin_index(slot: torch.Tensor) -> torch.Tensor:
    """int32[N] slot bin per rule-slot value."""
    binned = torch.clamp(slot, max=SLOT_BIN_OVERFLOW)
    return torch.where(slot < 0, SLOT_BIN_UNKNOWN, binned).to(torch.int32)


def slot_bins_to_dict(arr) -> dict:
    """[NUM_ATTR_REASONS, NUM_SLOT_BINS] counts -> {reason: {label:
    count}}, zero bins and empty reasons skipped (the one rendering of the
    (reason, slot) split the JSON surfaces share)."""
    out = {}
    for ch, reason in enumerate(ATTR_REASON_NAMES):
        bins = {SLOT_BIN_LABELS[b]: int(arr[ch, b])
                for b in range(min(arr.shape[1], NUM_SLOT_BINS))
                if arr[ch, b]}
        if bins:
            out[reason] = bins
    return out


RT_BUCKET_EDGES_MS: Tuple[int, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
NUM_RT_BUCKETS = len(RT_BUCKET_EDGES_MS) + 1  # + overflow (+Inf)


def rt_bucket_index(rt_ms: torch.Tensor) -> torch.Tensor:
    """int32[N] histogram bucket per response time: bucket b counts
    ``rt <= edge_b``; the last bucket is the +Inf overflow."""
    edges = torch.tensor(RT_BUCKET_EDGES_MS, dtype=torch.int32,
                         device=rt_ms.device)
    return (rt_ms[:, None] > edges[None, :]).sum(dim=1).to(torch.int32)


# The latency waterfall's ladder (telemetry/waterfall.py): sub-millisecond
# resolution on the same log2 / +Inf convention, 2^-6 ms .. 2^12 ms.
WF_BUCKET_EDGES_MS: Tuple[float, ...] = tuple(
    float(2.0 ** k) for k in range(-6, 13))
NUM_WF_BUCKETS = len(WF_BUCKET_EDGES_MS) + 1  # + overflow (+Inf)


def bucket_index_of(value_ms: float,
                    edges: Sequence[float] = WF_BUCKET_EDGES_MS) -> int:
    """Host-side bucket index for one observation (``le`` semantics:
    bucket b holds ``value <= edge_b``; past the last edge -> overflow)."""
    for b, edge in enumerate(edges):
        if value_ms <= edge:
            return b
    return len(edges)


def histogram_quantile_edges(counts: Sequence[float], q: float,
                             edges: Sequence[float]) -> float:
    """Estimate the q-quantile (0..1) from per-bucket counts over an
    arbitrary edge ladder (``counts`` = len(edges) buckets + overflow).

    Linear interpolation within the winning bucket (Prometheus
    ``histogram_quantile`` convention); the overflow bucket reports its
    lower edge. Returns 0.0 on an empty histogram.
    """
    total = float(sum(counts))
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for b, cnt in enumerate(counts):
        prev = cum
        cum += float(cnt)
        if cum >= target and cnt > 0:
            if b >= len(edges):  # overflow: no upper edge
                return float(edges[-1])
            lo = 0.0 if b == 0 else float(edges[b - 1])
            hi = float(edges[b])
            return lo + (hi - lo) * (target - prev) / float(cnt)
    return float(edges[-1])


def histogram_quantile(counts: Sequence[float], q: float) -> float:
    """Estimate the q-quantile (0..1) from per-bucket counts indexed like
    :data:`RT_BUCKET_EDGES_MS` plus the overflow bucket."""
    return histogram_quantile_edges(counts, q, RT_BUCKET_EDGES_MS)
