"""Device-side micro-batch layouts (port of ``sentinel_tpu/core/batch.py``).

The host engine expands each ``entry``/``exit`` call into fixed-width rows
of these struct-of-arrays batches (padding with row = -1), so the device
step is a function of (state, rules, batch, now).

The numpy staging buffers (``make_entry_batch_np`` / ``make_exit_batch_np``)
are identical to the JAX package's, so one staged dict can feed both.
``to_device`` turns one into tensors. ``param_hash`` is uint32 on the
host; torch's uint32 support is thin, so on the device it is carried as
int64 holding the same value in ``[0, 2^32)`` (``models/param_flow.py``
emulates the uint32 wrap-around with ``& 0xFFFFFFFF``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class EntryBatch(NamedTuple):
    """One admission micro-batch of N entry attempts (padded)."""

    cluster_row: torch.Tensor  # int32[N] resource ClusterNode row (-1 pad)
    dn_row: torch.Tensor       # int32[N] per-(context,resource) DefaultNode row
    origin_row: torch.Tensor   # int32[N] per-(resource,origin) row, -1 if none
    origin_id: torch.Tensor    # int32[N] interned origin (ORIGIN_ID_NONE if "")
    origin_named: torch.Tensor  # bool[N] origin named by some flow rule on res
    context_id: torch.Tensor   # int32[N] interned context name
    count: torch.Tensor        # int32[N] tokens to acquire
    prioritized: torch.Tensor  # bool[N]
    entry_in: torch.Tensor     # bool[N] EntryType.IN (system rules apply)
    skip_cluster: torch.Tensor  # bool[N] cluster rules enforced remotely
    pre_blocked: torch.Tensor  # bool[N] rejected before the step
    pre_reason: torch.Tensor   # int32[N] BlockReason of a pre_blocked entry
    pre_passed: torch.Tensor   # bool[N] admitted before the step
    param_hash: torch.Tensor   # int64[N, MAX_PARAMS] uint32 value hashes
    param_present: torch.Tensor  # bool[N, MAX_PARAMS]

    @property
    def size(self) -> int:
        return self.cluster_row.shape[0]


class ExitBatch(NamedTuple):
    """One completion micro-batch: rt / success / exception commits."""

    cluster_row: torch.Tensor  # int32[N]
    dn_row: torch.Tensor
    origin_row: torch.Tensor
    entry_in: torch.Tensor     # bool[N]
    count: torch.Tensor        # int32[N]
    rt_ms: torch.Tensor        # int32[N] response time
    success: torch.Tensor      # bool[N]
    error: torch.Tensor        # bool[N] business exception recorded
    param_hash: torch.Tensor   # int64[N, MAX_PARAMS] uint32 value hashes
    param_present: torch.Tensor  # bool[N, MAX_PARAMS]

    @property
    def size(self) -> int:
        return self.cluster_row.shape[0]


class Decisions(NamedTuple):
    """Per-entry verdicts coming back from the device step."""

    reason: torch.Tensor   # int32[N] BlockReason (0 = pass)
    wait_us: torch.Tensor  # int64[N] host must sleep this long before admitting
    rule_slot: torch.Tensor  # int32[N] first-blocking rule slot, -1 = none


MAX_PARAMS = 4

# Batch-width ladder shared with the JAX package: the engine pads every
# batch to one of these widths.
BATCH_WIDTHS = (1, 8, 64, 512, 2048)


def make_entry_batch_np(n: int):
    """Host-side numpy staging buffers for an EntryBatch of width n."""
    return dict(
        cluster_row=np.full(n, -1, np.int32),
        dn_row=np.full(n, -1, np.int32),
        origin_row=np.full(n, -1, np.int32),
        origin_id=np.full(n, -3, np.int32),
        origin_named=np.zeros(n, bool),
        context_id=np.zeros(n, np.int32),
        count=np.zeros(n, np.int32),
        prioritized=np.zeros(n, bool),
        entry_in=np.zeros(n, bool),
        skip_cluster=np.zeros(n, bool),
        pre_blocked=np.zeros(n, bool),
        pre_reason=np.full(n, 1, np.int32),  # BlockReason.FLOW
        pre_passed=np.zeros(n, bool),
        param_hash=np.zeros((n, MAX_PARAMS), np.uint32),
        param_present=np.zeros((n, MAX_PARAMS), bool),
    )


def make_exit_batch_np(n: int):
    return dict(
        cluster_row=np.full(n, -1, np.int32),
        dn_row=np.full(n, -1, np.int32),
        origin_row=np.full(n, -1, np.int32),
        entry_in=np.zeros(n, bool),
        count=np.zeros(n, np.int32),
        rt_ms=np.zeros(n, np.int32),
        success=np.zeros(n, bool),
        error=np.zeros(n, bool),
        param_hash=np.zeros((n, MAX_PARAMS), np.uint32),
        param_present=np.zeros((n, MAX_PARAMS), bool),
    )


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def to_device(batch_np, device):
    """Numpy staging dict (``make_*_batch_np``) -> EntryBatch / ExitBatch
    of tensors on ``device``. The kind follows the keys (``rt_ms`` marks
    an exit batch)."""
    cls = ExitBatch if "rt_ms" in batch_np else EntryBatch
    return cls(**{f: _to_tensor(batch_np[f], device) for f in cls._fields})
