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

The pipeline stages into :class:`BatchBufferPool` buffers instead: each
is a :class:`StagingBuffer`, whose fields are numpy views of ONE host
block (pinned on a CUDA engine), so ``to_device`` moves a batch in one
asynchronous copy. That copy may still be reading the block after the
dispatch returns, which is why a buffer goes back to the pool only once
its cycle has been harvested.
"""

from __future__ import annotations

import functools
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


def ladder_width(n: int) -> int:
    """The ladder width a batch of ``n`` rows is padded to."""
    for w in BATCH_WIDTHS:
        if n <= w:
            return w
    return BATCH_WIDTHS[-1]


def stage_row(buf, i: int, fields) -> None:
    """Write one submission into row ``i`` of a staging dict: its scalar
    fields by name, and its ``params`` hashes (if any) into
    ``param_hash`` / ``param_present``."""
    for k, v in fields.items():
        if k == "params":
            for j, h in enumerate(v[:MAX_PARAMS]):
                buf["param_hash"][i, j] = h
                buf["param_present"][i, j] = True
        else:
            buf[k][i] = v


class _CopyCounter:
    __slots__ = ("copies",)

    def __init__(self):
        self.copies = 0


# Host-to-device copies made by ``to_device`` onto a CUDA device: one per
# field of a plain staging dict, one per StagingBuffer.
H2D = _CopyCounter()


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, order="C")).to(device)


_TORCH_DTYPE = {np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(bool): torch.bool}


@functools.lru_cache(maxsize=16)
def _block_layout(kind: str, width: int):
    """Field layout of one packed staging block: ``((name, offset, numpy
    dtype, shape), ...)`` with 8-byte aligned offsets, the block's size,
    and a template block holding what ``make_*_batch_np`` fills every
    row with (row -1 marks padding), so a reset buffer and a fresh one
    cannot drift apart."""
    cls = EntryBatch if kind == "entry" else ExitBatch
    proto = make_entry_batch_np(width) if kind == "entry" \
        else make_exit_batch_np(width)
    fields, off = [], 0
    for name in cls._fields:
        a = proto[name]
        dt = np.dtype(np.int64) if a.dtype == np.uint32 else a.dtype
        fields.append((name, off, dt, a.shape))
        off += -(-a.size * dt.itemsize // 8) * 8
    template = np.zeros(off, np.uint8)
    for name, o, dt, shape in fields:
        n = int(np.prod(shape))
        template[o:o + n * dt.itemsize].view(dt).reshape(shape)[:] = \
            proto[name]
    return tuple(fields), off, template


class StagingBuffer(dict):
    """A staging dict (``make_*_batch_np`` keys; ``param_hash`` int64)
    whose fields are numpy views of one host block: pinned memory when
    ``pinned`` (a CUDA engine), plain memory otherwise. ``to_device``
    copies the block in one transfer."""

    def __init__(self, kind: str, width: int, pinned: bool):
        super().__init__()
        self.layout, nbytes, self._template = _block_layout(kind, width)
        self.block = torch.empty(nbytes, dtype=torch.uint8,
                                 pin_memory=pinned)
        self.raw = self.block.numpy()
        for name, off, dt, shape in self.layout:
            n = int(np.prod(shape))
            self[name] = self.raw[off:off + n * dt.itemsize].view(dt) \
                .reshape(shape)
        self.reset()

    def reset(self) -> None:
        """Every field back to its padding default."""
        np.copyto(self.raw, self._template)


class BatchBufferPool:
    """Recycled staging buffers for the pipelined admission path, per
    (kind, ladder width) (reference: ``core/batch.py:BatchBufferPool``).

    A buffer is handed back only once the cycle that used it has been
    harvested: on a CUDA engine its block is pinned and copied to the
    card asynchronously, so the copy may still be reading it after the
    dispatch returns. ``release`` re-fills every field with its padding
    default, so ``acquire`` returns a buffer indistinguishable from a
    fresh one (stale rows beyond a cycle's fill count would otherwise
    leak into the step).
    """

    __slots__ = ("_free", "allocated", "reused", "pinned")

    def __init__(self, prealloc_widths: tuple = (), pinned: bool = False):
        # Collector-thread-only by design (acquire and release run on the
        # pipeline loop or under its stop path): no lock.
        self._free = {}
        self.allocated = 0
        self.reused = 0
        self.pinned = pinned
        for w in prealloc_widths:
            for kind in ("entry", "exit"):
                self._push(kind, StagingBuffer(kind, int(w), pinned))

    def _push(self, kind: str, buf: StagingBuffer) -> None:
        width = buf["cluster_row"].shape[0]
        self._free.setdefault((kind, width), []).append(buf)

    def acquire(self, kind: str, width: int) -> StagingBuffer:
        stack = self._free.get((kind, width))
        if stack:
            self.reused += 1
            return stack.pop()
        self.allocated += 1
        return StagingBuffer(kind, width, self.pinned)

    def release(self, kind: str, buf: StagingBuffer) -> None:
        buf.reset()
        self._push(kind, buf)


def to_device(batch_np, device):
    """Numpy staging dict (``make_*_batch_np``, or a ``StagingBuffer``)
    -> EntryBatch / ExitBatch of tensors on ``device``. The kind follows
    the keys (``rt_ms`` marks an exit batch).

    A StagingBuffer moves in one copy, asynchronous from pinned memory on
    CUDA (the caller keeps the buffer untouched until the step that reads
    it is known to have run); on the CPU the block is cloned, so the
    batch never aliases a recycled buffer."""
    device = torch.device(device)
    cls = ExitBatch if "rt_ms" in batch_np else EntryBatch
    if isinstance(batch_np, StagingBuffer):
        if device.type == "cuda":
            H2D.copies += 1
            block = batch_np.block.to(device, non_blocking=True)
        else:
            block = batch_np.block.clone()
        out = {}
        for name, off, dt, shape in batch_np.layout:
            n = int(np.prod(shape))
            out[name] = block[off:off + n * dt.itemsize] \
                .view(_TORCH_DTYPE[dt]).view(shape)
        return cls(**out)
    if device.type == "cuda":
        H2D.copies += len(cls._fields)
    return cls(**{f: _to_tensor(batch_np[f], device) for f in cls._fields})


def batch_to(batch, device):
    """An ``EntryBatch`` / ``ExitBatch`` whose columns are tensors on
    ``device``, as the reference's jitted steps take a batch of numpy
    arrays: a tensor elsewhere is copied there, a numpy array or another
    array-like is converted as ``to_device`` converts a staging dict."""
    device = torch.device(device)
    cols = {}
    for f in batch._fields:
        col = getattr(batch, f)
        if not isinstance(col, torch.Tensor):
            col = _to_tensor(col, "cpu")
        moved = col.to(device)
        if moved is not col and device.type == "cuda":
            H2D.copies += 1
        cols[f] = moved
    return type(batch)(**cols)
