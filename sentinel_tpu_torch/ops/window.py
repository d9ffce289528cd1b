"""Sliding-window statistics as tensor programs (port of
``sentinel_tpu/ops/window.py``).

Same geometry as the JAX module: ALL node rows share one ``[B, E, rows]``
tensor with the row axis minor, and because every row uses the same clock
the ring geometry is one ``int64[B]`` ``starts`` vector. Rotation zeroes
every deprecated bucket in one masked ``where`` so later reads are plain
sums. :class:`RowWindow` gives each row its own bucket length (degrade
breakers, param-flow rules).

Time is an explicit ``now_ms`` Python int: the engine owns the clock, so
bucket indices and window starts are host integers and cost no device
work.

Out-of-range index modes. JAX's ``.at[].get(mode="fill")`` and
``.at[].add/set/min/max(mode="drop")``, fed by ``oob``, have no torch
equivalent, and a raw -1 index in torch silently hits the last row. Every
gather and scatter of the port goes through the helpers below instead:
``gather`` masks the read, the scatters route a dropped lane to row 0 with
the operation's identity (0 for add, the dtype max for min, the dtype min
for max), and ``set_at`` makes the duplicate-index winner explicit — the
LAST writer by lane position, which is what XLA's CPU scatter keeps — so
the result does not depend on the order a CUDA scatter happens to run in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sentinel_tpu_torch.core.constants import NUM_EVENTS

# A large sentinel for MIN_RT empty buckets.
MIN_RT_EMPTY = 2**31 - 1


# ---------------------------------------------------------------------------
# Masked gather / scatter helpers (the port's mode="fill" / mode="drop")
# ---------------------------------------------------------------------------


def in_range(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx >= 0) & (idx < n)


def gather(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``arr[idx]`` along dim 0; lanes with ``idx`` outside ``[0, len)``
    read ``fill`` (JAX ``arr.at[oob(idx)].get(mode="fill")``)."""
    ok = in_range(idx, arr.shape[0])
    out = arr[torch.where(ok, idx, 0)]
    okb = ok.reshape(ok.shape + (1,) * (out.dim() - ok.dim()))
    return torch.where(okb, out, fill)


def _flat_index(arr: torch.Tensor, idxs) -> torch.Tensor:
    """Linear index into ``arr.view(-1)`` for a full index tuple."""
    flat = None
    for d, ix in enumerate(idxs):
        term = ix.to(torch.int64) * arr.stride(d)
        flat = term if flat is None else flat + term
    return flat


def _prep(arr, idxs, vals, ok):
    """Flatten a (possibly multi-dim) index tuple, values and mask to 1-D
    lanes; dropped lanes index element 0."""
    if not arr.is_contiguous():
        raise ValueError("scatter target must be contiguous")
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    shape = torch.broadcast_shapes(ok.shape, vals.shape,
                                   *(ix.shape for ix in idxs))
    ok = ok.expand(shape).reshape(-1)
    idxs = tuple(torch.where(ok, ix.expand(shape).reshape(-1), 0)
                 for ix in idxs)
    flat = _flat_index(arr, idxs)
    return flat, vals.expand(shape).reshape(-1), ok


def add_at(arr: torch.Tensor, idxs, vals, ok: torch.Tensor) -> torch.Tensor:
    """In place: ``arr[idxs] += vals`` for lanes where ``ok``; others
    dropped (routed to element 0 with value 0). Returns ``arr``."""
    flat, vals, ok = _prep(arr, idxs, vals, ok)
    arr.view(-1).index_add_(0, flat, torch.where(ok, vals, 0).to(arr.dtype))
    return arr


def _reduce_at(arr, idxs, vals, ok, op, identity):
    flat, vals, ok = _prep(arr, idxs, vals, ok)
    arr.view(-1).scatter_reduce_(0, flat, torch.where(ok, vals, identity),
                                 op, include_self=True)
    return arr


def _dtype_max(dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _dtype_min(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def min_at(arr, idxs, vals, ok):
    """In place scatter-min with dropped lanes."""
    return _reduce_at(arr, idxs, vals, ok, "amin", _dtype_max(arr.dtype))


def max_at(arr, idxs, vals, ok):
    """In place scatter-max with dropped lanes."""
    return _reduce_at(arr, idxs, vals, ok, "amax", _dtype_min(arr.dtype))


def set_at(arr, idxs, vals, ok):
    """In place scatter-set with dropped lanes and an explicit winner.

    Where several live lanes write one element, the LAST lane by position
    wins (XLA's CPU scatter order). Every lane that touches an element —
    dropped lanes land on element 0 — writes the winner's value (or the
    element's own value when no live lane targets it), so the final
    ``index_put_`` is order-independent on any device.
    """
    flat, vals, ok = _prep(arr, idxs, vals, ok)
    n = flat.shape[0]
    if n == 0:
        return arr
    pos = torch.arange(n, dtype=torch.int64, device=arr.device)
    win = torch.full((arr.numel(),), -1, dtype=torch.int64, device=arr.device)
    win.scatter_reduce_(0, flat, torch.where(ok, pos, -1), "amax",
                        include_self=True)
    w = win[flat]
    flat_arr = arr.view(-1)
    v = torch.where(w >= 0, vals[w.clamp(min=0)], flat_arr[flat])
    flat_arr.index_put_((flat,), v)
    return arr


# ---------------------------------------------------------------------------
# Shared-clock window
# ---------------------------------------------------------------------------


class WindowSpec(NamedTuple):
    """Static geometry of a shared-clock window."""

    interval_ms: int
    buckets: int

    @property
    def bucket_ms(self) -> int:
        return self.interval_ms // self.buckets


class Window(NamedTuple):
    """Device state of one shared-clock sliding window over all node rows.

    counts:  int32[B, NUM_EVENTS, rows] additive event counters
    min_rt:  int32[B, rows]             per-bucket minimum RT (ms)
    starts:  int64[B]                   windowStart of each slot (shared)
    """

    counts: torch.Tensor
    min_rt: torch.Tensor
    starts: torch.Tensor

    @property
    def num_rows(self) -> int:
        return self.counts.shape[2]


def make_window(rows: int, spec: WindowSpec, device) -> Window:
    return Window(
        counts=torch.zeros((spec.buckets, NUM_EVENTS, rows), dtype=torch.int32,
                           device=device),
        min_rt=torch.full((spec.buckets, rows), MIN_RT_EMPTY,
                          dtype=torch.int32, device=device),
        # Strictly older than any real window start: the first rotation
        # resets everything.
        starts=torch.full((spec.buckets,), -spec.interval_ms,
                          dtype=torch.int64, device=device),
    )


def expected_starts(now_ms: int, spec: WindowSpec, device) -> torch.Tensor:
    """windowStart of the most recent occurrence of each slot at ``now_ms``:
    slot b started at ``cur_start - ((cur_idx - b) % B) * bucket_ms``."""
    now_ms = int(now_ms)
    bucket_ms = spec.bucket_ms
    cur_start = now_ms - now_ms % bucket_ms
    cur_idx = (now_ms // bucket_ms) % spec.buckets
    offset = [(cur_idx - b) % spec.buckets for b in range(spec.buckets)]
    return torch.tensor([cur_start - o * bucket_ms for o in offset],
                        dtype=torch.int64, device=device)


def rotate(win: Window, now_ms: int, spec: WindowSpec) -> Window:
    """Zero every deprecated bucket and stamp fresh starts (new tensors;
    ``win`` is left as it was)."""
    exp = expected_starts(now_ms, spec, win.starts.device)
    keep = win.starts == exp
    counts = torch.where(keep[:, None, None], win.counts, 0)
    min_rt = torch.where(keep[:, None], win.min_rt, MIN_RT_EMPTY)
    return Window(counts, min_rt, exp)


def rotate_current(win: Window, now_ms: int, spec: WindowSpec) -> Window:
    """Freshen only the bucket ``now`` falls in, IN PLACE on ``win``.

    Zeroes + restamps that bucket when it is stale, leaving older buckets'
    stamps untouched (a later full :func:`rotate` or a read-side
    :func:`staleness_mask` still sees which buckets are deprecated). Cost
    is one ``[E, rows]`` slice instead of the whole ``[B, E, rows]``
    tensor. Returns ``win``.
    """
    idx = current_index(now_ms, spec)
    now = int(now_ms)
    cur_start = now - now % spec.bucket_ms
    fresh = win.starts[idx] == cur_start
    win.counts[idx] = torch.where(fresh, win.counts[idx], 0)
    win.min_rt[idx] = torch.where(fresh, win.min_rt[idx], MIN_RT_EMPTY)
    win.starts[idx] = cur_start
    return win


def staleness_mask(win: Window, now_ms: int, spec: WindowSpec) -> torch.Tensor:
    """bool[B]: True where the stored bucket is fresh at ``now``."""
    return win.starts == expected_starts(now_ms, spec, win.starts.device)


def current_index(now_ms: int, spec: WindowSpec) -> int:
    return (int(now_ms) // spec.bucket_ms) % spec.buckets


def add_events(win: Window, now_ms: int, rows: torch.Tensor,
               events: torch.Tensor, values: torch.Tensor,
               spec: WindowSpec) -> Window:
    """Scatter-add a batch of (row, event, value) into the current bucket
    (new ``counts``). The window must already be rotated to ``now_ms``;
    rows < 0 are dropped."""
    idx = current_index(now_ms, spec)
    counts = win.counts.clone()
    bucket = torch.full_like(rows, idx)
    add_at(counts, (bucket, events, rows), values,
           in_range(rows, counts.shape[2]))
    return win._replace(counts=counts)


def add_min_rt(win: Window, now_ms: int, rows: torch.Tensor,
               rt: torch.Tensor, spec: WindowSpec) -> Window:
    idx = current_index(now_ms, spec)
    min_rt = win.min_rt.clone()
    bucket = torch.full_like(rows, idx)
    min_at(min_rt, (bucket, rows), rt.to(torch.int32),
           in_range(rows, min_rt.shape[1]))
    return win._replace(min_rt=min_rt)


def row_totals(win: Window, rows: torch.Tensor) -> torch.Tensor:
    """int64[N, NUM_EVENTS]: each event summed over the buckets for the
    given rows (rotated state). Out-of-range rows read zeros."""
    totals = win.counts.sum(dim=0)  # [E, R] int64
    return gather(totals.T, rows, 0)


def row_min_rt(win: Window, rows: torch.Tensor) -> torch.Tensor:
    gathered = gather(win.min_rt.T, rows, MIN_RT_EMPTY)  # [N, B]
    return gathered.min(dim=1).values


def all_totals(win: Window) -> torch.Tensor:
    """int64[rows, NUM_EVENTS] totals over the full window."""
    return win.counts.sum(dim=0).T


# ---------------------------------------------------------------------------
# Per-row-clock window: each row has its own bucket_ms (degrade breakers,
# param-flow rules). starts int64[rows, B]; channel axis C caller-defined.
# ---------------------------------------------------------------------------


class RowWindow(NamedTuple):
    counts: torch.Tensor     # int32[rows, B, C]
    starts: torch.Tensor     # int64[rows, B]
    bucket_ms: torch.Tensor  # int64[rows] (0 => row unused)


def make_row_window(rows: int, buckets: int, channels: int, bucket_ms,
                    device) -> RowWindow:
    bm = np.asarray(bucket_ms, np.int64)
    if bm.ndim == 0:
        bm = np.full((rows,), int(bm), np.int64)
    return RowWindow(
        counts=torch.zeros((rows, buckets, channels), dtype=torch.int32,
                           device=device),
        starts=torch.full((rows, buckets), -(1 << 40), dtype=torch.int64,
                          device=device),
        bucket_ms=torch.as_tensor(bm, device=device),
    )


def row_expected_starts(rw: RowWindow, now_ms: int) -> torch.Tensor:
    buckets = rw.starts.shape[1]
    bm = rw.bucket_ms.clamp(min=1)[:, None]  # [rows, 1]
    now = torch.full((), int(now_ms), dtype=torch.int64,
                     device=rw.bucket_ms.device)
    cur_start = now - now % bm
    cur_idx = (now // bm) % buckets
    slots = torch.arange(buckets, dtype=torch.int64,
                         device=rw.bucket_ms.device)[None, :]
    offset = (cur_idx - slots) % buckets
    return cur_start - offset * bm


def row_rotate(rw: RowWindow, now_ms: int) -> RowWindow:
    exp = row_expected_starts(rw, now_ms)
    keep = rw.starts == exp
    counts = torch.where(keep[:, :, None], rw.counts, 0)
    return RowWindow(counts, exp, rw.bucket_ms)


def row_window_add(rw: RowWindow, now_ms: int, rows: torch.Tensor,
                   channel: torch.Tensor, values: torch.Tensor) -> RowWindow:
    """Scatter-add into each row's current bucket (new ``counts``).
    Must be rotated; rows out of range are dropped."""
    buckets = rw.starts.shape[1]
    bm = gather(rw.bucket_ms, rows, 1).clamp(min=1)
    idx = ((int(now_ms) // bm) % buckets).to(torch.int32)
    counts = rw.counts.clone()
    add_at(counts, (rows, idx, channel), values,
           in_range(rows, counts.shape[0]))
    return rw._replace(counts=counts)


def row_window_totals(rw: RowWindow, rows: torch.Tensor) -> torch.Tensor:
    """int64[N, C] full-window totals for given rows (rotated state)."""
    return gather(rw.counts, rows, 0).sum(dim=1)
