"""Within-batch segmented scans (port of ``sentinel_tpu/ops/segment.py``).

A micro-batched step sees N requests at once; to keep arrival-order
semantics each request needs the sum of the candidate counts of EARLIER
requests that target the same node row / rule — a segmented exclusive
prefix in arrival order.

``segmented_prefix_dense_multi`` is the one entry point the models call.
On a CUDA tensor it launches the hand-written kernel
(``ops/prefix_cuda.py`` → ``csrc/segmented_prefix.cu``), one launch for
all pairs that share a column count. On a CPU tensor it runs
:func:`segmented_prefix_plain`, the sort + cumsum + cummax form of the
same function (the JAX package's ``_sorted_prefix_multi``). There is no
fallback between the two: a kernel that fails to build or launch raises.

Exactness: the plain version accumulates in float64 and the kernel sums
only equal-id rows in float32, so both are exact — and bit-equal — for
integer values whose per-segment prefix stays below 2^24.

``bincount_matmul`` keeps the JAX name but not the JAX form: the one-hot
matmul existed only because TPU scatters serialize. Here it is an exact
integer ``index_add_``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

_ID_SENTINEL = -(2**31)


def prep_prefix_pair(ids: torch.Tensor, values: torch.Tensor, npad: int):
    """Same contract as the JAX helper: squeeze 1-D values, pad ids with
    the INT32_MIN sentinel, append the ones column whose prefix is the
    earlier-same-id count. Returns ``(squeeze, m, ids_p, vals_p)`` with
    ``vals_p`` float32 [npad, m+1]. The CUDA kernel needs no padding; this
    stays for callers that compare padded layouts."""
    n = ids.shape[0]
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    m = values.shape[1]
    ids_p = torch.full((npad,), _ID_SENTINEL, dtype=torch.int32,
                       device=ids.device)
    ids_p[:n] = ids.to(torch.int32)
    vals_p = torch.zeros((npad, m + 1), dtype=torch.float32, device=ids.device)
    vals_p[:n, :m] = values.to(torch.float32)
    vals_p[:n, m] = 1.0
    return squeeze, m, ids_p, vals_p


def segmented_prefix_plain(ids: torch.Tensor, values: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: stable sort + cumsum + cummax.

    ``ids`` int[N]; ``values`` [N, M]. Returns ``(prefix float32 [N, M],
    is_first bool[N])`` aligned with the input order, where ``prefix[i]``
    sums ``values[j]`` over ``j < i`` with ``ids[j] == ids[i]``. Sums run
    in float64, so the result is exact for any integer prefix below 2^53
    and bit-equal to the kernel wherever the kernel is exact (< 2^24).
    """
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    sval = values[order].to(torch.float64)
    csum = torch.cumsum(sval, dim=0)
    first = torch.ones((n,), dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    head_base = torch.where(first[:, None], csum - sval, -1.0)
    base = torch.cummax(head_base, dim=0).values
    prefix_sorted = csum - sval - base
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, dtype=order.dtype, device=ids.device)
    return prefix_sorted[inv].to(torch.float32), first[inv]


def segmented_prefix(ids: torch.Tensor, values: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D form of :func:`segmented_prefix_plain` (the JAX package's
    sort-based ``segmented_prefix``): ``values`` [N] -> ``prefix`` [N]."""
    prefix, first = segmented_prefix_plain(ids, values[:, None])
    return prefix[:, 0], first


def segmented_prefix_dense(ids: torch.Tensor, values: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One segmented exclusive prefix. ``values`` [N] or [N, M]; returns
    ``(prefix float32 shaped like values, is_first bool[N])``."""
    (prefix, is_first), = segmented_prefix_dense_multi([(ids, values)])
    return prefix, is_first


def segmented_prefix_dense_multi(
        pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """K independent segmented prefixes over the same batch.

    ``pairs``: list of ``(ids, values)`` with one leading length N.
    Returns a list of ``(prefix, is_first)``. On CUDA, pairs with the same
    column count go to ONE kernel launch (one thread block per pair up to
    N = 8192).
    """
    n = pairs[0][0].shape[0]
    for ids_k, values_k in pairs:
        if ids_k.shape[0] != n or values_k.shape[0] != n:
            raise ValueError(
                "segmented_prefix_dense_multi: all pairs must share the "
                f"same leading length (got {ids_k.shape[0]} / "
                f"{values_k.shape[0]}, expected {n})")
    squeezes = [v.dim() == 1 for _, v in pairs]
    mats = [v[:, None] if sq else v for (_, v), sq in zip(pairs, squeezes)]
    if n == 0:
        # Zero-width batches: nothing to scan.
        out0 = []
        for (ids, _), v, sq in zip(pairs, mats, squeezes):
            p = torch.zeros(v.shape, dtype=torch.float32, device=ids.device)
            out0.append((p[:, 0] if sq else p, ids < 0))
        return out0
    device = pairs[0][0].device
    results: List = [None] * len(pairs)
    if device.type == "cuda":
        from sentinel_tpu_torch.ops import prefix_cuda

        groups = {}
        for i, v in enumerate(mats):
            groups.setdefault(v.shape[1], []).append(i)
        for m, members in groups.items():
            ids_k = torch.stack([pairs[i][0].to(torch.int32)
                                 for i in members]).contiguous()
            vals_k = torch.stack([mats[i].to(torch.float32)
                                  for i in members]).contiguous()
            prefix, first = prefix_cuda.segmented_prefix_cuda(ids_k, vals_k)
            for slot, i in enumerate(members):
                results[i] = (prefix[slot], first[slot])
    elif device.type == "cpu":
        for i, ((ids, _), v) in enumerate(zip(pairs, mats)):
            results[i] = segmented_prefix_plain(ids, v)
    else:
        raise ValueError(f"segmented prefix: unsupported device {device}")
    return [(p[:, 0] if sq else p, f)
            for (p, f), sq in zip(results, squeezes)]


def bincount_matmul(ids: torch.Tensor, values: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """Exact integer weighted bincount: ``out[:, b] = Σ values[n, :]``
    over ``ids[n] == b``.

    ``ids`` int[N], negative or >= num_bins dropped (routed to a spill bin
    that is sliced off). ``values`` integer [N] or [N, M]. Returns
    ``[num_bins]`` or ``[M, num_bins]`` in the dtype of ``values``.
    """
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    m = values.shape[1]
    valid = (ids >= 0) & (ids < num_bins)
    idc = torch.where(valid, ids, num_bins).to(torch.int64)
    v = torch.where(valid[:, None], values, 0)
    out = torch.zeros((num_bins + 1, m), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, idc, v)
    out = out[:num_bins].T
    return out[0] if squeeze else out


def first_in_segment(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """bool[N]: is this the first occurrence of its (non-negative) id?
    Negative / out-of-range ids return False. A scatter-min of positions
    (``scatter_reduce(amin)``) into a spill-padded table."""
    n = ids.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=ids.device)
    ok = (ids >= 0) & (ids < num_segments)
    idx = torch.where(ok, ids, num_segments).to(torch.int64)
    first_pos = torch.full((num_segments + 1,), n, dtype=torch.int64,
                           device=ids.device)
    first_pos.scatter_reduce_(0, idx, pos, "amin", include_self=True)
    return ok & (first_pos[idx] == pos)
