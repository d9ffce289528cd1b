"""The token service's serial admission: the CUDA kernel and its plain form
(counterpart of the ``lax.scan`` in ``sentinel_tpu/cluster/token_service.py``
``acquire_step``, ``:183-206``; an XLA scan, not a Pallas kernel).

For N requests in arrival order, each request sees the usage of every
EARLIER admitted (OK or SHOULD_WAIT) request of the same rule slot and
nothing of other slots. Inputs per lane: ``slots`` int32, ``counts``,
``base`` (PASS + WAITING of the lane's rule window), ``thr``,
``qps_scale`` and ``waiting`` float32, ``known`` and ``prioritized``
bool; scalars ``num_slots`` and ``max_occupy_ratio``. Outputs ``ok``,
``can_wait`` (bool) and ``passed`` (float32).

Rounding, as XLA's CPU backend compiles the reference (pinned by
``tests/test_torch_cluster.py``): the admission test
``(base + used) * scale + cnt <= thr`` is ONE fused multiply-add;
``passed`` is the product rounded on its own; the occupy test
``backlog + cnt <= ratio * thr`` rounds the sum and the product apiece.
The kernel pins these with ``__fmaf_rn`` / ``__fmul_rn`` / ``__fadd_rn``;
the plain form computes the fused one exactly with
``utils/fp.py:fma32``, so card and plain form are bit-equal.

Lanes outside the table: slot -1 is unknown (never ok, commits nothing);
a slot at or above ``num_slots`` is known but reads 0 usage and drops its
update (the reference's ``mode="fill"`` / ``mode="drop"``).

:func:`acquire_scan` is what the token service calls: on a CPU tensor it
runs :func:`acquire_scan_plain`; on a CUDA tensor it launches the kernel
(``csrc/cluster_acquire.cu``, built with ``nvcc`` for ``sm_90a`` at the
first launch into ``sentinel_tpu_torch/_build/``, loaded with ``ctypes``)
or raises. There is no fallback. ``launches`` counts kernel launches and
``launches_by_width`` counts them by N. Importing this module needs
neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from sentinel_tpu_torch.ops.nvcc_build import CSRC, build_library
from sentinel_tpu_torch.utils.fp import fma32

SOURCE = CSRC / "cluster_acquire.cu"

# Kernel launches since import (or since a caller reset them), and by N.
launches = 0
launches_by_width: Dict[int, int] = {}

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def build() -> Tuple[Path, str]:
    """Compile the kernel if this source has not been built yet; returns
    ``(library path, compiler log)`` with the ``-Xptxas -v`` lines."""
    return build_library("cluster_acquire", SOURCE, [SOURCE])


def _load() -> ctypes.CDLL:
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        lib.ca_acquire.argtypes = [p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, p, p, p, p, p]
        lib.ca_acquire.restype = ctypes.c_int
        _lib = lib
    return _lib


_BOOL_INPUTS = ("known", "prioritized")


def acquire_scan(slots, counts, base, thr, qps_scale, known, prioritized,
                 waiting, num_slots: int, max_occupy_ratio: float):
    """-> ``(ok, can_wait, passed)``: the plain form on CPU tensors, the
    kernel on CUDA tensors."""
    if slots.device.type == "cpu":
        return acquire_scan_plain(slots, counts, base, thr, qps_scale, known,
                                  prioritized, waiting, num_slots,
                                  max_occupy_ratio)
    return acquire_scan_cuda(slots, counts, base, thr, qps_scale, known,
                             prioritized, waiting, num_slots,
                             max_occupy_ratio)


def acquire_scan_cuda(slots, counts, base, thr, qps_scale, known,
                      prioritized, waiting, num_slots: int,
                      max_occupy_ratio: float):
    """One launch of ``csrc/cluster_acquire.cu``. Every input is a
    contiguous 1-D tensor of one length on one CUDA device: ``slots``
    int32, ``counts`` / ``base`` / ``thr`` / ``qps_scale`` / ``waiting``
    float32, ``known`` / ``prioritized`` bool."""
    named = dict(slots=slots, counts=counts, base=base, thr=thr,
                 qps_scale=qps_scale, known=known, prioritized=prioritized,
                 waiting=waiting)
    dev = slots.device
    n = slots.shape[0] if slots.dim() == 1 else -1
    for name, t in named.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"acquire_scan_cuda: {name} must be on {dev} "
                             f"(CUDA), got {t.device}")
        want = (torch.int32 if name == "slots" else
                torch.bool if name in _BOOL_INPUTS else torch.float32)
        if t.dtype != want:
            raise TypeError(f"acquire_scan_cuda: {name} must be {want}, "
                            f"got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"acquire_scan_cuda: {name} must be 1-D of "
                             f"length {n}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"acquire_scan_cuda: {name} must be contiguous")
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    can_wait = torch.empty(n, dtype=torch.bool, device=dev)
    passed = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return ok, can_wait, passed
    # The kernel's grouped lane order, and its per-slot cursors when they
    # do not fit in shared memory.
    scratch = torch.empty(n + max(int(num_slots), 0), dtype=torch.int32,
                          device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ca_acquire(
            slots.data_ptr(), counts.data_ptr(), base.data_ptr(),
            thr.data_ptr(), qps_scale.data_ptr(), known.data_ptr(),
            prioritized.data_ptr(), waiting.data_ptr(), n, int(num_slots),
            float(torch.tensor(max_occupy_ratio, dtype=torch.float32)),
            ok.data_ptr(), can_wait.data_ptr(), passed.data_ptr(),
            scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cluster_acquire kernel launch failed: "
                           f"cudaError {err}")
    global launches
    launches += 1
    launches_by_width[n] = launches_by_width.get(n, 0) + 1
    return ok, can_wait, passed


def acquire_scan_plain(slots, counts, base, thr, qps_scale, known,
                       prioritized, waiting, num_slots: int,
                       max_occupy_ratio: float):
    """The scan in torch ops, on any device: the CPU path and the oracle.

    Lanes of one slot depend on each other in arrival order; lanes of
    different slots, and lanes outside the table, do not. So the lanes
    are ranked within their slot (stable), and step ``k`` evaluates every
    slot's ``k``-th lane at once against the per-slot tables, then adds
    its admissions to them: as many steps as the longest same-slot run,
    each the scan body's arithmetic in the reference's order."""
    dev = slots.device
    n = slots.shape[0]
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    can_wait = torch.zeros(n, dtype=torch.bool, device=dev)
    passed = torch.zeros(n, dtype=torch.float32, device=dev)
    if n == 0:
        return ok, can_wait, passed
    slots = slots.to(torch.int64)
    in_tbl = (slots >= 0) & (slots < num_slots)
    lane = torch.arange(n, device=dev)
    # Out-of-table lanes get a run of their own each.
    key = torch.where(in_tbl, slots, num_slots + lane)
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = sk[1:] != sk[:-1]
    run_start = torch.cummax(torch.where(start, lane, 0), dim=0).values
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = lane - run_start
    ratio = torch.tensor(max_occupy_ratio, dtype=torch.float32, device=dev)
    used_tbl = torch.zeros(num_slots + 1, dtype=torch.float32, device=dev)
    wait_tbl = torch.zeros(num_slots + 1, dtype=torch.float32, device=dev)
    tbl_idx = torch.where(in_tbl, slots, num_slots)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for k in range(int(rank.max()) + 1):
        i = (rank == k).nonzero().squeeze(1)
        t = tbl_idx[i]
        tin = in_tbl[i]
        used = torch.where(tin, used_tbl[t], zero)
        wait = torch.where(tin, wait_tbl[t], zero)
        cnt, thr_i, sc, kn = counts[i], thr[i], qps_scale[i], known[i]
        x = base[i] + used
        ok_i = kn & (fma32(x, sc, cnt) <= thr_i)
        backlog = waiting[i] + wait
        cw_i = kn & prioritized[i] & ~ok_i & (backlog + cnt <= ratio * thr_i)
        ok[i], can_wait[i], passed[i] = ok_i, cw_i, x * sc
        # Distinct slots within a step: plain indexed writes; lanes
        # outside the table write the spare row, which nothing reads.
        used_tbl[t] = used + torch.where(ok_i | cw_i, cnt, zero)
        wait_tbl[t] = wait + torch.where(cw_i, cnt, zero)
    return ok, can_wait, passed
