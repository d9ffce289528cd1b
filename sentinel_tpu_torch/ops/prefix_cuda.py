"""The segmented-prefix kernels on CUDA (counterpart of
``sentinel_tpu/ops/pallas_prefix.py``).

``csrc/segmented_prefix.cu`` (which includes ``csrc/*.cuh``) is compiled
with ``nvcc`` for ``sm_90a`` at the first CUDA call into a shared library
with plain C launchers, cached under ``sentinel_tpu_torch/_build/`` by a
hash of every source file in ``csrc/`` and the flags, and loaded with
``ctypes``. Importing this module needs neither ``nvcc`` nor a card.

:func:`segmented_prefix_cuda` is the wrapper the models reach: one launch
for all K pairs. The launcher picks the path by N alone: the
in-shared-memory block radix sort and segmented scan for N up to
:func:`block_capacity` (8192), the tile-walk kernel above it.
:func:`segmented_prefix_tiles_cuda` runs the tile walk at any N, to
compare the two. Each wrapper checks device, dtype, shape and contiguity,
allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises on a non-zero launch error, and
adds one to ``launches`` for each launch (and to ``tile_launches`` when the
launcher reports that it ran the tile walk, and to ``launches_by_shape``
under its (K, N, M)). There is no fallback: the
plain version (``ops/segment.py:segmented_prefix_plain``) is the CPU path
and the oracle, never a rescue for a failed build or launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "segmented_prefix.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since import (or since a caller reset them to 0), how
# many of them went to the tile walk, and all of them by (K, N, M).
launches = 0
tile_launches = 0
launches_by_shape: Dict[Tuple[int, int, int], int] = {}

# Column counts M the launcher instantiates: the models' sweeps use 1 and 2.
COLUMNS = (1, 2)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# What sp_segmented_prefix reports through its last argument when it ran
# the tile walk (0 for the block sort).
PATH_TILE_WALK = 1


def _find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME): the segmented-prefix "
                       "kernel is built from source at first use")


def sources():
    """Every file the build reads: the compiled source and its headers."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"segmented_prefix_{key}.so"


def build() -> Tuple[Path, str]:
    """Compile the kernel if this source has not been built yet.

    Returns ``(library path, compiler log)``; the log holds the
    ``-Xptxas -v`` register and shared-memory lines of the build that
    produced the library.
    """
    out = library_path()
    log = out.with_suffix(".log")
    with _lock:
        if out.exists() and log.exists():
            return out, log.read_text()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        log.write_text(proc.stdout + proc.stderr)
        return out, log.read_text()


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
        lib.sp_segmented_prefix.argtypes = args + [
            ctypes.POINTER(ctypes.c_int)]
        lib.sp_segmented_prefix_tiles.argtypes = args
        lib.sp_segmented_prefix.restype = ctypes.c_int
        lib.sp_segmented_prefix_tiles.restype = ctypes.c_int
        lib.sp_block_capacity.argtypes = []
        lib.sp_block_capacity.restype = ctypes.c_int
        _lib = lib
    return _lib


def block_capacity() -> int:
    """The largest N the single-block sort takes (M = 1 and M = 2); the
    launcher sends larger N to the tile walk."""
    return _load().sp_block_capacity()


def segmented_prefix_cuda(ids: torch.Tensor, values: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K segmented exclusive prefixes in one launch.

    ``ids`` int32[K, N] and ``values`` float32[K, N, M] with M in
    :data:`COLUMNS`, contiguous, on one CUDA device. Returns
    ``(prefix float32[K, N, M], is_first bool[K, N])``.
    ``N == 0`` launches nothing.
    """
    return _launch(ids, values, tiles=False)


def segmented_prefix_tiles_cuda(ids: torch.Tensor, values: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`segmented_prefix_cuda` through the tile walk at any N."""
    return _launch(ids, values, tiles=True)


def _launch(ids: torch.Tensor, values: torch.Tensor, tiles: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not (ids.is_cuda and values.is_cuda):
        raise ValueError("segmented_prefix_cuda: tensors must be on CUDA")
    if ids.device != values.device:
        raise ValueError("segmented_prefix_cuda: ids and values on different "
                         "devices")
    if ids.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError("segmented_prefix_cuda: want int32 ids and float32 "
                        f"values, got {ids.dtype} / {values.dtype}")
    if ids.dim() != 2 or values.dim() != 3 or values.shape[:2] != ids.shape:
        raise ValueError("segmented_prefix_cuda: want ids [K, N] and values "
                         f"[K, N, M], got {tuple(ids.shape)} / "
                         f"{tuple(values.shape)}")
    if not (ids.is_contiguous() and values.is_contiguous()):
        raise ValueError("segmented_prefix_cuda: inputs must be contiguous")
    k, n, m = values.shape
    if m not in COLUMNS:
        raise ValueError(f"segmented_prefix_cuda: M={m}, want one of "
                         f"{COLUMNS}")
    prefix = torch.empty((k, n, m), dtype=torch.float32, device=ids.device)
    is_first = torch.empty((k, n), dtype=torch.bool, device=ids.device)
    if n == 0 or k == 0:
        return prefix, is_first
    lib = _load()
    args = (ids.data_ptr(), values.data_ptr(), prefix.data_ptr(),
            is_first.data_ptr(), n, k, m)
    path = ctypes.c_int(PATH_TILE_WALK)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        if tiles:
            err = lib.sp_segmented_prefix_tiles(*args, stream)
        else:
            err = lib.sp_segmented_prefix(*args, stream, ctypes.byref(path))
    if err != 0:
        raise RuntimeError(f"segmented_prefix kernel launch failed: "
                           f"cudaError {err}")
    global launches, tile_launches
    launches += 1
    launches_by_shape[k, n, m] = launches_by_shape.get((k, n, m), 0) + 1
    if path.value == PATH_TILE_WALK:
        tile_launches += 1
    return prefix, is_first
