"""Building the port's CUDA kernels: ``nvcc`` for ``sm_90a`` into shared
libraries with plain C launchers, bound with ``ctypes`` by each kernel's
wrapper (``ops/prefix_cuda.py``, ``ops/cluster_acquire.py``).

A library is cached under ``sentinel_tpu_torch/_build/`` by a hash of the
flags and of every file its build reads, so an edit to a header alone
rebuilds. Each library builds under a lock of its own, so two build at
once; importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock_for(stem: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(stem, threading.Lock())


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def library_file(stem: str, inputs) -> Path:
    """The cached library for ``stem``: keyed by the flags and every file
    in ``inputs`` (the compiled source and the headers it includes)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in inputs:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build_library(stem: str, source: Path, inputs) -> Tuple[Path, str]:
    """Compile ``source`` with nvcc if these inputs have not been built
    yet. Returns ``(library path, compiler log)``; the log holds the
    ``-Xptxas -v`` register and shared-memory lines of the build that
    produced the library."""
    out = library_file(stem, inputs)
    log = out.with_suffix(".log")
    with _lock_for(stem):
        if out.exists() and log.exists():
            return out, log.read_text()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        log.write_text(proc.stdout + proc.stderr)
        return out, log.read_text()

