"""Builds and loads the native token-lease ring (``csrc/lease_ext.c``),
the counterpart of ``sentinel_tpu/native/__init__.py:load_lease_ext``.

The ring is a CPython extension: :func:`build` compiles it with the host C
compiler (``$CC``, else ``cc`` or ``gcc``) against the RUNNING
interpreter's include directory into ``sentinel_tpu_torch/_build/``, under
a name keyed by a hash of the source, the flags and the interpreter, so
an edit or another Python rebuilds it. :func:`load_lease_ext` builds on
first use and imports the result; it returns None when no compiler or
no ``Python.h`` is available, and every lease then runs the Python ring
of ``core/lease.py``. Importing this module builds nothing.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "lease_ext.c"
BUILD_DIR = _PKG / "_build"
MODULE = "sentinel_torch_lease_ext"
CFLAGS = ("-O2", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_ext = None
_error: Optional[str] = None


def _include_dir() -> str:
    return sysconfig.get_paths()["include"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(_include_dir().encode() + b"\0" + sys.version.encode() + b"\0")
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"{MODULE}_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the extension unless this source is built already; raises
    ``RuntimeError`` with the compiler's output when it cannot."""
    out = library_path()
    if out.exists():
        return out
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler (cc, gcc or $CC) for the lease ring")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cc, *CFLAGS, f"-I{_include_dir()}", "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as ex:
        raise RuntimeError(f"lease ring build failed: {ex!r}") from ex
    if proc.returncode != 0:
        raise RuntimeError(f"lease ring build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_lease_ext():
    """The ``sentinel_torch_lease_ext`` module, built on first use, or None
    when it cannot be built or imported (:func:`build_error` says why).
    The outcome is kept for the life of the process."""
    global _ext, _error
    with _lock:
        if _ext is not None or _error is not None:
            return _ext
        try:
            path = build()
            spec = importlib.util.spec_from_file_location(MODULE, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except (RuntimeError, OSError, ImportError) as ex:
            _error = str(ex)
            return None
        _ext = mod
        return _ext


def build_error() -> Optional[str]:
    """Why :func:`load_lease_ext` returned None, or None."""
    return _error
