"""Builds and loads the port's two host libraries: the native token-lease
ring (``csrc/lease_ext.c``) and the C++ client shim
(``csrc/sentinel_shim.cpp``), the counterparts of
``sentinel_tpu/native/__init__.py``'s ``load_lease_ext`` and ``load_shim``.

The ring is a CPython extension: :func:`build` compiles it with the host C
compiler (``$CC``, else ``cc`` or ``gcc``) against the RUNNING
interpreter's include directory into ``sentinel_tpu_torch/_build/``, under
a name keyed by a hash of the source, the flags and the interpreter, so
an edit or another Python rebuilds it. :func:`load_lease_ext` builds on
first use and imports the result; it returns None when no compiler or
no ``Python.h`` is available, and every lease then runs the Python ring
of ``core/lease.py``.

The shim is a plain C ABI library (the language-neutral token client:
JNI, FFI and ctypes all bind it) plus a cached-tick clock.
:func:`build_shim` compiles it with the host C++ compiler (``$CXX``, else
``c++`` or ``g++``) and ``native/Makefile``'s flags into the same
``_build/``, keyed by a hash of its sources and flags; :func:`load_shim`
builds on first use and binds it with ``ctypes``, or returns None
(:func:`shim_build_error` says why). :class:`NativeTokenClient` raises
when the shim is missing: nothing switches to the Python client behind
the caller's back. Every build writes a temporary file and renames it
into place, so processes that build at once never load a partial file.
Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Optional, Sequence

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "lease_ext.c"
BUILD_DIR = _PKG / "_build"
MODULE = "sentinel_torch_lease_ext"
CFLAGS = ("-O2", "-fPIC", "-Wall", "-shared")

SHIM_SOURCES = (_PKG / "csrc" / "sentinel_shim.cpp",
                _PKG / "csrc" / "sentinel_shim.h")
SHIM_LIB = "libsentinel_torch_shim"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_ext = None
_error: Optional[str] = None
_shim: Optional[ctypes.CDLL] = None
_shim_error: Optional[str] = None


def _compile(what: str, compiler: str, flags: Sequence[str],
             extra: Sequence[str], source: Path, out: Path) -> Path:
    """``compiler flags extra -o <tmp> source``, then the temporary file
    renamed to ``out``; raises ``RuntimeError`` with the compiler's output
    when it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp.so")
    cmd = [compiler, *flags, *extra, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as ex:
        raise RuntimeError(f"{what} build failed: {ex!r}") from ex
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


# -- the lease ring ---------------------------------------------------------------

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
    return _compile("lease ring", cc, CFLAGS, (f"-I{_include_dir()}",),
                    SOURCE, out)


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


# -- the client shim ----------------------------------------------------------------

def shim_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode() + b"\0")
    for src in SHIM_SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{SHIM_LIB}_{h.hexdigest()[:16]}.so"


def build_shim() -> Path:
    """Compile the shim unless these sources are built already; raises
    ``RuntimeError`` with the compiler's output when it cannot."""
    out = shim_path()
    if out.exists():
        return out
    cxx = (os.environ.get("CXX") or shutil.which("c++")
           or shutil.which("g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++, g++ or $CXX) for the shim")
    return _compile("shim", cxx, CXXFLAGS, (), SHIM_SOURCES[0], out)


def load_shim() -> Optional[ctypes.CDLL]:
    """The shim library, built and bound on first use, or None when it
    cannot be built or loaded (:func:`shim_build_error` says why). The
    outcome is kept for the life of the process."""
    global _shim, _shim_error
    with _lock:
        if _shim is not None or _shim_error is not None:
            return _shim
        try:
            lib = ctypes.CDLL(str(build_shim()))
            _declare(lib)
        except (RuntimeError, OSError, AttributeError) as ex:
            _shim_error = str(ex)
            return None
        _shim = lib
        return _shim


def shim_build_error() -> Optional[str]:
    """Why :func:`load_shim` returned None, or None."""
    return _shim_error


def _declare(lib: ctypes.CDLL) -> None:
    lib.st_client_connect.restype = ctypes.c_void_p
    lib.st_client_connect.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.st_request_token.restype = ctypes.c_int
    lib.st_request_token.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.st_request_param_token.restype = ctypes.c_int
    lib.st_request_param_token.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(StParam), ctypes.c_int]
    lib.st_request_tokens_batch.restype = ctypes.c_int
    lib.st_request_tokens_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.st_remote_entry.restype = ctypes.c_int
    lib.st_remote_entry.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(StParam), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.st_remote_exit.restype = ctypes.c_int
    lib.st_remote_exit.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    lib.st_client_close.argtypes = [ctypes.c_void_p]
    lib.st_now_ms.restype = ctypes.c_longlong


class StParam(ctypes.Structure):
    """Mirror of ``st_param`` in ``csrc/sentinel_shim.h``."""

    _fields_ = [("tag", ctypes.c_ubyte), ("i", ctypes.c_longlong),
                ("d", ctypes.c_double), ("s", ctypes.c_char_p)]


def _pack_params(params):
    arr = (StParam * len(params))()
    keepalive = []
    for k, p in enumerate(params):
        if isinstance(p, bool):
            arr[k].tag, arr[k].i = 2, int(p)
        elif isinstance(p, int):
            arr[k].tag, arr[k].i = 0, p
        elif isinstance(p, float):
            arr[k].tag, arr[k].d = 3, p
        else:
            raw = str(p).encode("utf-8")
            keepalive.append(raw)
            arr[k].tag, arr[k].s = 1, raw
    return arr, keepalive


def _token_result(status: int, extra: int):
    from sentinel_tpu_torch.cluster.token_service import TokenResult

    if status == 2:  # SHOULD_WAIT
        return TokenResult(status, wait_ms=extra)
    return TokenResult(status, remaining=extra)


class NativeTokenClient:
    """Token client backed by the C++ shim (wire-compatible with the
    Python ``ClusterTokenClient``), returning the port's ``TokenResult``.
    Multi-in-flight: N threads may call concurrently on one instance —
    responses demux by xid inside the shim. ``close`` must not race new
    requests (shim close contract). Raises when the shim is missing."""

    def __init__(self, host: str, port: int, namespace: str = "default",
                 timeout_ms: int = 3000):
        lib = load_shim()
        if lib is None:
            raise RuntimeError(f"native shim unavailable: {_shim_error}")
        self._lib = lib
        self._handle = lib.st_client_connect(
            host.encode(), port, namespace.encode(), timeout_ms)
        if not self._handle:
            raise ConnectionError(f"shim could not connect to {host}:{port}")

    def request_token(self, flow_id: int, count: int = 1,
                      prioritized: bool = False):
        extra = ctypes.c_int(0)
        status = self._lib.st_request_token(
            self._handle, flow_id, count, 1 if prioritized else 0,
            ctypes.byref(extra))
        return _token_result(status, extra.value)

    def request_param_token(self, flow_id: int, count: int, params):
        """Hot-param acquire through the shim (typed params hash-compatible
        with the Python client's)."""
        from sentinel_tpu_torch.cluster.token_service import TokenResult

        arr, keepalive = _pack_params(list(params))
        status = self._lib.st_request_param_token(
            self._handle, flow_id, count, arr, len(arr))
        del keepalive
        return TokenResult(status)

    def request_tokens_batch(self, requests):
        """Pipelined batch acquire: ``requests`` is a sequence of
        ``(flow_id, count, prioritized)``; all frames are sent before any
        response is awaited — one RTT per batch, and the server's
        micro-batcher folds them into one device step. Returns a list of
        TokenResult (status -1 entries mark transport loss)."""
        n = len(requests)
        if n == 0:
            return []
        flow_ids = (ctypes.c_longlong * n)(*[int(r[0]) for r in requests])
        counts = (ctypes.c_int * n)(*[int(r[1]) for r in requests])
        prios = (ctypes.c_int * n)(*[1 if r[2] else 0 for r in requests])
        statuses = (ctypes.c_int * n)()
        extras = (ctypes.c_int * n)()
        self._lib.st_request_tokens_batch(
            self._handle, flow_ids, counts, prios, n, statuses, extras)
        return [_token_result(statuses[k], extras[k]) for k in range(n)]

    def remote_entry(self, resource: str, origin: str = "", count: int = 1,
                     entry_type: int = 0, prioritized: bool = False,
                     params=()):
        """The remote slot-chain bridge: the server engine's full check
        and stats commit. Returns ``(status, entry_id, reason)``."""
        arr, keepalive = _pack_params(list(params))
        entry_id = ctypes.c_longlong(0)
        reason = ctypes.c_int(0)
        status = self._lib.st_remote_entry(
            self._handle, resource.encode(), origin.encode(), count,
            entry_type, 1 if prioritized else 0, arr, len(arr),
            ctypes.byref(entry_id), ctypes.byref(reason))
        del keepalive
        return status, entry_id.value, reason.value

    def remote_exit(self, entry_id: int, error: bool = False,
                    count: int = -1) -> int:
        return self._lib.st_remote_exit(
            self._handle, entry_id, 1 if error else 0, count)

    def close(self) -> None:
        if self._handle:
            self._lib.st_client_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def native_now_ms() -> Optional[int]:
    """Cached-tick clock read; None when the shim is unavailable."""
    lib = load_shim()
    if lib is None:
        return None
    return int(lib.st_now_ms())
