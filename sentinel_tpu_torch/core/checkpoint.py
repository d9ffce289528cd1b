"""Stats checkpoint / warm restart (port of ``sentinel_tpu/core/checkpoint.py``,
the engine level: ``save_checkpoint``, ``restore_checkpoint`` and
``CheckpointTimer``).

A checkpoint snapshots the node-statistics tensors (the 1 s and minute
windows, the concurrency gauges, the staged second, the occupy borrows)
plus the row registry, and restores them into a fresh engine, so sliding
windows and breaker inputs survive a process restart instead of giving a
restarted instance a burst of untracked quota. Per-rule controller state
(warm-up tokens, pacer heads, breaker timers, param tables) is not saved:
it is re-created on rule load anyway, and rules are the datasources' job.

Format: one ``.npz`` (the twelve arrays and a JSON header), the JAX
package's layout, key for key, dtype for dtype: either package restores
the other's files. Checkpoints travel as these files, not through
``convert.py``.

Pod checkpoints (``save_pod_checkpoint`` / ``restore_pod_checkpoint``)
snapshot a whole pod state tree (``parallel/cluster.py:make_pod_state``,
every leaf with its shard axis): the same ``.npz`` as the JAX package's, a
header with ``version`` and ``n_leaves`` and ``leaf_{i}`` in
``jax.tree.leaves`` order (NamedTuple field order, ``None`` subtrees
dropped), the param owner keys as uint32. Either package restores the
other's files.

Cluster checkpoints (``save_cluster_checkpoint`` /
``restore_cluster_checkpoint``) snapshot a token service's per-flow
window rows (``counts`` int32, ``starts`` int64, ``bucket_ms`` int64) keyed
by flowId: the JAX package's ``.npz``, so either package's leader
warm-starts from the other's file. On the card the snapshot copies the
three window tensors to the host in one copy on the service's stream,
under the service lock; the restore grafts the matching rows back on that
stream, in the window's own dtypes (an int64 start never passes through a
float).

The LLM stream ledger (``llm/streams.py``) travels in the header's
``llm_streams``: streamId-keyed JSON rows, grafted after the windows on a
restore (survivors graft, unknown streams start cold).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.utils.device import to_host
from sentinel_tpu_torch.utils.tree import named_leaves, tree_unflatten

CHECKPOINT_VERSION = 1


def _tensor_schema(capacity: int, w1_buckets: Optional[int] = None
                   ) -> Dict[str, Tuple[tuple, type]]:
    """name -> (shape, numpy dtype) of every persisted tensor: the one list
    driving save and restore's validation, derivable without compiling, so
    restore rejects an incompatible file before it changes anything.
    ``w1_buckets`` defaults to the static sample count; an engine with a
    retuned or config-seeded instant window passes its own."""
    E, R = C.NUM_EVENTS, capacity
    b1 = C.SECOND_BUCKETS if w1_buckets is None else w1_buckets
    return {
        "w1_counts": ((b1, E, R), np.int32),
        "w1_min_rt": ((b1, R), np.int32),
        "w1_starts": ((b1,), np.int64),
        "w60_counts": ((C.MINUTE_BUCKETS, E, R), np.int32),
        "w60_min_rt": ((C.MINUTE_BUCKETS, R), np.int32),
        "w60_starts": ((C.MINUTE_BUCKETS,), np.int64),
        "cur_threads": ((R,), np.int32),
        "sec_counts": ((E, R), np.int32),
        "sec_min_rt": ((R,), np.int32),
        "sec_stamp": ((), np.int64),
        "occupied_next": ((R,), np.int32),
        "occupied_stamp": ((), np.int64),
    }


def _state_arrays(state) -> Dict[str, torch.Tensor]:
    """The persisted tensors, in schema order."""
    return {
        "w1_counts": state.w1.counts, "w1_min_rt": state.w1.min_rt,
        "w1_starts": state.w1.starts,
        "w60_counts": state.w60.counts, "w60_min_rt": state.w60.min_rt,
        "w60_starts": state.w60.starts,
        "cur_threads": state.cur_threads,
        "sec_counts": state.sec.counts, "sec_min_rt": state.sec.min_rt,
        "sec_stamp": state.sec.stamp,
        "occupied_next": state.occupied_next,
        "occupied_stamp": state.occupied_stamp,
    }


def _atomic_savez(path: str, header: dict, arrays: dict) -> None:
    """Write header + arrays as one ``.npz`` via tmp file + fsync + rename
    (+ directory fsync), so neither a crash mid-write nor a power loss
    after the rename can leave a truncated or unlinked checkpoint at
    ``path``: the rename alone orders the metadata, not the data
    blocks."""
    from sentinel_tpu_torch.resilience import faults

    target_dir = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=target_dir, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, __header__=np.frombuffer(
                json.dumps(header).encode("utf-8"), dtype=np.uint8), **arrays)
            f.flush()
            os.fsync(f.fileno())
        # Torn-write seam ("checkpoint.torn.write"): error mode raises here,
        # before the rename (a crash before publishing; the previous file
        # survives); garbage mode tears the fsync'd temp file to half its
        # bytes and lets the rename publish the wreck (a power cut in the
        # data blocks), which restore must reject as one ValueError.
        if faults.mutate("checkpoint.torn.write", b"\x01") != b"\x01":
            size = os.path.getsize(tmp)
            with open(tmp, "r+b") as tf:
                tf.truncate(max(1, size // 2))
        os.replace(tmp, path)
        try:
            dfd = os.open(target_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # platforms and filesystems without directory fsync
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load_npz(path: str):
    """Load an ``.npz`` checkpoint defensively: every way a truncated or
    corrupted file fails inside numpy or zip surfaces as ONE ValueError
    naming the file. A missing file still raises ``FileNotFoundError``
    (callers tell "no checkpoint yet" apart). Returns ``(header dict,
    {name: array})`` with every member read in full (a chopped member
    fails here, not halfway through a restore)."""
    import zipfile
    import zlib

    try:
        with np.load(path, allow_pickle=False) as z:
            raw = z["__header__"]
            header = json.loads(bytes(raw).decode("utf-8"))
            if not isinstance(header, dict):
                raise ValueError("header is not a JSON object")
            arrays = {k: np.asarray(z[k]) for k in z.files
                      if k != "__header__"}
        return header, arrays
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError, KeyError,
            UnicodeDecodeError, ValueError) as ex:
        raise ValueError(
            f"corrupted or truncated checkpoint {path!r}: {ex!r:.200}"
        ) from ex


def save_checkpoint(engine, path: str) -> None:
    """Atomically snapshot the engine's node statistics to ``path``.

    Under the engine lock, on the engine's stream (whatever thread calls
    it): compile what is pending, copy the twelve tensors to the host in
    one copy and build the header. The registry's snapshot, the
    compression and the fsyncs run after the lock is released."""
    with engine._lock, engine._on_stream():
        engine._ensure_compiled()
        header = {
            "version": CHECKPOINT_VERSION,
            "capacity": engine.capacity,
            "sealed_sec": engine._sealed_sec,
            "registry": None,  # below, outside the lock
            # w1 geometry: the bucket count alone cannot tell a 1 s / 2
            # window from a 2 s / 2 one.
            "w1_interval_ms": engine._spec1.interval_ms,
            "w1_sample_count": engine._spec1.buckets,
            # Streaming-reservation leases: streamId-keyed host rows (the
            # ledger is never on the device), grafted on a restore.
            "llm_streams": engine.streams.checkpoint_rows(),
        }
        # Slot mode: the arrays are slot-indexed, so the assignment and
        # generations that bind slots to resources travel in the header.
        # Spill records and cold tallies are not saved: the cold tail
        # restarts cold.
        if engine.slots is not None:
            header["slots"] = engine.slots.checkpoint_dict()
        arrays = to_host(_state_arrays(engine._state))
    # Rows are only ever added: a snapshot taken after the copy names every
    # row the copy holds statistics for (a row interned since has none in
    # it). Outside the lock, its ~0.1 s at 20,000 rows holds up no step.
    header["registry"] = engine.registry.to_dict()
    _atomic_savez(path, header, arrays)


def restore_checkpoint(engine, path: str, force: bool = False) -> None:
    """Warm-restart ``engine`` from a checkpoint, on the engine's own
    device.

    The registry is replaced whole (row ids must match the stats rows);
    rule tensors and per-rule state are rebuilt fresh from the engine's
    CURRENT rule managers against the restored registry, the flight ring
    restarts empty, and the concurrency gauges restart at zero (the
    entries in flight died with their process). Capacity, slot mode and
    the instant window's geometry must match the snapshot's; the whole
    file is validated before anything changes.

    Restore is a boot-time operation: ``entry()`` reads the registry
    without a lock, so an engine whose registry already allocated rows
    is refused; ``force=True`` is for callers that quiesced the engine.
    Loading rules before restoring is fine: rule rows are interned by
    this call's recompile, against the restored registry."""
    from sentinel_tpu_torch.core.registry import NodeRegistry
    from sentinel_tpu_torch.ops.step import SecondAccum
    from sentinel_tpu_torch.ops.window import Window

    if not force and engine.registry.rows_in_use() > 2:  # ROOT + ENTRY
        raise RuntimeError(
            "restore_checkpoint requires a fresh engine (rows already "
            "allocated — it has served traffic or compiled rules); restore "
            "at boot, or pass force=True after quiescing the engine")

    header, arrays = _load_npz(path)
    if header.get("version") != CHECKPOINT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version {header.get('version')}")
    if header.get("capacity") != engine.capacity:
        raise ValueError(
            f"checkpoint capacity {header.get('capacity')} != engine "
            f"capacity {engine.capacity}")
    ck_slots = header.get("slots")
    if (ck_slots is not None) != (engine.slots is not None):
        raise ValueError(
            "checkpoint slot mode does not match the engine: "
            f"checkpoint {'has' if ck_slots is not None else 'lacks'} a "
            "slot assignment, engine is in "
            f"{'slot' if engine.slots is not None else 'fixed-capacity'} "
            "mode")
    spec = engine._spec1
    ck_spec = (header.get("w1_interval_ms", 1000),
               header.get("w1_sample_count", spec.buckets))
    if ck_spec != (spec.interval_ms, spec.buckets):
        raise ValueError(
            f"checkpoint w1 geometry {ck_spec[0]}ms/{ck_spec[1]} buckets"
            f" != engine {spec.interval_ms}ms/{spec.buckets}; retune with "
            "set_window_geometry before restoring")
    schema = _tensor_schema(engine.capacity, w1_buckets=spec.buckets)
    for name, (shape, dtype) in schema.items():
        got = arrays.get(name)
        if got is None:
            raise ValueError(f"incompatible checkpoint: missing {name}")
        if tuple(got.shape) != shape or np.dtype(got.dtype) != np.dtype(dtype):
            raise ValueError(
                f"incompatible checkpoint: {name} is "
                f"{got.dtype}{list(got.shape)}, engine expects "
                f"{np.dtype(dtype)}{list(shape)}")

    dev = engine.device

    def t(name):
        # np.array keeps the 0-d stamps 0-d (ascontiguousarray would not).
        return torch.from_numpy(np.array(arrays[name], order="C")).to(dev)

    with engine._lock, engine._on_stream():
        engine.registry = NodeRegistry.from_dict(header["registry"])
        if ck_slots is not None:
            # Re-bind the slot assignment BEFORE the rebuild below: rule
            # rows resolve through the slot table, so ruled resources must
            # already sit at their checkpointed slots.
            engine.slots.restore_assignment(ck_slots)
        engine._sealed_sec = int(header["sealed_sec"])
        # Rebuild rule tensors and fresh rule state against the restored
        # registry, then graft the persisted statistics in.
        engine._state = None
        for family in engine._dirty:
            engine._dirty[family] = True
        engine._ensure_compiled()
        engine._state = engine._state._replace(
            w1=Window(t("w1_counts"), t("w1_min_rt"), t("w1_starts")),
            w60=Window(t("w60_counts"), t("w60_min_rt"), t("w60_starts")),
            cur_threads=torch.zeros_like(engine._state.cur_threads),
            sec=SecondAccum(t("sec_counts"), t("sec_min_rt"),
                            t("sec_stamp")),
            occupied_next=t("occupied_next"),
            occupied_stamp=t("occupied_stamp"),
        )
    # The lease mirrors must match the restored windows, or host admission
    # would re-grant quota the snapshot already spent.
    engine._seed_leases_from_state()
    # Streaming reservations graft after the windows, so a restored
    # lease's ticks reconcile against the restored debits; last_ms is
    # re-stamped to now, so a restore never mass-evicts.
    engine.streams.graft(header.get("llm_streams") or [], engine.now_ms())


# Leaves the JAX package holds as uint32 (param value hashes) and this one
# as int64 holding the same values: written and validated as uint32.
_UINT32_LEAVES = frozenset({"param.key", "shadow.param.key"})


def _wire_dtype(path: str, t: torch.Tensor) -> np.dtype:
    if path in _UINT32_LEAVES:
        return np.dtype(np.uint32)
    return np.dtype(str(t.dtype).replace("torch.", ""))


def save_pod_checkpoint(pod_state, path: str) -> None:
    """Snapshot a pod state tree, every leaf with its shard axis, so a
    restarted pod resumes with each shard's share of the global window
    (the pod-global view is rebuilt from the shares). One device-to-host
    copy; the file is the JAX package's layout."""
    leaves = named_leaves(pod_state)
    host = to_host({f"leaf_{i}": t for i, (_, t) in enumerate(leaves)})
    arrays = {k: (v.astype(np.uint32) if leaves[i][0] in _UINT32_LEAVES
                  else v)
              for i, (k, v) in enumerate(host.items())}
    _atomic_savez(path, {"version": CHECKPOINT_VERSION,
                         "n_leaves": len(leaves)}, arrays)


def restore_pod_checkpoint(like, path: str):
    """A pod state rebuilt from ``save_pod_checkpoint`` output (this
    package's or the JAX package's), on ``like``'s device. ``like`` is a
    template with the target structure and shapes (a fresh
    ``make_pod_state``); every leaf is validated against it before any
    value is returned, so a mismatched file cannot half-load."""
    leaves = named_leaves(like)
    header, arrays = _load_npz(path)
    if header.get("version") != CHECKPOINT_VERSION:
        raise ValueError(
            f"unsupported pod checkpoint version {header.get('version')}")
    if header.get("n_leaves") != len(leaves):
        raise ValueError(
            f"pod checkpoint has {header.get('n_leaves')} leaves, "
            f"template expects {len(leaves)}")
    try:
        loaded = [arrays[f"leaf_{i}"] for i in range(len(leaves))]
    except KeyError as ex:
        raise ValueError(
            f"corrupted pod checkpoint {path!r}: missing {ex}") from ex
    for i, (got, (name, want)) in enumerate(zip(loaded, leaves)):
        dtype = _wire_dtype(name, want)
        if tuple(got.shape) != tuple(want.shape) \
                or np.dtype(got.dtype) != dtype:
            raise ValueError(
                f"pod checkpoint leaf {i} ({name}) is "
                f"{got.dtype}{list(got.shape)}, template expects "
                f"{dtype}{list(want.shape)}")
    return tree_unflatten(like, (
        torch.from_numpy(np.array(got, dtype=str(want.dtype).replace(
            "torch.", ""), order="C")).to(want.device)
        for got, (_, want) in zip(loaded, leaves)))


# ---------------------------------------------------------------------------
# Cluster token-server window checkpoint (cluster/ha.py state-preserving
# recovery): the leader snapshots its per-flow global sliding windows so a
# successor warm-starts from them instead of handing the whole fleet a
# fresh window of quota at failover. Rows are keyed by flowId (slot layout
# is a compile artifact that differs across processes); a flow whose bucket
# geometry changed starts cold, same stance as the service's own rule-push
# carry-over. Param-flow buckets are NOT checkpointed: they are 1-second
# QPS buckets, so skipping them bounds their over-admission to at most one
# second of per-key quota (docs/SEMANTICS.md "Degraded-quota bound").
# ---------------------------------------------------------------------------

CLUSTER_CHECKPOINT_VERSION = 1


def _peek_header_epoch(path: str) -> Optional[int]:
    """The existing checkpoint's header epoch, or None when there is no
    readable checkpoint (missing/corrupted files never block a save)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["__header__"]).decode("utf-8"))
        return int(header.get("epoch", 0))
    except Exception:  # noqa: BLE001 — any unreadable file: overwritable
        return None


def _slice_filter(slices, n_slices, what: str):
    """flowId -> kept? for a slice-filtered save/restore (None: keep all)."""
    if slices is None:
        return None
    from sentinel_tpu_torch.cluster.sharding import slice_of

    n = int(n_slices) if n_slices is not None else 0
    if n <= 0:
        raise ValueError(f"slice-filtered {what} needs n_slices > 0")
    wanted = {int(s) for s in slices}
    return lambda fid: slice_of(fid, n) in wanted


def save_cluster_checkpoint(service, path: str, slices=None,
                            n_slices: Optional[int] = None,
                            epoch: Optional[int] = None) -> None:
    """Atomically snapshot a ``DefaultTokenService``'s flow windows.

    ``slices``/``n_slices`` (cluster/sharding.py rebalancing): restrict
    the snapshot to flows hashing into those slices of an ``n_slices``
    ring — a slice HANDOFF publishes exactly the donor's rows for the
    moving slice, nothing else. ``epoch`` overrides the header's fencing
    epoch with the slice's own term (per-slice epochs, not the
    service-global max).

    The shared file is epoch-fenced like the wire: a save from a service
    whose epoch is BELOW the file's is refused, so a deposed leader's
    still-running CheckpointTimer cannot clobber the successor's
    published state. The peek-and-replace is held under an exclusive
    sidecar flock so two same-host writers cannot interleave between the
    epoch check and the rename; filesystems without flock fall back to
    the unlocked check. Epoch-0 services (pre-HA, no fencing) keep
    last-writer-wins."""
    keep = _slice_filter(slices, n_slices, "save")
    # Snapshot first (service lock only) — never hold the file lock
    # while waiting on the device.
    with service._lock:
        service._ensure_compiled()
        win = service._state.win
        header = {
            "version": CLUSTER_CHECKPOINT_VERSION,
            "epoch": int(epoch if epoch is not None
                         else getattr(service, "epoch", 0)),
            "flows": {str(fid): slot
                      for fid, slot in service._slot_of.items()
                      if keep is None or keep(fid)},
        }
        if slices is not None:
            header["slices"] = sorted(int(s) for s in slices)
            header["nSlices"] = int(n_slices)
        with service._device_ctx():
            arrays = to_host({"counts": win.counts, "starts": win.starts,
                              "bucket_ms": win.bucket_ms})

    epoch = header["epoch"]
    if not epoch:
        _atomic_savez(path, header, arrays)
        return
    with open(path + ".lock", "a+b") as lk:
        try:
            import fcntl

            fcntl.flock(lk, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass  # no flock here: keep the (unlocked) epoch check
        try:
            existing = _peek_header_epoch(path)
            if existing is not None and existing > epoch:
                raise ValueError(
                    f"refusing to overwrite checkpoint {path!r} from epoch "
                    f"{existing} with state from deposed epoch {epoch}")
            _atomic_savez(path, header, arrays)
        finally:
            try:
                import fcntl

                fcntl.flock(lk, fcntl.LOCK_UN)
            except (ImportError, OSError):
                pass


def restore_cluster_checkpoint(service, path: str, slices=None,
                               n_slices: Optional[int] = None) -> int:
    """Warm-start ``service``'s flow windows from a leader's snapshot.

    Grafts each surviving flowId's window row into the service's OWN
    compiled layout; rows whose bucket geometry differs (rule edit
    between leaders) or whose flowId is unknown here start cold.
    ``slices``/``n_slices`` restrict the graft to flows hashing into
    those slices (a handoff recipient warm-starts ONLY the slice it
    gained — rows for slices it does not own must not shadow their true
    owner's state). Returns the number of rows restored. A corrupted or
    truncated file raises ``ValueError`` before any service state is
    touched."""
    keep = _slice_filter(slices, n_slices, "restore")
    header, arrays = _load_npz(path)
    if header.get("version") != CLUSTER_CHECKPOINT_VERSION:
        raise ValueError(
            f"unsupported cluster checkpoint version {header.get('version')}")
    for name, nd in (("counts", 3), ("starts", 2), ("bucket_ms", 1)):
        got = arrays.get(name)
        if got is None or got.ndim != nd:
            raise ValueError(
                f"corrupted or truncated checkpoint {path!r}: bad {name}")
    old_counts, old_starts = arrays["counts"], arrays["starts"]
    old_bucket = arrays["bucket_ms"]
    flows = header.get("flows") or {}

    with service._lock:
        service._ensure_compiled()
        win = service._state.win
        new_bucket = win.bucket_ms.cpu().numpy()
        dst, src = [], []
        for fid_str, old_slot in flows.items():
            try:
                fid, old_slot = int(fid_str), int(old_slot)
            except (TypeError, ValueError):
                continue
            if keep is not None and not keep(fid):
                continue
            new_slot = service._slot_of.get(fid)
            # old_slot must index EVERY old array (a corrupted file can
            # carry inconsistent leading dims — never an IndexError out
            # of a leader promotion).
            if (new_slot is None
                    or not 0 <= old_slot < min(old_counts.shape[0],
                                               old_starts.shape[0],
                                               old_bucket.shape[0])
                    or old_counts.shape[1:] != tuple(win.counts.shape[1:])
                    or old_starts.shape[1:] != tuple(win.starts.shape[1:])
                    or old_bucket[old_slot] != new_bucket[new_slot]):
                continue
            dst.append(new_slot)
            src.append(old_slot)
        if dst:  # distinct: one slot per flowId
            rows = np.asarray(src, np.int64)
            with service._device_ctx():
                idx = torch.tensor(dst, dtype=torch.int64,
                                   device=win.counts.device)
                win.counts[idx] = torch.from_numpy(np.ascontiguousarray(
                    old_counts[rows], dtype=np.int32)).to(
                        win.counts.device, win.counts.dtype)
                win.starts[idx] = torch.from_numpy(np.ascontiguousarray(
                    old_starts[rows], dtype=np.int64)).to(
                        win.starts.device, win.starts.dtype)
    return len(dst)


class CheckpointTimer:
    """Low-rate background checkpointer (off unless started).

    ``save`` picks the snapshot function: :func:`save_checkpoint` by
    default (``target`` an engine), or :func:`save_cluster_checkpoint`
    (``target`` a token service: the HA leader's periodic publish). A failed save is logged, never
    raised, and the timer keeps going."""

    def __init__(self, engine, path: str, period_s: float = 30.0,
                 save=None):
        self.engine = engine
        self.path = path
        self.period_s = period_s
        self._save = save or save_checkpoint
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CheckpointTimer":
        if self._thread is not None and self._thread.is_alive():
            # Includes a thread whose stop() join timed out: clearing the
            # event now would resurrect it beside a new one.
            return self
        self._thread = None
        self._stop.clear()  # start() after a stop() runs again
        self._thread = threading.Thread(
            target=self._run, name="sentinel-torch-checkpoint", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        from sentinel_tpu_torch.log.record_log import record_log

        while not self._stop.wait(self.period_s):
            try:
                self._save(self.engine, self.path)
            except Exception as ex:  # noqa: BLE001 — logged, the timer goes on
                record_log.warn("checkpoint failed: %r", ex)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            if not self._thread.is_alive():
                self._thread = None
            # else: keep the handle, so start() sees the straggler and
            # refuses to race a second writer against it
