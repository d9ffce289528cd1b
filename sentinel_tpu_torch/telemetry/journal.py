"""Crash-safe, causally-linked control-plane audit journal (port of
``sentinel_tpu/telemetry/journal.py``; the file format is the same, so a
journal directory written by either package recovers in the other).

Every mutation of the control plane — rule/SLO/adaptive-target loads
(with datasource provenance), rollout transitions, shard-map applies,
HA role flips, adaptive decisions, clock swaps — appends ONE versioned
JSONL record here, so "why was the control plane in state X at time T"
is answerable from recorded data instead of operator memory. The
``why`` ops command joins these records with the flight recorder's
per-second series (:func:`forensic_why`).

Record shape (version 1)::

    {"v": 1, "seq": 17, "kind": "ruleLoad", "timestamp": <engine ms>,
     "actor": "datasource:RedisDataSource", "causeSeq": 12, ...fields}

* ``seq`` is strictly monotone for the journal's lifetime — INCLUDING
  across process restarts when a file backs it (recovery resumes above
  the highest recorded seq, so ``sinceSeq`` cursors held by external
  consumers stay valid).
* ``timestamp`` is the ENGINE timebase (the injected clock seam),
  never an ambient wall read: a replay of the same trace + seed
  produces an identical record stream, and
  ``tests/test_torch_journal.py`` pins that no wall clock is read in
  this module.
* ``causeSeq`` is a back-pointer to the record that *shaped* this one
  (an adaptive promote links to its canary, which links to its
  propose; a rule load fired by a rollout promotion links to the
  promote). :meth:`ControlPlaneJournal.chain` walks it.
* ``actor`` records provenance: ``local`` by default, overridden by
  the :func:`acting` context (datasource pollers, ops commands).

Durability: with a ``path`` configured every record is appended as one
JSON line, flushed, and fsync'd (the flight-recorder tee's crash-safety
discipline, hardened: control-plane mutations are rare enough that the
fsync is free). Writes are APPEND-ONLY — no seek, no truncate, pinned
by the tests — and segment rotation renames the live file aside
instead of rewriting it. Recovery reads every complete line back
(re-seeding the bounded in-memory tail and the seq cursor); a
torn/partial tail record from a crash is dropped LOUDLY (counted +
warned, never silently parsed) and the line is terminated so new
appends can never splice into it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

JOURNAL_VERSION = 1

# Rule dicts embedded per ruleLoad record are capped so one pathological
# wholesale load cannot balloon the journal; the count is always exact.
MAX_RULES_PER_RECORD = 64

# Rotated segments kept beside the live file: <path>.1 (newest) .. .N.
ROTATE_SEGMENTS = 3

_ctx = threading.local()


def current_actor() -> str:
    """The provenance label attached to records on this thread."""
    return getattr(_ctx, "actor", None) or "local"


@contextlib.contextmanager
def acting(actor: str):
    """Attribute every journal record on this thread to ``actor``
    (``datasource:<name>``, ``ops:<command>``): the write path that
    mutates the control plane declares who is driving it, and the
    journal records it as provenance."""
    prev = getattr(_ctx, "actor", None)
    _ctx.actor = actor
    try:
        yield
    finally:
        _ctx.actor = prev


def current_cause() -> Optional[int]:
    return getattr(_ctx, "cause_seq", None)


@contextlib.contextmanager
def causing(seq: Optional[int]):
    """Default ``causeSeq`` for records on this thread: a rollout
    promotion wraps its rule loads in ``causing(promote_seq)`` so the
    resulting ``ruleLoad`` records point back at the promote that
    triggered them — the causality the ``why`` query walks."""
    prev = getattr(_ctx, "cause_seq", None)
    _ctx.cause_seq = seq
    try:
        yield
    finally:
        _ctx.cause_seq = prev


class ControlPlaneJournal:
    """Seq-numbered audit journal for one engine.

    ``clock`` is a callable returning engine-timebase milliseconds
    (``engine.now_ms`` — the simulator's injected clock rides through
    it, so replays journal in simulated time). ``path=None`` keeps the
    journal in-memory only (the bounded tail still serves the
    ``journal`` command); a path makes it durable and restart-resuming.
    """

    def __init__(self, clock, path: Optional[str] = None,
                 capacity: Optional[int] = None,
                 rotate_bytes: Optional[int] = None):
        from sentinel_tpu_torch.core.config import config as _cfg

        self._clock = clock
        self.path = path if path is not None else _cfg.journal_path()
        if self.path == "":  # explicit memory-only override (simulator)
            self.path = None
        self.capacity = int(capacity if capacity is not None
                            else _cfg.journal_capacity())
        self.rotate_bytes = int(rotate_bytes if rotate_bytes is not None
                                else _cfg.journal_rotate_bytes())
        self._lock = threading.RLock()
        self._tail: deque = deque(maxlen=max(1, self.capacity))
        self._seq = 0
        self.appended = 0          # records written by THIS process
        self.dropped_partial = 0   # torn tail records dropped on recovery
        self.rotations = 0
        self._file = None
        self._file_bytes = 0
        if self.path:
            self._recover()
            self._open_append()

    # -- durability --------------------------------------------------------

    def _recover(self) -> None:
        """Re-seed seq + tail from the existing file set. A trailing
        line with no newline (crash mid-append) is handled append-only:
        if its bytes already form a COMPLETE valid record (only the
        newline was lost) it is committed — terminating it would
        otherwise resurrect it for replay() while seq numbering reused
        its seq, a duplicate-seq split-brain; a genuinely torn record
        is dropped loudly and terminated with a marker that keeps the
        line permanently unparseable, so it can neither splice into the
        next append nor come back as a record later."""
        from sentinel_tpu_torch.log.record_log import record_log

        records: List[Dict] = []
        for seg in self._segment_paths():
            records.extend(self._read_segment(seg)[0])
        live, partial = self._read_segment(self.path)
        records.extend(live)
        committed_partial = None
        if partial:
            try:
                rec = json.loads(partial)
            except ValueError:
                rec = None
            if isinstance(rec, dict) and rec.get("v") == JOURNAL_VERSION:
                committed_partial = rec
                records.append(rec)
        for rec in records:
            self._seq = max(self._seq, int(rec.get("seq", 0)))
            self._tail.append(rec)
        if partial:
            with open(self.path, "a", encoding="utf-8") as f:
                if committed_partial is not None:
                    f.write("\n")  # only the newline was lost: commit it
                else:
                    self.dropped_partial += 1
                    record_log.warn(
                        "journal %s: dropped torn tail record (%d bytes) "
                        "from a previous crash; seq resumes at %d",
                        self.path, len(partial), self._seq + 1)
                    # The marker keeps the terminated line unparseable
                    # forever — a dropped record must stay dropped.
                    f.write(" #torn\n")
                f.flush()
                os.fsync(f.fileno())

    @staticmethod
    def _read_segment(path: str):
        """(complete records, trailing partial line or None). Garbled
        COMPLETE lines (e.g. a previously terminated torn record) are
        skipped — they were already counted the restart they tore."""
        records: List[Dict] = []
        partial = None
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = f.read()
        except FileNotFoundError:
            return records, None
        lines = data.split("\n")
        if lines and lines[-1] != "":
            partial = lines[-1]
            lines = lines[:-1]
        else:
            lines = lines[:-1] if lines else lines
        for line in lines:
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("v") == JOURNAL_VERSION:
                records.append(rec)
        return records, (partial if partial else None)

    def _segment_paths(self) -> List[str]:
        """Existing rotated segments, OLDEST first."""
        out = []
        for i in range(ROTATE_SEGMENTS, 0, -1):
            p = f"{self.path}.{i}"
            if os.path.exists(p):
                out.append(p)
        return out

    def _open_append(self) -> None:
        self._file = open(self.path, "a", encoding="utf-8")
        self._file_bytes = self._file.tell()

    def _rotate(self) -> None:
        """Shift the live file aside (<path> -> <path>.1 -> .2 ...),
        dropping the oldest segment. Renames only — the journal never
        rewrites bytes it already committed."""
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        for i in range(ROTATE_SEGMENTS - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self.rotations += 1
        self._open_append()

    # -- the one write path ------------------------------------------------

    def record(self, kind: str, actor: Optional[str] = None,
               cause_seq: Optional[int] = None, **fields) -> int:
        """Append one record; returns its seq. Never raises for file
        I/O trouble — a full disk degrades durability, not the control
        plane (the in-memory tail keeps recording; counted + warned)."""
        with self._lock:
            self._seq += 1
            rec = {
                "v": JOURNAL_VERSION,
                "seq": self._seq,
                "kind": kind,
                "timestamp": int(self._clock()),
                "actor": actor if actor is not None else current_actor(),
                "causeSeq": (cause_seq if cause_seq is not None
                             else current_cause()),
            }
            rec.update(fields)
            self._tail.append(rec)
            self.appended += 1
            if self._file is not None:
                try:
                    # Disk-full seam (resilience/faults.py
                    # "journal.disk.full"): an armed error is
                    # an OSError, taken by the same degrade path a real
                    # ENOSPC/EIO takes — durability drops, the in-memory
                    # tail keeps recording, loudly.
                    from sentinel_tpu_torch.resilience import faults

                    faults.fire("journal.disk.full")
                    line = json.dumps(rec, sort_keys=True,
                                      separators=(",", ":"), default=str)
                    self._file.write(line + "\n")
                    self._file.flush()
                    os.fsync(self._file.fileno())
                    self._file_bytes += len(line) + 1
                    if self._file_bytes > self.rotate_bytes:
                        self._rotate()
                except (OSError, ValueError) as ex:
                    from sentinel_tpu_torch.log.record_log import record_log

                    record_log.warn(
                        "journal append to %s failed: %r (in-memory tail "
                        "keeps recording)", self.path, ex)
                    try:
                        self._file.close()
                    except OSError:
                        pass
                    self._file = None
            return self._seq

    # -- read surfaces -----------------------------------------------------

    @property
    def last_seq(self) -> int:
        return self._seq

    def tail(self, since_seq: int = 0, kind: Optional[str] = None,
             limit: Optional[int] = None) -> List[Dict]:
        """Records with seq > since_seq from the bounded in-memory
        tail, oldest first (the ``journal`` command's cursor space —
        the same shape as the adaptive decision log)."""
        with self._lock:
            out = [dict(r) for r in self._tail
                   if r["seq"] > since_seq
                   and (kind is None or r["kind"] == kind)]
        if limit is not None and limit >= 0:
            out = out[-limit:] if limit > 0 else []
        return out

    def replay(self, kind: Optional[str] = None) -> List[Dict]:
        """EVERY retained record, oldest first: the full file set when
        one backs the journal (restart restore reads through this),
        else the in-memory tail."""
        if not self.path:
            return self.tail(kind=kind)
        with self._lock:
            records: List[Dict] = []
            for seg in self._segment_paths():
                records.extend(self._read_segment(seg)[0])
            records.extend(self._read_segment(self.path)[0])
        if kind is not None:
            records = [r for r in records if r.get("kind") == kind]
        return records

    def find(self, seq: int) -> Optional[Dict]:
        with self._lock:
            for r in reversed(self._tail):
                if r["seq"] == seq:
                    return dict(r)
        if self.path:
            for r in self.replay():
                if r.get("seq") == seq:
                    return dict(r)
        return None

    def chain(self, seq: int, max_depth: int = 16) -> List[Dict]:
        """The causality walk: the record at ``seq`` followed by its
        ``causeSeq`` ancestors, nearest first, bounded. The file set is
        parsed at most ONCE per walk (on the first tail miss), not once
        per ancestor."""
        with self._lock:
            idx = {r["seq"]: r for r in self._tail}
        out: List[Dict] = []
        cur: Optional[int] = seq
        file_loaded = not self.path
        while cur is not None and len(out) < max_depth:
            rec = idx.get(cur)
            if rec is None and not file_loaded:
                file_loaded = True
                for r in self.replay():
                    idx.setdefault(int(r.get("seq", 0)), r)
                rec = idx.get(cur)
            if rec is None:
                break
            out.append(dict(rec))
            cause = rec.get("causeSeq")
            cur = int(cause) if cause is not None else None
        return out

    def in_force(self, stamp_ms: int, kinds, **match) -> Optional[Dict]:
        """The NEWEST record of one of ``kinds`` with timestamp <=
        stamp_ms whose fields contain ``match`` — "what was in force at
        T". Scans the tail first; ANY tail miss on a file-backed
        journal falls through to the full file set — the in-force
        record can be arbitrarily older than the tail horizon (a rule
        loaded once at boot stays in force through thousands of later
        records), so no tail-timestamp shortcut is sound."""
        if isinstance(kinds, str):
            kinds = (kinds,)

        def scan(records):
            for r in records:
                if r.get("kind") in kinds and r.get("timestamp", 0) <= stamp_ms \
                        and all(r.get(k) == v for k, v in match.items()):
                    return dict(r)
            return None

        with self._lock:
            tail = list(self._tail)
        hit = scan(reversed(tail))
        if hit is not None:
            return hit
        if self.path:
            return scan(reversed(self.replay()))
        return None

    def stats(self) -> Dict:
        with self._lock:
            return {
                "lastSeq": self._seq,
                "appended": self.appended,
                "retained": len(self._tail),
                "capacity": self.capacity,
                "droppedPartial": self.dropped_partial,
                "rotations": self.rotations,
                "path": self.path,
                "fileBytes": self._file_bytes if self._file else 0,
                "durable": self._file is not None,
            }

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                    self._file.close()
                except OSError:
                    pass
                self._file = None


# -- the forensic join --------------------------------------------------------

_REASON_TO_FAMILY = {
    "FLOW": "flow",
    "DEGRADE": "degrade",
    "SYSTEM": "system",
    "AUTHORITY": "authority",
    "PARAM_FLOW": "param",
}

_ROLLOUT_KINDS = ("rolloutStage", "rolloutPromote", "rolloutAbort")


def forensic_why(engine, resource: str,
                 stamp_ms: Optional[int] = None) -> Dict:
    """"Why was ``resource`` blocked at ``stamp_ms``": join the
    flight-recorder second at the stamp with the journal records in
    force then — the blocking rule family and its live rules from the
    load record (with datasource provenance and the causeSeq chain),
    the rollout candidate in force, and the shard assignment in force.

    ``stamp_ms=None`` uses the newest complete recorded second. The
    join is reconstruction from RECORDED data: no step re-run, and the
    answer stays stable however the rules have moved since."""
    journal: ControlPlaneJournal = engine.journal
    if stamp_ms is None:
        view = engine.timeseries_view(resource=resource, limit=1)
        if not view["seconds"]:
            return {"resource": resource, "second": None,
                    "error": "no recorded second for this resource"}
        stamp_ms = view["seconds"][-1]["timestamp"]
    stamp_ms = int(stamp_ms)
    sec_start = stamp_ms - stamp_ms % 1000
    view = engine.timeseries_view(resource=resource, start_ms=sec_start,
                                  end_ms=sec_start + 1000)
    second = view["seconds"][0] if view["seconds"] else None
    cell = ((second or {}).get("resources") or {}).get(resource, {})
    reasons = cell.get("blockByReason") or {}
    blocking = max(reasons, key=reasons.get) if reasons else None

    rule_block = None
    if blocking is not None:
        family = _REASON_TO_FAMILY.get(blocking)
        load_rec = (journal.in_force(stamp_ms, "ruleLoad", family=family)
                    if family else None)
        matched = []
        if load_rec is not None:
            matched = [r for r in load_rec.get("rules", ())
                       if r.get("resource", resource) == resource]
        rule_block = {
            "reason": blocking,
            "blockedThatSecond": int(reasons.get(blocking, 0)),
            "family": family,
            "matchedRules": matched,
            "provenance": ({
                "seq": load_rec["seq"],
                "actor": load_rec.get("actor"),
                "loadedAtMs": load_rec.get("timestamp"),
                "ruleCount": load_rec.get("count"),
                "causeChain": journal.chain(load_rec["seq"])[1:],
            } if load_rec is not None else None),
        }

    roll_rec = journal.in_force(stamp_ms, _ROLLOUT_KINDS)
    candidate = None
    if roll_rec is not None and roll_rec["kind"] == "rolloutStage":
        candidate = {"name": roll_rec.get("name"),
                     "stage": roll_rec.get("stage"),
                     "seq": roll_rec["seq"],
                     "sinceMs": roll_rec.get("timestamp")}
    shard_rec = journal.in_force(stamp_ms, "shardMapApply")
    return {
        "resource": resource,
        "stampMs": stamp_ms,
        "second": second,
        "verdict": rule_block,
        # what ELSE was in force: the staged candidate (traffic at this
        # stamp may have been canary-enforced under it) and the shard
        # epoch/ownership the cluster was partitioned by.
        "candidateInForce": candidate,
        "lastRolloutTransition": roll_rec,
        "shardMapInForce": shard_rec,
        "journalCursor": journal.last_seq,
    }
