"""The versioned, portable trace format (capture half of the simulator;
port of ``sentinel_tpu/simulator/trace.py``).

One trace = one timebase (``epochMs``) + one record per flight-recorder
second: per-resource demand (acquire-count histogram), and the observed
exit pattern (success-RT bucket histogram + exception count). Traces
carry the rule sets that were live at capture so a replay reproduces the
admission world, and free-form ``meta`` the generators use for the two
models real recordings cannot carry — the closed-loop retry coupling and
the load-dependent RT profile (``scenarios.py``).

Capture paths:

* :func:`export_trace` — one-shot export of the engine's spilled
  flight-recorder history (the ``flightrec op=export`` command).
* :class:`TraceWriter` — a tee registered on the engine's spill
  (``engine.add_flight_tee``): every complete second is appended to a
  JSONL file as it spills (header line + one line per second), so a
  live incident can be captured continuously and replayed later
  (``flightrec op=tee`` / ``op=stop``).

Exactness contract (the reference's "Replay determinism"): the flight
recorder records token AGGREGATES per second — live export reconstructs
demand as count-1 acquires at the second boundary, which replays the
per-second pass/block series exactly for default-window rules driven at
second granularity; per-entry acquire-count structure and sub-second
arrival order are the two things a live trace does not carry (synthetic
scenario traces DO carry mixed counts explicitly).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from sentinel_tpu_torch.telemetry.attribution import NUM_RT_BUCKETS

TRACE_VERSION = 1
TRACE_KIND = "sentinel-tpu-trace"

# Rule families a trace may carry, in the converter vocabulary.
_RULE_FAMILIES = ("flow", "degrade", "param", "system", "authority", "tps")

# Streaming-reservation ops a trace second's "g" events may carry:
# deterministic stream lifecycles the replay drives through
# the engine's stream_open/stream_tick/stream_close calls.
_STREAM_OPS = ("open", "tick", "close", "abort")


def _validate_streams(events) -> list:
    out = []
    for ev in events or ():
        op = ev.get("op")
        if op not in _STREAM_OPS:
            raise ValueError(f"trace stream event op {op!r} invalid "
                             f"(one of {_STREAM_OPS})")
        sid = ev.get("id")
        if not isinstance(sid, str) or not sid:
            raise ValueError(f"trace stream event id {sid!r} invalid")
        clean = {"op": op, "id": sid}
        if op == "open":
            model = ev.get("model")
            if not isinstance(model, str) or not model:
                raise ValueError(
                    f"trace stream open {sid!r} needs a model")
            clean["model"] = model
            est = int(ev.get("est", 0))
            if est < 0:
                raise ValueError(
                    f"trace stream open {sid!r} estimate {est} < 0")
            clean["est"] = est
        elif op == "tick":
            tok = int(ev.get("tok", 0))
            if tok < 0:
                raise ValueError(
                    f"trace stream tick {sid!r} tokens {tok} < 0")
            clean["tok"] = tok
        out.append(clean)
    return out


def _validate_demand(d: Dict) -> Dict[str, list]:
    out = {}
    for res, pairs in (d or {}).items():
        if not isinstance(res, str) or not res:
            raise ValueError(f"trace demand resource {res!r} invalid")
        clean = []
        for pair in pairs:
            count, n = int(pair[0]), int(pair[1])
            if count <= 0 or n < 0:
                raise ValueError(
                    f"trace demand pair {pair!r} on {res!r} invalid "
                    "(count must be positive, n non-negative)")
            if n:
                clean.append([count, n])
        if clean:
            out[res] = clean
    return out


class Trace:
    """One replayable workload: metadata + rules + per-second records."""

    __slots__ = ("version", "epoch_ms", "duration_s", "meta", "resources",
                 "rules", "seconds")

    def __init__(self, epoch_ms: int, duration_s: int,
                 meta: Optional[Dict] = None,
                 resources: Optional[List[str]] = None,
                 rules: Optional[Dict[str, list]] = None,
                 seconds: Optional[List[Dict]] = None):
        self.version = TRACE_VERSION
        self.epoch_ms = int(epoch_ms)
        self.duration_s = int(duration_s)
        self.meta = dict(meta or {})
        self.resources = list(resources or [])
        self.rules = {f: list(rs) for f, rs in (rules or {}).items()}
        # Sparse by design: all-idle seconds are omitted (the recorder's
        # own skip-idle stance); duration_s preserves trailing idle.
        self.seconds = list(seconds or [])

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> Dict:
        return {
            "version": self.version,
            "kind": TRACE_KIND,
            "epochMs": self.epoch_ms,
            "durationS": self.duration_s,
            "meta": self.meta,
            "resources": self.resources,
            "rules": self.rules,
            "seconds": self.seconds,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Trace":
        if not isinstance(d, dict):
            raise ValueError("trace must be a JSON object")
        if d.get("kind") != TRACE_KIND:
            raise ValueError(f"not a {TRACE_KIND} document "
                             f"(kind={d.get('kind')!r})")
        version = int(d.get("version", -1))
        if version != TRACE_VERSION:
            # Versioned: a future writer's trace must fail loudly here,
            # never half-replay under old semantics.
            raise ValueError(
                f"trace version {version} unsupported (this build reads "
                f"version {TRACE_VERSION})")
        duration = int(d.get("durationS", 0))
        if duration <= 0:
            raise ValueError(f"trace durationS {duration} must be positive")
        seconds = []
        for sec in d.get("seconds", ()):
            t = int(sec["t"])
            if not 0 <= t < duration:
                raise ValueError(
                    f"trace second t={t} outside [0, {duration})")
            rec = {"t": t, "d": _validate_demand(sec.get("d", {}))}
            if sec.get("x"):
                exits = {}
                for res, cell in sec["x"].items():
                    rt = [int(v) for v in cell.get("rt", ())]
                    if len(rt) > NUM_RT_BUCKETS:
                        # Reject at load, not IndexError mid-replay:
                        # the bucket geometry is part of the format.
                        raise ValueError(
                            f"trace second t={t} resource {res!r} "
                            f"carries {len(rt)} rt buckets (format "
                            f"has {NUM_RT_BUCKETS})")
                    exits[res] = {"rt": rt,
                                  "err": int(cell.get("err", 0))}
                rec["x"] = exits
            if sec.get("g"):
                # Streamed-generation events — preserved
                # through the round-trip, replayed in list order.
                rec["g"] = _validate_streams(sec["g"])
            seconds.append(rec)
        seconds.sort(key=lambda s: s["t"])
        stamps = [s["t"] for s in seconds]
        if len(set(stamps)) != len(stamps):
            raise ValueError("trace carries duplicate seconds")
        rules = d.get("rules") or {}
        unknown = sorted(set(rules) - set(_RULE_FAMILIES))
        if unknown:
            raise ValueError(f"trace carries unknown rule families "
                             f"{unknown}")
        # Resources = declared ∪ observed: a TraceWriter stream's header
        # is written before any second exists, so its declared list is
        # empty — the seconds themselves are authoritative (a replay
        # must resolve a row for every resource they reference).
        # Declared order is preserved (round-trip fidelity); observed
        # stragglers append sorted.
        declared = [str(r) for r in d.get("resources", ())]
        observed = set()
        for sec in seconds:
            observed.update(sec["d"])
            observed.update(sec.get("x", {}))
        return cls(
            epoch_ms=int(d.get("epochMs", 0)),
            duration_s=duration,
            meta=d.get("meta") or {},
            resources=declared + sorted(observed - set(declared)),
            rules=rules,
            seconds=seconds,
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, source: str) -> "Trace":
        """Parse either shape a capture produces: one JSON object
        (``export_trace``/``save``) or the ``TraceWriter`` JSONL stream
        (header line + one line per second)."""
        source = source.strip()
        try:
            doc = json.loads(source)
        except ValueError:
            doc = None
        if isinstance(doc, dict):
            return cls.from_dict(doc)
        lines = [ln for ln in source.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace document")
        head = json.loads(lines[0])
        body = lines[1:]
        # Crash-safety contract: a tee killed mid-write may leave ONE
        # torn trailing line — drop it, the complete seconds before it
        # are the capture. A torn line anywhere else is corruption and
        # still rejects loudly.
        if body:
            try:
                json.loads(body[-1])
            except ValueError:
                body = body[:-1]
        head["seconds"] = [json.loads(ln) for ln in body]
        # A mid-write tail may exceed the header's provisional duration:
        # the stream is authoritative for how long the capture ran.
        if head["seconds"]:
            head["durationS"] = max(int(head.get("durationS", 1)),
                                    head["seconds"][-1]["t"] + 1)
        return cls.from_dict(head)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())

    # -- accessors ---------------------------------------------------------

    def second(self, t: int) -> Optional[Dict]:
        for sec in self.seconds:
            if sec["t"] == t:
                return sec
        return None

    def total_offered(self) -> int:
        """Total demand tokens across the trace (utilization divisor)."""
        return sum(count * n
                   for sec in self.seconds
                   for pairs in sec["d"].values()
                   for count, n in pairs)


def _rules_snapshot(engine) -> Dict[str, list]:
    """Every family's live rules as converter dicts (what a replay needs
    to reproduce the admission world at capture time)."""
    from sentinel_tpu_torch.datasource import converters as CV

    return {
        "flow": [CV.flow_rule_to_dict(r)
                 for r in engine.flow_rules.get_rules()],
        "degrade": [CV.degrade_rule_to_dict(r)
                    for r in engine.degrade_rules.get_rules()],
        "param": [CV.param_rule_to_dict(r)
                  for r in engine.param_rules.get_rules()],
        "system": [CV.system_rule_to_dict(r)
                   for r in engine.system_rules.get_rules()],
        "authority": [CV.authority_rule_to_dict(r)
                      for r in engine.authority_rules.get_rules()],
        "tps": [CV.tps_rule_to_dict(r)
                for r in engine.tps_rules.get_rules()],
    }


def _second_to_trace_record(sec_dict: Dict, epoch_ms: int) -> Dict:
    """``second_to_dict`` JSON shape -> one trace second (offset form)."""
    t = (int(sec_dict["timestamp"]) - epoch_ms) // 1000
    demand: Dict[str, list] = {}
    exits: Dict[str, Dict] = {}
    for res, cell in sec_dict.get("resources", {}).items():
        offered = int(cell.get("pass", 0)) + int(cell.get("block", 0))
        if offered:
            demand[res] = [[1, offered]]
        rt = cell.get("rtBuckets") or []
        err = int(cell.get("exception", 0))
        if any(rt) or err:
            exits[res] = {"rt": [int(v) for v in rt], "err": err}
    rec = {"t": t, "d": demand}
    if exits:
        rec["x"] = exits
    return rec


def export_trace(engine, start_ms: Optional[int] = None,
                 end_ms: Optional[int] = None,
                 limit: Optional[int] = None,
                 resource: Optional[str] = None,
                 meta: Optional[Dict] = None) -> Trace:
    """Build a trace from the engine's spilled flight-recorder history
    (the ``flightrec op=export`` surface). ``limit`` keeps the newest N
    complete seconds; ``start_ms``/``end_ms`` bound the window;
    ``resource`` filters to one resource's series."""
    view = engine.timeseries_view(resource=resource, start_ms=start_ms,
                                  end_ms=end_ms, limit=limit)
    secs = view["seconds"]
    if secs:
        epoch = int(secs[0]["timestamp"])
        duration = (int(secs[-1]["timestamp"]) - epoch) // 1000 + 1
    else:
        epoch, duration = engine.now_ms() - engine.now_ms() % 1000, 1
    records = [_second_to_trace_record(s, epoch) for s in secs]
    records = [r for r in records if r["d"] or r.get("x")]
    resources = sorted({res for r in records for res in r["d"]}
                       | {res for r in records for res in r.get("x", {})})
    base_meta = {
        "source": "flightrec",
        "capturedMs": engine.now_ms(),
        # Honesty markers the replay keys off: live
        # aggregates collapse acquire counts to 1-token acquires and
        # sub-second arrival to the second boundary.
        "demand": "token-aggregate",
        "openLoop": True,
    }
    base_meta.update(meta or {})
    return Trace(epoch_ms=epoch, duration_s=max(1, duration),
                 meta=base_meta, resources=resources,
                 rules=_rules_snapshot(engine), seconds=records)


class TraceWriter:
    """Continuous capture: tee every spilled second into a JSONL file.

    Register with ``engine.add_flight_tee(writer.on_second)`` (the
    ``flightrec op=tee`` command does both ends). The header line is
    written on the FIRST second (its stamp fixes the trace epoch), each
    subsequent second appends one line and flushes — a crash keeps every
    complete second written so far, and :meth:`Trace.from_json` reads
    the stream shape directly."""

    def __init__(self, path: str, engine, meta: Optional[Dict] = None):
        self.path = path
        self.engine = engine
        self.meta = dict(meta or {})
        self.epoch_ms: Optional[int] = None
        self.seconds_written = 0
        self._file = open(path, "w", encoding="utf-8")
        self._closed = False

    def on_second(self, sec_dict: Dict) -> None:
        if self._closed:
            return
        try:
            self._write_second(sec_dict)
        except OSError:
            # Disk full / file yanked: mark THIS writer dead before the
            # engine detaches the callback, so `flightrec op=status`
            # reports the truth (closed, count frozen) and a fresh
            # op=tee is not refused by a zombie "active" writer.
            self.close()
            raise

    def _write_second(self, sec_dict: Dict) -> None:
        stamp = int(sec_dict["timestamp"])
        if self.epoch_ms is None:
            self.epoch_ms = stamp
            head = Trace(
                epoch_ms=stamp, duration_s=1,
                meta={"source": "flightrec-tee", "streamed": True,
                      "demand": "token-aggregate", "openLoop": True,
                      **self.meta},
                resources=[], rules=_rules_snapshot(self.engine),
                seconds=[]).to_dict()
            del head["seconds"]
            self._file.write(json.dumps(head, sort_keys=True) + "\n")
        rec = _second_to_trace_record(sec_dict, self.epoch_ms)
        if not rec["d"] and not rec.get("x"):
            return
        self._file.write(json.dumps(rec, sort_keys=True) + "\n")
        self._file.flush()
        self.seconds_written += 1

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._file.close()

    def status(self) -> Dict:
        return {"path": self.path, "epochMs": self.epoch_ms,
                "secondsWritten": self.seconds_written,
                "closed": self._closed}
