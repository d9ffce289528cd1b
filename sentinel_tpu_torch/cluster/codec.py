"""Binary TLV wire protocol (port of ``sentinel_tpu/cluster/codec.py``;
reference: ``cluster-common:`` request/response
entities + ``codec/`` writer/decoder registries — SURVEY.md §2.11).

Frame: big-endian ``u16`` length prefix, then the body.
Request body:  ``xid:i32 | type:u8 | entity``.
Response body: ``xid:i32 | type:u8 | status:i8 | entity``.

Entities:
  * PING request: ``u8 len | namespace utf-8``; response: empty.
  * FLOW request: ``flowId:i64 | count:i32 | priority:u8``;
    response: ``remaining:i32 | waitMs:i32`` (``FlowTokenResponseData``).
  * PARAM_FLOW request: ``flowId:i64 | count:i32 | nparams:u16 | params``
    with each param type-tagged (``u8``: 0=int/1=str/2=bool/3=float);
    response: empty.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

from sentinel_tpu_torch.cluster.constants import (
    MSG_ENTRY,
    MSG_EXIT,
    MSG_FLEET,
    MSG_FLOW,
    MSG_PARAM_FLOW,
    MSG_PING,
)

_LEN = struct.Struct(">H")
_REQ_HEAD = struct.Struct(">iB")
_RESP_HEAD = struct.Struct(">iBb")
_FLOW_REQ = struct.Struct(">qiB")
_FLOW_RESP = struct.Struct(">ii")

PARAM_INT = 0
PARAM_STR = 1
PARAM_BOOL = 2
PARAM_FLOAT = 3


class Request(NamedTuple):
    xid: int
    msg_type: int
    entity: bytes

    def materialized(self) -> "Request":
        """A Request whose entity owns its bytes: zero-copy decode hands
        out memoryview entities aliasing the recv chunk, which must be
        materialized before crossing a thread (the reactor's worker
        hand-off) or outliving the chunk."""
        if isinstance(self.entity, memoryview):
            return self._replace(entity=bytes(self.entity))
        return self


class Response(NamedTuple):
    xid: int
    msg_type: int
    status: int
    entity: bytes


def frame(body: bytes) -> bytes:
    if len(body) > 0xFFFF:
        raise ValueError(f"frame body too large: {len(body)} bytes")
    return _LEN.pack(len(body)) + body


def encode_request(xid: int, msg_type: int, entity: bytes) -> bytes:
    return frame(_REQ_HEAD.pack(xid, msg_type) + entity)


def encode_response(xid: int, msg_type: int, status: int, entity: bytes = b"") -> bytes:
    return frame(_RESP_HEAD.pack(xid, msg_type, status) + entity)


def decode_request(body: bytes) -> Request:
    xid, msg_type = _REQ_HEAD.unpack_from(body)
    return Request(xid, msg_type, body[_REQ_HEAD.size:])


def decode_response(body: bytes) -> Response:
    xid, msg_type, status = _RESP_HEAD.unpack_from(body)
    return Response(xid, msg_type, status, body[_RESP_HEAD.size:])


class FrameReader:
    """Incremental length-field frame splitter (Netty frame decoder analog)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf.extend(data)
        frames = []
        while True:
            if len(self._buf) < _LEN.size:
                break
            (length,) = _LEN.unpack_from(self._buf)
            if len(self._buf) < _LEN.size + length:
                break
            frames.append(bytes(self._buf[_LEN.size:_LEN.size + length]))
            del self._buf[:_LEN.size + length]
        return frames


class FrameScanner:
    """Zero-copy incremental frame splitter (the reactor ingest path).

    Where :class:`FrameReader` appends every chunk into one rolling
    ``bytearray`` and copies every frame body out of it (two copies per
    frame, O(buffer) deletes), ``feed`` returns ``memoryview`` slices
    INTO the fed chunk for every frame that lies wholly inside it — zero
    copies on the hot path. Only a frame split across reads is stitched,
    and the stitch copies exactly the partial bytes, never the whole
    buffer. All entity decoders read via ``struct.unpack_from``, which
    accepts memoryviews directly.

    Contract: the yielded views alias the chunk's buffer, so callers
    must finish decoding them (or materialize with ``bytes()``) before
    reusing the chunk.
    """

    __slots__ = ("_carry",)

    def __init__(self):
        self._carry = bytearray()  # partial trailing frame, if any

    def feed(self, chunk: bytes) -> List[memoryview]:
        frames: List[memoryview] = []
        n = len(chunk)
        pos = 0
        carry = self._carry
        if carry:
            # Finish the split frame first: top the carry up to a full
            # header, then to the full frame, taking only what's needed.
            if len(carry) < _LEN.size:
                take = min(_LEN.size - len(carry), n)
                carry.extend(memoryview(chunk)[:take])
                pos = take
                if len(carry) < _LEN.size:
                    return frames
            need = _LEN.size + ((carry[0] << 8) | carry[1]) - len(carry)
            if need > 0:
                take = min(need, n - pos)
                carry.extend(memoryview(chunk)[pos:pos + take])
                pos += take
                if take < need:
                    return frames
            frames.append(memoryview(bytes(carry))[_LEN.size:])
            carry.clear()
        mv = memoryview(chunk)
        while n - pos >= _LEN.size:
            end = pos + _LEN.size + ((chunk[pos] << 8) | chunk[pos + 1])
            if end > n:
                break
            frames.append(mv[pos + _LEN.size:end])
            pos = end
        if pos < n:
            carry.extend(mv[pos:])
        return frames


# -- trace-context TLV (telemetry/spans.py — the M5 cross-process hop) --------
#
# An OPTIONAL trailing field appended after any entity:
# ``tag:u8(0x54 'T') | len:u16 | value utf-8``. Wire-compatible both
# ways: every pre-existing entity decoder reads its fixed/self-delimited
# prefix with ``unpack_from`` and ignores trailing bytes, so an old peer
# simply never sees the field, and a new peer treats a missing/garbled
# TLV as "no trace" (tracing is sampling-lossy by design — a mangled
# context must never fail the token request it rides on).
#
# Request direction carries a W3C traceparent (``00-<trace32>-<span16>-
# <flags2>``); response direction carries the server-side span as
# ``<span16>:<start_ms>:<duration_us>`` so the client can stitch per-hop
# timings without a second round trip.

TLV_TRACE = 0x54
# Leadership-epoch TLV (cluster/ha.py — the M5 epoch fence): responses
# from an HA token server carry the leader's epoch as a second trailing
# TLV, AFTER any span TLV so pre-HA clients' fixed-offset trace read
# keeps working. Old peers ignore it (trailing bytes); new peers reject
# responses whose epoch is below the highest they have ever observed,
# so a deposed leader's replies can never double-grant quota.
TLV_EPOCH = 0x45
# Shard-map version TLV (cluster/sharding.py): WRONG_SLICE
# responses carry the replying server's current shard-map version so a
# mis-routed client can tell HOW stale its map is and self-heal (walk
# the other leaders, adopt the one that answers) without a config push.
# Appended after any span TLV like the epoch TLV; old peers skip it as
# trailing bytes. Flow responses ALSO mirror the version into the
# waitMs field (cheap access), but the TLV is the canonical carrier —
# param responses have no waitMs field.
TLV_MAP_VERSION = 0x4D

_TLV_HEAD = struct.Struct(">BH")
_EPOCH_VALUE = struct.Struct(">q")


def append_tlv(entity: bytes, tag: int, raw: bytes) -> bytes:
    return entity + _TLV_HEAD.pack(tag, len(raw)) + raw


def read_tlv(entity: bytes, offset: int, tag: int) -> Optional[bytes]:
    """Scan the trailing TLV run starting at ``offset`` (= the entity's
    fixed size) for ``tag``; None when absent or the run is garbled.
    Unknown tags are skipped, so TLV order and future tags never break
    a reader — the same lossy-by-design stance as the trace TLV."""
    if offset < 0:
        return None
    while len(entity) >= offset + _TLV_HEAD.size:
        t, n = _TLV_HEAD.unpack_from(entity, offset)
        if len(entity) < offset + _TLV_HEAD.size + n:
            return None
        if t == tag:
            return entity[offset + _TLV_HEAD.size:
                          offset + _TLV_HEAD.size + n]
        offset += _TLV_HEAD.size + n
    return None


def encode_epoch_value(epoch: int) -> bytes:
    return _EPOCH_VALUE.pack(int(epoch))


def append_epoch_tlv(entity: bytes, raw: bytes) -> bytes:
    """Append an epoch TLV; ``raw`` is :func:`encode_epoch_value` output
    (kept as bytes so the chaos suite's stale-epoch mutate seam can
    replace it in flight)."""
    return append_tlv(entity, TLV_EPOCH, raw)


def read_epoch_tlv(entity: bytes, offset: int) -> Optional[int]:
    raw = read_tlv(entity, offset, TLV_EPOCH)
    if raw is None or len(raw) != _EPOCH_VALUE.size:
        return None
    return _EPOCH_VALUE.unpack(raw)[0]


def append_map_version_tlv(entity: bytes, version: int) -> bytes:
    return append_tlv(entity, TLV_MAP_VERSION, _EPOCH_VALUE.pack(int(version)))


def read_map_version_tlv(entity: bytes, offset: int) -> Optional[int]:
    raw = read_tlv(entity, offset, TLV_MAP_VERSION)
    if raw is None or len(raw) != _EPOCH_VALUE.size:
        return None
    return _EPOCH_VALUE.unpack(raw)[0]


def append_trace_tlv(entity: bytes, value: str) -> bytes:
    raw = value.encode("utf-8")[:0xFF00]
    return entity + _TLV_HEAD.pack(TLV_TRACE, len(raw)) + raw


def read_trace_tlv(entity: bytes, offset: int) -> Optional[str]:
    """The TLV's utf-8 value at ``offset`` (= the entity's fixed size),
    or None when absent/garbled. Accepts memoryview entities (the
    zero-copy reactor path) as well as bytes."""
    if offset < 0 or len(entity) < offset + _TLV_HEAD.size:
        return None
    tag, n = _TLV_HEAD.unpack_from(entity, offset)
    if tag != TLV_TRACE or len(entity) < offset + _TLV_HEAD.size + n:
        return None
    try:
        return bytes(entity[offset + _TLV_HEAD.size:
                            offset + _TLV_HEAD.size + n]).decode("utf-8")
    except UnicodeDecodeError:
        return None


def encode_span_info(span_id: str, start_ms: int, duration_us: int) -> str:
    return f"{span_id}:{int(start_ms)}:{int(duration_us)}"


def decode_span_info(value: str) -> Optional[Tuple[str, int, int]]:
    parts = value.split(":")
    if len(parts) != 3:
        return None
    try:
        return parts[0], int(parts[1]), int(parts[2])
    except ValueError:
        return None


FLOW_REQ_SIZE = _FLOW_REQ.size
FLOW_RESP_SIZE = _FLOW_RESP.size


def param_flow_request_size(entity: bytes) -> int:
    """Offset just past a PARAM_FLOW request entity (where a trace TLV
    would start) — params are self-delimiting."""
    _, end = decode_params(entity, 12)
    return end


# -- entities -----------------------------------------------------------------


def encode_ping(namespace: str) -> bytes:
    raw = namespace.encode("utf-8")[:255]
    return bytes([len(raw)]) + raw


def decode_ping(entity: bytes) -> str:
    n = entity[0] if entity else 0
    return bytes(entity[1:1 + n]).decode("utf-8")


def encode_flow_request(flow_id: int, count: int, prioritized: bool) -> bytes:
    return _FLOW_REQ.pack(flow_id, count, 1 if prioritized else 0)


def decode_flow_request(entity: bytes) -> Tuple[int, int, bool]:
    flow_id, count, prio = _FLOW_REQ.unpack_from(entity)
    return flow_id, count, bool(prio)


def encode_flow_response(remaining: int, wait_ms: int) -> bytes:
    return _FLOW_RESP.pack(remaining, wait_ms)


def decode_flow_response(entity: bytes) -> Tuple[int, int]:
    if len(entity) < _FLOW_RESP.size:
        return 0, 0
    return _FLOW_RESP.unpack_from(entity)


def encode_params(params: Sequence) -> bytes:
    out = [struct.pack(">H", len(params))]
    for p in params:
        if isinstance(p, bool):
            out.append(struct.pack(">BB", PARAM_BOOL, 1 if p else 0))
        elif isinstance(p, int):
            out.append(struct.pack(">Bq", PARAM_INT, p))
        elif isinstance(p, float):
            out.append(struct.pack(">Bd", PARAM_FLOAT, p))
        else:
            # u16 length field: clamp pathological values (identity of a
            # >64KB param value degrades to its prefix, which is the same
            # bounded-key-space stance the param tables already take).
            raw = str(p).encode("utf-8")[:0xFFF0]
            out.append(struct.pack(">BH", PARAM_STR, len(raw)) + raw)
    return b"".join(out)


def decode_params(entity: bytes, offset: int = 0) -> Tuple[list, int]:
    (n,) = struct.unpack_from(">H", entity, offset)
    offset += 2
    params: list = []
    for _ in range(n):
        (tag,) = struct.unpack_from(">B", entity, offset)
        offset += 1
        if tag == PARAM_BOOL:
            (v,) = struct.unpack_from(">B", entity, offset)
            params.append(bool(v))
            offset += 1
        elif tag == PARAM_INT:
            (v,) = struct.unpack_from(">q", entity, offset)
            params.append(v)
            offset += 8
        elif tag == PARAM_FLOAT:
            (v,) = struct.unpack_from(">d", entity, offset)
            params.append(v)
            offset += 8
        else:
            (length,) = struct.unpack_from(">H", entity, offset)
            offset += 2
            params.append(bytes(entity[offset:offset + length])
                          .decode("utf-8"))
            offset += length
    return params, offset


def encode_param_flow_request(flow_id: int, count: int, params: Sequence) -> bytes:
    return struct.pack(">qi", flow_id, count) + encode_params(params)


def decode_param_flow_request(entity: bytes) -> Tuple[int, int, list]:
    flow_id, count = struct.unpack_from(">qi", entity)
    params, _ = decode_params(entity, 12)
    return flow_id, count, params


# -- MSG_ENTRY / MSG_EXIT (TPU extension — the M4 slot-chain bridge) ----------
#
# ENTRY request:  u8 rlen | resource utf-8 | u8 olen | origin utf-8 |
#                 count:i32 | entry_type:u8 | prioritized:u8 | params
#                 (params as in PARAM_FLOW: u16 n, then tagged values).
# ENTRY response: entry_id:i64 | reason:u8 — status carries OK/BLOCKED;
#                 entry_id is 0 when blocked, reason is a BlockReason code
#                 (core/constants.py: 1=flow 2=degrade 3=system 4=authority
#                 5=param 7=custom) and 0 when passed.
# EXIT request:   entry_id:i64 | error:u8 | count:i32 (count -1 = the
#                 count given at entry).
# EXIT response:  empty; status OK, or BAD_REQUEST for an unknown id.


def _pack_str8(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) > 255:
        # Truncate on a CHARACTER boundary: a blind byte slice can split
        # a multibyte sequence, and the receiver's strict UTF-8 decode
        # would then kill the whole bridge connection (and force-exit
        # every live remote entry on it) over one long resource name.
        raw = raw[:255].decode("utf-8", errors="ignore").encode("utf-8")
    return bytes([len(raw)]) + raw


def _unpack_str8(entity: bytes, offset: int) -> Tuple[str, int]:
    n = entity[offset]
    # Tolerant receive (strict send): a peer that DID split a multibyte
    # char must cost itself one mangled name, not the connection — which
    # carries other threads' live entries.
    return (bytes(entity[offset + 1:offset + 1 + n]).decode("utf-8",
                                                            "replace"),
            offset + 1 + n)


def encode_entry_request(resource: str, origin: str, count: int,
                         entry_type: int, prioritized: bool,
                         params: Sequence = ()) -> bytes:
    return (_pack_str8(resource) + _pack_str8(origin)
            + struct.pack(">iBB", count, entry_type, 1 if prioritized else 0)
            + encode_params(params))


def decode_entry_request(entity: bytes) -> Tuple[str, str, int, int, bool, list]:
    resource, off = _unpack_str8(entity, 0)
    origin, off = _unpack_str8(entity, off)
    count, entry_type, prio = struct.unpack_from(">iBB", entity, off)
    params, _ = decode_params(entity, off + 6)
    return resource, origin, count, entry_type, bool(prio), params


def encode_entry_response(entry_id: int, reason: int) -> bytes:
    return struct.pack(">qB", entry_id, reason)


def decode_entry_response(entity: bytes) -> Tuple[int, int]:
    if len(entity) < 9:
        return 0, 0
    return struct.unpack_from(">qB", entity)


def encode_exit_request(entry_id: int, error: bool, count: int = -1) -> bytes:
    return struct.pack(">qBi", entry_id, 1 if error else 0, count)


def decode_exit_request(entity: bytes) -> Tuple[int, bool, int]:
    entry_id, error, count = struct.unpack_from(">qBi", entity)
    return entry_id, bool(error), count


# -- MSG_STREAM_TICK (TPU extension — streaming reservations) ----------------
#
# STREAM request:  op:u8 (0=OPEN 1=TICK 2=CLOSE 3=ABORT) | u8 slen |
#                  streamId utf-8 | u8 mlen | model utf-8 (OPEN only,
#                  empty otherwise) | tokens:i32 (OPEN: the estimate,
#                  -1 = server default; TICK: output tokens streamed
#                  since the last tick; CLOSE/ABORT: ignored).
# STREAM response: remaining:i32 — the lease's remaining reserved
#                  tokens (floored); status carries OK / BLOCKED (the
#                  window rejected an open or an overflow tick) /
#                  BAD_REQUEST (unknown stream / malformed frame) /
#                  FAIL (no engine behind this server).

_STREAM_TOKENS = struct.Struct(">i")


def encode_stream_request(op: int, stream_id: str, model: str = "",
                          tokens: int = -1) -> bytes:
    return (bytes([int(op) & 0xFF]) + _pack_str8(stream_id)
            + _pack_str8(model) + _STREAM_TOKENS.pack(int(tokens)))


def decode_stream_request(entity: bytes) -> Tuple[int, str, str, int]:
    op = entity[0]
    stream_id, off = _unpack_str8(entity, 1)
    model, off = _unpack_str8(entity, off)
    (tokens,) = _STREAM_TOKENS.unpack_from(entity, off)
    return op, stream_id, model, tokens


def encode_stream_response(remaining: int) -> bytes:
    return _STREAM_TOKENS.pack(int(remaining))


def decode_stream_response(entity: bytes) -> int:
    if len(entity) < _STREAM_TOKENS.size:
        return 0
    return _STREAM_TOKENS.unpack_from(entity)[0]


# -- MSG_FLEET (TPU extension — fleet telemetry pull) ------------------------
#
# FLEET request:  since_ms:i64 | max_seconds:i32 — "complete seconds
#                 strictly after since_ms, at most max_seconds of them".
# FLEET response: u32 json_len | json utf-8 | trailing TLVs — the JSON
#                 document is the leader's fleet page (telemetry/fleet.py
#                 ``leader_fleet_payload``); the length prefix gives the
#                 TLV scan a fixed offset, so the response is epoch-
#                 stamped exactly like a token reply (stamp_epoch), and
#                 future TLVs ride behind it without touching the JSON.

_FLEET_REQ = struct.Struct(">qi")
_JSON_HEAD = struct.Struct(">I")


def encode_fleet_request(since_ms: int, max_seconds: int) -> bytes:
    return _FLEET_REQ.pack(int(since_ms), int(max_seconds))


def decode_fleet_request(entity: bytes) -> Tuple[int, int]:
    since_ms, max_seconds = _FLEET_REQ.unpack_from(entity)
    return since_ms, max_seconds


def encode_json_entity(obj) -> bytes:
    import json as _json

    raw = _json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return _JSON_HEAD.pack(len(raw)) + raw


def decode_json_entity(entity) -> Tuple[Optional[dict], int]:
    """(decoded object, offset past the JSON — where the TLV run
    starts), or (None, -1) on any malformation. Accepts memoryview
    entities (the zero-copy reactor path) as well as bytes."""
    import json as _json

    if len(entity) < _JSON_HEAD.size:
        return None, -1
    (n,) = _JSON_HEAD.unpack_from(entity)
    end = _JSON_HEAD.size + n
    if len(entity) < end:
        return None, -1
    try:
        return _json.loads(bytes(entity[_JSON_HEAD.size:end])
                           .decode("utf-8")), end
    except (ValueError, UnicodeDecodeError):
        return None, -1
