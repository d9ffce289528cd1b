"""etcd v3 datasource: the gRPC watch protocol (reference:
``sentinel-datasource-etcd``'s ``EtcdDataSource`` — an initial KV get
plus a Watch stream keyed on revisions — SURVEY.md §2.2).

This speaks actual etcd3 gRPC: ``etcdserverpb.KV/Range``, ``KV/Put``
and the bidirectional ``etcdserverpb.Watch/Watch`` stream, with message
schemas (field numbers mirroring etcd's ``rpc.proto`` / ``kv.proto``)
registered at runtime the same way ``envoy_rls/proto.py`` does — the
environment has the protobuf runtime but no protoc codegen. Wire-
compatible with a real etcd server for the subset used.

The connector owns reconnect/backoff and revision bookkeeping: every
(re)connected watch starts at ``last seen revision + 1``, and the fake
(like real etcd) replays the current value when the start revision is
in the past, so updates missed during an outage are recovered. Bad
payloads keep the last good rules; deletes keep the last good rules.

``MiniEtcdServer`` is the in-repo fake (Range/Put/Watch subset over a
real grpcio server); point the datasource at a real etcd and no line of
the connector changes.

Port of ``sentinel_tpu/datasource/etcd.py``: the same classes, wire and
threads, importing only this package.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Tuple

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

from sentinel_tpu_torch.datasource.base import (
    AbstractDataSource,
    Converter,
    ReconnectingWatchMixin,
    T,
    WritableDataSource,
    _log_warn,
)

_T = descriptor_pb2.FieldDescriptorProto

EVENT_PUT = 0
EVENT_DELETE = 1


def _field(name, number, ftype, label=_T.LABEL_OPTIONAL, type_name=None):
    f = _T(name=name, number=number, type=ftype, label=label)
    if type_name:
        f.type_name = type_name
    return f


def _build_pool() -> descriptor_pool.DescriptorPool:
    pool = descriptor_pool.DescriptorPool()

    kv = descriptor_pb2.FileDescriptorProto(
        name="etcd/mvccpb/kv.proto", package="mvccpb")
    keyvalue = kv.message_type.add(name="KeyValue")
    keyvalue.field.append(_field("key", 1, _T.TYPE_BYTES))
    keyvalue.field.append(_field("create_revision", 2, _T.TYPE_INT64))
    keyvalue.field.append(_field("mod_revision", 3, _T.TYPE_INT64))
    keyvalue.field.append(_field("version", 4, _T.TYPE_INT64))
    keyvalue.field.append(_field("value", 5, _T.TYPE_BYTES))
    keyvalue.field.append(_field("lease", 6, _T.TYPE_INT64))
    event = kv.message_type.add(name="Event")
    etype = event.enum_type.add(name="EventType")
    etype.value.add(name="PUT", number=0)
    etype.value.add(name="DELETE", number=1)
    event.field.append(_field(
        "type", 1, _T.TYPE_ENUM, type_name=".mvccpb.Event.EventType"))
    event.field.append(_field(
        "kv", 2, _T.TYPE_MESSAGE, type_name=".mvccpb.KeyValue"))
    pool.Add(kv)

    rpc = descriptor_pb2.FileDescriptorProto(
        name="etcd/etcdserverpb/rpc.proto", package="etcdserverpb",
        dependency=["etcd/mvccpb/kv.proto"])

    header = rpc.message_type.add(name="ResponseHeader")
    header.field.append(_field("cluster_id", 1, _T.TYPE_UINT64))
    header.field.append(_field("member_id", 2, _T.TYPE_UINT64))
    header.field.append(_field("revision", 3, _T.TYPE_INT64))
    header.field.append(_field("raft_term", 4, _T.TYPE_UINT64))

    rng = rpc.message_type.add(name="RangeRequest")
    rng.field.append(_field("key", 1, _T.TYPE_BYTES))
    rng.field.append(_field("range_end", 2, _T.TYPE_BYTES))
    rng.field.append(_field("limit", 3, _T.TYPE_INT64))
    rng.field.append(_field("revision", 4, _T.TYPE_INT64))

    rngr = rpc.message_type.add(name="RangeResponse")
    rngr.field.append(_field(
        "header", 1, _T.TYPE_MESSAGE, type_name=".etcdserverpb.ResponseHeader"))
    rngr.field.append(_field(
        "kvs", 2, _T.TYPE_MESSAGE, _T.LABEL_REPEATED, ".mvccpb.KeyValue"))
    rngr.field.append(_field("more", 3, _T.TYPE_BOOL))
    rngr.field.append(_field("count", 4, _T.TYPE_INT64))

    put = rpc.message_type.add(name="PutRequest")
    put.field.append(_field("key", 1, _T.TYPE_BYTES))
    put.field.append(_field("value", 2, _T.TYPE_BYTES))

    putr = rpc.message_type.add(name="PutResponse")
    putr.field.append(_field(
        "header", 1, _T.TYPE_MESSAGE, type_name=".etcdserverpb.ResponseHeader"))

    wcreate = rpc.message_type.add(name="WatchCreateRequest")
    wcreate.field.append(_field("key", 1, _T.TYPE_BYTES))
    wcreate.field.append(_field("range_end", 2, _T.TYPE_BYTES))
    wcreate.field.append(_field("start_revision", 3, _T.TYPE_INT64))

    wcancel = rpc.message_type.add(name="WatchCancelRequest")
    wcancel.field.append(_field("watch_id", 1, _T.TYPE_INT64))

    wreq = rpc.message_type.add(name="WatchRequest")
    wreq.field.append(_field(
        "create_request", 1, _T.TYPE_MESSAGE,
        type_name=".etcdserverpb.WatchCreateRequest"))
    wreq.field.append(_field(
        "cancel_request", 2, _T.TYPE_MESSAGE,
        type_name=".etcdserverpb.WatchCancelRequest"))

    wresp = rpc.message_type.add(name="WatchResponse")
    wresp.field.append(_field(
        "header", 1, _T.TYPE_MESSAGE, type_name=".etcdserverpb.ResponseHeader"))
    wresp.field.append(_field("watch_id", 2, _T.TYPE_INT64))
    wresp.field.append(_field("created", 3, _T.TYPE_BOOL))
    wresp.field.append(_field("canceled", 4, _T.TYPE_BOOL))
    wresp.field.append(_field("compact_revision", 5, _T.TYPE_INT64))
    wresp.field.append(_field(
        "events", 11, _T.TYPE_MESSAGE, _T.LABEL_REPEATED, ".mvccpb.Event"))
    pool.Add(rpc)
    return pool


_pool = _build_pool()


def _cls(full_name: str):
    return message_factory.GetMessageClass(
        _pool.FindMessageTypeByName(full_name))


KeyValue = _cls("mvccpb.KeyValue")
Event = _cls("mvccpb.Event")
RangeRequest = _cls("etcdserverpb.RangeRequest")
RangeResponse = _cls("etcdserverpb.RangeResponse")
PutRequest = _cls("etcdserverpb.PutRequest")
PutResponse = _cls("etcdserverpb.PutResponse")
WatchRequest = _cls("etcdserverpb.WatchRequest")
WatchResponse = _cls("etcdserverpb.WatchResponse")

KV_SERVICE = "etcdserverpb.KV"
WATCH_SERVICE = "etcdserverpb.Watch"


class EtcdDataSource(ReconnectingWatchMixin, AbstractDataSource[bytes, T]):
    """Initial Range + revision-keyed Watch stream, with reconnect.

    Revision bookkeeping follows etcd's contract: the header revision of
    the last observed state is remembered, and every (re)created watch
    asks for ``start_revision = seen + 1`` — so an update that landed
    while the watcher was down arrives as the first replayed event (and
    each reconnect's fresh Range read covers even compacted history).
    """

    _watch_thread_name = "sentinel-etcd-watch"

    def __init__(self, endpoint: str, key: str, converter: Converter,
                 reconnect_backoff_ms: Tuple[int, int] = (50, 2000)):
        super().__init__(converter)
        self.endpoint = endpoint
        self.key = key.encode("utf-8") if isinstance(key, str) else key
        self._revision = 0      # last header revision observed
        self._applied: Optional[bytes] = None
        self._channel = None
        self._init_watch(reconnect_backoff_ms)

    # -- plumbing ----------------------------------------------------------

    def _open(self):
        import grpc

        channel = grpc.insecure_channel(self.endpoint)
        range_rpc = channel.unary_unary(
            f"/{KV_SERVICE}/Range",
            request_serializer=RangeRequest.SerializeToString,
            response_deserializer=RangeResponse.FromString)
        watch_rpc = channel.stream_stream(
            f"/{WATCH_SERVICE}/Watch",
            request_serializer=WatchRequest.SerializeToString,
            response_deserializer=WatchResponse.FromString)
        return channel, range_rpc, watch_rpc

    # -- ReadableDataSource ------------------------------------------------

    def read_source(self) -> Optional[bytes]:
        channel, range_rpc, _ = self._open()
        try:
            resp = range_rpc(RangeRequest(key=self.key), timeout=5.0)
            if resp.header.revision > self._revision:
                self._revision = resp.header.revision
            return resp.kvs[0].value if resp.kvs else None
        finally:
            channel.close()

    def start(self) -> "EtcdDataSource":
        try:
            self._apply(self.read_source())
        except Exception as ex:  # grpc.RpcError etc.
            _log_warn("etcd datasource initial load failed: %r", ex)
        self._start_watching()
        return self

    def close(self) -> None:
        self._join_watch()

    def _interrupt_watch(self) -> None:
        channel = self._channel
        if channel is not None:
            # close() aborts the in-flight watch stream, waking the thread.
            channel.close()

    # -- internals ---------------------------------------------------------

    def _apply(self, raw: Optional[bytes]) -> None:
        if raw is None or self._stop.is_set():
            return
        if raw == self._applied:
            return  # replayed catch-up of a value already live
        try:
            value = self.converter(raw.decode("utf-8"))
        except Exception as ex:  # keep last good rules
            _log_warn("etcd datasource bad payload: %r", ex)
            return
        if value is not None:
            self._property.update_value(value)
            self._applied = raw

    def _watch_round(self) -> None:
        """One connect → catch-up Range → watch-until-error cycle.

        ``grpc.RpcError`` is re-raised as ``ConnectionError`` so the
        mixin's exception tuple stays free of the (lazily imported) grpc
        module.
        """
        import grpc

        channel = None
        try:
            channel, range_rpc, watch_rpc = self._open()
            self._channel = channel
            # State-based catch-up BEFORE watching (the Consul/Redis
            # reconnect discipline): a put that landed while the watcher
            # was down — including one the server compacted past, which a
            # start_revision replay can NEVER deliver — is recovered by
            # this read; the watch then covers everything after it.
            cur = range_rpc(RangeRequest(key=self.key), timeout=5.0)
            if cur.header.revision > self._revision:
                self._revision = cur.header.revision
            if cur.kvs:
                self._apply(cur.kvs[0].value)
            create = WatchRequest()
            create.create_request.key = self.key
            create.create_request.start_revision = self._revision + 1
            responses = watch_rpc(iter([create]))
            for resp in responses:
                if self._stop.is_set():
                    return
                if resp.canceled:
                    # e.g. compaction past our start revision — the next
                    # round's Range read re-syncs state.
                    raise ConnectionError(
                        f"watch canceled (compact_revision="
                        f"{resp.compact_revision})")
                if resp.header.revision > self._revision:
                    self._revision = resp.header.revision
                for ev in resp.events:
                    if ev.type == EVENT_PUT:
                        self._apply(ev.kv.value)
                    # DELETE keeps the last good rules (the reference
                    # datasources' stance on removal).
                if resp.created:
                    self._healthy()
            if not self._stop.is_set():
                raise ConnectionError("watch stream ended")
        except grpc.RpcError as ex:
            raise ConnectionError(f"grpc: {ex}") from ex
        finally:
            self._channel = None
            if channel is not None:
                channel.close()


class EtcdWritableDataSource(WritableDataSource[T]):
    """Publish via ``KV/Put`` (the reference writer's shape)."""

    def __init__(self, endpoint: str, key: str, encoder: Converter):
        self.endpoint = endpoint
        self.key = key.encode("utf-8") if isinstance(key, str) else key
        self.encoder = encoder

    def write(self, value: T) -> None:
        import grpc

        channel = grpc.insecure_channel(self.endpoint)
        try:
            put_rpc = channel.unary_unary(
                f"/{KV_SERVICE}/Put",
                request_serializer=PutRequest.SerializeToString,
                response_deserializer=PutResponse.FromString)
            put_rpc(PutRequest(
                key=self.key,
                value=self.encoder(value).encode("utf-8")), timeout=5.0)
        finally:
            channel.close()


# -- in-repo fake server ------------------------------------------------------


class MiniEtcdServer:
    """etcd3 Range/Put/Watch subset over a real grpcio server.

    ``stop()`` + ``start()`` rebinds the same port for reconnect tests;
    the KV store and revision counter survive (a real etcd's raft log
    would too). A watch created with ``start_revision`` at or before the
    watched key's mod_revision replays the current value first — etcd's
    historical-replay contract, which is what makes reconnect lossless.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._kv: Dict[bytes, Tuple[bytes, int, int, int]] = (
            {})  # key -> (value, create_rev, mod_rev, version)
        self._revision = 0
        self._lock = threading.Lock()
        self._watchers: List[Tuple[bytes, "queue.Queue"]] = []
        self._server = None
        self.watch_count = 0  # test hook

    # -- handlers ----------------------------------------------------------

    def _range(self, request, context):
        resp = RangeResponse()
        with self._lock:
            resp.header.revision = self._revision
            entry = self._kv.get(bytes(request.key))
            if entry is not None:
                value, crev, mrev, ver = entry
                kv = resp.kvs.add()
                kv.key = bytes(request.key)
                kv.value = value
                kv.create_revision = crev
                kv.mod_revision = mrev
                kv.version = ver
                resp.count = 1
        return resp

    def _put(self, request, context):
        key, value = bytes(request.key), bytes(request.value)
        with self._lock:
            self._revision += 1
            old = self._kv.get(key)
            crev = old[1] if old else self._revision
            ver = (old[3] + 1) if old else 1
            self._kv[key] = (value, crev, self._revision, ver)
            mrev = self._revision
            watchers = list(self._watchers)
        for wkey, q in watchers:
            if wkey == key:
                q.put((EVENT_PUT, key, value, crev, mrev, ver))
        resp = PutResponse()
        resp.header.revision = mrev
        return resp

    def _watch(self, request_iterator, context):
        create = None
        for req in request_iterator:
            if req.HasField("create_request"):
                create = req.create_request
                break
            if req.HasField("cancel_request"):
                return
        if create is None:
            return
        key = bytes(create.key)
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            self._watchers.append((key, q))
            self.watch_count += 1
            entry = self._kv.get(key)
            rev = self._revision
        try:
            created = WatchResponse()
            created.created = True
            created.header.revision = rev
            yield created
            # Historical replay: a start_revision at or before the
            # current mod_revision means the watcher missed that put.
            if (entry is not None and create.start_revision
                    and create.start_revision <= entry[2]):
                q.put((EVENT_PUT, key, entry[0], entry[1], entry[2],
                       entry[3]))
            while context.is_active():
                try:
                    etype, k, v, crev, mrev, ver = q.get(timeout=0.2)
                except queue.Empty:
                    continue
                resp = WatchResponse()
                resp.header.revision = mrev
                ev = resp.events.add()
                ev.type = etype
                ev.kv.key = k
                ev.kv.value = v
                ev.kv.create_revision = crev
                ev.kv.mod_revision = mrev
                ev.kv.version = ver
                yield resp
        finally:
            with self._lock:
                try:
                    self._watchers.remove((key, q))
                except ValueError:
                    pass

    # -- lifecycle ---------------------------------------------------------

    @property
    def endpoint(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "MiniEtcdServer":
        import concurrent.futures

        import grpc

        server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=8))
        server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(KV_SERVICE, {
                "Range": grpc.unary_unary_rpc_method_handler(
                    self._range,
                    request_deserializer=RangeRequest.FromString,
                    response_serializer=RangeResponse.SerializeToString),
                "Put": grpc.unary_unary_rpc_method_handler(
                    self._put,
                    request_deserializer=PutRequest.FromString,
                    response_serializer=PutResponse.SerializeToString),
            }),
            grpc.method_handlers_generic_handler(WATCH_SERVICE, {
                "Watch": grpc.stream_stream_rpc_method_handler(
                    self._watch,
                    request_deserializer=WatchRequest.FromString,
                    response_serializer=WatchResponse.SerializeToString),
            }),
        ))
        bound = server.add_insecure_port(f"{self.host}:{self.port}")
        if self.port == 0:
            self.port = bound  # pin for restarts
        server.start()
        self._server = server
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.2).wait(timeout=2.0)
            self._server = None
        with self._lock:
            self._watchers.clear()

    def put(self, key: str, value: str) -> None:
        self._put(PutRequest(key=key.encode("utf-8"),
                             value=value.encode("utf-8")), None)
