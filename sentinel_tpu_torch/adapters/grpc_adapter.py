"""gRPC interceptors (reference: ``sentinel-grpc-adapter``'s
``SentinelGrpcServerInterceptor`` + ``SentinelGrpcClientInterceptor`` —
SURVEY.md §2.5): the server side wraps every inbound RPC in a
``ContextUtil.enter`` + ``entry(method, IN)`` and answers blocked calls
with RESOURCE_EXHAUSTED; the client side guards outbound RPCs with
``entry(method, OUT)`` and traces failures. Resource name = the full RPC
method (``/pkg.Service/Method``), matching the reference's naming.

Port of ``sentinel_tpu/adapters/grpc_adapter.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import grpc  # this module, like the reference's grpc adapter, requires it

import sentinel_tpu_torch as st
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.exceptions import BlockException

GRPC_CONTEXT_NAME = "sentinel_grpc_context"
ORIGIN_METADATA_KEY = "sentinel-origin"  # caller app, like dubbo's attachment


def _origin_from_metadata(metadata) -> str:
    for key, value in metadata or ():
        if key == ORIGIN_METADATA_KEY:
            return value
    return ""


class SentinelGrpcServerInterceptor(grpc.ServerInterceptor):
    """``grpc.ServerInterceptor``: guard every inbound unary/streaming RPC.

    Add to the server: ``grpc.server(..., interceptors=[
    SentinelGrpcServerInterceptor()])``.
    """

    def __init__(self, fallback: Optional[Callable] = None):
        self._grpc = grpc
        self._fallback = fallback

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method
        origin = _origin_from_metadata(
            getattr(handler_call_details, "invocation_metadata", ()))
        grpc = self._grpc
        fallback = self._fallback

        def guard(behavior):
            """Unary-response guard: entry spans the behavior call; the
            with-block auto-traces a raised business exception."""

            def guarded(request_or_iterator, context):
                st.context_enter(GRPC_CONTEXT_NAME, origin)
                try:
                    try:
                        handle = st.entry(method, entry_type=C.EntryType.IN)
                    except BlockException as ex:
                        if fallback is not None:
                            return fallback(request_or_iterator, context, ex)
                        context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                      f"Blocked by Sentinel: {ex}")
                    with handle:
                        return behavior(request_or_iterator, context)
                finally:
                    st.exit_context()

            return guarded

        def guard_streaming(behavior):
            """Response-streaming guard: the behavior returns a generator,
            so the entry must stay live ACROSS the iteration — otherwise
            long streams are invisible to concurrency rules, RT is ~0, and
            mid-stream failures never reach exception metrics. gRPC's sync
            server iterates the response on the same worker thread, so the
            thread-local context holds."""

            def guarded(request_or_iterator, context):
                st.context_enter(GRPC_CONTEXT_NAME, origin)
                try:
                    try:
                        handle = st.entry(method, entry_type=C.EntryType.IN)
                    except BlockException as ex:
                        if fallback is not None:
                            return fallback(request_or_iterator, context, ex)
                        context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                      f"Blocked by Sentinel: {ex}")
                except BaseException:
                    st.exit_context()
                    raise

                def stream():
                    try:
                        with handle:  # auto-traces mid-stream exceptions
                            for item in behavior(request_or_iterator, context):
                                yield item
                    finally:
                        st.exit_context()

                return stream()

            return guarded

        # Rewrap whichever behavior kind this handler carries.
        if handler.unary_unary:
            return grpc.unary_unary_rpc_method_handler(
                guard(handler.unary_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        if handler.unary_stream:
            return grpc.unary_stream_rpc_method_handler(
                guard_streaming(handler.unary_stream),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        if handler.stream_unary:
            return grpc.stream_unary_rpc_method_handler(
                guard(handler.stream_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        return grpc.stream_stream_rpc_method_handler(
            guard_streaming(handler.stream_stream),
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer)


class SentinelGrpcClientInterceptor(grpc.UnaryUnaryClientInterceptor):
    """``grpc.UnaryUnaryClientInterceptor``: guard outbound RPCs.

    ``grpc.intercept_channel(channel, SentinelGrpcClientInterceptor())``.
    A blocked call raises the BlockException to the caller (the reference
    fails the future with the StatusRuntimeException analog); RPC errors
    feed exception metrics via ``trace``.
    """

    def __init__(self):
        self._grpc = grpc

    def intercept_unary_unary(self, continuation, client_call_details, request):
        method = client_call_details.method
        if isinstance(method, bytes):
            method = method.decode("utf-8", "replace")
        handle = st.entry(method, entry_type=C.EntryType.OUT)
        try:
            call = continuation(client_call_details, request)
        except BaseException as ex:
            handle.trace(ex)
            handle.exit()
            raise
        ok_code = self._grpc.StatusCode.OK

        def _on_done(completed):
            # Asynchronous completion: Call.code() BLOCKS until the status
            # is known, so it must never run inline — a .future() caller
            # would have every launch serialized behind its own RPC.
            try:
                if completed.code() != ok_code:
                    handle.trace(RuntimeError(f"rpc failed: {completed.code()}"))
            finally:
                handle.exit()

        call.add_done_callback(_on_done)
        return call
