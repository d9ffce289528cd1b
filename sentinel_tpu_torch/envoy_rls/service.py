"""The RLS service implementation (port of
``sentinel_tpu/envoy_rls/service.py``; reference:
``SentinelEnvoyRlsServiceImpl.java``): each request descriptor resolves to
its generated cluster rule's flowId and acquires tokens from the token
service; any over-limit descriptor makes the overall answer OVER_LIMIT.

``SentinelEnvoyRlsService`` is transport-agnostic (plain Python call);
``serve_grpc`` wraps it in a real gRPC server via a generic handler when
grpcio is present.

Device: the token service the constructor builds runs on ``cuda`` unless
the caller passes ``device="cpu"``; with no card and no device it raises.
On the card every acquire is a launch of the acquire kernel
(``csrc/cluster_acquire.cu``), one per direct call or one per coalesced
batch in batched mode.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

from sentinel_tpu_torch.cluster.constants import TokenResultStatus
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.envoy_rls.rule import (EnvoyRlsRuleManager,
                                               descriptor_flow_id)


class SentinelEnvoyRlsService:
    def __init__(self, rule_manager: Optional[EnvoyRlsRuleManager] = None,
                 token_service: Optional[DefaultTokenService] = None,
                 max_concurrent: Optional[int] = None,
                 batched: Optional[bool] = None,
                 device=None):
        self.rules = rule_manager or EnvoyRlsRuleManager()
        self.token_service = token_service or DefaultTokenService(
            self.rules.cluster_rules, device=device)
        # Batched mode: every ShouldRateLimit call submits its WHOLE
        # descriptor set as one group through a shared coalescing
        # batcher — concurrent gRPC workers fold into ONE fused device
        # step per linger tick instead of serializing on the token
        # service's lock one call at a time.
        self.batched = bool(config.wire_rls_batched()
                            if batched is None else batched)
        self._batcher = None
        if self.batched:
            from sentinel_tpu_torch.cluster.server import _Batcher

            self._batcher = _Batcher(self.token_service, linger_s=0.0002,
                                     max_batch=1024).start()
        # Overload shed gate: the gRPC executor is a fixed worker pool,
        # but nothing bounded how many in-flight ShouldRateLimit calls
        # could pile onto the shared token service's device lock. Past
        # ``max_concurrent``, calls shed IMMEDIATELY with CODE_UNKNOWN
        # (Envoy's failure-mode path: fail-open by default, deny with
        # failure_mode_deny) instead of queueing — a limiter in the
        # request path must bound its own tail latency or it becomes the
        # outage.
        self.max_concurrent = int(
            max_concurrent if max_concurrent is not None
            else config.overload_rls_max_concurrent())
        self._gate = threading.BoundedSemaphore(self.max_concurrent)
        self._stats_lock = threading.Lock()
        self.shed_count = 0
        self.served_count = 0

    def overload_stats(self) -> dict:
        out = {"maxConcurrent": self.max_concurrent,
               "shedCount": self.shed_count,
               "servedCount": self.served_count,
               "batched": self.batched}
        if self._batcher is not None:
            out["batcher"] = self._batcher.overload_stats()
        return out

    def close(self) -> None:
        """Stop the batched-mode coalescing drain (no-op otherwise)."""
        if self._batcher is not None:
            self._batcher.stop()

    def should_rate_limit(
        self,
        domain: str,
        descriptors: Sequence[Sequence[Tuple[str, str]]],
        hits_addend: int = 1,
    ) -> Tuple[int, List[Tuple[int, int]]]:
        """-> (overall_code, [(code, limit_remaining)] per descriptor).

        Codes are the RLS proto's: 1 = OK, 2 = OVER_LIMIT. Descriptors with
        no matching rule pass (reference behavior: unknown descriptor = OK).
        Over the concurrency gate the whole answer is 0 = UNKNOWN (shed):
        no descriptor touched the token service, no token was granted.
        """
        from sentinel_tpu_torch.envoy_rls import proto

        if not self._gate.acquire(blocking=False):
            with self._stats_lock:
                self.shed_count += 1
            return proto.CODE_UNKNOWN, [
                (proto.CODE_UNKNOWN, 0) for _ in descriptors]
        try:
            hits = max(1, int(hits_addend))
            statuses: List[Tuple[int, int]] = []
            overall = proto.CODE_OK
            requests = [(descriptor_flow_id(domain, list(entries)), hits,
                         False) for entries in descriptors]
            results = self._acquire(requests)
            if results is None:
                # Batched-mode shed / failed drain: same failure-mode
                # path as the concurrency gate — no token was granted.
                with self._stats_lock:
                    self.shed_count += 1
                return proto.CODE_UNKNOWN, [
                    (proto.CODE_UNKNOWN, 0) for _ in descriptors]
            for result in results:
                if result.status == TokenResultStatus.OK:
                    statuses.append((proto.CODE_OK, result.remaining))
                elif result.status == TokenResultStatus.NO_RULE_EXISTS:
                    statuses.append((proto.CODE_OK, 0))
                else:
                    statuses.append((proto.CODE_OVER_LIMIT, 0))
                    overall = proto.CODE_OVER_LIMIT
            with self._stats_lock:
                self.served_count += 1
            return overall, statuses
        finally:
            self._gate.release()

    def _acquire(self, requests):
        """Token acquires for one descriptor set: direct or as one
        coalesced group through the shared batcher (batched mode).
        Returns None when the batched path shed or failed the group."""
        if self._batcher is None:
            return self.token_service.request_tokens(requests)
        done, box = self._batcher.submit_many(requests)
        done.wait(timeout=max(5.0, self._batcher.deadline_ms / 1000.0 + 1.0))
        return box.get("results")

    # -- gRPC transport ----------------------------------------------------

    def _grpc_body(self, request, response_cls):
        descriptors = [
            [(e.key, e.value) for e in d.entries] for d in request.descriptors
        ]
        overall, statuses = self.should_rate_limit(
            request.domain, descriptors, request.hits_addend or 1)
        resp = response_cls()
        resp.overall_code = overall
        for code, remaining in statuses:
            s = resp.statuses.add()
            s.code = code
            s.limit_remaining = remaining
        return resp

    def grpc_should_rate_limit(self, request, context=None):
        """v2 gRPC method body over the dynamic proto messages."""
        from sentinel_tpu_torch.envoy_rls import proto

        return self._grpc_body(request, proto.RateLimitResponse)

    def grpc_should_rate_limit_v3(self, request, context=None):
        """v3 twin (``envoy.service.ratelimit.v3`` — what current Envoy
        speaks); identical semantics, renamed packages."""
        from sentinel_tpu_torch.envoy_rls import proto

        return self._grpc_body(request, proto.RateLimitResponseV3)

    def serve_grpc(self, address: str = "0.0.0.0:10245",
                   max_workers: Optional[int] = None):
        """Start a gRPC server exposing RateLimitService under BOTH the
        v2 service name (the reference's surface) and the v3 one
        (current Envoy's); returns it. The worker pool SIZES ABOVE the
        shed gate: the gate must be the binding limit, so the overflow
        workers exist precisely to run the immediate CODE_UNKNOWN shed —
        a pool <= the gate would instead park excess RPCs in the
        executor's unbounded internal queue with no deadline, the exact
        collapse mode the gate closes."""
        import concurrent.futures

        if max_workers is None:
            # No independent cap: clamping the pool below the gate would
            # silently reintroduce executor-queue collapse for large
            # gate configs; the operator sizes thread count via the
            # rls.max.concurrent key itself.
            max_workers = self.max_concurrent + 8

        import grpc

        from sentinel_tpu_torch.envoy_rls import proto

        v2_handler = grpc.method_handlers_generic_handler(
            proto.SERVICE_NAME,
            {
                proto.METHOD_NAME: grpc.unary_unary_rpc_method_handler(
                    self.grpc_should_rate_limit,
                    request_deserializer=proto.RateLimitRequest.FromString,
                    response_serializer=proto.RateLimitResponse.SerializeToString,
                )
            },
        )
        v3_handler = grpc.method_handlers_generic_handler(
            proto.SERVICE_NAME_V3,
            {
                proto.METHOD_NAME: grpc.unary_unary_rpc_method_handler(
                    self.grpc_should_rate_limit_v3,
                    request_deserializer=proto.RateLimitRequestV3.FromString,
                    response_serializer=(
                        proto.RateLimitResponseV3.SerializeToString),
                )
            },
        )
        server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=max_workers))
        server.add_generic_rpc_handlers((v2_handler, v3_handler))
        port = server.add_insecure_port(address)
        server.start()
        server.bound_port = port
        return server
