"""The port's framework adapters (``sentinel_tpu_torch/adapters/``) on
the CPU, then held to the JAX package's.

The first part is the port's counterpart of every case of
``tests/test_adapters.py``: the same scenario on a fresh port default
engine (``reset(capacity=512, device="cpu")``) under the port's frozen
clock; the gRPC and HTTP cases run real loopback servers.

The second part (``TestParity``) drives the same scripts through both
packages' adapters: the JAX package's default engine and the port's,
built ONCE for the module (a JAX engine compiles its steps per width and
rule shape, seconds each on the CPU), with both clocks frozen at the same
epoch and the rules reset between cases, not the engines. Every verdict,
``rule_slot``, rule list, JSON document and status code must be equal.

The last part holds the two repairs the adapters need: the param rule
manager's gateway partition and the RLS config readers.
"""

import asyncio
import io

import pytest

import sentinel_tpu_torch as st
from sentinel_tpu_torch.adapters import (
    ApiDefinition,
    ApiPredicateItem,
    GatewayApiDefinitionManager,
    GatewayFlowRule,
    GatewayParamFlowItem,
    GatewayRequest,
    GatewayRuleManager,
    SentinelASGIMiddleware,
    SentinelWSGIMiddleware,
    gateway_entry,
    sentinel_resource,
)
from sentinel_tpu_torch.adapters import gateway as G
from sentinel_tpu_torch.core.exceptions import BlockException, FlowException
from sentinel_tpu_torch.utils import time_util as ptu

NOW0 = 1_700_000_000_000


@pytest.fixture()
def frozen_time():
    """The port's clock pinned to the reference tests' epoch."""
    ptu.freeze_time(NOW0)
    yield ptu
    ptu.unfreeze_time()


@pytest.fixture()
def engine(frozen_time):
    """A fresh port default engine on the CPU with a clean context (the
    port's twin of tests/conftest.py's ``engine``)."""
    from sentinel_tpu_torch.core.context import bump_generation, replace_context

    replace_context(None)
    bump_generation()
    eng = st.reset(capacity=512, device="cpu")
    yield eng
    replace_context(None)
    eng.close()


# -- decorator --------------------------------------------------------------

class TestDecorator:
    def test_blocks_after_quota_and_routes_to_block_handler(self, engine):
        calls = []

        def on_block(x, ex=None):
            calls.append(x)
            return "blocked"

        @sentinel_resource("deco", block_handler=on_block)
        def work(x):
            return x * 2

        st.load_flow_rules([st.FlowRule(resource="deco", count=2)])
        assert work(1) == 2
        assert work(2) == 4
        assert work(3) == "blocked"
        assert calls == [3]

    def test_fallback_on_business_exception(self, engine):
        @sentinel_resource("fb", fallback=lambda x, ex=None: f"fb:{x}")
        def work(x):
            raise ValueError("boom")

        assert work(7) == "fb:7"
        # The exception was traced into the stats.
        snap = engine.node_snapshot()["fb"]
        assert snap["exceptionQps"] == 1

    def test_ignored_exceptions_propagate_untraced(self, engine):
        @sentinel_resource("ig", exceptions_to_ignore=(KeyError,),
                           fallback=lambda ex=None: "fb")
        def work():
            raise KeyError("x")

        with pytest.raises(KeyError):
            work()
        assert engine.node_snapshot()["ig"]["exceptionQps"] == 0

    def test_default_resource_name(self, engine):
        @sentinel_resource()
        def named():
            return 1

        assert named() == 1
        assert "named" in named.__sentinel_resource__

    def test_no_handler_raises_block(self, engine):
        @sentinel_resource("raw")
        def work():
            return 1

        st.load_flow_rules([st.FlowRule(resource="raw", count=0)])
        with pytest.raises(FlowException):
            work()


# -- WSGI -------------------------------------------------------------------

def _wsgi_get(app, path, environ_extra=None):
    environ = {"PATH_INFO": path, "REQUEST_METHOD": "GET",
               "wsgi.input": io.BytesIO()}
    environ.update(environ_extra or {})
    status_headers = {}

    def start_response(status, headers):
        status_headers["status"] = status

    body = b"".join(app(environ, start_response))
    return status_headers["status"], body


class TestWSGI:
    def test_block_returns_429(self, engine):
        app = SentinelWSGIMiddleware(
            lambda env, sr: (sr("200 OK", []), [b"ok"])[1])
        st.load_flow_rules([st.FlowRule(resource="/api", count=2)])
        results = [_wsgi_get(app, "/api")[0] for _ in range(4)]
        assert results.count("200 OK") == 2
        assert results.count("429 Too Many Requests") == 2

    def test_url_cleaner_groups_resources(self, engine):
        app = SentinelWSGIMiddleware(
            lambda env, sr: (sr("200 OK", []), [b"ok"])[1],
            url_cleaner=lambda p: "/users/{id}" if p.startswith("/users/") else p)
        st.load_flow_rules([st.FlowRule(resource="/users/{id}", count=1)])
        assert _wsgi_get(app, "/users/1")[0] == "200 OK"
        assert _wsgi_get(app, "/users/2")[0] == "429 Too Many Requests"

    def test_origin_parser_feeds_authority(self, engine):
        app = SentinelWSGIMiddleware(
            lambda env, sr: (sr("200 OK", []), [b"ok"])[1],
            origin_parser=lambda env: env.get("HTTP_X_ORIGIN", ""))
        st.load_authority_rules([st.AuthorityRule("/a", "good", 0)])  # whitelist
        ok = _wsgi_get(app, "/a", {"HTTP_X_ORIGIN": "good"})
        bad = _wsgi_get(app, "/a", {"HTTP_X_ORIGIN": "evil"})
        assert ok[0] == "200 OK"
        assert bad[0] == "429 Too Many Requests"

    def test_custom_block_handler(self, engine):
        def handler(environ, start_response, ex):
            start_response("503 Service Unavailable", [])
            return [b"custom"]

        app = SentinelWSGIMiddleware(
            lambda env, sr: (sr("200 OK", []), [b"ok"])[1],
            block_handler=handler)
        st.load_flow_rules([st.FlowRule(resource="/x", count=0)])
        status, body = _wsgi_get(app, "/x")
        assert status == "503 Service Unavailable" and body == b"custom"

    def test_app_exception_traced(self, engine):
        def bad_app(env, sr):
            raise RuntimeError("boom")

        app = SentinelWSGIMiddleware(bad_app)
        with pytest.raises(RuntimeError):
            _wsgi_get(app, "/err")
        assert engine.node_snapshot()["/err"]["exceptionQps"] == 1


# -- ASGI -------------------------------------------------------------------

async def _asgi_get(app, path):
    messages = []

    async def receive():
        return {"type": "http.request"}

    async def send(msg):
        messages.append(msg)

    await app({"type": "http", "path": path}, receive, send)
    return messages


class TestASGI:
    def test_block_returns_429(self, engine):
        async def ok_app(scope, receive, send):
            await send({"type": "http.response.start", "status": 200,
                        "headers": []})
            await send({"type": "http.response.body", "body": b"ok"})

        app = SentinelASGIMiddleware(ok_app)
        st.load_flow_rules([st.FlowRule(resource="/ws", count=1)])

        async def run():
            first = await _asgi_get(app, "/ws")
            second = await _asgi_get(app, "/ws")
            return first, second

        first, second = asyncio.run(run())
        assert first[0]["status"] == 200
        assert second[0]["status"] == 429


# -- gateway ----------------------------------------------------------------

class TestGateway:
    def test_route_rule_without_param_item(self, engine):
        rm = GatewayRuleManager(engine)
        rm.load_rules([GatewayFlowRule(resource="route-a", count=2)])
        req = GatewayRequest(path="/any", route="route-a")
        passed = blocked = 0
        for _ in range(4):
            try:
                entries = gateway_entry(req, rule_manager=rm,
                                        api_manager=GatewayApiDefinitionManager())
                passed += 1
                for e in reversed(entries):
                    e.exit()
            except BlockException:
                blocked += 1
        assert passed == 2 and blocked == 2

    def test_param_item_per_client_ip(self, engine):
        rm = GatewayRuleManager(engine)
        rm.load_rules([GatewayFlowRule(
            resource="route-b", count=1,
            param_item=GatewayParamFlowItem(
                parse_strategy=G.PARAM_PARSE_STRATEGY_CLIENT_IP))])
        am = GatewayApiDefinitionManager()

        def hit(ip):
            try:
                entries = gateway_entry(
                    GatewayRequest(route="route-b", client_ip=ip),
                    rule_manager=rm, api_manager=am)
                for e in reversed(entries):
                    e.exit()
                return True
            except BlockException:
                return False

        assert hit("1.1.1.1") and not hit("1.1.1.1")  # per-IP quota 1
        assert hit("2.2.2.2")  # other IP unaffected

    def test_pattern_mismatch_passes_unlimited(self, engine):
        rm = GatewayRuleManager(engine)
        rm.load_rules([GatewayFlowRule(
            resource="route-c", count=1,
            param_item=GatewayParamFlowItem(
                parse_strategy=G.PARAM_PARSE_STRATEGY_URL_PARAM,
                field_name="user", pattern="vip-.*",
                match_strategy=G.PARAM_MATCH_STRATEGY_REGEX))])
        am = GatewayApiDefinitionManager()

        def hit(user):
            try:
                entries = gateway_entry(
                    GatewayRequest(route="route-c", params={"user": user}),
                    rule_manager=rm, api_manager=am)
                for e in reversed(entries):
                    e.exit()
                return True
            except BlockException:
                return False

        assert hit("vip-1") and not hit("vip-1")  # matched: limited
        # Non-matching values ($NM) pass without limit.
        assert all(hit("pleb") for _ in range(5))

    def test_api_definition_matching(self, engine):
        am = GatewayApiDefinitionManager()
        am.load_api_definitions([ApiDefinition("user-api", [
            ApiPredicateItem("/users/", G.PARAM_MATCH_STRATEGY_PREFIX)])])
        rm = GatewayRuleManager(engine)
        rm.load_rules([GatewayFlowRule(
            resource="user-api", count=1,
            resource_mode=G.RESOURCE_MODE_CUSTOM_API_NAME)])
        req = GatewayRequest(path="/users/42")
        entries = gateway_entry(req, rule_manager=rm, api_manager=am)
        assert len(entries) == 1
        for e in entries:
            e.exit()
        with pytest.raises(BlockException):
            gateway_entry(req, rule_manager=rm, api_manager=am)
        # Unrelated paths map to no API -> no entries, pass.
        assert gateway_entry(GatewayRequest(path="/other"),
                             rule_manager=rm, api_manager=am) == []


class TestReviewRegressions:
    def test_async_decorator_instruments_the_await(self, engine):
        @sentinel_resource("adeco", fallback=lambda ex=None: "fb")
        async def work():
            raise ValueError("boom")

        assert asyncio.run(work()) == "fb"
        assert engine.node_snapshot()["adeco"]["exceptionQps"] == 1

    def test_async_decorator_blocks(self, engine):
        @sentinel_resource("ablock", block_handler=lambda ex=None: "blocked")
        async def work():
            return "ok"

        st.load_flow_rules([st.FlowRule(resource="ablock", count=1)])
        assert asyncio.run(work()) == "ok"
        assert asyncio.run(work()) == "blocked"

    def test_nested_block_routes_to_block_handler(self, engine):
        @sentinel_resource("outer", block_handler=lambda ex=None: "bh",
                           fallback=lambda ex=None: "fb")
        def outer():
            with st.entry("inner"):
                return "ran"

        st.load_flow_rules([st.FlowRule(resource="inner", count=0)])
        assert outer() == "bh"  # not the business fallback

    def test_asgi_interleaved_tasks_have_isolated_contexts(self, engine):
        st.load_authority_rules([st.AuthorityRule("/iso", "good", 0)])

        async def slow_app(scope, receive, send):
            await asyncio.sleep(0.05)
            await send({"type": "http.response.start", "status": 200,
                        "headers": []})
            await send({"type": "http.response.body", "body": b"ok"})

        app = SentinelASGIMiddleware(
            slow_app, origin_parser=lambda scope: scope.get("origin", ""))

        async def one(origin):
            messages = []

            async def receive():
                return {"type": "http.request"}

            async def send(msg):
                messages.append(msg)

            await app({"type": "http", "path": "/iso", "origin": origin},
                      receive, send)
            return messages[0]["status"]

        async def run():
            return await asyncio.gather(one("good"), one("evil"))

        good_status, evil_status = asyncio.run(run())
        assert good_status == 200
        assert evil_status == 429  # evil must NOT inherit good's context

    def test_gateway_and_user_param_rules_coexist(self, engine):
        st.load_param_flow_rules([st.ParamFlowRule("hot", param_idx=0, count=1)])
        rm = GatewayRuleManager(engine)
        rm.load_rules([GatewayFlowRule(resource="route-z", count=1)])
        # User hot-param rule still enforced after the gateway load.
        assert st.entry_ok("hot", args=("k",)) is not None
        assert st.entry_ok("hot", args=("k",)) is None
        # And the gateway rule is enforced too.
        req = GatewayRequest(route="route-z")
        entries = gateway_entry(req, rule_manager=rm,
                                api_manager=GatewayApiDefinitionManager())
        for e in entries:
            e.exit()
        with pytest.raises(BlockException):
            gateway_entry(req, rule_manager=rm,
                          api_manager=GatewayApiDefinitionManager())

    def test_wsgi_streaming_body_keeps_entry_live(self, engine, frozen_time):
        def streaming_app(env, sr):
            sr("200 OK", [])

            def gen():
                frozen_time.advance_time(500)  # body generation takes 500ms
                yield b"chunk"

            return gen()

        app = SentinelWSGIMiddleware(streaming_app)
        environ = {"PATH_INFO": "/stream", "REQUEST_METHOD": "GET"}
        body = app(environ, lambda s, h: None)
        assert b"".join(body) == b"chunk"
        snap = engine.node_snapshot()["/stream"]
        assert snap["avgRt"] >= 500  # RT covers body generation

    def test_block_routes_to_fallback_when_no_block_handler(self, engine):
        @sentinel_resource("fbonly", fallback=lambda ex=None: "fb")
        def work():
            return "ok"

        st.load_flow_rules([st.FlowRule(resource="fbonly", count=0)])
        assert work() == "fb"

    def test_async_handlers_are_awaited(self, engine):
        async def afb(ex=None):
            await asyncio.sleep(0)
            return "async-fb"

        @sentinel_resource("ah", fallback=afb)
        async def work():
            raise ValueError("x")

        assert asyncio.run(work()) == "async-fb"


class TestGrpcAdapters:
    """gRPC server + client interceptors over a REAL in-process channel
    (reference: sentinel-grpc-adapter's interceptor pair)."""

    @pytest.fixture()
    def echo_server(self, engine):
        import concurrent.futures

        import grpc

        from sentinel_tpu_torch.adapters.grpc_adapter import (
            SentinelGrpcServerInterceptor,
        )

        def echo(request, context):
            return request  # bytes in, bytes out

        handler = grpc.method_handlers_generic_handler(
            "test.Echo", {"Call": grpc.unary_unary_rpc_method_handler(
                echo,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b)})
        server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=4),
            interceptors=[SentinelGrpcServerInterceptor()])
        server.add_generic_rpc_handlers((handler,))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        yield f"127.0.0.1:{port}"
        server.stop(grace=None)

    def test_server_interceptor_blocks_over_quota(self, engine, echo_server):
        import grpc

        st.load_flow_rules([st.FlowRule(resource="/test.Echo/Call", count=2)])
        with grpc.insecure_channel(echo_server) as channel:
            call = channel.unary_unary("/test.Echo/Call",
                                       request_serializer=lambda b: b,
                                       response_deserializer=lambda b: b)
            assert call(b"hi") == b"hi"
            assert call(b"hi") == b"hi"
            with pytest.raises(grpc.RpcError) as e:
                call(b"hi")
            assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        snap = engine.node_snapshot()["/test.Echo/Call"]
        assert snap["passQps"] == 2 and snap["blockQps"] == 1

    def test_client_interceptor_guards_outbound(self, engine):
        import concurrent.futures

        import grpc

        from sentinel_tpu_torch.adapters.grpc_adapter import (
            SentinelGrpcClientInterceptor,
        )

        # Plain server (no server-side interceptor — in-process it would
        # share this engine's quota and block first).
        handler = grpc.method_handlers_generic_handler(
            "test.Echo", {"Call": grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: req,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b)})
        server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=2))
        server.add_generic_rpc_handlers((handler,))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        try:
            st.load_flow_rules([st.FlowRule(resource="/test.Echo/Call",
                                            count=1)])
            with grpc.insecure_channel(f"127.0.0.1:{port}") as raw:
                channel = grpc.intercept_channel(
                    raw, SentinelGrpcClientInterceptor())
                call = channel.unary_unary("/test.Echo/Call",
                                           request_serializer=lambda b: b,
                                           response_deserializer=lambda b: b)
                assert call(b"x") == b"x"
                with pytest.raises(BlockException):
                    call(b"x")  # client-side OUT entry over quota
        finally:
            server.stop(grace=None)


class TestHttpClientAdapter:
    def _local_server(self, status=200):
        import threading
        from http.server import BaseHTTPRequestHandler, HTTPServer

        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(status)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

            def log_message(self, *a):
                pass

        server = HTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server

    def test_blocks_and_names_resources(self, engine):
        from sentinel_tpu_torch.adapters.http_client import SentinelHttpClient

        server = self._local_server()
        port = server.server_address[1]
        try:
            client = SentinelHttpClient()
            resource = f"GET:127.0.0.1:{port}/api/users"
            st.load_flow_rules([st.FlowRule(resource=resource, count=1)])
            assert client.get(
                f"http://127.0.0.1:{port}/api/users?id=1").read() == b"ok"
            with pytest.raises(BlockException):
                client.get(f"http://127.0.0.1:{port}/api/users?id=2")
            snap = engine.node_snapshot()[resource]
            assert snap["passQps"] == 1 and snap["blockQps"] == 1
        finally:
            server.shutdown()

    def test_5xx_feeds_exception_metrics(self, engine):
        import urllib.error

        from sentinel_tpu_torch.adapters.http_client import SentinelHttpClient

        server = self._local_server(status=503)
        port = server.server_address[1]
        try:
            client = SentinelHttpClient()
            with pytest.raises(urllib.error.HTTPError):
                client.get(f"http://127.0.0.1:{port}/down")
            snap = engine.node_snapshot()[f"GET:127.0.0.1:{port}/down"]
            assert snap["exceptionQps"] == 1
        finally:
            server.shutdown()

    def test_guarded_wraps_any_callable(self, engine):
        from sentinel_tpu_torch.adapters.http_client import guarded

        st.load_flow_rules([st.FlowRule(resource="dep", count=1)])
        calls = []
        fn = guarded(lambda x: calls.append(x) or "r", "dep")
        assert fn(1) == "r"
        with pytest.raises(BlockException):
            fn(2)
        assert calls == [1]


class TestGrpcStreaming:
    def test_stream_entry_spans_iteration_and_traces_midstream(self, engine):
        """The entry must stay live across response streaming (concurrency
        visible mid-stream) and a mid-stream failure must feed exception
        metrics."""
        import concurrent.futures
        import threading

        import grpc

        from sentinel_tpu_torch.adapters.grpc_adapter import (
            SentinelGrpcServerInterceptor,
        )

        midstream_threads = []
        release = threading.Event()

        def counter(request, context):
            yield b"1"
            midstream_threads.append(
                engine.node_snapshot()["/test.S/Stream"]["curThreadNum"])
            release.wait(timeout=5)
            if request == b"boom":
                raise RuntimeError("mid-stream failure")
            yield b"2"

        handler = grpc.method_handlers_generic_handler(
            "test.S", {"Stream": grpc.unary_stream_rpc_method_handler(
                counter,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b)})
        server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=4),
            interceptors=[SentinelGrpcServerInterceptor()])
        server.add_generic_rpc_handlers((handler,))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        try:
            with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
                call = channel.unary_stream(
                    "/test.S/Stream",
                    request_serializer=lambda b: b,
                    response_deserializer=lambda b: b)
                release.set()
                assert list(call(b"ok")) == [b"1", b"2"]
                with pytest.raises(grpc.RpcError):
                    list(call(b"boom"))
            # concurrency was visible WHILE the stream was in flight
            assert midstream_threads and midstream_threads[0] >= 1
            snap = engine.node_snapshot()["/test.S/Stream"]
            assert snap["exceptionQps"] == 1  # only the boom stream
        finally:
            server.stop(grace=None)


def test_http_client_4xx_not_counted_as_dependency_exception(engine):
    """A 404 is a caller error: it re-raises but must NOT feed exception
    metrics (a degrade rule would break a healthy dependency)."""
    import threading
    import urllib.error
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from sentinel_tpu_torch.adapters.http_client import SentinelHttpClient

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    server = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        client = SentinelHttpClient()
        with pytest.raises(urllib.error.HTTPError):
            client.get(f"http://127.0.0.1:{port}/missing")
        snap = engine.node_snapshot()[f"GET:127.0.0.1:{port}/missing"]
        assert snap["exceptionQps"] == 0
        assert snap["passQps"] == 1
    finally:
        server.shutdown()


class TestAsyncioAdapter:
    """asyncio adapter (reactor-adapter analog): entry on await, exit on
    completion, cancellation-safe, concurrency visible across tasks."""

    def test_entry_scope_blocks_over_quota(self, engine):
        from sentinel_tpu_torch.adapters import aio

        st.load_flow_rules([st.FlowRule(resource="aio", count=2)])

        async def run():
            outcomes = []
            for _ in range(4):
                try:
                    async with aio.entry_scope("aio"):
                        outcomes.append("ok")
                except BlockException:
                    outcomes.append("blocked")
            return outcomes

        assert asyncio.run(run()) == ["ok", "ok", "blocked", "blocked"]

    def test_coroutine_decorator_routes_block_and_fallback(self, engine):
        from sentinel_tpu_torch.adapters import aio

        @aio.sentinel_coroutine("aiod",
                                block_handler=lambda x, ex: f"blocked:{x}",
                                fallback=lambda x, ex: f"fb:{x}")
        async def work(x):
            if x == "boom":
                raise ValueError("x")
            return f"done:{x}"

        st.load_flow_rules([st.FlowRule(resource="aiod", count=2)])

        async def run():
            return [await work("a"), await work("boom"), await work("c")]

        assert asyncio.run(run()) == ["done:a", "fb:boom", "blocked:c"]
        assert engine.node_snapshot()["aiod"]["exceptionQps"] == 1

    def test_concurrent_tasks_share_thread_quota(self, engine):
        """THREAD-grade concurrency across asyncio tasks: gauge counts
        in-flight awaits, releasing on exit."""
        from sentinel_tpu_torch.adapters import aio
        from sentinel_tpu_torch.core import constants as CC

        st.load_flow_rules([st.FlowRule(resource="aioc", count=2,
                                        grade=CC.FLOW_GRADE_THREAD)])

        async def held(gate):
            async with aio.entry_scope("aioc"):
                await gate.wait()
                return "ok"

        async def run():
            gate = asyncio.Event()
            t1 = asyncio.create_task(held(gate))
            t2 = asyncio.create_task(held(gate))
            await asyncio.sleep(0.4)  # both entries in flight
            try:
                async with aio.entry_scope("aioc"):
                    third = "ok"
            except BlockException:
                third = "blocked"
            gate.set()
            assert await asyncio.gather(t1, t2) == ["ok", "ok"]
            # concurrency released: a new entry passes
            async with aio.entry_scope("aioc"):
                fourth = "ok"
            return third, fourth

        third, fourth = asyncio.run(run())
        assert third == "blocked" and fourth == "ok"

    def test_cancellation_exits_entry(self, engine):
        """A cancelled task must release its concurrency slot — whether
        cancellation lands mid-body or mid-admission (the entry may commit
        in the worker thread AFTER the cancel; the undo callback exits
        it)."""
        import time as _time

        from sentinel_tpu_torch.adapters import aio
        from sentinel_tpu_torch.core import constants as CC

        st.load_flow_rules([st.FlowRule(resource="aiox", count=1,
                                        grade=CC.FLOW_GRADE_THREAD)])
        # warm the step compile so admission timing is not dominated by it
        h = st.entry_ok("warmup-aiox")
        if h:
            h.exit()
        row = engine.registry.cluster_row("aiox")

        @aio.sentinel_coroutine("aiox")
        async def hang():
            await asyncio.sleep(30)

        async def run():
            t = asyncio.create_task(hang())
            await asyncio.sleep(0.5)
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
            # the slot must come free (undo may land a beat later when
            # cancellation hit mid-admission)
            deadline = _time.time() + 10
            while _time.time() < deadline:
                if int(engine.row_stats()[1][row]) == 0:
                    break
                await asyncio.sleep(0.05)
            assert int(engine.row_stats()[1][row]) == 0
            async with aio.entry_scope("aiox"):
                return "ok"

        assert asyncio.run(run()) == "ok"


class TestStreams:
    """Reactor-transformer analog: one entry per stream subscription."""

    def test_stream_entry_spans_whole_stream(self, engine):
        from sentinel_tpu_torch.adapters.streams import guard_aiter

        async def gen():
            for i in range(3):
                yield i

        async def run():
            return [x async for x in guard_aiter("streamRes", gen())]

        assert asyncio.run(run()) == [0, 1, 2]
        snap = engine.node_snapshot()["streamRes"]
        assert snap["passQps"] == 1  # one entry for the stream, not 3
        assert snap["curThreadNum"] == 0  # exited on completion

    def test_stream_block_raises_at_first_pull(self, engine):
        from sentinel_tpu_torch.adapters.streams import guard_aiter

        st.load_flow_rules([st.FlowRule(resource="deniedStream", count=0)])

        async def gen():
            yield 1

        async def run():
            it = guard_aiter("deniedStream", gen())
            try:
                async for _ in it:
                    pass
            except st.FlowException:
                return "blocked"
            return "ran"

        assert asyncio.run(run()) == "blocked"
        assert engine.node_snapshot()["deniedStream"]["blockQps"] == 1

    def test_stream_error_traced_and_exited(self, engine):
        from sentinel_tpu_torch.adapters.streams import guard_aiter

        async def gen():
            yield 1
            raise RuntimeError("mid-stream failure")

        async def run():
            got = []
            try:
                async for x in guard_aiter("errStream", gen()):
                    got.append(x)
            except RuntimeError:
                return got
            return None

        assert asyncio.run(run()) == [1]
        snap = engine.node_snapshot()["errStream"]
        assert snap["exceptionQps"] == 1
        assert snap["curThreadNum"] == 0

    def test_stream_abandonment_exits_without_error(self, engine):
        """Consumer breaks out early (reactor cancel): the entry exits,
        nothing is traced."""
        from sentinel_tpu_torch.adapters.streams import guard_aiter

        async def gen():
            for i in range(100):
                yield i

        async def run():
            it = guard_aiter("cancelStream", gen())
            async for x in it:
                break  # abandon after one element
            await it.aclose()

        asyncio.run(run())
        snap = engine.node_snapshot()["cancelStream"]
        assert snap["curThreadNum"] == 0
        assert snap["exceptionQps"] == 0

    def test_sentinel_stream_decorator(self, engine):
        from sentinel_tpu_torch.adapters.streams import sentinel_stream

        @sentinel_stream("decoStream")
        async def numbers(n):
            for i in range(n):
                yield i

        async def run():
            return [x async for x in numbers(2)]

        assert asyncio.run(run()) == [0, 1]
        assert engine.node_snapshot()["decoStream"]["passQps"] == 1
        assert numbers.__sentinel_resource__ == "decoStream"


class TestFrameworkSugar:
    """Flask extension + Django-style middleware (duck-typed, no frameworks
    installed in this image)."""

    def test_flask_extension_wraps_wsgi_app(self, engine):
        from sentinel_tpu_torch.adapters.flask_ext import SentinelFlask

        class FakeFlask:
            def wsgi_app(self, environ, start_response):
                start_response("200 OK", [])
                return [b"hello"]

        app = FakeFlask()
        SentinelFlask(app=app, url_cleaner=lambda p: "/flask")
        st.load_flow_rules([st.FlowRule(resource="/flask", count=1)])
        statuses = []
        for _ in range(2):
            body = app.wsgi_app({"PATH_INFO": "/x"},
                                lambda s, h: statuses.append(s))
            list(body)
        assert statuses[0].startswith("200")
        assert statuses[1].startswith("429")

    def test_django_middleware_blocks_and_traces(self, engine):
        from sentinel_tpu_torch.adapters.django_mw import SentinelMiddleware

        class Req:
            path = "/dj"

        st.load_flow_rules([st.FlowRule(resource="/dj", count=1)])
        mw = SentinelMiddleware(lambda request: "downstream-ok")
        assert mw(Req()) == "downstream-ok"
        blocked = mw(Req())
        assert blocked.status_code == 429

        # downstream exception is traced and re-raised
        class Boom(Exception):
            pass

        def bad(request):
            raise Boom()

        st.load_flow_rules([st.FlowRule(resource="/dj", count=100)])
        with pytest.raises(Boom):
            SentinelMiddleware(bad)(Req())
        assert engine.node_snapshot()["/dj"]["exceptionQps"] == 1

    def test_django_middleware_custom_block_handler(self, engine):
        from sentinel_tpu_torch.adapters.django_mw import SentinelMiddleware

        class Handled(SentinelMiddleware):
            block_handler = staticmethod(lambda req, ex: "custom-blocked")

        class Req:
            path = "/djh"

        st.load_flow_rules([st.FlowRule(resource="/djh", count=0)])
        assert Handled(lambda r: "nope")(Req()) == "custom-blocked"

    def test_flask_init_app_idempotent(self, engine):
        from sentinel_tpu_torch.adapters.flask_ext import SentinelFlask
        from sentinel_tpu_torch.adapters.wsgi import SentinelWSGIMiddleware

        class FakeFlask:
            def wsgi_app(self, environ, start_response):
                start_response("200 OK", [])
                return [b"ok"]

        app = FakeFlask()
        ext = SentinelFlask(app=app, url_cleaner=lambda p: "/idem")
        ext.init_app(app)  # app-factory pattern double-registration
        assert isinstance(app.wsgi_app, SentinelWSGIMiddleware)
        assert not isinstance(app.wsgi_app.app, SentinelWSGIMiddleware)
        st.load_flow_rules([st.FlowRule(resource="/idem", count=10)])
        list(app.wsgi_app({"PATH_INFO": "/x"}, lambda s, h: None))
        assert engine.node_snapshot()["/idem"]["passQps"] == 1  # not 2

    def test_django_streaming_response_keeps_entry_live(self, engine):
        from sentinel_tpu_torch.adapters.django_mw import SentinelMiddleware

        class StreamingResp:
            def __init__(self, gen):
                self.streaming_content = gen

        class Boom(Exception):
            pass

        def body():
            yield b"a"
            raise Boom()

        class Req:
            path = "/stream"

        st.load_flow_rules([st.FlowRule(resource="/stream", count=100)])
        mw = SentinelMiddleware(lambda request: StreamingResp(body()))
        resp = mw(Req())
        # entry still live until the body is consumed
        assert engine.node_snapshot()["/stream"]["curThreadNum"] == 1
        with pytest.raises(Boom):
            list(resp.streaming_content)
        snap = engine.node_snapshot()["/stream"]
        assert snap["curThreadNum"] == 0
        assert snap["exceptionQps"] == 1  # mid-stream error traced


# -- the port's own cases beyond the reference's ------------------------------


def test_gateway_caps_rules_at_max_params_and_warns(engine, monkeypatch):
    """Past ``MAX_PARAMS`` (4) gateway rules on one resource the rest are
    dropped with one warning, and ``get_rules`` reports only what is
    enforced."""
    from sentinel_tpu_torch.core.batch import MAX_PARAMS
    from sentinel_tpu_torch.log import record_log as RL

    warned = []
    monkeypatch.setattr(RL.record_log, "warn",
                        lambda msg, *a: warned.append(msg % a))
    rm = GatewayRuleManager(engine)
    rules = [GatewayFlowRule(resource="capped", count=10 + i)
             for i in range(MAX_PARAMS + 2)]
    rm.load_rules(rules)
    assert [r.count for r in rm.get_rules()] == [10, 11, 12, 13]
    assert [r.param_idx for r in engine.param_rules.get_rules()] == \
        list(range(MAX_PARAMS))
    assert warned == ["gateway: 2 rules beyond 4 per resource dropped"]
    # the parser emits one argument per enforced rule
    assert rm.parse_parameters("capped", GatewayRequest()) == \
        (G.GATEWAY_DEFAULT_PARAM,) * MAX_PARAMS


def test_gateway_pattern_miss_rewrites_to_not_match_item(engine):
    rm = GatewayRuleManager(engine)
    rm.load_rules([GatewayFlowRule(
        resource="nm", count=1,
        param_item=GatewayParamFlowItem(
            parse_strategy=G.PARAM_PARSE_STRATEGY_HEADER, field_name="X-T",
            pattern="gold", match_strategy=G.PARAM_MATCH_STRATEGY_PREFIX))])
    (rule,) = engine.param_rules.get_rules()
    assert [(i.object, i.count) for i in rule.items] == \
        [(G.GATEWAY_NOT_MATCH_PARAM, G.NOT_MATCH_PASS_COUNT)]
    parse = rm.parse_parameters
    assert parse("nm", GatewayRequest(headers={"X-T": "gold-1"})) == \
        ("gold-1",)
    assert parse("nm", GatewayRequest(headers={"X-T": "tin"})) == \
        (G.GATEWAY_NOT_MATCH_PARAM,)


def test_gateway_entry_exits_taken_entries_in_reverse_on_block(engine):
    """A request mapping to a route and an API group: when the group
    blocks, the route's entry (already taken) is exited, so its thread
    gauge drains."""
    am = GatewayApiDefinitionManager()
    am.load_api_definitions([ApiDefinition("grp", [
        ApiPredicateItem("/g/", G.PARAM_MATCH_STRATEGY_PREFIX)])])
    rm = GatewayRuleManager(engine)
    rm.load_rules([GatewayFlowRule(resource="grp", count=0)])
    with pytest.raises(BlockException):
        gateway_entry(GatewayRequest(path="/g/1", route="rt"),
                      rule_manager=rm, api_manager=am)
    snap = engine.node_snapshot()
    assert snap["rt"]["passQps"] == 1 and snap["rt"]["curThreadNum"] == 0
    assert snap["grp"]["blockQps"] == 1


def test_managers_for_scopes_per_engine_and_holds_it_weakly(engine):
    import gc
    import weakref

    from sentinel_tpu_torch.core.engine import SentinelEngine

    rm, am = G.managers_for(engine)
    assert rm is G.get_gateway_rule_manager() and am is G.get_api_manager()
    other = SentinelEngine(capacity=64, device="cpu")
    pair = G.managers_for(other)
    assert pair is G.managers_for(other)  # memoized
    assert pair[0] is not rm and pair[0].engine is other
    pair[0].load_rules([GatewayFlowRule(resource="other-route", count=1)])
    assert other.param_rules.get_rules()[0].resource == "other-route"
    assert engine.param_rules.get_rules() == []
    ref = weakref.ref(other)
    other.close()
    del other, pair
    gc.collect()
    assert ref() is None  # the memo does not pin the engine


def test_default_engine_raises_without_a_card(monkeypatch):
    """With no card and no device, an adapter's first entry raises the
    device error (the default engine is built on ``cuda``)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(st, "_default_engine", None)

    @sentinel_resource("nocard")
    def work():
        return 1

    with pytest.raises(RuntimeError, match="CUDA"):
        work()
    assert st._default_engine is None


# -- parity: the same scripts through both packages ---------------------------


ROUTES = ("route-a", "route-b")


@pytest.fixture(scope="module")
def twins():
    """Both packages' default engines (capacity 512, the CPU), built once;
    both clocks frozen at ``NOW0``. The lease and unruled fast paths are
    off (``csp.sentinel.lease.enabled=false``): every entry and exit is
    one width-1 device step, decided and committed in call order, so the
    JAX engine compiles two steps for the module and no committer flush
    races the script. The port-only cases above run with the fast paths
    on."""
    from tests.test_torch_support import ad_pkgs

    pkgs = ad_pkgs()
    engines = {}
    lease_key = "csp.sentinel.lease.enabled"
    saved = [P.config.config.get(lease_key) for P in pkgs]
    for P in pkgs:
        P.config.config.set(lease_key, "false")
        P.tu.freeze_time(NOW0)
        P.ctx.replace_context(None)
        P.ctx.bump_generation()
        engines[P.name] = P.st.reset(capacity=512, **P.kw)
    yield pkgs, engines
    for P, value in zip(pkgs, saved):
        P.ctx.replace_context(None)
        P.tu.unfreeze_time()
        if value is None:
            P.config.config._config.pop(lease_key, None)
        else:
            P.config.config.set(lease_key, value)
    # The JAX default engine is left fresh, as tests/conftest.py leaves
    # it; the port's is closed.
    pkgs[0].st.reset(capacity=512)
    engines["port"].close()


@pytest.fixture()
def case(twins):
    """A case on the shared engines: no rules, no context, both clocks a
    whole second at least 100 s past the last case (the windows empty)."""
    pkgs, engines = twins
    for P in pkgs:
        eng = engines[P.name]
        P.rules(eng)
        P.gateway_filler(eng)
        P.ctx.replace_context(None)
        now = P.tu.current_time_millis()
        P.tu.advance_time((now // 1000 + 100) * 1000 - now)
    yield pkgs, engines
    for P in pkgs:
        P.rules(engines[P.name])
        P.gateway_filler(engines[P.name])
        P.ctx.replace_context(None)


def _np(x):
    import numpy as np

    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def record_slots(eng, out):
    """Append (reason, rule_slot) of every single-entry device step of
    ``eng`` to ``out``; the committer's flushes are not recorded."""
    import threading

    run, submit = eng._run_entry_batch_locked, eng._submit_entry
    flag = threading.local()

    def run_rec(batch, *a, **k):
        dec = run(batch, *a, **k)
        if getattr(flag, "on", False):
            out.append((int(_np(dec.reason)[0]), int(_np(dec.rule_slot)[0])))
        return dec

    def submit_rec(*a, **k):
        flag.on = True
        try:
            return submit(*a, **k)
        finally:
            flag.on = False

    eng._run_entry_batch_locked = run_rec
    eng._submit_entry = submit_rec

    def restore():
        del eng._run_entry_batch_locked, eng._submit_entry

    return restore


def verdict(fn):
    """``"pass"`` or the blocking exception's class name."""
    try:
        out = fn()
    except BaseException as ex:  # noqa: BLE001 - the verdict is the class
        return type(ex).__name__
    return "pass" if out is None else out


def gateway_rules(P):
    G = P.gw
    item = G.GatewayParamFlowItem
    a, b = ROUTES
    return [
        G.GatewayFlowRule(resource=a, count=6),
        G.GatewayFlowRule(resource=a, count=2, param_item=item(
            parse_strategy=G.PARAM_PARSE_STRATEGY_CLIENT_IP)),
        G.GatewayFlowRule(resource=a, count=1, param_item=item(
            parse_strategy=G.PARAM_PARSE_STRATEGY_HEADER, field_name="X-Tier",
            pattern="gold", match_strategy=G.PARAM_MATCH_STRATEGY_EXACT)),
        G.GatewayFlowRule(resource=a, count=3, param_item=item(
            parse_strategy=G.PARAM_PARSE_STRATEGY_URL_PARAM,
            field_name="user")),
        # past MAX_PARAMS on route-a: dropped
        G.GatewayFlowRule(resource=a, count=1),
        G.GatewayFlowRule(resource=b, count=5, interval_sec=2),
        G.GatewayFlowRule(resource=b, count=1, param_item=item(
            parse_strategy=G.PARAM_PARSE_STRATEGY_HEADER, field_name="X-Tier",
            pattern="gold-.*", match_strategy=G.PARAM_MATCH_STRATEGY_REGEX)),
        G.GatewayFlowRule(resource=b, count=2, param_item=item(
            parse_strategy=G.PARAM_PARSE_STRATEGY_HOST, pattern="api.",
            match_strategy=G.PARAM_MATCH_STRATEGY_PREFIX)),
        G.GatewayFlowRule(resource="api-users", count=3,
                          resource_mode=G.RESOURCE_MODE_CUSTOM_API_NAME),
    ]


def gateway_requests(P, seed, n):
    import random

    rnd = random.Random(seed)
    out = []
    for _ in range(n):
        out.append(P.gw.GatewayRequest(
            path=rnd.choice(("/users/7", "/items", "/other", "/users/")),
            route=rnd.choice(ROUTES + (None,)),
            client_ip=f"10.0.0.{rnd.randrange(3)}",
            host=rnd.choice(("api.example", "www.example")),
            headers={"X-Tier": rnd.choice(("gold", "gold-2", "tin"))},
            params={"user": rnd.choice(("u1", "u2"))},
            cookies={"sid": rnd.choice(("s1", "s2"))}))
    return out


def run_gateway(P, eng, seconds=3, per_second=30):
    G = P.gw
    rm = G.GatewayRuleManager(eng)
    am = G.GatewayApiDefinitionManager()
    am.load_api_definitions(G.api_definitions_from_json(json_apis()))
    rm.load_rules(gateway_rules(P))
    slots, verdicts = [], []
    restore = record_slots(eng, slots)
    try:
        for s in range(seconds):
            for req in gateway_requests(P, 100 + s, per_second):
                def go(req=req):
                    for e in reversed(G.gateway_entry(
                            req, rule_manager=rm, api_manager=am)):
                        e.exit()
                verdicts.append(verdict(go))
            P.tu.advance_time(1000)
    finally:
        restore()
    snap = eng.node_snapshot()
    return {
        "verdicts": verdicts, "slots": slots,
        "rules": G.gateway_rules_to_json(rm.get_rules()),
        "apis": G.api_definitions_to_json(am.get_api_definitions()),
        "param_rules": [(r.resource, r.param_idx, r.count, r.duration_in_sec,
                         [(i.object, i.count) for i in r.items])
                        for r in eng.param_rules.get_rules()
                        if not r.resource.startswith("_fill")],
        "parsed": [rm.parse_parameters(r, q) for q in
                   gateway_requests(P, 7, 8) for r in ROUTES + ("api-users",)],
        "snapshot": {k: snap.get(k) for k in ROUTES + ("api-users",)},
    }


def json_apis():
    import json

    return json.dumps([
        {"apiName": "api-users", "predicateItems": [
            {"pattern": "/users/", "matchStrategy": 1}]},
        {"apiName": "api-items", "predicateItems": [
            {"pattern": "/items", "matchStrategy": 0},
            {"pattern": "/item.*", "matchStrategy": 2}]}])


class TestParity:
    def test_gateway_verdicts_rule_slots_and_rules(self, case):
        pkgs, engines = case
        jax_out, port_out = (run_gateway(P, engines[P.name]) for P in pkgs)
        assert port_out["verdicts"] == jax_out["verdicts"]
        assert "ParamFlowException" in port_out["verdicts"]
        assert port_out["verdicts"].count("pass") > 0
        # the device steps' reasons and rule slots, lane for lane
        assert port_out["slots"] == jax_out["slots"]
        assert any(slot >= 0 for _, slot in port_out["slots"])
        for key in ("rules", "apis", "param_rules", "parsed", "snapshot"):
            assert port_out[key] == jax_out[key], key
        assert len(port_out["param_rules"]) == 8  # one of 9 dropped

    def test_gateway_and_user_param_rules_union(self, case):
        """User rules first, then gateway rules, in both packages: the
        union decides the rule slots; a user reload keeps the gateway
        partition and a gateway reload keeps the user rules."""
        pkgs, engines = case
        outs = []
        for P in pkgs:
            eng = engines[P.name]
            G = P.gw
            rm = G.GatewayRuleManager(eng)
            am = G.GatewayApiDefinitionManager()
            v0 = eng.param_rules.version
            user = [P.param.ParamFlowRule("hot", param_idx=0, count=1),
                    P.param.ParamFlowRule("route-z", param_idx=1, count=5)]
            P.rules(eng, param=user)
            rm.load_rules([G.GatewayFlowRule(resource="route-z", count=2)])
            slots, verdicts = [], []
            restore = record_slots(eng, slots)
            try:
                for _ in range(3):
                    verdicts.append(verdict(
                        lambda: P.st.entry("hot", args=("k",)).exit()))
                    verdicts.append(verdict(lambda: [
                        e.exit() for e in G.gateway_entry(
                            G.GatewayRequest(route="route-z"),
                            rule_manager=rm, api_manager=am)] and None))
                P.rules(eng, param=user[:1])  # user reload
                P.tu.advance_time(1000)
                for _ in range(3):
                    verdicts.append(verdict(lambda: [
                        e.exit() for e in G.gateway_entry(
                            G.GatewayRequest(route="route-z"),
                            rule_manager=rm, api_manager=am)] and None))
            finally:
                restore()
            outs.append({
                "verdicts": verdicts, "slots": slots,
                "versions": eng.param_rules.version - v0,
                "rules": [(r.resource, r.param_idx, r.count)
                          for r in eng.param_rules.get_rules()
                          if not r.resource.startswith("_fill")]})
        jax_out, port_out = outs
        assert port_out == jax_out
        assert port_out["rules"] == [("hot", 0, 1.0), ("route-z", 0, 2.0)]
        # hot's blocks at its row's slot 0; before the reload route-z's
        # row holds the user rule, then the gateway rule, so the gateway
        # block is at slot 1; after it the gateway rule is alone (slot 0).
        blocked = [slot for reason, slot in port_out["slots"] if reason]
        assert blocked == [0, 0, 1, 0]
        assert port_out["verdicts"].count("ParamFlowException") == 4

    def test_web_middlewares_status_codes(self, case):
        """WSGI (with an aggregate resource), ASGI, Django and Flask over
        one script of paths and origins: equal status codes and stats."""
        pkgs, engines = case
        outs = []
        for P in pkgs:
            eng = engines[P.name]
            P.rules(eng, flow=[
                P.flow.FlowRule(resource="/api", count=3),
                P.flow.FlowRule(resource="web-total", count=7),
                P.flow.FlowRule(resource="/dj", count=2)],
                authority=[P.authority.AuthorityRule("/auth", "good", 0)])
            wsgi = P.wsgi.SentinelWSGIMiddleware(
                lambda env, sr: (sr("200 OK", []), [b"ok"])[1],
                origin_parser=lambda env: env.get("HTTP_X_ORIGIN", ""),
                total_resource="web-total")

            async def ok_app(scope, receive, send):
                await send({"type": "http.response.start", "status": 200,
                            "headers": []})
                await send({"type": "http.response.body", "body": b"ok"})

            asgi = P.asgi.SentinelASGIMiddleware(
                ok_app, origin_parser=lambda scope: scope.get("origin", ""))
            codes = []
            for i in range(10):
                path = ("/api", "/auth", "/free")[i % 3]
                status, _ = _wsgi_get(wsgi, path, {
                    "HTTP_X_ORIGIN": "good" if i % 2 else "evil"})
                codes.append(status)

            async def asgi_run():
                out = []
                for i in range(6):
                    path = ("/api", "/auth")[i % 2]
                    msgs = []

                    async def receive():
                        return {"type": "http.request"}

                    async def send(msg):
                        msgs.append(msg)

                    await asgi({"type": "http", "path": path,
                                "origin": "good" if i < 3 else "evil"},
                               receive, send)
                    out.append(msgs[0]["status"])
                return out

            codes.extend(asyncio.run(asgi_run()))

            class Req:
                path = "/dj"

            mw = P.django.SentinelMiddleware(lambda request: "ok")
            for _ in range(3):
                r = mw(Req())
                codes.append(r if isinstance(r, str) else r.status_code)
            class FakeFlask:
                def wsgi_app(self, environ, start_response):
                    start_response("200 OK", [])
                    return [b"hello"]

            app = FakeFlask()
            P.flask.SentinelFlask(app=app, url_cleaner=lambda p: "/api")
            for _ in range(2):
                statuses = []
                list(app.wsgi_app({"PATH_INFO": "/x"},
                                  lambda s, h: statuses.append(s)))
                codes.append(statuses[0])
            snap = eng.node_snapshot()
            outs.append({"codes": codes, "snap": {
                k: snap.get(k) for k in ("/api", "/auth", "/free",
                                         "web-total", "/dj")}})
        jax_out, port_out = outs
        assert port_out == jax_out
        assert "429 Too Many Requests" in port_out["codes"]
        assert 429 in port_out["codes"] and 200 in port_out["codes"]

    def test_async_and_stream_verdicts(self, case):
        pkgs, engines = case
        outs = []
        for P in pkgs:
            eng = engines[P.name]
            P.rules(eng, flow=[
                P.flow.FlowRule(resource="aio", count=2),
                P.flow.FlowRule(resource="aiod", count=2),
                P.flow.FlowRule(resource="stream", count=1)])

            @P.aio.sentinel_coroutine(
                "aiod", block_handler=lambda x, ex: f"blocked:{x}",
                fallback=lambda x, ex: f"fb:{x}")
            async def work(x):
                if x == "boom":
                    raise ValueError("x")
                return f"done:{x}"

            async def gen():
                for i in range(3):
                    yield i

            async def run():
                out = []
                for _ in range(4):
                    try:
                        async with P.aio.entry_scope("aio"):
                            out.append("ok")
                    except P.exc.BlockException as ex:
                        out.append(type(ex).__name__)
                out += [await work("a"), await work("boom"), await work("c")]
                for _ in range(2):
                    try:
                        out.append([x async for x in
                                    P.streams.guard_aiter("stream", gen())])
                    except P.exc.BlockException as ex:
                        out.append(type(ex).__name__)
                return out

            got = asyncio.run(run())
            snap = eng.node_snapshot()
            outs.append({"got": got, "snap": {
                k: snap.get(k) for k in ("aio", "aiod", "stream")}})
        jax_out, port_out = outs
        assert port_out == jax_out
        assert port_out["got"] == [
            "ok", "ok", "FlowException", "FlowException", "done:a",
            "fb:boom", "blocked:c", [0, 1, 2], "FlowException"]

    def test_grpc_server_interceptor_blocks_over_quota(self, case):
        import concurrent.futures

        import grpc

        pkgs, engines = case
        outs = []
        for P in pkgs:
            eng = engines[P.name]
            handler = grpc.method_handlers_generic_handler(
                "test.Echo", {"Call": grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: req, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)})
            server = grpc.server(
                concurrent.futures.ThreadPoolExecutor(max_workers=2),
                interceptors=[P.grpc_ad.SentinelGrpcServerInterceptor()])
            server.add_generic_rpc_handlers((handler,))
            port = server.add_insecure_port("127.0.0.1:0")
            server.start()
            codes = []
            try:
                P.rules(eng, flow=[P.flow.FlowRule(
                    resource="/test.Echo/Call", count=3)])
                with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                    call = ch.unary_unary(
                        "/test.Echo/Call", request_serializer=lambda b: b,
                        response_deserializer=lambda b: b)
                    for _ in range(5):
                        try:
                            call(b"hi", timeout=30)
                            codes.append("OK")
                        except grpc.RpcError as ex:
                            codes.append(ex.code().name)
            finally:
                server.stop(grace=None)
            snap = eng.node_snapshot()["/test.Echo/Call"]
            outs.append({"codes": codes, "snap": snap})
        jax_out, port_out = outs
        assert port_out == jax_out
        assert port_out["codes"] == ["OK"] * 3 + ["RESOURCE_EXHAUSTED"] * 2


def test_gateway_json_schema_equal_across_packages():
    """The camelCase documents: each package writes the same JSON for the
    same rules, and reads either package's document back to the same
    rules (a count comes back a float in both)."""
    from tests.test_torch_support import ad_pkgs

    jax, port = ad_pkgs()
    docs = [P.gw.gateway_rules_to_json(gateway_rules(P)) for P in (jax, port)]
    assert docs[0] == docs[1]
    for doc in docs + [
            '[{"resource": "r", "count": 3, "paramItem": {"fieldName": "f"}}]']:
        back = [P.gw.gateway_rules_to_json(P.gw.gateway_rules_from_json(doc))
                for P in (jax, port)]
        assert back[0] == back[1]
    assert port.gw.gateway_rules_from_json(docs[0]) == [
        port.gw.GatewayFlowRule(**{**r.__dict__, "count": float(r.count)})
        for r in gateway_rules(port)]
    apis = [P.gw.api_definitions_to_json(
        P.gw.api_definitions_from_json(json_apis())) for P in (jax, port)]
    assert apis[0] == apis[1] == json_apis()


# -- the repairs ---------------------------------------------------------------


def test_param_rule_manager_keeps_a_gateway_partition():
    """``load_gateway_rules`` fills a partition of its own (invalid rules
    dropped, the version bumped, listeners called outside the lock);
    ``get_rules`` is the user rules, then the gateway rules; neither load
    clobbers the other."""
    from sentinel_tpu_torch.models.param_flow import (ParamFlowRule,
                                                      ParamFlowRuleManager)

    mgr = ParamFlowRuleManager()
    calls = []
    mgr.add_listener(lambda: calls.append(mgr._lock._is_owned()))
    user = [ParamFlowRule("u", param_idx=0, count=1)]
    gw = [ParamFlowRule("g", param_idx=0, count=2),
          ParamFlowRule("bad", param_idx=0, count=-1)]
    mgr.load_rules(user)
    v = mgr.version
    mgr.load_gateway_rules(gw)
    assert mgr.version == v + 1 and calls == [False, False]
    assert [r.resource for r in mgr.get_rules()] == ["u", "g"]
    mgr.load_rules([ParamFlowRule("u2", param_idx=1, count=3)])
    assert [r.resource for r in mgr.get_rules()] == ["u2", "g"]
    mgr.load_gateway_rules([])
    assert [r.resource for r in mgr.get_rules()] == ["u2"]


@pytest.mark.parametrize("value", [None, "8", "1", "0", "-3", "abc", "2.5"])
def test_rls_max_concurrent_reader_matches_reference(value, monkeypatch):
    from sentinel_tpu.core.config import config as jconfig

    from sentinel_tpu_torch.core import config as PC

    key = PC.OVERLOAD_RLS_MAX_CONCURRENT
    assert key == "csp.sentinel.overload.rls.max.concurrent"
    monkeypatch.delenv(key, raising=False)
    for cfg in (jconfig, PC.config):
        monkeypatch.setitem(cfg._config, key, value) if value is not None \
            else cfg._config.pop(key, None)
    want = {None: 64, "8": 8, "1": 1}.get(value, 64)
    assert PC.config.overload_rls_max_concurrent() == want
    assert jconfig.overload_rls_max_concurrent() == want


@pytest.mark.parametrize("value", [None, "true", "TRUE", "false", "yes", ""])
def test_rls_batched_reader_matches_reference(value, monkeypatch):
    from sentinel_tpu.core.config import config as jconfig

    from sentinel_tpu_torch.core import config as PC

    key = PC.WIRE_RLS_BATCHED
    assert key == "csp.sentinel.wire.rls.batched"
    for cfg in (jconfig, PC.config):
        monkeypatch.setitem(cfg._config, key, value) if value is not None \
            else cfg._config.pop(key, None)
    want = value in ("true", "TRUE")
    assert PC.config.wire_rls_batched() is want
    assert jconfig.wire_rls_batched() is want
