"""The port's Envoy RLS surface (``sentinel_tpu_torch/envoy_rls/``) on the
CPU, then held to the JAX package's.

The first part is the port's counterpart of every case of
``tests/test_envoy_rls.py`` (rule conversion, ``ShouldRateLimit``
semantics, a real gRPC round trip over the runtime-built messages), with
the service's token service on ``device="cpu"``.

The second part holds the port to the JAX package: descriptor flow ids
bit-equal over a seeded set, the generated cluster rules, the v2 / v3
message bytes, the codes and ``limit_remaining`` direct and batched under
frozen clocks, a gRPC client of either package against the other's
server, the shed gate and the module entry point's reload.
"""

import pytest

from sentinel_tpu_torch.envoy_rls import (
    EnvoyRlsRule,
    EnvoyRlsRuleManager,
    KeyValueResource,
    ResourceDescriptor,
    SentinelEnvoyRlsService,
    descriptor_flow_id,
    to_cluster_flow_rules,
)
from sentinel_tpu_torch.envoy_rls import proto
from sentinel_tpu_torch.utils import time_util as ptu

NOW0 = 1_700_000_000_000


@pytest.fixture()
def frozen_time():
    """The port's clock pinned to the reference tests' epoch."""
    ptu.freeze_time(NOW0)
    yield ptu
    ptu.unfreeze_time()


def _rls_rule(domain="web", key="path", value="/api", count=3):
    return EnvoyRlsRule(domain, [
        ResourceDescriptor([KeyValueResource(key, value)], count)])


def test_rule_conversion_generates_cluster_rules():
    rules = to_cluster_flow_rules(_rls_rule())
    assert len(rules) == 1
    r = rules[0]
    assert r.cluster_mode and r.count == 3
    assert r.resource == "web|path:/api"
    assert r.cluster_config["flowId"] == descriptor_flow_id(
        "web", [("path", "/api")])
    # flowId is stable and descriptor-sensitive.
    assert descriptor_flow_id("web", [("path", "/api")]) == \
        descriptor_flow_id("web", [("path", "/api")])
    assert descriptor_flow_id("web", [("path", "/other")]) != \
        descriptor_flow_id("web", [("path", "/api")])


@pytest.fixture()
def rls_service(frozen_time):
    svc = SentinelEnvoyRlsService(device="cpu")
    svc.rules.load_rules([_rls_rule(count=3)])
    return svc


def test_should_rate_limit_enforces_quota(rls_service, frozen_time):
    codes = []
    for _ in range(5):
        overall, statuses = rls_service.should_rate_limit(
            "web", [[("path", "/api")]])
        codes.append(overall)
    assert codes.count(proto.CODE_OK) == 3
    assert codes.count(proto.CODE_OVER_LIMIT) == 2
    frozen_time.advance_time(1100)
    overall, _ = rls_service.should_rate_limit("web", [[("path", "/api")]])
    assert overall == proto.CODE_OK


def test_unknown_descriptor_passes(rls_service):
    overall, statuses = rls_service.should_rate_limit(
        "web", [[("header", "x")]])
    assert overall == proto.CODE_OK


def test_mixed_descriptors_over_limit_wins(rls_service, frozen_time):
    descriptors = [[("path", "/api")], [("header", "x")]]
    for _ in range(3):
        rls_service.should_rate_limit("web", [[("path", "/api")]])
    overall, statuses = rls_service.should_rate_limit("web", descriptors)
    assert overall == proto.CODE_OVER_LIMIT
    assert statuses[0][0] == proto.CODE_OVER_LIMIT
    assert statuses[1][0] == proto.CODE_OK


def test_hits_addend(rls_service, frozen_time):
    overall, _ = rls_service.should_rate_limit(
        "web", [[("path", "/api")]], hits_addend=3)
    assert overall == proto.CODE_OK
    overall, _ = rls_service.should_rate_limit(
        "web", [[("path", "/api")]], hits_addend=1)
    assert overall == proto.CODE_OVER_LIMIT


def test_rule_reload_clears_old_domains(frozen_time):
    mgr = EnvoyRlsRuleManager()
    mgr.load_rules([_rls_rule(domain="a"), _rls_rule(domain="b")])
    assert set(mgr.cluster_rules.namespaces()) >= {"a", "b"}
    mgr.load_rules([_rls_rule(domain="a")])
    assert mgr.cluster_rules.get_rules("b") == []


def test_proto_messages_round_trip():
    req = proto.RateLimitRequest()
    req.domain = "web"
    d = req.descriptors.add()
    e = d.entries.add()
    e.key, e.value = "path", "/api"
    req.hits_addend = 2
    raw = req.SerializeToString()
    back = proto.RateLimitRequest.FromString(raw)
    assert back.domain == "web"
    assert back.descriptors[0].entries[0].value == "/api"
    assert back.hits_addend == 2


def test_proto_messages_round_trip_v3():
    req = proto.RateLimitRequestV3()
    req.domain = "web"
    d = req.descriptors.add()
    e = d.entries.add()
    e.key, e.value = "path", "/api"
    req.hits_addend = 2
    back = proto.RateLimitRequestV3.FromString(req.SerializeToString())
    assert back.domain == "web"
    assert back.descriptors[0].entries[0].value == "/api"
    assert back.hits_addend == 2
    assert back.DESCRIPTOR.full_name == \
        "envoy.service.ratelimit.v3.RateLimitRequest"


def test_v2_v3_wire_compatible():
    """The schemas are shape-identical, so v2 bytes parse as v3 and
    vice versa — exactly the migration property Envoy relied on when it
    renamed the packages."""
    req = proto.RateLimitRequest()
    req.domain = "web"
    d = req.descriptors.add()
    e = d.entries.add()
    e.key, e.value = "k", "v"
    req.hits_addend = 7
    as_v3 = proto.RateLimitRequestV3.FromString(req.SerializeToString())
    assert as_v3.domain == "web" and as_v3.hits_addend == 7
    assert as_v3.descriptors[0].entries[0].key == "k"

    resp = proto.RateLimitResponseV3()
    resp.overall_code = proto.CODE_OVER_LIMIT
    s = resp.statuses.add()
    s.code = proto.CODE_OVER_LIMIT
    s.limit_remaining = 0
    as_v2 = proto.RateLimitResponse.FromString(resp.SerializeToString())
    assert as_v2.overall_code == proto.CODE_OVER_LIMIT
    assert as_v2.statuses[0].code == proto.CODE_OVER_LIMIT


def test_grpc_round_trip_v3(frozen_time):
    """current Envoy's service path: /envoy.service.ratelimit.v3.
    RateLimitService/ShouldRateLimit — served alongside v2 from the
    SAME server and token windows (a v2 and a v3 client drain one
    quota)."""
    grpc = pytest.importorskip("grpc")
    svc = SentinelEnvoyRlsService(device="cpu")
    svc.rules.load_rules([_rls_rule(count=2)])
    server = svc.serve_grpc("127.0.0.1:0")
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{server.bound_port}")
        call_v3 = channel.unary_unary(
            f"/{proto.SERVICE_NAME_V3}/{proto.METHOD_NAME}",
            request_serializer=proto.RateLimitRequestV3.SerializeToString,
            response_deserializer=proto.RateLimitResponseV3.FromString,
        )
        call_v2 = channel.unary_unary(
            f"/{proto.SERVICE_NAME}/{proto.METHOD_NAME}",
            request_serializer=proto.RateLimitRequest.SerializeToString,
            response_deserializer=proto.RateLimitResponse.FromString,
        )
        req3 = proto.RateLimitRequestV3()
        req3.domain = "web"
        d = req3.descriptors.add()
        e = d.entries.add()
        e.key, e.value = "path", "/api"
        req2 = proto.RateLimitRequest.FromString(req3.SerializeToString())
        # one v3 + one v2 acquire exhaust the 2-token quota; the next v3
        # call is over limit — both versions share the windows
        assert call_v3(req3, timeout=5).overall_code == proto.CODE_OK
        assert call_v2(req2, timeout=5).overall_code == proto.CODE_OK
        r = call_v3(req3, timeout=5)
        assert r.overall_code == proto.CODE_OVER_LIMIT
        assert r.statuses[0].code == proto.CODE_OVER_LIMIT
        channel.close()
    finally:
        server.stop(0)


def test_grpc_round_trip(frozen_time):
    grpc = pytest.importorskip("grpc")
    svc = SentinelEnvoyRlsService(device="cpu")
    svc.rules.load_rules([_rls_rule(count=2)])
    server = svc.serve_grpc("127.0.0.1:0")
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{server.bound_port}")
        call = channel.unary_unary(
            f"/{proto.SERVICE_NAME}/{proto.METHOD_NAME}",
            request_serializer=proto.RateLimitRequest.SerializeToString,
            response_deserializer=proto.RateLimitResponse.FromString,
        )
        req = proto.RateLimitRequest()
        req.domain = "web"
        d = req.descriptors.add()
        e = d.entries.add()
        e.key, e.value = "path", "/api"
        codes = [call(req, timeout=5).overall_code for _ in range(4)]
        assert codes.count(proto.CODE_OK) == 2
        assert codes.count(proto.CODE_OVER_LIMIT) == 2
        channel.close()
    finally:
        server.stop(0)


# -- the port's own cases --------------------------------------------------------


def test_service_raises_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SentinelEnvoyRlsService()


def test_module_entry_exits_2_without_a_card(monkeypatch, tmp_path, capsys):
    import torch

    from sentinel_tpu_torch.envoy_rls import __main__ as M

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rules = tmp_path / "rules.json"
    rules.write_text("[]")
    with pytest.raises(SystemExit) as ex:
        M.main(["--rules", str(rules), "--address", "127.0.0.1:0"])
    assert ex.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_reload_keeps_last_good_rules(tmp_path, frozen_time, capsys):
    """``reload_rules``: an mtime change reloads; a malformed file keeps
    the last good rules and leaves the mtime unrecorded, so the next poll
    retries even if the fix lands in the same mtime tick."""
    import os

    from sentinel_tpu_torch.envoy_rls.__main__ import reload_rules

    mgr = EnvoyRlsRuleManager()
    path = tmp_path / "rules.json"
    path.write_text('[{"domain": "web", "descriptors": [{"resources": '
                    '[{"key": "path", "value": "/a"}], "count": 4}]}]')
    os.utime(path, (1_600_000_001,) * 2)
    mtime = reload_rules(mgr, str(path), None)
    assert mtime == 1_600_000_001 and mgr.get_rules()[0].domain == "web"
    assert reload_rules(mgr, str(path), mtime) == mtime  # unchanged: no-op
    path.write_text('[{"domain": "web", "descriptors": [{"resources": []')
    os.utime(path, (1_600_000_002,) * 2)
    assert reload_rules(mgr, str(path), mtime) == mtime
    assert mgr.get_rules()[0].descriptors[0].count == 4
    path.write_text('[{"domain": "api", "descriptors": []}]')
    os.utime(path, (1_600_000_002,) * 2)
    assert reload_rules(mgr, str(path), mtime) == 1_600_000_002
    assert [r.domain for r in mgr.get_rules()] == ["api"]
    assert mgr.cluster_rules.get_rules("web") == []
    path.unlink()
    assert reload_rules(mgr, str(path), 1_600_000_002) == 1_600_000_002
    out = capsys.readouterr().out
    assert out.count("RLS rules reloaded") == 2
    assert "kept last good" in out


# -- parity with the JAX package ---------------------------------------------


def _pkgs():
    from tests.test_torch_support import ad_pkgs

    return ad_pkgs()


def _descriptors(seed, n):
    """Seeded (domain, entries) pairs: 1-3 entries of ASCII and non-ASCII
    keys and values, ``|`` and ``:`` inside them, empty strings too."""
    import random

    rnd = random.Random(seed)
    alphabet = "abcxyz019/-_.:|é中 "
    word = lambda: "".join(rnd.choice(alphabet)
                           for _ in range(rnd.randrange(0, 9)))
    return [(word() or "d", [(word(), word())
                             for _ in range(rnd.randrange(1, 4))])
            for _ in range(n)]


def test_descriptor_flow_ids_bit_equal():
    jax, port = _pkgs()
    for domain, entries in _descriptors(5, 500):
        want = jax.rls_rule.descriptor_flow_id(domain, entries)
        got = port.rls_rule.descriptor_flow_id(domain, entries)
        assert got == want and 0 <= got < (1 << 63)
        assert port.rls_rule.descriptor_identity(domain, entries) == \
            jax.rls_rule.descriptor_identity(domain, entries)


def test_cluster_rules_equal():
    jax, port = _pkgs()

    def view(P):
        R = P.rls_rule
        rules = []
        for k, (domain, entries) in enumerate(_descriptors(9, 40)):
            rules.append(R.EnvoyRlsRule(domain, [R.ResourceDescriptor(
                [R.KeyValueResource(a, b) for a, b in entries],
                float(k % 7))]))
        out = []
        for rule in rules:
            for fr in R.to_cluster_flow_rules(rule):
                out.append((fr.resource, fr.count, fr.cluster_mode,
                            sorted(fr.cluster_config.items()), fr.grade,
                            fr.is_valid()))
        mgr = R.EnvoyRlsRuleManager()
        mgr.load_rules(rules + [R.EnvoyRlsRule("")])  # invalid: dropped
        ns = {n: [(r.resource, r.cluster_config["flowId"])
                  for r in mgr.cluster_rules.get_rules(n)]
              for n in mgr.cluster_rules.namespaces()}
        return out, ns, [r.domain for r in mgr.get_rules()]

    assert view(port) == view(jax)


def _request(P, v3, domain, descriptors, hits=0):
    cls = P.proto.RateLimitRequestV3 if v3 else P.proto.RateLimitRequest
    req = cls()
    req.domain = domain
    for entries in descriptors:
        d = req.descriptors.add()
        for k, v in entries:
            e = d.entries.add()
            e.key, e.value = k, v
    req.hits_addend = hits
    return req


def _response(P, v3, overall, statuses):
    cls = P.proto.RateLimitResponseV3 if v3 else P.proto.RateLimitResponse
    resp = cls()
    resp.overall_code = overall
    for code, remaining in statuses:
        s = resp.statuses.add()
        s.code = code
        s.limit_remaining = remaining
        s.current_limit.requests_per_unit = remaining + 1
        s.current_limit.unit = 1
    return resp


@pytest.mark.parametrize("v3", [False, True], ids=["v2", "v3"])
def test_message_bytes_equal(v3):
    jax, port = _pkgs()
    for domain, entries in _descriptors(11, 50):
        descs = [entries, entries[:1]]
        raw = [_request(P, v3, domain, descs, hits=len(domain)
                        ).SerializeToString() for P in (jax, port)]
        assert raw[0] == raw[1]
        back = _request(jax, v3, "", []).FromString(raw[1])
        assert back.domain == domain and len(back.descriptors) == 2
    for statuses in ([], [(1, 7)], [(2, 0), (1, 0), (0, 0)]):
        overall = max([c for c, _ in statuses], default=0)
        raw = [_response(P, v3, overall, statuses).SerializeToString()
               for P in (jax, port)]
        assert raw[0] == raw[1]
    assert (port.proto.SERVICE_NAME, port.proto.SERVICE_NAME_V3,
            port.proto.METHOD_NAME) == (jax.proto.SERVICE_NAME,
                                        jax.proto.SERVICE_NAME_V3,
                                        jax.proto.METHOD_NAME)
    for name in ("RateLimitRequest", "RateLimitResponse",
                 "RateLimitDescriptor"):
        name += "V3" if v3 else ""
        assert getattr(port.proto, name).DESCRIPTOR.full_name == \
            getattr(jax.proto, name).DESCRIPTOR.full_name


def _rls_rules(P):
    R = P.rls_rule
    kv = R.KeyValueResource
    return [
        R.EnvoyRlsRule("mesh", [
            R.ResourceDescriptor([kv("destination_cluster", f"svc-{i}")],
                                 [3, 5, 1e6][i % 3]) for i in range(12)] + [
            R.ResourceDescriptor([kv("destination_cluster", "svc-0"),
                                  kv("generic_key", "route-1")], 2)]),
        R.EnvoyRlsRule("web", [R.ResourceDescriptor([kv("path", "/api")], 4)]),
    ]


def _rls_script(P, batched, n=200, seed=3):
    """``n`` seeded ``should_rate_limit`` calls on the package's frozen
    clock: 1-3 descriptors of the two domains (known and unknown), hits
    1-3, the clock 0-300 ms on between calls."""
    import random

    rnd = random.Random(seed)
    P.tu.freeze_time(NOW0)
    svc = P.service(batched=batched)
    try:
        svc.rules.load_rules(_rls_rules(P))
        out = []
        for _ in range(n):
            domain = rnd.choice(("mesh", "mesh", "web", "nope"))
            descs = []
            for _ in range(rnd.randrange(1, 4)):
                i = rnd.randrange(14)
                d = [("destination_cluster", f"svc-{i}")]
                if rnd.random() < 0.2:
                    d.append(("generic_key", "route-1"))
                descs.append(d if domain != "web" else [("path", "/api")])
            out.append(svc.should_rate_limit(domain, descs,
                                             rnd.choice((0, 1, 1, 2, 3))))
            P.tu.advance_time(rnd.randrange(0, 300))
        return out, (svc.shed_count, svc.served_count)
    finally:
        svc.close()
        P.tu.unfreeze_time()


@pytest.mark.parametrize("batched", [False, True], ids=["direct", "batched"])
def test_codes_and_remaining_equal(batched):
    jax, port = _pkgs()
    want, want_stats = _rls_script(jax, batched)
    got, got_stats = _rls_script(port, batched)
    assert got == want and got_stats == want_stats
    codes = [c for c, _ in got]
    assert codes.count(proto.CODE_OK) and codes.count(proto.CODE_OVER_LIMIT)
    assert any(r > 0 for _, sts in got for _, r in sts)


def _serve(P):
    svc = P.service(batched=False)
    svc.rules.load_rules(_rls_rules(P))
    return svc, svc.serve_grpc("127.0.0.1:0")


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_grpc_cross_package_round_trip(server_pkg, frozen_time):
    """A client built on one package's messages against the other's
    ``serve_grpc``, v2 and v3 on one channel: the answers equal a direct
    call's on a twin service of the client's package."""
    import grpc

    from sentinel_tpu.utils import time_util as jtu

    jax, port = _pkgs()
    server_p, client_p = (port, jax) if server_pkg == "port" else (jax, port)
    jtu.freeze_time(NOW0)
    svc, server = _serve(server_p)
    twin = client_p.service(batched=False)
    twin.rules.load_rules(_rls_rules(client_p))
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{server.bound_port}")
        calls = {}
        for v3 in (False, True):
            P = client_p.proto
            calls[v3] = channel.unary_unary(
                f"/{P.SERVICE_NAME_V3 if v3 else P.SERVICE_NAME}/"
                f"{P.METHOD_NAME}",
                request_serializer=(P.RateLimitRequestV3 if v3 else
                                    P.RateLimitRequest).SerializeToString,
                response_deserializer=(P.RateLimitResponseV3 if v3 else
                                       P.RateLimitResponse).FromString)
        got, want = [], []
        for k in range(8):
            v3 = bool(k % 2)
            descs = [[("destination_cluster", "svc-0")],
                     [("destination_cluster", "svc-0"),
                      ("generic_key", "route-1")]]
            r = calls[v3](_request(client_p, v3, "mesh", descs), timeout=10)
            got.append((r.overall_code, [(s.code, s.limit_remaining)
                                         for s in r.statuses]))
            want.append(twin.should_rate_limit("mesh", descs))
        assert got == want
        assert got[0] == (proto.CODE_OK, [(proto.CODE_OK, 2),
                                          (proto.CODE_OK, 1)])
        assert got[-1][0] == proto.CODE_OVER_LIMIT
        channel.close()
    finally:
        server.stop(0)
        jtu.unfreeze_time()


@pytest.mark.parametrize("which", ["jax", "port"])
def test_shed_gate_at_max_concurrent_one(which):
    """With one call parked inside the token service, a second call sheds
    at once with CODE_UNKNOWN on every descriptor; the counters and the
    overload stats equal the reference's."""
    import threading

    jax, port = _pkgs()

    def run(P):
        svc = P.service(max_concurrent=1, batched=False)
        inside, release = threading.Event(), threading.Event()
        real = svc.token_service.request_tokens

        def parked(requests):
            inside.set()
            release.wait(10)
            return real(requests)

        svc.token_service.request_tokens = parked
        first = []
        t = threading.Thread(target=lambda: first.append(
            svc.should_rate_limit("web", [[("path", "/api")]])))
        t.start()
        assert inside.wait(10)
        shed = svc.should_rate_limit("web", [[("a", "b")], [("c", "d")]])
        release.set()
        t.join(10)
        after = svc.should_rate_limit("web", [[("path", "/api")]])
        return shed, first, after, svc.overload_stats()

    want = run(jax)
    got = run(port if which == "port" else jax)
    assert got == want
    assert got[0] == (proto.CODE_UNKNOWN, [(proto.CODE_UNKNOWN, 0)] * 2)
    assert got[3]["shedCount"] == 1 and got[3]["servedCount"] == 2


def test_module_serves_v2_and_v3_and_reloads(tmp_path):
    """``python -m sentinel_tpu_torch.envoy_rls --device cpu``: answers a
    v2 and a v3 call from the rules file, keeps the last good rules over
    a malformed rewrite, then takes a good one."""
    import json
    import os
    import re
    import subprocess
    import sys
    import threading
    import time

    import grpc

    rules = tmp_path / "rules.json"

    def write(doc, tick):
        rules.write_text(doc if isinstance(doc, str) else json.dumps(doc))
        os.utime(rules, (1_600_000_000 + tick,) * 2)

    write([{"domain": "web", "descriptors": [
        {"resources": [{"key": "path", "value": "/api"}], "count": 1}]}], 0)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sentinel_tpu_torch.envoy_rls", "--rules",
         str(rules), "--address", "127.0.0.1:0", "--device", "cpu"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                              daemon=True)
    reader.start()

    def wait_line(pred, timeout=30):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for line in list(lines):
                if pred(line):
                    return line
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"no such line in {lines} (rc {proc.poll()})")

    try:
        line = wait_line(lambda s: "serving" in s)
        port_no = int(re.search(r"port (\d+)", line).group(1))
        channel = grpc.insecure_channel(f"127.0.0.1:{port_no}")

        def call(v3, value="/api"):
            name = proto.SERVICE_NAME_V3 if v3 else proto.SERVICE_NAME
            req = (proto.RateLimitRequestV3 if v3 else
                   proto.RateLimitRequest)()
            req.domain = "web"
            e = req.descriptors.add().entries.add()
            e.key, e.value = "path", value
            resp = (proto.RateLimitResponseV3 if v3
                    else proto.RateLimitResponse)
            return channel.unary_unary(
                f"/{name}/{proto.METHOD_NAME}",
                request_serializer=type(req).SerializeToString,
                response_deserializer=resp.FromString)(
                    req, timeout=10).overall_code

        assert call(False) == proto.CODE_OK      # v2 takes the one token
        assert call(True) == proto.CODE_OVER_LIMIT  # v3 shares the window
        write('[{"domain": "web", "descriptors": [', 1)
        wait_line(lambda s: "kept last good" in s, timeout=10)
        assert call(True, "/other") == proto.CODE_OK  # unknown: passes
        write([{"domain": "web", "descriptors": [
            {"resources": [{"key": "path", "value": "/other"}],
             "count": 0}]}], 2)
        wait_line(lambda s: "reloaded" in s, timeout=10)
        assert call(False, "/other") == proto.CODE_OVER_LIMIT
        channel.close()
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
