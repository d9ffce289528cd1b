"""Runtime-built protobuf messages for ``envoy.service.ratelimit.v2``
AND ``envoy.service.ratelimit.v3`` (the reference ships the v2 proto +
generated stubs — ``src/main/proto/envoy/service/ratelimit/v2/rls.proto``;
v3 is what current Envoy speaks, same shape under renamed packages. The
package ships no protoc-generated code, so both schemas are registered
through hand-built ``FileDescriptorProto``s — wire-compatible with
Envoy's RLS clients).

Port of ``sentinel_tpu/envoy_rls/proto.py``. The schemas live in a
private ``DescriptorPool``, so this module and the JAX package's can be
loaded in one process; their messages serialize to the same bytes.

Field numbers mirror the official protos (identical across v2/v3 for
the subset served):
  RateLimitRequest  { domain=1; descriptors=2; hits_addend=3 }
  RateLimitDescriptor { entries=1 } / Entry { key=1; value=2 }
  RateLimitResponse { overall_code=1; statuses=2 }
  DescriptorStatus  { code=1; current_limit=2; limit_remaining=3 }
  RateLimit         { requests_per_unit=1; unit=2 }
v3 moves the descriptor type to
``envoy.extensions.common.ratelimit.v3`` (file
``envoy/extensions/common/ratelimit/v3/ratelimit.proto``) and the
service to ``envoy.service.ratelimit.v3.RateLimitService``.
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_PKG = "envoy.service.ratelimit.v2"
_RL_PKG = "envoy.api.v2.ratelimit"
_PKG_V3 = "envoy.service.ratelimit.v3"
_RL_PKG_V3 = "envoy.extensions.common.ratelimit.v3"

# Response codes (RateLimitResponse.Code).
CODE_UNKNOWN = 0
CODE_OK = 1
CODE_OVER_LIMIT = 2

# RateLimit.Unit.
UNIT_UNKNOWN = 0
UNIT_SECOND = 1

_T = descriptor_pb2.FieldDescriptorProto


def _field(name, number, ftype, label=_T.LABEL_OPTIONAL, type_name=None):
    f = _T(name=name, number=number, type=ftype, label=label)
    if type_name:
        f.type_name = type_name
    return f


def _add_version(pool, rl_file, rl_pkg, rls_file, rls_pkg) -> None:
    """Register one version's descriptor + service files (the schema is
    shape-identical across v2/v3; only files/packages differ)."""
    rl = descriptor_pb2.FileDescriptorProto(name=rl_file, package=rl_pkg)
    desc = rl.message_type.add(name="RateLimitDescriptor")
    entry = desc.nested_type.add(name="Entry")
    entry.field.append(_field("key", 1, _T.TYPE_STRING))
    entry.field.append(_field("value", 2, _T.TYPE_STRING))
    desc.field.append(_field(
        "entries", 1, _T.TYPE_MESSAGE, _T.LABEL_REPEATED,
        f".{rl_pkg}.RateLimitDescriptor.Entry"))
    pool.Add(rl)

    rls = descriptor_pb2.FileDescriptorProto(
        name=rls_file, package=rls_pkg, dependency=[rl_file])

    req = rls.message_type.add(name="RateLimitRequest")
    req.field.append(_field("domain", 1, _T.TYPE_STRING))
    req.field.append(_field(
        "descriptors", 2, _T.TYPE_MESSAGE, _T.LABEL_REPEATED,
        f".{rl_pkg}.RateLimitDescriptor"))
    req.field.append(_field("hits_addend", 3, _T.TYPE_UINT32))

    resp = rls.message_type.add(name="RateLimitResponse")
    code_enum = resp.enum_type.add(name="Code")
    for n, v in (("UNKNOWN", 0), ("OK", 1), ("OVER_LIMIT", 2)):
        code_enum.value.add(name=n, number=v)
    ratelimit = resp.nested_type.add(name="RateLimit")
    unit_enum = ratelimit.enum_type.add(name="Unit")
    for n, v in (("UNKNOWN", 0), ("SECOND", 1), ("MINUTE", 2),
                 ("HOUR", 3), ("DAY", 4)):
        unit_enum.value.add(name=n, number=v)
    ratelimit.field.append(_field("requests_per_unit", 1, _T.TYPE_UINT32))
    ratelimit.field.append(_field(
        "unit", 2, _T.TYPE_ENUM,
        type_name=f".{rls_pkg}.RateLimitResponse.RateLimit.Unit"))
    status = resp.nested_type.add(name="DescriptorStatus")
    status.field.append(_field(
        "code", 1, _T.TYPE_ENUM,
        type_name=f".{rls_pkg}.RateLimitResponse.Code"))
    status.field.append(_field(
        "current_limit", 2, _T.TYPE_MESSAGE,
        type_name=f".{rls_pkg}.RateLimitResponse.RateLimit"))
    status.field.append(_field("limit_remaining", 3, _T.TYPE_UINT32))
    resp.field.append(_field(
        "overall_code", 1, _T.TYPE_ENUM,
        type_name=f".{rls_pkg}.RateLimitResponse.Code"))
    resp.field.append(_field(
        "statuses", 2, _T.TYPE_MESSAGE, _T.LABEL_REPEATED,
        f".{rls_pkg}.RateLimitResponse.DescriptorStatus"))
    pool.Add(rls)


def _build_pool() -> descriptor_pool.DescriptorPool:
    pool = descriptor_pool.DescriptorPool()
    _add_version(pool, "envoy/api/v2/ratelimit/ratelimit.proto", _RL_PKG,
                 "envoy/service/ratelimit/v2/rls.proto", _PKG)
    _add_version(pool,
                 "envoy/extensions/common/ratelimit/v3/ratelimit.proto",
                 _RL_PKG_V3,
                 "envoy/service/ratelimit/v3/rls.proto", _PKG_V3)
    return pool


_pool = _build_pool()


def _cls(full_name: str):
    return message_factory.GetMessageClass(_pool.FindMessageTypeByName(full_name))


RateLimitDescriptor = _cls(f"{_RL_PKG}.RateLimitDescriptor")
RateLimitRequest = _cls(f"{_PKG}.RateLimitRequest")
RateLimitResponse = _cls(f"{_PKG}.RateLimitResponse")

RateLimitDescriptorV3 = _cls(f"{_RL_PKG_V3}.RateLimitDescriptor")
RateLimitRequestV3 = _cls(f"{_PKG_V3}.RateLimitRequest")
RateLimitResponseV3 = _cls(f"{_PKG_V3}.RateLimitResponse")

SERVICE_NAME = f"{_PKG}.RateLimitService"
SERVICE_NAME_V3 = f"{_PKG_V3}.RateLimitService"
METHOD_NAME = "ShouldRateLimit"
