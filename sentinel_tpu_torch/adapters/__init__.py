"""Framework adapters (reference: ``sentinel-adapter/`` — SURVEY.md §2.5):
each adapter translates a host-framework request into
``context_enter(origin) + entry(resource, IN)`` with a block-handler hook.

Python-native adapter set: a decorator (the ``@SentinelResource`` aspect
analog), WSGI and ASGI middlewares (Servlet / WebFlux analogs), the API
gateway common layer (route/API-group rules + param parsing), gRPC
server/client interceptors (``sentinel-grpc-adapter`` — import
``sentinel_tpu_torch.adapters.grpc_adapter``, requires grpcio), an outbound
HTTP client guard (``sentinel-okhttp-adapter`` analog,
``sentinel_tpu_torch.adapters.http_client``), asyncio coroutine guards
(``sentinel_tpu_torch.adapters.aio``), async-stream guards — the
``sentinel-reactor-adapter`` analog (``sentinel_tpu_torch.adapters.streams``) —
and per-framework sugar: a Flask extension
(``sentinel_tpu_torch.adapters.flask_ext``) and a Django-style middleware
(``sentinel_tpu_torch.adapters.django_mw``), both duck-typed so neither
framework is a dependency.

Port of ``sentinel_tpu/adapters/__init__.py``, with the same re-exports.
The LLM inference gateway (``sentinel_tpu_torch.adapters.llm_gateway``)
is imported by name, as in the reference. Every adapter admits through
the module API's default engine (``cuda`` unless ``st.reset(device=
"cpu")`` built it; with no card it raises) or the engine it is given.
"""

from sentinel_tpu_torch.adapters.annotation import sentinel_resource
from sentinel_tpu_torch.adapters.asgi import SentinelASGIMiddleware
from sentinel_tpu_torch.adapters.gateway import (
    ApiDefinition,
    ApiPredicateItem,
    GatewayApiDefinitionManager,
    GatewayFlowRule,
    GatewayParamFlowItem,
    GatewayRuleManager,
    GatewayRequest,
    api_definitions_from_json,
    api_definitions_to_json,
    gateway_entry,
    gateway_rules_from_json,
    gateway_rules_to_json,
    get_api_manager,
    get_gateway_rule_manager,
)
from sentinel_tpu_torch.adapters.http_client import SentinelHttpClient, guarded
from sentinel_tpu_torch.adapters.streams import guard_aiter, sentinel_stream
from sentinel_tpu_torch.adapters.wsgi import SentinelWSGIMiddleware

__all__ = [
    "ApiDefinition", "ApiPredicateItem", "GatewayApiDefinitionManager",
    "GatewayFlowRule", "GatewayParamFlowItem", "GatewayRequest",
    "GatewayRuleManager", "SentinelASGIMiddleware", "SentinelHttpClient",
    "SentinelWSGIMiddleware", "api_definitions_from_json",
    "api_definitions_to_json", "gateway_entry", "gateway_rules_from_json",
    "gateway_rules_to_json", "get_api_manager", "get_gateway_rule_manager",
    "guard_aiter", "guarded", "sentinel_resource", "sentinel_stream",
]
