"""Framework adapters (port of ``sentinel_tpu/adapters/``), so far only
the LLM inference gateway: :mod:`sentinel_tpu_torch.adapters.llm_gateway`
(``MockInferenceServer``, ``LLMGateway``, ``run_demo``), which the
reference's package does not re-export either. The other adapters (the
decorator, WSGI / ASGI middlewares, the API gateway layer, gRPC, the HTTP
client guard, asyncio and async-stream guards, the Flask and Django
sugar) are not ported yet.
"""

__all__: list = []
