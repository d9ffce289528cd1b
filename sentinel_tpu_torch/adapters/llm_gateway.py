"""LLM inference gateway adapter (port of
``sentinel_tpu/adapters/llm_gateway.py``): fronts a (mock) SSE-streaming
inference backend with the TPS admission family.

The choreography is the one every real token-metered gateway runs:

1. ``complete()`` opens a **streaming reservation**
   (``engine.stream_open``) for the request's estimated output budget —
   a blocked open is the 429, returned before a single backend token is
   generated.
2. Each generated chunk ticks the reservation down
   (``engine.stream_tick``) — output beyond the reserved window budget
   pays live, so a runaway generation feels backpressure mid-stream
   instead of after the fact.
3. ``close`` (or client abandonment -> ``abort``) reconciles: the
   unstreamed remainder of the reservation is released as expiring
   credit, so estimates never leak budget past the window they were
   debited into (the streaming-reservation bound).

``MockInferenceServer`` is the deterministic stand-in backend: one
(seed, request_id) pair names one SSE event stream forever, so the demo
and its tests replay bit-identically. ``run_demo`` drives the gateway
shape end-to-end in-sim: ``hetero_cost`` streamed-generation load
through the production engine with the adaptive loop retuning per-model
``tokensPerSecond`` (shadow -> canary -> promote), then asserts the
ledger drained and nothing was silently dropped.

Device: ``LLMGateway`` uses the engine it is given, or the module's
default engine (``cuda`` unless ``reset(device="cpu")`` built it);
``run_demo`` takes ``device=`` for its replay engine (``cuda`` unless the
caller asks for the CPU; raises with no card).
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from sentinel_tpu_torch.core.exceptions import BlockException

SSE_DATA_PREFIX = "data: "
SSE_DONE = "data: [DONE]"


def _sse(payload: Dict) -> str:
    return SSE_DATA_PREFIX + json.dumps(payload, sort_keys=True)


class MockInferenceServer:
    """Deterministic SSE-style mock backend.

    ``stream(request_id, model, max_tokens)`` yields chunked SSE data
    lines; the generation length is a pure function of (seed,
    request_id, model) via crc32 — no RNG object, no wall clock — so a
    replayed demo sees byte-identical backend behavior."""

    def __init__(self, seed: int = 0, chunk_tokens: int = 8):
        self.seed = int(seed)
        self.chunk_tokens = max(1, int(chunk_tokens))

    def generation_tokens(self, request_id: str, model: str,
                          max_tokens: int) -> int:
        """How many tokens this request actually generates: 50%..100%
        of ``max_tokens``, deterministic per (seed, request, model)."""
        h = zlib.crc32(f"{self.seed}:{request_id}:{model}".encode())
        frac = 0.5 + (h % 1000) / 2000.0
        return max(1, int(max_tokens * frac))

    def stream(self, request_id: str, model: str,
               max_tokens: int) -> Iterator[str]:
        total = self.generation_tokens(request_id, model, max_tokens)
        sent = 0
        while sent < total:
            n = min(self.chunk_tokens, total - sent)
            sent += n
            yield _sse({"id": request_id, "model": model, "tokens": n,
                        "index": sent})
        yield SSE_DONE


@dataclass
class CompletionResult:
    """One gateway request's outcome — the reconciliation receipt."""

    request_id: str
    model: str
    admitted: bool
    blocked_reason: str = ""
    streamed_tokens: int = 0
    released_tokens: int = 0   # unreconciled reservation given back
    aborted: bool = False
    events: List[str] = field(default_factory=list)


class LLMGateway:
    """The admission front for a streaming inference backend.

    Every request is a reservation lifecycle against the engine's TPS
    family; the gateway never drops a stream silently — every open
    either blocks (counted) or ends in exactly one close/abort
    (reconciled)."""

    def __init__(self, engine=None, server: Optional[
            MockInferenceServer] = None, tick_tokens: int = 0):
        if engine is None:
            import sentinel_tpu_torch as st
            engine = st.get_engine()
        self.engine = engine
        self.server = server or MockInferenceServer()
        # 0 = tick per backend chunk (the honest cadence); >0 batches
        # ticks to amortize host calls on very chatty backends.
        self.tick_tokens = max(0, int(tick_tokens))

    def complete(self, request_id: str, model: str,
                 max_tokens: int = 0,
                 tenant: str = "default",
                 abandon_after_tokens: Optional[int] = None,
                 collect_events: bool = False) -> CompletionResult:
        """Run one streamed completion under admission.

        ``abandon_after_tokens`` models the impatient client: the
        stream aborts once that many tokens have streamed, leaving the
        rest of the reservation for ``stream_close(aborted=True)`` to
        reconcile — the over-admission-bound path."""
        eng = self.engine
        result = CompletionResult(request_id=request_id, model=model,
                                  admitted=False)
        try:
            eng.stream_open(request_id, model,
                            max_tokens if max_tokens > 0 else None,
                            tenant=tenant)
        except BlockException as ex:
            result.blocked_reason = type(ex).__name__
            return result
        result.admitted = True
        pending = 0
        try:
            for line in self.server.stream(request_id, model,
                                           max_tokens or 128):
                if collect_events:
                    result.events.append(line)
                if line == SSE_DONE:
                    break
                tokens = json.loads(line[len(SSE_DATA_PREFIX):])["tokens"]
                pending += int(tokens)
                if self.tick_tokens and pending < self.tick_tokens:
                    continue
                try:
                    eng.stream_tick(request_id, pending)
                finally:
                    result.streamed_tokens += pending
                    pending = 0
                if abandon_after_tokens is not None \
                        and result.streamed_tokens >= abandon_after_tokens:
                    result.aborted = True
                    break
        except BlockException:
            # Mid-stream backpressure: the window refused the overflow
            # tokens — surface it as an abort, reconciling what DID
            # stream. (A real gateway would retry-after instead.)
            result.aborted = True
        finally:
            if pending and not result.aborted:
                try:
                    eng.stream_tick(request_id, pending)
                    result.streamed_tokens += pending
                except BlockException:
                    result.aborted = True
            result.released_tokens = eng.stream_close(
                request_id, aborted=result.aborted)
        return result


def run_demo(seconds: int = 120, seed: int = 0,
             streams_per_s: float = 0.4,
             abandon_rate: float = 0.2, device=None) -> Dict:
    """The end-to-end acceptance drill: hetero_cost-shaped
    streamed-generation load through the production engine in-sim, the
    adaptive loop retuning per-model ``tokensPerSecond``
    (shadow -> canary -> promote). Returns a summary dict whose
    invariants the tests pin:

    * ``ledgerDrained`` — zero outstanding reservation tokens at end.
    * ``silentDrops`` — opened - closed - aborted - active == 0 always.
    * ``tpsPromotes`` — >= 1 promoted per-model TPS retune in-sim.
    """
    from sentinel_tpu_torch.simulator.lab import default_targets
    from sentinel_tpu_torch.simulator.replay import (
        DEFAULT_ADAPTIVE_KNOBS,
        ReplayEngine,
    )
    from sentinel_tpu_torch.simulator.scenarios import hetero_cost

    trace = hetero_cost(seconds=seconds, seed=seed,
                        streams_per_s=streams_per_s,
                        abandon_rate=abandon_rate)
    result = ReplayEngine(
        trace,
        adaptive=dict(DEFAULT_ADAPTIVE_KNOBS),
        targets=[t for t in default_targets(trace)
                 if t.resource.startswith("llm:")],
        device=device,
    ).run()
    st = result.streams
    opened = st.get("opened", 0)
    accounted = (st.get("closed", 0) + st.get("aborted", 0)
                 + st.get("active", 0))
    tps_promotes = [
        ev for ev in result.decisions if ev.get("kind") == "promote"
        and any(ch.get("resource", "").startswith("llm:")
                for ch in ev.get("changes", ()))]
    return {
        "seconds": result.seconds,
        "verdictSha256": result.verdict_sha256,
        "objective": result.objective_vector(),
        "streams": dict(st),
        "ledgerDrained": st.get("outstandingTokens", 0) == 0
        and st.get("active", 0) == 0,
        "silentDrops": opened - accounted,
        "tpsPromotes": len(tps_promotes),
        "finalCounts": {res: cnt
                        for res, cnt in result.final_counts.items()
                        if res.startswith("llm:")},
    }
