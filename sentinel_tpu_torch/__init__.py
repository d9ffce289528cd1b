"""sentinel-tpu on PyTorch and CUDA: the fused admission/commit step, the
engine and its module API, ported from the JAX package ``sentinel_tpu``.

Quick start::

    import sentinel_tpu_torch as st

    st.load_flow_rules([st.FlowRule(resource="getUser", count=20)])
    try:
        with st.entry("getUser"):
            do_work()
    except st.BlockException:
        fallback()

Layout mirrors the JAX package module for module (``core/``, ``ops/``,
``models/``, ``log/``, ``metrics/``, ``telemetry/``, ``cluster/``,
``resilience/``); each port module names its counterpart. The JAX package stays the reference: the
``tests/test_torch_*.py`` parity tests feed both packages the same inputs.

Device policy: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (``reset(device="cpu")``, ``SentinelEngine(device=
"cpu")``). With no CUDA device and no explicit device, the engine raises
(``utils/device.py``): it never quietly runs on the CPU. On a CUDA tensor
the segmented prefix launches the hand-written kernel
(``csrc/segmented_prefix.cu``), and the token service's serial admission
its own (``csrc/cluster_acquire.cu``); on a CPU tensor each runs the
plain torch version of the same function.

The cluster token path (``cluster/``): ``engine.cluster`` makes the
engine a token client or an embedded token server, and entries on
cluster-mode rules ask the server first; ``resilience`` holds the retry,
breaker and deadline-budget layer those remote calls run under.

LLM admission (``llm/``): ``load_tps_rules`` loads tokens-per-second
rules, lowered onto flow rules, and the engine's ``stream_open`` /
``stream_tick`` / ``stream_close`` run streaming reservations. The
trace-replay simulator (``simulator/``) drives an engine through recorded
or synthetic seconds on a program clock.

The ops plane (``transport/``): :func:`init_ops_plane` starts the
command HTTP server (rule CRUD, node stats, the OpenMetrics ``metrics``
exposition of ``telemetry/exporter.py``), the metric log timer and, when
``csp.sentinel.dashboard.server`` is set, the dashboard heartbeat;
:func:`shutdown_ops_plane` stops them.

This package imports ``torch`` and ``numpy`` only: never ``jax`` and
nothing of ``sentinel_tpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from sentinel_tpu_torch.core import constants
from sentinel_tpu_torch.core.constants import (
    BlockReason,
    EntryType,
    MetricEvent,
    ResourceType,
)
from sentinel_tpu_torch.core.context import enter as context_enter
from sentinel_tpu_torch.core.context import exit_context, get_context
from sentinel_tpu_torch.core.engine import (DeviceDispatchError, EntryHandle,
                                            SentinelEngine)
from sentinel_tpu_torch.core.exceptions import (
    AuthorityException,
    BlockException,
    DegradeException,
    FlowException,
    ParamFlowException,
    SystemBlockException,
)
from sentinel_tpu_torch.core.checkpoint import (
    CheckpointTimer,
    restore_checkpoint,
    save_checkpoint,
)
from sentinel_tpu_torch.core.spi import (
    EntryInfo,
    ProcessorSlot,
    init_func,
    register_device_checker,
    register_slot,
    unregister_device_checker,
    unregister_slot,
)
from sentinel_tpu_torch.models.authority import AuthorityRule
from sentinel_tpu_torch.models.degrade import DegradeRule
from sentinel_tpu_torch.models.flow import FlowRule
from sentinel_tpu_torch.models.param_flow import ParamFlowItem, ParamFlowRule
from sentinel_tpu_torch.models.system import SystemRule
from sentinel_tpu_torch.llm import TpsRule
from sentinel_tpu_torch import resilience

__version__ = "0.1.0"

_default_engine: Optional[SentinelEngine] = None


def get_engine() -> SentinelEngine:
    """The default engine, built on first use on ``cuda`` (raises without
    a card; call :func:`reset` with ``device="cpu"`` to run on the CPU)."""
    global _default_engine
    if _default_engine is None:
        _default_engine = SentinelEngine()
        # doInit AFTER the singleton is installed, so @init_func hooks that
        # use this module API configure THIS engine.
        from sentinel_tpu_torch.core.spi import run_init_funcs

        run_init_funcs()
    return _default_engine


def reset(capacity: int = 4096, device=None) -> SentinelEngine:
    """Close the default engine and build a new one (tests, the smoke)."""
    global _default_engine
    had_engine = _default_engine is not None
    if had_engine:
        _default_engine.close()
    _default_engine = SentinelEngine(capacity, device=device)
    if had_engine:
        # Surviving contexts (on ANY thread) hold row ids of the dead
        # engine's registry; the stamp invalidates them all. Bump AFTER
        # installing the new engine: a context created through the old
        # engine mid-reset must carry a pre-bump stamp.
        from sentinel_tpu_torch.core.context import bump_generation

        bump_generation()
    from sentinel_tpu_torch.core.spi import run_init_funcs

    run_init_funcs()
    return _default_engine


def entry(resource: str, entry_type: int = EntryType.OUT, count: int = 1,
          args: Sequence = (), prioritized: bool = False) -> EntryHandle:
    """``SphU.entry``: raises a BlockException subclass when rejected."""
    return get_engine().entry(resource, entry_type, count, args, prioritized)


def entry_ok(resource: str, entry_type: int = EntryType.OUT, count: int = 1,
             args: Sequence = ()) -> Optional[EntryHandle]:
    """``SphO.entry``: boolean variant, None instead of an exception."""
    try:
        return get_engine().entry(resource, entry_type, count, args)
    except BlockException:
        return None


def trace(ex: BaseException) -> None:
    """``Tracer.trace``: record a business exception on the current entry."""
    ctx = get_context()
    if ctx is not None and ctx.cur_entry is not None:
        ctx.cur_entry.trace(ex)


_ops_plane = None


def init_ops_plane(port: Optional[int] = None):
    """Boot the ops plane (reference: ``InitExecutor.doInit``, SURVEY.md
    §3.4): the command HTTP server, the heartbeat (when a dashboard is
    configured) and the 1 Hz metric log timer. Idempotent; returns the
    started parts. ``port=0`` binds an ephemeral port (``command_center.
    bound_port``); None reads ``csp.sentinel.api.port`` (8719).
    """
    global _ops_plane
    if _ops_plane is not None:
        return _ops_plane
    from sentinel_tpu_torch.core.config import config as _config
    from sentinel_tpu_torch.metrics.timer import MetricTimerListener
    from sentinel_tpu_torch.transport.command_center import CommandCenter
    from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

    get_engine()
    # No explicit engine: both follow the live default engine so a later
    # reset() doesn't leave the ops plane serving a dead one.
    center = CommandCenter(port=port).start()
    timer = MetricTimerListener().start()
    heartbeat = None
    if _config.dashboard_server():
        heartbeat = HeartbeatSender(api_port=center.bound_port).start()
    _ops_plane = {"command_center": center, "metric_timer": timer,
                  "heartbeat": heartbeat}
    return _ops_plane


def shutdown_ops_plane() -> None:
    """Stop what :func:`init_ops_plane` started and join its threads."""
    global _ops_plane
    if _ops_plane is None:
        return
    parts, _ops_plane = _ops_plane, None
    parts["command_center"].stop()
    parts["metric_timer"].stop()
    if parts["heartbeat"] is not None:
        parts["heartbeat"].stop()


def load_flow_rules(rules) -> None:
    get_engine().flow_rules.load_rules(list(rules))


def load_degrade_rules(rules) -> None:
    get_engine().degrade_rules.load_rules(list(rules))


def load_authority_rules(rules) -> None:
    get_engine().authority_rules.load_rules(list(rules))


def load_system_rules(rules) -> None:
    get_engine().system_rules.load_rules(list(rules))


def load_param_flow_rules(rules) -> None:
    get_engine().param_rules.load_rules(list(rules))


def load_tps_rules(rules) -> None:
    get_engine().tps_rules.load_rules(list(rules))


__all__ = [
    "AuthorityException", "AuthorityRule", "BlockException", "BlockReason",
    "CheckpointTimer", "restore_checkpoint", "save_checkpoint",
    "DegradeException", "DegradeRule", "DeviceDispatchError", "EntryHandle",
    "EntryInfo", "EntryType", "FlowException", "FlowRule", "MetricEvent",
    "ParamFlowException", "ParamFlowItem", "ParamFlowRule", "ProcessorSlot",
    "ResourceType", "SentinelEngine", "SystemBlockException", "SystemRule",
    "TpsRule", "constants", "context_enter", "entry", "entry_ok",
    "exit_context", "get_context", "get_engine", "init_func",
    "init_ops_plane", "load_authority_rules", "load_degrade_rules", "load_flow_rules",
    "load_param_flow_rules", "load_system_rules", "load_tps_rules",
    "register_device_checker", "register_slot", "reset", "resilience",
    "shutdown_ops_plane", "trace", "unregister_device_checker",
    "unregister_slot",
]
