"""Block exceptions — the typed rejection surface.

Reference: ``core:slots/block/BlockException.java`` and its subclasses
(FlowException, DegradeException, SystemBlockException, AuthorityException,
ParamFlowException) — SURVEY.md §2.1. Semantics preserved: a blocked entry
raises one of these; everything else (user errors) is traced, never treated
as a block.
"""

from __future__ import annotations

from sentinel_tpu_torch.core.constants import BlockReason


class BlockException(Exception):
    """Base class for every traffic-governance rejection."""

    def __init__(self, resource: str = "", rule=None, limit_app: str = ""):
        super().__init__(f"blocked: {resource}")
        self.resource = resource
        self.rule = rule
        self.limit_app = limit_app

    @staticmethod
    def is_block_exception(ex: BaseException) -> bool:
        return isinstance(ex, BlockException)


class FlowException(BlockException):
    pass


class DegradeException(BlockException):
    pass


class SystemBlockException(BlockException):
    def __init__(self, resource: str = "", limit_type: str = "", rule=None):
        super().__init__(resource, rule)
        self.limit_type = limit_type


class AuthorityException(BlockException):
    pass


class ParamFlowException(BlockException):
    pass


class ClusterFallbackException(BlockException):
    """Raised internally when a cluster check fails and fallback is off."""


_REASON_TO_EXC = {
    BlockReason.FLOW: FlowException,
    BlockReason.DEGRADE: DegradeException,
    BlockReason.SYSTEM: SystemBlockException,
    BlockReason.AUTHORITY: AuthorityException,
    BlockReason.PARAM_FLOW: ParamFlowException,
}


def exception_for_reason(reason: int, resource: str, rule=None) -> BlockException:
    cls = _REASON_TO_EXC.get(BlockReason(int(reason)), BlockException)
    if cls is SystemBlockException:
        return SystemBlockException(resource, rule=rule)
    return cls(resource, rule=rule)


def reason_for_exception(ex: BlockException) -> int:
    """Inverse of ``exception_for_reason`` — the wire code the M4 bridge
    sends so a JVM can re-raise the matching BlockException subclass.
    Unmapped subclasses (e.g. an SPI slot's custom type) report CUSTOM."""
    for reason, cls in _REASON_TO_EXC.items():
        if type(ex) is cls:
            return int(reason)
    return int(BlockReason.CUSTOM)
