"""The simulator (port of ``sentinel_tpu/simulator/``), so far only its
program-advanced clock, :class:`~sentinel_tpu_torch.simulator.clock.
SimClock`, which the chaos campaign and the shard rebalancer's
certification ride. The trace format, the scenarios, the replay engine
and the policy lab are not ported yet.
"""

from sentinel_tpu_torch.simulator.clock import SimClock

__all__ = ["SimClock"]
