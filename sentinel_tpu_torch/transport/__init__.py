"""Ops transport plane (port of ``sentinel_tpu/transport/``; reference:
``sentinel-transport/``, SURVEY.md §2.3):
an embedded HTTP command center for remote rule CRUD + metric scraping, and
a heartbeat sender registering with the dashboard.
"""

from sentinel_tpu_torch.transport.aio_command_center import AsyncCommandCenter
from sentinel_tpu_torch.transport.command_center import (
    CommandCenter,
    CommandRequest,
    CommandResponse,
    command_mapping,
)
from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

__all__ = [
    "AsyncCommandCenter", "CommandCenter", "CommandRequest",
    "CommandResponse", "HeartbeatSender", "command_mapping",
]
