"""The sentinel-tpu dashboard (port of ``sentinel_tpu/dashboard/``;
reference: ``sentinel-dashboard``, SURVEY.md §2.6): machine discovery
from heartbeats, a metrics poller + 5-minute in-memory repository, rule
CRUD pushed through each engine's command port, cluster token-server
assignment, and a single-page live UI. The dashboard touches no tensor:
the engines it manages run on the card and answer over HTTP.

Run standalone::

    python -m sentinel_tpu_torch.dashboard --port 8080

then point engines at it with ``csp.sentinel.dashboard.server=host:8080``.
"""

from sentinel_tpu_torch.dashboard.auth import AuthService, AuthUser
from sentinel_tpu_torch.dashboard.client import ApiError, SentinelApiClient
from sentinel_tpu_torch.dashboard.discovery import AppManagement, MachineInfo
from sentinel_tpu_torch.dashboard.metrics import InMemoryMetricsRepository, MetricFetcher
from sentinel_tpu_torch.dashboard.server import DashboardServer

__all__ = [
    "ApiError",
    "AppManagement",
    "AuthService",
    "AuthUser",
    "DashboardServer",
    "InMemoryMetricsRepository",
    "MachineInfo",
    "MetricFetcher",
    "SentinelApiClient",
]
