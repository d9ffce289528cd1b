"""Cluster flow control (port of ``sentinel_tpu/cluster/``; reference:
``sentinel-cluster/`` — SURVEY.md §2.4, §2.11, §3.3): a token server
owning global sliding windows so N instances share one quota, a
binary-TLV TCP wire protocol, a token client with reconnect, breaker and local fallback,
and namespace-scoped cluster rule management.

The token server batches acquire requests from remote clients into one
device step over a ``[flow_rules, buckets, events]`` window tensor; its
serial admission is the hand-written kernel of ``ops/cluster_acquire.py``
on a card. The client side plugs into the engine's flow checker with the
reference's ``fallbackToLocalOrPass`` semantics.

``ha.py`` drives a seat's role from cluster and shard maps (failover,
epoch fencing, cluster checkpoints), ``sharding.py`` partitions the flowId
space into hash slices, and ``rebalance.py`` governs slice placement.
``__main__.py`` is the standalone token server and HA participant
(``python -m sentinel_tpu_torch.cluster``).
"""

from sentinel_tpu_torch.cluster.constants import (
    ClusterFlowEvent,
    MSG_FLOW,
    MSG_PARAM_FLOW,
    MSG_PING,
    THRESHOLD_AVG_LOCAL,
    THRESHOLD_GLOBAL,
    TokenResultStatus,
)
from sentinel_tpu_torch.cluster.rules import ClusterFlowRuleManager
from sentinel_tpu_torch.cluster.token_service import (
    DefaultTokenService,
    TokenResult,
)
from sentinel_tpu_torch.cluster.client import ClusterTokenClient
from sentinel_tpu_torch.cluster.server import ClusterTokenServer
from sentinel_tpu_torch.cluster.state import ClusterStateManager, EpochFence
from sentinel_tpu_torch.cluster.ha import (
    ClusterHAManager,
    ClusterMap,
    ClusterServerSpec,
    DegradedQuota,
    FailoverTokenClient,
)

__all__ = [
    "ClusterFlowEvent", "ClusterFlowRuleManager", "ClusterHAManager",
    "ClusterMap", "ClusterServerSpec", "ClusterStateManager",
    "ClusterTokenClient", "ClusterTokenServer", "DefaultTokenService",
    "DegradedQuota", "EpochFence", "FailoverTokenClient", "MSG_FLOW",
    "MSG_PARAM_FLOW", "MSG_PING", "THRESHOLD_AVG_LOCAL", "THRESHOLD_GLOBAL",
    "TokenResult", "TokenResultStatus",
]
