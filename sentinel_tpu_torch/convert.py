"""Carry rule packs and step state across from numpy.

The JAX package's ``RulePack`` and ``SentinelState`` are pytrees of
NamedTuples; flattened to nested dicts of numpy arrays (field name ->
array or sub-dict) they load into this package's NamedTuples of the same
field names. uint32 arrays (param value hashes, owner keys) become int64
holding the same values; every other dtype is kept. The flight-recorder
ring (``flight``) and the staged-rollout shadow world (``shadow``, with
its window, flow, param and degrade state) carry both ways, and each
stays ``None`` when the dict has none (a flattened JAX state drops its
``None`` fields).

Pod states (``parallel/``: every leaf with a leading ``[D]`` shard axis,
or ``[S, P]`` for the two-axis pod) carry the same way, leaf shapes kept,
so the reference's pod tree loads into the port's pod drivers and back.

A token service's compiled rule tensors (``ClusterRuleTensors``) and its
window state (``ClusterMetricState``) carry the same way, so a test can
hand the JAX service's state to the port (:func:`cluster_from_numpy`)
and compare the two after each batch (:func:`state_to_numpy`).

Checkpoints do not travel through this module: both packages write and
read the same ``.npz`` files (``core/checkpoint.py``).

This module sees only numpy: it imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from sentinel_tpu_torch.cluster.rules import (
    ClusterMetricState, ClusterRuleTensors)
from sentinel_tpu_torch.models import authority as A
from sentinel_tpu_torch.models import degrade as D
from sentinel_tpu_torch.models import flow as F
from sentinel_tpu_torch.models import param_flow as P
from sentinel_tpu_torch.models import system as Y
from sentinel_tpu_torch.ops import step as S
from sentinel_tpu_torch.ops import window as W

# Nested NamedTuple types by (parent type, field).
_NESTED = {
    S.RulePack: {"flow": F.FlowRuleTensors, "degrade": D.DegradeRuleTensors,
                 "authority": A.AuthorityRuleTensors,
                 "system": Y.SystemRuleTensors, "param": P.ParamRuleTensors},
    S.SentinelState: {"w1": W.Window, "w60": W.Window, "flow": F.FlowState,
                      "degrade": D.DegradeState, "param": P.ParamFlowState,
                      "sec": S.SecondAccum, "telemetry": S.TelemetryState,
                      "shadow": S.ShadowState, "flight": S.FlightRecorder},
    S.ShadowState: {"w1": W.Window, "flow": F.FlowState,
                    "param": P.ParamFlowState, "degrade": D.DegradeState},
    D.DegradeState: {"win": W.RowWindow},
    ClusterMetricState: {"win": W.RowWindow},
}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def tree_from_numpy(cls, d: Dict[str, Any], device):
    """Nested numpy dict -> the NamedTuple ``cls`` (nested types from
    ``_NESTED``) with tensors on ``device``."""
    device = torch.device(device)
    nested = _NESTED.get(cls, {})
    kw = {}
    for name in cls._fields:
        if name not in d and name in cls._field_defaults:
            kw[name] = cls._field_defaults[name]  # an optional part, absent
        elif name in nested:
            kw[name] = tree_from_numpy(nested[name], d[name], device)
        else:
            kw[name] = _tensor(d[name], device)
    return cls(**kw)


def rules_from_numpy(d: Dict[str, Any], device) -> S.RulePack:
    """Nested numpy dict of a JAX ``RulePack`` -> this package's pack."""
    return tree_from_numpy(S.RulePack, d, device)


def state_from_numpy(d: Dict[str, Any], device) -> S.SentinelState:
    """Nested numpy dict of a JAX ``SentinelState`` -> this package's
    state."""
    return tree_from_numpy(S.SentinelState, d, device)


def cluster_from_numpy(rules: Dict[str, Any], state: Dict[str, Any],
                       device):
    """Nested numpy dicts of a JAX token service's ``ClusterRuleTensors``
    and ``ClusterMetricState`` -> this package's, on ``device``."""
    return (tree_from_numpy(ClusterRuleTensors, rules, device),
            tree_from_numpy(ClusterMetricState, state, device))


def state_to_numpy(state) -> Dict[str, Any]:
    """This package's state (or any NamedTuple of tensors) -> nested dict
    of numpy arrays; ``None`` fields are dropped. The arrays are copies:
    on the CPU a tensor's numpy view would follow the next step's
    in-place updates."""
    out = {}
    for name, v in state._asdict().items():
        if v is None:
            continue
        if isinstance(v, tuple) and hasattr(v, "_asdict"):
            out[name] = state_to_numpy(v)
        else:
            out[name] = v.detach().cpu().numpy().copy()
    return out
