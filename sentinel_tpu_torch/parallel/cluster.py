"""Pod-as-one-rate-limiter (port of ``sentinel_tpu/parallel/cluster.py``).

Each shard of the pod holds a full-capacity replica of the stats tensors
carrying its OWN admitted traffic, and the request stream is sharded over
the shards. Cluster-mode flow and param rules admit against the
pod-global window: every step sums each shard's pass counts, next-window
use and param sketch over the pod, and each shard admits against the
other shards' part (the sum less its own). Everything else stays per
shard: local rules, system and authority rules, the breakers (the
reference's breakers are per instance), telemetry and the flight ring.

Exactness: within one step a shard sees the others' counts as of the
step start, so overshoot is bounded by (shards - 1) x the largest
per-shard admission in one step for one rule (``docs/SEMANTICS.md``);
the step after, admission stops pod-wide.

The reference is one program under ``shard_map`` with a ``psum`` over the
mesh axis. Here one per-shard body is split around the reduction:

1. :func:`prepare` (per shard) rotates ``w1``, rolls the param sketch
   windows (``cluster_param``) and a candidate's shadow window and
   sketch, and yields the shard's :class:`Contribution`;
2. the reduction sums every shard's contribution;
3. :func:`finish` (per shard) runs ``entry_step`` with each extra taken
   as total - own, the reference's ``psum(x) - x``.

Two drivers call that body, so they agree bit for bit:

* :func:`make_pod_steps` — one process. The pod state has the JAX
  layout, every leaf with a leading ``[D]`` shard axis on one device
  (:func:`make_pod_state`); the batch is ``[D * B]``, lanes
  ``d*B:(d+1)*B`` going to shard ``d``; the reduction is a sum over the
  shards on the device. This is the tree the global reads and the pod
  checkpoints take.
* :func:`make_dist_pod_steps` — one process per shard (one per GPU). It
  steps a plain per-shard state with that shard's batch; the reduction is
  ``torch.distributed.all_reduce(SUM)`` over the group: NCCL on CUDA,
  gloo on the CPU. NCCL has run at world size 1 only (one GPU); between
  two or more GPUs it is unverified.

The reduction moves 2 x R int32 (pass counts, next-window use), plus the
``[PR, 4, 2048]`` float32 sketch with ``cluster_param``, plus the shadow
twins with a candidate. The int32 sums are exact; the sketch cells hold
whole acquire counts, so their float32 sums and differences are exact (in
any order) while the cells stay below 2**24.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import Decisions
from sentinel_tpu_torch.models import param_flow as P
from sentinel_tpu_torch.ops import step as S
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.utils.device import resolve_device
from sentinel_tpu_torch.utils.tree import tree_leaves, tree_map

AXIS = "pod"


class Contribution(NamedTuple):
    """What one shard adds to the pod's reduction."""

    passes: torch.Tensor                          # int32[R] PASS in w1
    next_use: torch.Tensor                        # int32[R] next-window use
    cms: Optional[torch.Tensor] = None            # f32[PR, D, W] sketch
    shadow_passes: Optional[torch.Tensor] = None  # int32[R] candidate's PASS
    shadow_cms: Optional[torch.Tensor] = None     # f32 candidate's sketch


# ---------------------------------------------------------------------------
# Shards of the pod tree
# ---------------------------------------------------------------------------


def shard(tree, index):
    """The shard at ``index`` (an int, or a tuple for ``[S, P]`` pods):
    views into the pod's tensors, so in-place updates reach the pod."""
    return tree_map(lambda x: x[index], tree)


def write_back(views, new) -> None:
    """Copy each leaf of ``new`` into the matching view of the pod, unless
    the step updated that view in place (it is the same memory)."""
    for v, n in zip(tree_leaves(views), tree_leaves(new), strict=True):
        if v.data_ptr() != n.data_ptr():
            v.copy_(n)


def make_pod_state(n_shards: int, one: S.SentinelState) -> S.SentinelState:
    """Every leaf of ``one`` (a fresh single-shard state whose geometry
    matches the rule pack) copied to a leading ``[n_shards]`` axis."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((n_shards,) + tuple(x.shape))
        .contiguous(), one)


# ---------------------------------------------------------------------------
# The per-shard body
# ---------------------------------------------------------------------------


def pass_counts(w1: W.Window) -> torch.Tensor:
    """int32[R]: PASS over a rotated window."""
    return w1.counts[:, C.MetricEvent.PASS, :].sum(dim=0, dtype=torch.int32)


def next_window_use(w1: W.Window, occupied_next: torch.Tensor,
                    now_ms: int) -> torch.Tensor:
    """int32[R]: the shard's NEXT-window use: its window PASS less the
    bucket about to expire, plus its pending occupy borrows. Summed over
    the pod, prioritized occupy grants admit against the pod-global next
    window (else every shard would lend up to the threshold)."""
    spec = S.SPEC_1S
    oldest = (W.current_index(now_ms, spec) + 1) % spec.buckets
    return (pass_counts(w1) - w1.counts[oldest, C.MetricEvent.PASS, :]
            + occupied_next)


def prepare(local: S.SentinelState, rules: S.RulePack, now_ms: int, *,
            cluster_param: bool, shadow_rules: Optional[S.RulePack] = None,
            ) -> Tuple[S.SentinelState, Contribution]:
    """Before the reduction: ``local`` with ``w1`` (and a candidate's
    shadow ``w1``) rotated to ``now_ms`` and, with ``cluster_param``, the
    param sketches rolled IN PLACE, every shard at the same per-rule
    boundary (a stale window in the sum would zero the first step of each
    fresh window); and the shard's contribution."""
    now_ms = int(now_ms)
    w1 = W.rotate(local.w1, now_ms, S.SPEC_1S)
    local = local._replace(w1=w1)
    cms = sh_passes = sh_cms = None
    if cluster_param:
        P.roll_sketch_windows(rules.param, local.param, now_ms, lazy=False)
        cms = local.param.cms
    if shadow_rules is not None and local.shadow is not None:
        # The candidate's cluster-mode rules admit against the pod-global
        # shadow window, so its would-verdicts are pod-exact too.
        sh_w1 = W.rotate(local.shadow.w1, now_ms, S.SPEC_1S)
        local = local._replace(shadow=local.shadow._replace(w1=sh_w1))
        sh_passes = pass_counts(sh_w1)
        if cluster_param:
            P.roll_sketch_windows(shadow_rules.param, local.shadow.param,
                                  now_ms, lazy=False)
            sh_cms = local.shadow.param.cms
    return local, Contribution(
        passes=pass_counts(w1),
        next_use=next_window_use(w1, local.occupied_next, now_ms),
        cms=cms, shadow_passes=sh_passes, shadow_cms=sh_cms)


def _less(total: Optional[torch.Tensor], own: Optional[torch.Tensor]):
    return None if total is None else total - own


def finish(local: S.SentinelState, rules: S.RulePack, batch, now_ms: int,
           own: Contribution, total: Contribution, *,
           global_total: Optional[Contribution] = None,
           extra_checkers: Sequence[Callable] = (),
           occupy_timeout_ms: int = C.DEFAULT_OCCUPY_TIMEOUT_MS,
           shadow_rules: Optional[S.RulePack] = None,
           canary_bps: Optional[int] = None,
           canary_salt: Optional[int] = None,
           ) -> Tuple[S.SentinelState, Decisions]:
    """After the reduction: the shard's ``entry_step`` with the other
    shards' part of each sum (``total - own``). ``global_total`` (the
    two-axis pod) gives scope="global" rules their cross-slice twins.
    ``local`` carries the rotated window through, so the step's own
    rotation finds it current."""
    return S.entry_step(
        local, rules, batch, now_ms, occupy_timeout_ms=occupy_timeout_ms,
        extra_checkers=extra_checkers, shadow_rules=shadow_rules,
        canary_bps=canary_bps, canary_salt=canary_salt,
        extra_pass=total.passes - own.passes,
        extra_next=total.next_use - own.next_use,
        extra_cms=_less(total.cms, own.cms),
        extra_pass_global=(None if global_total is None
                           else global_total.passes - own.passes),
        extra_next_global=(None if global_total is None
                           else global_total.next_use - own.next_use),
        shadow_extra_pass=_less(total.shadow_passes, own.shadow_passes),
        shadow_extra_cms=_less(total.shadow_cms, own.shadow_cms))


# ---------------------------------------------------------------------------
# The reductions
# ---------------------------------------------------------------------------


def sum_contributions(contribs: Sequence[Contribution]) -> Contribution:
    """The pod's sum of the shards' contributions, on their device, in
    shard order (new tensors; the inputs may be views of the pod)."""
    def add(*xs):
        if xs[0] is None:
            return None
        out = xs[0].clone()
        for x in xs[1:]:
            out += x
        return out

    return Contribution(*(add(*(getattr(c, f) for c in contribs))
                          for f in Contribution._fields))


def contribution_bytes(c: Contribution) -> int:
    """Bytes one shard puts into the reduction."""
    return sum(x.numel() * x.element_size() for x in c if x is not None)


def _all_reduce(parts: List[Optional[torch.Tensor]], group) -> list:
    """``all_reduce(SUM)`` of the given tensors over ``group``: one call
    for the int32 vectors and one for the float32 sketches, each packed
    flat. ``None`` entries stay ``None``."""
    import torch.distributed as dist

    out: list = [None] * len(parts)
    for dtype in (torch.int32, torch.float32):
        idx = [i for i, x in enumerate(parts)
               if x is not None and x.dtype == dtype]
        if not idx:
            continue
        flat = torch.cat([parts[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for i in idx:
            n = parts[i].numel()
            out[i] = flat[off:off + n].view(parts[i].shape)
            off += n
    return out


def all_reduce_contribution(c: Contribution, group=None) -> Contribution:
    """The pod's sum of ``c`` over a ``torch.distributed`` group."""
    return Contribution(*_all_reduce(list(c), group))


def check_backend(group, device: torch.device) -> None:
    """NCCL reduces CUDA tensors and gloo CPU ones here; anything else is
    refused up front rather than inside the first collective."""
    import torch.distributed as dist

    backend = str(dist.get_backend(group)).lower()
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"a pod on {device.type} reduces over {want}, "
                         f"not {backend}")


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------


def _lane_slices(batch, n: int) -> list:
    width = batch.size
    if width % n:
        raise ValueError(f"batch width {width} is not a multiple of the "
                         f"{n} shards")
    b = width // n
    return [tree_map(lambda x: x[d * b:(d + 1) * b], batch)
            for d in range(n)]


def cat_decisions(decs: Sequence[Decisions]) -> Decisions:
    return Decisions(*(torch.cat([getattr(d, f) for d in decs])
                       for f in Decisions._fields))


def _on(tree, device: torch.device) -> None:
    dev = tree.cur_threads.device
    if dev.type != device.type:
        raise ValueError(f"the pod steps were built for {device}, the "
                         f"state is on {dev}")


def make_pod_steps(device=None, cluster_param: bool = True,
                   occupy_timeout_ms: int = C.DEFAULT_OCCUPY_TIMEOUT_MS,
                   shadow_rules: Optional[S.RulePack] = None,
                   canary_bps: Optional[int] = None,
                   canary_salt: Optional[int] = None):
    """``(entry_step, exit_step)`` over a one-process pod on ``device``
    (``cuda`` unless the caller passes another).

    ``entry_step(pod, rules, batch, now_ms) -> (pod, decisions)`` and
    ``exit_step(pod, rules, batch, now_ms) -> pod`` step every shard of a
    :func:`make_pod_state` tree in place (the returned tree is ``pod``);
    the batch is ``[D * B]`` and the decisions come back in lane order.

    ``cluster_param=False`` drops the sketch from the reduction (a pod
    with no cluster-mode param rules), as in the reference. The SPI device
    checkers registered now are spliced into every shard's step; later
    registrations need fresh steps. ``shadow_rules`` / ``canary_bps`` /
    ``canary_salt`` stage a candidate pod-wide: the pod state must carry
    a shadow world (``S.make_shadow_state`` copied by
    :func:`make_pod_state`), and the candidate's cluster-mode rules admit
    against the pod-global shadow window and sketch."""
    from sentinel_tpu_torch.core import spi

    device = resolve_device(device)
    opts = dict(extra_checkers=spi.device_checkers(),
                occupy_timeout_ms=occupy_timeout_ms,
                shadow_rules=shadow_rules, canary_bps=canary_bps,
                canary_salt=canary_salt)

    def entry(pod: S.SentinelState, rules: S.RulePack, batch, now_ms):
        _on(pod, device)
        n = pod.cur_threads.shape[0]
        lanes = _lane_slices(batch, n)
        prepared = [prepare(shard(pod, d), rules, now_ms,
                            cluster_param=cluster_param,
                            shadow_rules=shadow_rules) for d in range(n)]
        total = sum_contributions([c for _, c in prepared])
        decs = []
        for d, (local, own) in enumerate(prepared):
            new, dec = finish(local, rules, lanes[d], now_ms, own, total,
                              **opts)
            write_back(shard(pod, d), new)
            decs.append(dec)
        return pod, cat_decisions(decs)

    def exit_(pod: S.SentinelState, rules: S.RulePack, batch, now_ms):
        _on(pod, device)
        n = pod.cur_threads.shape[0]
        for d, lane in enumerate(_lane_slices(batch, n)):
            write_back(shard(pod, d), S.exit_step(
                shard(pod, d), rules, lane, now_ms,
                shadow_rules=shadow_rules))
        return pod

    return entry, exit_


def make_dist_pod_steps(group=None, device=None, cluster_param: bool = True,
                        occupy_timeout_ms: int = C.DEFAULT_OCCUPY_TIMEOUT_MS,
                        shadow_rules: Optional[S.RulePack] = None,
                        canary_bps: Optional[int] = None,
                        canary_salt: Optional[int] = None):
    """``(entry_step, exit_step)`` for one shard of a pod whose shards are
    the processes of ``group`` (the default group when None), one per
    device; ``device`` defaults to ``cuda``.

    ``entry_step(state, rules, batch, now_ms) -> (state, decisions)``
    steps this shard's plain ``SentinelState`` (consumed, as
    ``entry_step`` consumes it) with this shard's batch; every process of
    the group must step together. Options as :func:`make_pod_steps`."""
    from sentinel_tpu_torch.core import spi

    device = resolve_device(device)
    check_backend(group, device)
    opts = dict(extra_checkers=spi.device_checkers(),
                occupy_timeout_ms=occupy_timeout_ms,
                shadow_rules=shadow_rules, canary_bps=canary_bps,
                canary_salt=canary_salt)

    def entry(state: S.SentinelState, rules: S.RulePack, batch, now_ms):
        _on(state, device)
        local, own = prepare(state, rules, now_ms,
                             cluster_param=cluster_param,
                             shadow_rules=shadow_rules)
        total = all_reduce_contribution(own, group)
        return finish(local, rules, batch, now_ms, own, total, **opts)

    def exit_(state: S.SentinelState, rules: S.RulePack, batch, now_ms):
        _on(state, device)
        return S.exit_step(state, rules, batch, now_ms,
                           shadow_rules=shadow_rules)

    return entry, exit_


# ---------------------------------------------------------------------------
# Pod-global reads of a [D, ...] pod state
# ---------------------------------------------------------------------------


def global_pass_counts(w1: W.Window) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(extra[D, R], local[D, R])`` of a pod's rotated ``[D, ...]``
    window: each shard's PASS and the other shards' part of the sum."""
    local = w1.counts[:, :, C.MetricEvent.PASS, :].sum(dim=1,
                                                       dtype=torch.int32)
    return local.sum(dim=0, dtype=torch.int32) - local, local


def global_next_window(w1: W.Window, occupied_next: torch.Tensor,
                       now_ms: int) -> torch.Tensor:
    """extra[D, R]: the other shards' next-window use, from a pod's
    rotated ``[D, ...]`` window and ``[D, R]`` borrows."""
    local = torch.stack([next_window_use(shard(w1, d), occupied_next[d],
                                         now_ms)
                         for d in range(occupied_next.shape[0])])
    return local.sum(dim=0, dtype=torch.int32) - local


def global_shadow_counts(state: S.SentinelState) -> Optional[torch.Tensor]:
    """Pod-global rollout counters: the shadow counter tensor summed over
    the shard axis (each shard counted only its own lanes)."""
    if state.shadow is None:
        return None
    return state.shadow.counts.sum(dim=0)


def global_telemetry_counts(state: S.SentinelState) -> S.TelemetryState:
    """Pod-global decision attribution, RT histograms and totals: each
    shard attributed only its own lanes, so the pod view is the sum over
    the shard axis, with the live staged second folded in
    (``S.telemetry_view``), so the read is exact at any instant."""
    return tree_map(lambda x: x.sum(dim=0), S.telemetry_view(state))


def global_flight_recorder(state: S.SentinelState
                           ) -> Optional[S.FlightRecorder]:
    """Pod-global flight ring: the stamps are clock-derived and equal on
    every shard, so the per-second deltas are the sums over the shard
    axis. None when recording is off."""
    fl = state.flight
    if fl is None:
        return None
    return S.FlightRecorder(
        stamps=fl.stamps[0], events=fl.events.sum(dim=0),
        attr=fl.attr.sum(dim=0), hist=fl.hist.sum(dim=0),
        slot_attr=fl.slot_attr.sum(dim=0))
