"""The replay engine: a real ``SentinelEngine`` on a program clock (port of
``sentinel_tpu/simulator/replay.py``).

Verdicts are produced by the PRODUCTION step — each simulated second's
demand is expanded into entry-batch rows and driven through
``engine.check_batch`` (the same fused step live traffic rides; on the
card, with its segmented-prefix kernel), exits through
``engine.complete_batch``, with ``now`` always the injected
:class:`~sentinel_tpu_torch.simulator.clock.SimClock`. The once-per-second
flight-recorder fold, SLO judgement, rollout guardrail windows, and the
adaptive loop all run in-sim unmodified, riding the same
``_spill_flight`` cadence they ride live — just at whatever wall speed
the host can step.

Determinism by construction: one clock (never wall), one fixed demand
expansion order (sorted resources, trace pair order), one fixed batch
chunking, exits drained before entries each second (the production
cycle order), and the only async machinery (trace-ring sampling) torn
down at engine birth. Two runs of the same trace produce bit-identical
verdict streams and identical adaptive decision logs; and the same trace
gives the same verdict sha on the card, on the CPU and in the JAX
package.

Device: ``ReplayEngine(device=None)`` builds its engine on ``cuda`` and
raises with no card; ``device="cpu"`` runs the plain CPU path. Nothing
on the replay path falls back to the CPU.

The retry-storm closed loop (``trace.meta["retry"]``) is the one
feedback edge recorded traces cannot carry: blocked entries re-offer
after a backoff at a decay factor, so admission decisions feed back
into future demand exactly like impatient clients do.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional

import numpy as np

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import (
    BATCH_WIDTHS,
    make_entry_batch_np,
    make_exit_batch_np,
)
from sentinel_tpu_torch.simulator.clock import SimClock
from sentinel_tpu_torch.simulator.trace import Trace
from sentinel_tpu_torch.telemetry.attribution import (
    NUM_RT_BUCKETS,
    RT_BUCKET_EDGES_MS,
    histogram_quantile,
)
from sentinel_tpu_torch.utils.device import resolve_device, to_host

# Smallest int rt landing in each device histogram bucket (bucket b
# counts rt in (edge[b-1], edge[b]]): replaying a recorded bucket with
# its representative re-buckets identically on device, so a recorded RT
# histogram round-trips bit-exact.
_RT_REP = tuple(RT_BUCKET_EDGES_MS) + (RT_BUCKET_EDGES_MS[-1] + 1,)

_SIM_CONTEXT = "sim"

# Drill-speed adaptive knobs for in-sim closed-loop runs; override per
# key via ReplayEngine(adaptive={...}). Real-time defaults would spend
# most of a short scenario soaking.
DEFAULT_ADAPTIVE_KNOBS = {
    "intervalS": 2, "shadowS": 2, "canaryS": 2, "canaryBps": 2000,
    "cooldownS": 4, "stepPct": 0.5, "backoffS": 20, "minWindowEntries": 8,
}


def _pad_width(n: int, cap: int) -> int:
    for w in BATCH_WIDTHS:
        if w >= n and w <= cap:
            return w
    return cap


def _rt_bucket(rt_ms: int) -> int:
    b = 0
    for edge in RT_BUCKET_EDGES_MS:
        if rt_ms > edge:
            b += 1
    return b


class ReplayResult:
    """Everything one replay run observed, host-side and exact."""

    __slots__ = ("trace_meta", "seconds", "offered", "passed", "blocked",
                 "retried", "verdict_sha256", "series", "rt_hist",
                 "decisions", "counters", "final_counts", "band_violations",
                 "journal", "streams", "population", "replay_wall_s",
                 "total_wall_s")

    def __init__(self):
        self.trace_meta: Dict = {}
        self.seconds = 0
        self.offered = 0      # demand tokens offered (incl. retries)
        self.passed = 0       # tokens admitted
        self.blocked = 0      # tokens blocked
        self.retried = 0      # tokens re-offered by the retry model
        self.verdict_sha256 = ""
        self.series: List[Dict] = []   # per second: t / pass / block maps
        self.rt_hist = [0] * NUM_RT_BUCKETS
        self.decisions: List[Dict] = []  # adaptive decision log
        self.counters: Dict = {}         # adaptive monotone counters
        self.final_counts: Dict[str, float] = {}  # tunable rule counts
        self.band_violations = 0
        # The sim engine's control-plane audit journal: memory-only
        # (never file-backed — see _build_engine), stamped in SIMULATED
        # time, so two runs of one trace+seed produce identical record
        # streams — the journal-determinism oracle.
        self.journal: List[Dict] = []
        # Streamed-generation outcomes: what the trace's "g" events did
        # to the host-side reservation ledger. Empty unless the scenario
        # carries streams.
        self.streams: Dict[str, int] = {}
        # Namespace-telescope output: the sealed churn-window
        # series plus the final top-k — folded at SIMULATED time on the
        # same spill cadence as judgement, so two runs of one trace+seed
        # produce identical population series (the determinism oracle).
        self.population: Dict = {}
        # Wall timing (perf_counter, the one wall read in this package —
        # it measures speed, it never drives replay): replay_wall_s
        # covers the second loop only (steady state); total_wall_s adds
        # engine build + rule compile + optional warmup.
        self.replay_wall_s = 0.0
        self.total_wall_s = 0.0

    @property
    def block_rate(self) -> float:
        total = self.passed + self.blocked
        return self.blocked / total if total else 0.0

    @property
    def utilization(self) -> float:
        """Admitted fraction of offered demand (goodput ratio)."""
        return self.passed / self.offered if self.offered else 0.0

    @property
    def rt_p99_ms(self) -> float:
        if not sum(self.rt_hist):
            return 0.0
        return float(histogram_quantile(self.rt_hist, 0.99))

    def objective_vector(self) -> Dict[str, float]:
        """The multi-objective score surface (block-rate, RT-p99,
        utilization) the policy lab ranks on."""
        return {"blockRate": round(self.block_rate, 6),
                "rtP99Ms": round(self.rt_p99_ms, 2),
                "utilization": round(self.utilization, 6)}

    def to_dict(self) -> Dict:
        return {
            "seconds": self.seconds,
            "offered": self.offered, "passed": self.passed,
            "blocked": self.blocked, "retried": self.retried,
            "verdictSha256": self.verdict_sha256,
            "objective": self.objective_vector(),
            "counters": self.counters,
            "finalCounts": self.final_counts,
            "bandViolations": self.band_violations,
            "decisions": len(self.decisions),
            "journalRecords": len(self.journal),
            "streams": dict(self.streams),
            "population": ({
                "observed": self.population.get("observed", 0),
                "distinct": self.population.get("distinct", 0.0),
                "windows": len(self.population.get("windows", ())),
            } if self.population else {}),
        }


class ReplayEngine:
    """One trace -> one fresh engine -> one deterministic run.

    ``run()`` builds everything from scratch (engine, clock, rule
    loads), so calling it twice IS the determinism oracle: no state
    survives between runs but the trace itself.
    """

    def __init__(self, trace: Trace, *,
                 rules: Optional[Dict[str, list]] = None,
                 capacity: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 epoch_ms: Optional[int] = None,
                 spill_every_s: Optional[int] = None,
                 adaptive: Optional[Dict] = None,
                 policy=None,
                 targets: Optional[list] = None,
                 fixed_width: Optional[bool] = None,
                 device=None):
        from sentinel_tpu_torch.core.config import config as _cfg

        # cuda unless the caller asks for the CPU; raises with no card.
        self.device = resolve_device(device)
        self.trace = trace
        self.rules = rules if rules is not None else trace.rules
        self.capacity = int(capacity) if capacity \
            else max(128, 4 * (len(trace.resources) + 4))
        cap = _cfg.sim_max_batch()
        self.max_batch = min(int(max_batch) if max_batch else cap,
                             BATCH_WIDTHS[-1])
        self.epoch_ms = int(epoch_ms) if epoch_ms is not None \
            else (trace.epoch_ms or _cfg.sim_epoch_ms())
        self.adaptive_knobs = (dict(DEFAULT_ADAPTIVE_KNOBS, **adaptive)
                               if adaptive is not None else None)
        self.policy = policy
        self.targets = targets
        # Adaptive needs every second spilled (interval gating, freeze
        # staleness); open-loop replay spills sparsely — each spill is a
        # device gather, and the ring holds well more than this.
        self.spill_every_s = int(spill_every_s) if spill_every_s else (
            1 if self.adaptive_knobs is not None else 32)
        # Closed-loop runs pad every chunk to ONE ladder width and
        # open-loop runs keep the minimal-width ladder, as the reference
        # does: the chunking is part of the verdict stream (the sha), so
        # both packages chunk alike.
        self.fixed_width = (self.adaptive_knobs is not None
                            if fixed_width is None else bool(fixed_width))

    # -- engine assembly ---------------------------------------------------

    def _build_engine(self, clock: SimClock):
        from sentinel_tpu_torch.core.engine import SentinelEngine
        from sentinel_tpu_torch.datasource import converters as CV

        # journal_path="" forces a memory-only journal whatever the
        # process config says: a shared file would leak one replay's
        # records into the next run's restore, breaking determinism.
        eng = SentinelEngine(self.capacity, device=self.device,
                             clock=clock.now_ms, journal_path="")
        # The trace ring's worker thread is the one async consumer on
        # the check_batch path; stopped, submit() is a pinned no-op —
        # zero nondeterministic host work rides the verdict stream.
        eng.traces.stop()
        loaders = {
            "flow": (eng.flow_rules, CV.flow_rules_from_json),
            "degrade": (eng.degrade_rules, CV.degrade_rules_from_json),
            "param": (eng.param_rules, CV.param_rules_from_json),
            "system": (eng.system_rules, CV.system_rules_from_json),
            "authority": (eng.authority_rules, CV.authority_rules_from_json),
            "tps": (eng.tps_rules, CV.tps_rules_from_json),
        }
        for fam, rules in (self.rules or {}).items():
            mgr, from_json = loaders[fam]
            parsed = from_json(json.dumps(list(rules)))
            if parsed:
                mgr.load_rules(parsed)
        if self.adaptive_knobs is not None:
            self._configure_adaptive(eng)
        return eng

    def _configure_adaptive(self, eng) -> None:
        from sentinel_tpu_torch.adaptive.envelope import SafetyEnvelope

        k = self.adaptive_knobs
        loop = eng.adaptive
        loop.interval_s = int(k["intervalS"])
        loop.shadow_soak_s = int(k["shadowS"])
        loop.canary_soak_s = int(k["canaryS"])
        loop.canary_bps = int(k["canaryBps"])
        loop.backoff_s = int(k["backoffS"])
        loop.envelope = SafetyEnvelope(
            step_pct=float(k["stepPct"]),
            cooldown_ms=int(k["cooldownS"]) * 1000)
        eng.rollout.min_window_entries = int(k["minWindowEntries"])
        if self.policy is not None:
            loop.controller.policy = self.policy
        if self.targets is not None:
            loop.load_targets(self.targets)
        loop.enable()

    def _resolve_rows(self, eng) -> Dict[str, tuple]:
        reg = eng.registry
        ent_row = reg.entrance_row(_SIM_CONTEXT)
        rows = {}
        for res in self.trace.resources:
            c_row = reg.cluster_row(res)
            d_row = reg.default_row(_SIM_CONTEXT, res, ent_row)
            rows[res] = (c_row, d_row)
        return rows

    # -- batch builders ----------------------------------------------------

    def _dispatch_entries(self, eng, rows, entries, now, sha) -> List[tuple]:
        """Expand (res, count, n, attempt) demand into padded ladder
        batches, dispatch through the production step, fold verdicts.
        Returns per-row (res, count, attempt, passed) tuples in dispatch
        order — the attempt tag rides through so the retry model can
        bound each entry's chain independently (fresh blocked demand
        must not inherit a due retry's attempt number)."""
        flat = []
        for res, count, n, attempt in entries:
            flat.extend((res, count, attempt) for _ in range(n))
        out = []
        for lo in range(0, len(flat), self.max_batch):
            chunk = flat[lo:lo + self.max_batch]
            width = (self.max_batch if self.fixed_width
                     else _pad_width(len(chunk), self.max_batch))
            buf = make_entry_batch_np(width)
            for i, (res, count, _attempt) in enumerate(chunk):
                c_row, d_row = rows[res]
                buf["cluster_row"][i] = c_row
                buf["dn_row"][i] = d_row
                buf["count"][i] = count
            dec = eng.check_batch(buf, now_ms=now)
            # One device-to-host copy of the three verdict columns.
            host = to_host({"reason": dec.reason, "wait": dec.wait_us,
                            "slot": dec.rule_slot})
            reason = host["reason"][:len(chunk)]
            wait = host["wait"][:len(chunk)]
            slot = host["slot"][:len(chunk)]
            sha.update(reason.tobytes())
            sha.update(wait.tobytes())
            sha.update(slot.tobytes())
            for i, (res, count, attempt) in enumerate(chunk):
                passed = reason[i] == 0 or reason[i] == C.BlockReason.WAIT
                out.append((res, count, attempt, bool(passed)))
        return out

    def _dispatch_streams(self, eng, sec, now, sha,
                          result: ReplayResult) -> None:
        """Drive this second's streamed-generation events ("g" rows)
        through the production reservation path (stream_open / tick /
        close), folding each outcome into the verdict sha so
        a reservation-semantics change breaks replay determinism
        loudly. Blocked opens and blocked overflow ticks are outcomes,
        not errors: impatient clients simply go away."""
        from sentinel_tpu_torch.core.exceptions import BlockException

        events = sec.get("g")
        if not events:
            return
        st = result.streams
        for ev in events:
            op = ev["op"]
            try:
                if op == "open":
                    lease = eng.stream_open(ev["id"], ev["model"],
                                            int(ev["est"]))
                    outcome, val = 0, int(lease.remaining)
                    st["opened"] = st.get("opened", 0) + 1
                elif op == "tick":
                    val = int(eng.stream_tick(ev["id"], int(ev["tok"])))
                    outcome = 0
                    st["ticks"] = st.get("ticks", 0) + 1
                    st["tokens"] = st.get("tokens", 0) + int(ev["tok"])
                else:  # close / abort
                    val = int(eng.stream_close(
                        ev["id"], aborted=op == "abort"))
                    outcome = 0
                    key = "aborted" if op == "abort" else "closed"
                    st[key] = st.get(key, 0) + 1
            except BlockException:
                outcome, val = 1, 0
                st["blocked"] = st.get("blocked", 0) + 1
            except KeyError:
                # The stream never opened (its open blocked): later
                # ticks/closes of the same id are no-ops by design.
                outcome, val = 2, 0
            sha.update(b"g%d:%s:%d:%d" % (
                outcome, ev["id"].encode(), now, val))

    def _dispatch_exits(self, eng, rows, exits, now) -> None:
        """(res, count, rt_ms, error) rows -> padded exit batches."""
        for lo in range(0, len(exits), self.max_batch):
            chunk = exits[lo:lo + self.max_batch]
            width = (self.max_batch if self.fixed_width
                     else _pad_width(len(chunk), self.max_batch))
            buf = make_exit_batch_np(width)
            for i, (res, count, rt_ms, error) in enumerate(chunk):
                c_row, d_row = rows[res]
                buf["cluster_row"][i] = c_row
                buf["dn_row"][i] = d_row
                buf["count"][i] = count
                buf["rt_ms"][i] = rt_ms
                buf["success"][i] = True
                buf["error"][i] = error
            eng.complete_batch(buf, now_ms=now)

    # -- exit models -------------------------------------------------------

    @staticmethod
    def _recorded_exits(sec: Dict) -> List[tuple]:
        """Live-trace mode: replay the recorded completion pattern of
        this second as-is (open loop)."""
        out = []
        for res in sorted(sec.get("x", {})):
            cell = sec["x"][res]
            for b, n in enumerate(cell.get("rt", ())):
                for _ in range(int(n)):
                    out.append((res, 1, _RT_REP[b], False))
            for _ in range(int(cell.get("err", 0))):
                out.append((res, 1, 0, True))
        return out

    def _model_exits(self, passes: Dict[str, int], t: int,
                     pending: Dict[int, list], result) -> List[tuple]:
        """Synthetic mode: admitted tokens complete under the scenario's
        load-dependent RT profile — tokens beyond the knee see the
        loaded RT, so over-admission is visible in the scored p99."""
        profile = self.trace.meta.get("rtProfile", {})
        now_exits = []
        for res in sorted(passes):
            tokens = passes[res]
            prof = profile.get(res)
            if prof is None or tokens <= 0:
                continue
            base = int(prof.get("baseMs", 10))
            loaded = int(prof.get("loadedMs", base * 5))
            knee = int(prof.get("kneeTps", 1 << 30))
            for rt_ms, n in ((base, min(tokens, knee)),
                             (loaded, max(0, tokens - knee))):
                if n <= 0:
                    continue
                result.rt_hist[_rt_bucket(rt_ms)] += n
                row = (res, 1, rt_ms, False)
                if rt_ms < 1000:
                    now_exits.extend([row] * n)
                else:
                    pending.setdefault(t + rt_ms // 1000, []).extend(
                        [row] * n)
        return now_exits

    # -- the run -----------------------------------------------------------

    def warmup_widths(self) -> List[int]:
        """Ladder widths to warm before a timed run, so the measured
        replay starts on a loaded kernel and a warm allocator. Every
        ladder width up to max_batch, not just the entry-demand-derived
        set: exit batches size by COMPLETION rows (recorded buckets, or
        tokens in model mode — count-16 entries fan out 16 exit rows
        each) and the retry model grows entry chunks past the trace's
        own demand."""
        if self.fixed_width:
            return [self.max_batch]
        return [w for w in BATCH_WIDTHS if w <= self.max_batch]

    def run(self, warmup: bool = False) -> ReplayResult:
        import time as _time

        t_total = _time.perf_counter()
        clock = SimClock(self.epoch_ms)
        eng = self._build_engine(clock)
        result = ReplayResult()
        result.trace_meta = dict(self.trace.meta)
        sha = hashlib.sha256()
        try:
            rows = self._resolve_rows(eng)
            if warmup:
                eng.warmup(self.warmup_widths())
            t_loop = _time.perf_counter()
            by_t = {sec["t"]: sec for sec in self.trace.seconds}
            retry = self.trace.meta.get("retry")
            pending_exits: Dict[int, list] = {}
            pending_retries: Dict[int, Dict[tuple, int]] = {}
            for t in range(self.trace.duration_s):
                now = clock.now_ms()
                sec = by_t.get(t, {"t": t, "d": {}})
                # 1. completions due from earlier seconds drain first
                #    (the production cycle order: exits before entries).
                due = pending_exits.pop(t, [])
                recorded = self._recorded_exits(sec)
                for res, _c, rt_ms, err in recorded:
                    if not err:
                        result.rt_hist[_rt_bucket(rt_ms)] += 1
                if due or recorded:
                    self._dispatch_exits(eng, rows, due + recorded, now)
                # 2. this second's demand (attempt 0) + due retries
                #    (their own attempt — chains are bounded per entry).
                entries = [(res, count, n, 0)
                           for res in sorted(sec["d"])
                           for count, n in sec["d"][res]]
                for (res, count, attempt), n in sorted(
                        pending_retries.pop(t, {}).items()):
                    entries.append((res, count, n, attempt))
                    result.retried += count * n
                verdicts = self._dispatch_entries(eng, rows, entries,
                                                  now, sha)
                # 2b. streamed-generation events ride the same second,
                #     after the batched demand (fixed order = replayable).
                self._dispatch_streams(eng, sec, now, sha, result)
                # 3. fold outcomes; blocked demand feeds the retry model.
                passes: Dict[str, int] = {}
                blocked_by: Dict[tuple, int] = {}
                sec_pass: Dict[str, int] = {}
                sec_block: Dict[str, int] = {}
                for res, count, attempt, passed in verdicts:
                    result.offered += count
                    if passed:
                        result.passed += count
                        passes[res] = passes.get(res, 0) + count
                        sec_pass[res] = sec_pass.get(res, 0) + count
                    else:
                        result.blocked += count
                        sec_block[res] = sec_block.get(res, 0) + count
                        blocked_by[(res, count, attempt)] = \
                            blocked_by.get((res, count, attempt), 0) + 1
                if retry:
                    for (res, count, attempt), n in sorted(
                            blocked_by.items()):
                        next_attempt = attempt + 1
                        if next_attempt > int(retry.get("maxAttempts", 0)):
                            continue
                        again = int(n * float(retry.get("factor", 0.5)))
                        if again <= 0:
                            continue
                        due_t = t + max(1, int(retry.get(
                            "backoffSeconds", 1)))
                        if due_t < self.trace.duration_s:
                            bucket = pending_retries.setdefault(due_t, {})
                            key = (res, count, next_attempt)
                            bucket[key] = bucket.get(key, 0) + again
                # 4. synthetic completions for this second's passes.
                if not sec.get("x"):
                    now_exits = self._model_exits(
                        passes, t, pending_exits, result)
                    if now_exits:
                        self._dispatch_exits(eng, rows, now_exits, now)
                if sec_pass or sec_block:
                    result.series.append(
                        {"t": t, "pass": sec_pass, "block": sec_block})
                # 5. the second completes; judgement + the adaptive loop
                #    ride the spill at simulated time.
                now = clock.advance(1000)
                if (t + 1) % self.spill_every_s == 0 \
                        or t + 1 == self.trace.duration_s:
                    eng._spill_flight(now)
                result.seconds += 1
            result.replay_wall_s = max(_time.perf_counter() - t_loop, 1e-9)
            result.verdict_sha256 = sha.hexdigest()
            self._finalize(eng, result)
        finally:
            eng.close()
        result.total_wall_s = max(_time.perf_counter() - t_total, 1e-9)
        return result

    def _finalize(self, eng, result: ReplayResult) -> None:
        from sentinel_tpu_torch.adaptive.loop import _tunable

        loop = eng.adaptive
        hist = loop.history()
        result.decisions = hist["events"]
        result.counters = dict(loop._counters())
        # The full audit stream, simulated-time-stamped: rule loads at
        # build, every rollout transition and adaptive decision the run
        # produced. Deterministic given the trace + seed.
        result.journal = eng.journal.tail()
        if result.streams:
            # Ledger end-state: a drained run shows zero outstanding
            # reservation tokens (the gateway demo's acceptance gate).
            st = eng.streams.stats()
            result.streams["outstandingTokens"] = st["outstandingTokens"]
            result.streams["active"] = st["active"]
        for r in eng.flow_rules.get_rules():
            if _tunable(r):
                result.final_counts[r.resource] = float(r.count)
        # Population series: sealed churn windows + the
        # final top-k with error bars, all stamped in simulated time.
        population = getattr(eng, "population", None)
        if population is not None and population.enabled:
            result.population = {
                "windows": population.series(),
                "topk": [{"key": k, "count": c, "err": e}
                         for k, c, e in population._ss.top()],
                "observed": population.observed_total,
                "distinct": round(population._hll.estimate(), 2),
            }
        # Safety-envelope audit: every promoted change AND the final
        # live counts must sit inside the declared [floor, ceiling]
        # band. The envelope guarantees this by construction; the lab's
        # acceptance gate counts violations anyway (belt and braces).
        bands = {t.resource: (t.floor, t.ceiling)
                 for t in loop.controller.targets()}
        for ev in result.decisions:
            if ev.get("kind") != "promote":
                continue
            for ch in ev.get("changes", ()):
                band = bands.get(ch.get("resource"))
                if band and not band[0] <= ch["to"] <= band[1]:
                    result.band_violations += 1
        for res, count in result.final_counts.items():
            band = bands.get(res)
            if band and not band[0] <= count <= band[1]:
                result.band_violations += 1
