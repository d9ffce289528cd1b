"""The plain reference: one deployment's batch admission, in numpy.

It replays what the program is given — each round's entries at a trace
time, then the exits of the entries it admitted — and gives, for every
entry, the verdict the batch API promises, and the statistics those steps
commit. It imports numpy and the benchmark's own modules only, nothing of
the program, and works out from the configuration everything the program
derives (rule tables, windows, the hot-parameter sketch).

The semantics, as the reference package's batch API defines them
(``check_batch`` / ``complete_batch``):

- Rule slots in the order system -> hot parameter -> flow -> degrade; a
  lane blocked by one slot is not a candidate of the later ones, and its
  reason is the first slot that blocked it.
- Within a batch, arrival order is lane order. A slot admits a lane
  against the lanes before it that share its counter, counting only the
  slot's survivors: with equal acquire counts, the lanes that a first
  sweep over all candidates admits; with mixed counts the survivor set
  iterates ``S' = candidate & ~blocked(S)`` up to 12 times and keeps the
  last even iterate if it does not settle. The verdict is one more sweep
  over the survivors.
- Flow (QPS, default behavior, default origin, direct): pass in the
  resource's 1 s window (its buckets) plus the earlier survivors' counts,
  plus the lane's count, against the threshold.
- System (QPS): the same over the entry node, for inbound lanes.
- Hot parameter (QPS, default behavior): each rule holds a direct-mapped
  table of 2048 slots (``hash % 2048``) with an owner key, tokens and a
  refill time, and two count-min sketches of depth 4 and width 2048
  (column ``((hash * A_d mod 2^32) >> 16) mod 2048``): the window's
  admitted acquires, reset every duration, and a hotness sketch halved
  every duration. A lane whose key owns its slot spends the slot's tokens,
  refilled by ``count`` per whole duration since the refill time (capped
  at ``count + burst``); any other key admits against ``count + burst``
  less its sketch estimate. Lanes that share a slot share one prefix. An
  admitted key that does not own its slot takes it when its hotness has
  caught up with the owner's; where several lanes write one slot, the last
  lane wins. Sketch updates are conservative (only the cells at a key's
  minimum grow) and read the sketch as it was before the step.
- Degrade: one breaker per rule (closed, open, half-open) over a tumbling
  stat interval of total, error and slow counts. An open breaker whose
  retry time has come admits its first candidate lane of the batch as a
  probe and turns half-open; half-open blocks. Completions feed the
  interval; after each exit step a half-open breaker opens again on any
  bad completion or closes (its interval cleared) on a good one, and a
  closed breaker opens when its interval holds at least
  ``min_request_amount`` completions and its slow ratio exceeds the
  threshold (or reaches 1 at a threshold of 1), its error ratio exceeds
  the threshold, or its error count does.
- Statistics: an entry step commits pass and block counts and a thread to
  the lane's cluster, default, origin (when it has one) and entry (when
  inbound) nodes; an exit step commits success, exception and RT (clipped
  to 65535 a lane) and gives the thread back. The 1 s window, the current
  second and the running totals take the same deltas; a second is sealed
  when the first step of a later second runs.

Arithmetic is float32 where the configuration states float32, and exact
integers for the statistics. ``lowered=True`` is the control: every float32
quantity rounded to bfloat16 after each operation, and each step's
statistics committed as a bfloat16 product (each node's delta rounded to
bfloat16), the step a later change would be tempted to take.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.spec import rule_layout

REASONS = ("pass", "flow", "degrade", "system", "param_flow")
R_PASS, R_FLOW, R_DEGRADE, R_SYSTEM, R_PARAM = range(5)
EVENTS = ("pass", "block", "exception", "success", "rt", "occupied_pass")
E_PASS, E_BLOCK, E_EXCEPTION, E_SUCCESS, E_RT = range(5)
CLOSED, OPEN, HALF_OPEN = range(3)
DEGRADE_GRADES = {"RT": 0, "EXCEPTION_RATIO": 1, "EXCEPTION_COUNT": 2}

SLOTS = 2048
CMS_DEPTH = 4
CMS_WIDTH = 2048
CMS_MULT = np.array([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F],
                    np.uint64)
FIXPOINT_CAP = 12
RT_CLIP = 65535
F32 = np.float32


def to_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    held in float32."""
    a = np.ascontiguousarray(np.asarray(x, F32))
    u = a.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(F32).reshape(a.shape)


def group_prefix(ids: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Exclusive prefix of ``vals`` over the earlier lanes with the same
    id, in lane order."""
    n = ids.shape[0]
    if n == 0:
        return vals.copy()
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    sv = vals[order]
    before = np.cumsum(sv) - sv
    first = np.ones(n, bool)
    first[1:] = sid[1:] != sid[:-1]
    group = np.cumsum(first) - 1
    base = before[first][group]
    out = np.empty_like(before)
    out[order] = before - base
    return out


def first_occurrence(ids: np.ndarray) -> np.ndarray:
    """bool: the lane is the first with its (non-negative) id."""
    out = np.zeros(ids.shape[0], bool)
    live = np.flatnonzero(ids >= 0)
    if live.size:
        _, first = np.unique(ids[live], return_index=True)
        out[live[first]] = True
    return out


def set_last(table: np.ndarray, flat: np.ndarray, vals: np.ndarray,
             mask: np.ndarray) -> None:
    """``table.flat[flat] = vals`` where ``mask``; where several lanes
    write one cell, the last lane wins."""
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        return
    rev = idx[::-1]
    _, keep = np.unique(flat[rev], return_index=True)
    sel = rev[keep]
    table.reshape(-1)[flat[sel]] = vals[sel]


def survivors(cand: np.ndarray, blocked_for, count: np.ndarray,
              relevant: Optional[np.ndarray] = None) -> np.ndarray:
    """The survivor set of one slot (module docstring)."""
    if cand.shape[0] == 0:
        return cand
    rel = cand if relevant is None else cand & relevant
    c = count[rel]
    if c.size == 0 or c.min() == c.max():
        return cand & ~blocked_for(cand)
    s, last_even = cand, cand
    for k in range(FIXPOINT_CAP):
        nxt = cand & ~blocked_for(s)
        done = np.array_equal(nxt, s)
        if k % 2 == 1:
            last_even = nxt
        s = nxt
        if done:
            return s
    return last_even


def _sub_at(flat: np.ndarray, idx: np.ndarray, vals: np.ndarray, q) -> None:
    """``flat[idx] -= vals`` with repeated indices summed, the result
    rounded by ``q``."""
    if idx.size == 0:
        return
    u, inv = np.unique(idx, return_inverse=True)
    flat[u] = q(flat[u] - np.bincount(inv, weights=vals).astype(F32))


def cms_columns(keys: np.ndarray) -> np.ndarray:
    """[N] 32-bit keys -> [N, depth] sketch columns."""
    h = (np.asarray(keys, np.int64) & 0xFFFFFFFF).astype(np.uint64)
    prod = (h[:, None] * CMS_MULT[None, :]) & np.uint64(0xFFFFFFFF)
    return ((prod >> np.uint64(16)) % np.uint64(CMS_WIDTH)).astype(np.int64)


class Reference:
    """One deployment's state, advanced by :meth:`entry` and :meth:`exit`.

    Nodes: cluster node of resource i is ``i``, its default node
    ``R + i``, its origin node ``2R + i``, the entry node ``3R``.
    """

    def __init__(self, cfg: Dict, lowered: bool = False):
        self.lowered = lowered
        self.q = to_bf16 if lowered else (lambda x: np.asarray(x, F32))
        n = int(cfg["resources"])
        self.R = n
        self.nodes = 3 * n + 1
        self.entry_node = 3 * n
        self.inbound = cfg.get("entry_type", "OUT") == "IN"
        win = cfg["window"]
        self.interval_ms = int(win["interval_ms"])
        self.buckets = int(win["buckets"])
        self.bucket_ms = self.interval_ms // self.buckets
        self.qps_scale = F32(1000.0 / self.interval_ms)
        rules = rule_layout(cfg)

        # Flow: one QPS / default / direct rule per resource at most.
        self.flow_thr = np.full(n, np.nan, F32)
        for r in rules["flow"]:
            if (r.get("grade", "QPS") != "QPS"
                    or r.get("control_behavior", "DEFAULT") != "DEFAULT"
                    or r.get("limit_app", "default") != "default"
                    or r.get("strategy", "DIRECT") != "DIRECT"):
                raise ValueError(f"reference has no flow rule like {r}")
            if not np.isnan(self.flow_thr[r["resource"]]):
                raise ValueError("reference holds one flow rule a resource")
            self.flow_thr[r["resource"]] = r["count"]

        # Hot parameter: one QPS / default rule per resource at most.
        pr = rules["param"]
        self.p_rule = np.full(n, -1, np.int64)
        self.p_arg = np.zeros(len(pr), np.int64)
        self.p_thr = np.zeros(len(pr), F32)
        self.p_burst = np.zeros(len(pr), F32)
        self.p_dur = np.zeros(len(pr), np.int64)
        for j, r in enumerate(pr):
            if (r.get("grade", "QPS") != "QPS"
                    or r.get("control_behavior", "DEFAULT") != "DEFAULT"
                    or r.get("items") or r.get("param_idx", 0) != 0):
                raise ValueError(f"reference has no param rule like {r}")
            if self.p_rule[r["resource"]] >= 0:
                raise ValueError("reference holds one param rule a resource")
            self.p_rule[r["resource"]] = j
            self.p_thr[j] = r["count"]
            self.p_burst[j] = r.get("burst_count", 0)
            self.p_dur[j] = int(r.get("duration_in_sec", 1)) * 1000
        m = len(pr)
        self.p_key = np.zeros((m, SLOTS), np.int64)
        self.p_tokens = np.zeros((m, SLOTS), F32)
        self.p_filled = np.zeros((m, SLOTS), np.int64)
        self.p_cms = np.zeros((m, CMS_DEPTH, CMS_WIDTH), F32)
        self.p_hot = np.zeros((m, CMS_DEPTH, CMS_WIDTH), F32)
        self.p_cms_start = np.zeros(m, np.int64)

        # Degrade: one breaker per resource at most.
        dr = rules["degrade"]
        self.d_rule = np.full(n, -1, np.int64)
        self.d_res = np.array([r["resource"] for r in dr], np.int64)
        self.d_grade = np.array([DEGRADE_GRADES[r["grade"]] for r in dr],
                                np.int64)
        self.d_thr = np.array([r["count"] for r in dr], F32)
        self.d_slow = np.array([r.get("slow_ratio_threshold", 1.0)
                                for r in dr], F32)
        self.d_min = np.array([r.get("min_request_amount", 5) for r in dr],
                              np.int64)
        self.d_tw = np.array([int(r.get("time_window", 0)) * 1000
                              for r in dr], np.int64)
        self.d_stat = np.array([r.get("stat_interval_ms", 1000) for r in dr],
                               np.int64)
        for j, r in enumerate(dr):
            if self.d_rule[r["resource"]] >= 0:
                raise ValueError("reference holds one degrade rule a "
                                 "resource")
            self.d_rule[r["resource"]] = j
        self.d_state = np.zeros(len(dr), np.int64)
        self.d_retry = np.zeros(len(dr), np.int64)
        self.d_win = np.zeros((len(dr), 3), np.int64)  # total, error, slow
        self.d_win_start = np.full(len(dr), -(1 << 40), np.int64)

        # System: the QPS field alone.
        self.sys_qps = None
        for r in rules["system"]:
            if set(r) - {"qps"}:
                raise ValueError(f"reference has no system rule like {r}")
            q = F32(r["qps"])
            self.sys_qps = q if self.sys_qps is None else min(self.sys_qps, q)

        # Statistics.
        self.w1_pass = np.zeros((self.buckets, self.nodes), np.int64)
        self.w1_start = np.full(self.buckets, -self.interval_ms, np.int64)
        self.totals = np.zeros((len(EVENTS), self.nodes), np.int64)
        self.sec = np.zeros((len(EVENTS), self.nodes), np.int64)
        self.sec_stamp = -1
        self.seconds: Dict[int, np.ndarray] = {}
        self.threads = np.zeros(self.nodes, np.int64)

    # -- shared clocks -----------------------------------------------------

    def _roll(self, now: int) -> None:
        cur_idx = (now // self.bucket_ms) % self.buckets
        cur_start = now - now % self.bucket_ms
        for b in range(self.buckets):
            want = cur_start - ((cur_idx - b) % self.buckets) * self.bucket_ms
            if self.w1_start[b] != want:
                self.w1_pass[b] = 0
                self.w1_start[b] = want
        sec_start = now - now % 1000
        if self.sec_stamp >= 0 and self.sec_stamp != sec_start:
            self.seconds[self.sec_stamp] = self.sec.copy()
            self.sec[:] = 0
        self.sec_stamp = sec_start

    def _nodes4(self, res, origin) -> np.ndarray:
        """[N, 4] nodes each lane commits to, -1 where it has none."""
        n = res.shape[0]
        out = np.full((n, 4), -1, np.int64)
        out[:, 0] = self.R + res
        out[:, 1] = res
        out[:, 2] = np.where(origin, 2 * self.R + res, -1)
        if self.inbound:
            out[:, 3] = self.entry_node
        return out

    def _commit(self, nodes4, cols: List[Tuple[int, np.ndarray]],
                threads: np.ndarray, now: int) -> None:
        flat = nodes4.reshape(-1)
        live = flat >= 0
        idx = flat[live]
        delta = np.zeros((len(EVENTS), self.nodes), np.int64)
        for ev, v in cols:
            w = np.repeat(v, 4)[live]
            delta[ev] = np.bincount(idx, weights=w, minlength=self.nodes
                                    ).astype(np.int64)
        if self.lowered:
            delta = to_bf16(delta.astype(F32)).astype(np.int64)
        self.w1_pass[(now // self.bucket_ms) % self.buckets] += delta[E_PASS]
        self.sec += delta
        self.totals += delta
        t = np.bincount(idx, weights=np.repeat(threads, 4)[live],
                        minlength=self.nodes).astype(np.int64)
        self.threads = np.maximum(self.threads + t, 0)

    # -- the entry step ----------------------------------------------------

    def entry(self, now: int, res, origin, key, count
              ) -> Tuple[np.ndarray, np.ndarray]:
        """One entry step; returns (reason codes, wait_us) per lane."""
        now = int(now)
        self._roll(now)
        n = res.shape[0]
        valid = res >= 0
        reason = np.where(valid, R_PASS, -1).astype(np.int64)
        decided = ~valid

        if self.sys_qps is not None and self.inbound:
            cand = valid & ~decided
            pass_entry = self.w1_pass[:, self.entry_node].sum()

            def sys_blocked(surv):
                contrib = np.where(surv, count, 0)
                prefix = np.cumsum(contrib) - contrib
                used = self.q(self.q(pass_entry + prefix.astype(F32))
                              * self.qps_scale)
                return cand & ~(self.q(used + count.astype(F32))
                                <= self.sys_qps)

            blk = sys_blocked(survivors(cand, sys_blocked, count))
            reason[blk] = R_SYSTEM
            decided |= blk

        if self.p_rule.max(initial=-1) >= 0:
            cand = valid & ~decided
            self._roll_sketch(now)
            blocked_for, commit = self._param_slot(now, res, key, count,
                                                   cand)
            blk = commit(survivors(cand, blocked_for, count))
            reason[blk] = R_PARAM
            decided |= blk

        if not np.all(np.isnan(self.flow_thr)):
            cand = valid & ~decided
            thr = self.flow_thr[np.where(valid, res, 0)]
            has = cand & ~np.isnan(thr)
            pass1 = self.w1_pass[:, :self.R].sum(axis=0)[np.where(valid, res,
                                                                   0)]

            def flow_blocked(surv):
                prefix = group_prefix(res, np.where(surv, count, 0))
                used = self.q(self.q(pass1.astype(F32) + prefix.astype(F32))
                              * self.qps_scale)
                return has & ~(self.q(used + count.astype(F32)) <= thr)

            blk = flow_blocked(survivors(cand, flow_blocked, count))
            reason[blk] = R_FLOW
            decided |= blk

        if self.d_res.size:
            cand = valid & ~decided
            blk = self._degrade_entry(now, res, cand)
            reason[blk] = R_DEGRADE
            decided |= blk

        admit = valid & (reason == R_PASS)
        blocked = valid & ~admit
        self._commit(self._nodes4(res, origin),
                     [(E_PASS, np.where(admit, count, 0)),
                      (E_BLOCK, np.where(blocked, count, 0))],
                     admit.astype(np.int64), now)
        return reason, np.zeros(n, np.int64)

    def _roll_sketch(self, now: int) -> None:
        dur = np.maximum(self.p_dur, 1)
        start = now - now % dur
        elapsed = np.clip((start - self.p_cms_start) // dur, 0, 30)
        rolled = elapsed > 0
        if not rolled.any():
            return
        self.p_cms[rolled] = 0
        factor = np.exp2(-elapsed.astype(F32)).astype(F32)
        self.p_hot *= factor[:, None, None]
        self.p_cms_start = np.where(rolled, start, self.p_cms_start)

    def _param_slot(self, now, res, key, count, cand):
        """The hot-parameter slot's reads for one step, which do not
        depend on the survivor set; returns ``(blocked_for, commit)``."""
        q = self.q
        rid = self.p_rule[np.where(res >= 0, res, 0)]
        app = cand & (rid >= 0)
        r = np.where(app, rid, 0)
        thr = self.p_thr[r]
        maxc = q(thr + self.p_burst[r])
        slot = key % SLOTS
        cell = r * SLOTS + slot
        stored = np.where(app, self.p_key.reshape(-1)[cell], 0)
        fresh = stored != key
        gid = np.where(app, cell, -1)
        tokens = self.p_tokens.reshape(-1)[cell]
        filled = self.p_filled.reshape(-1)[cell]
        dur = np.maximum(self.p_dur[r], 1)
        windows = np.maximum((now - filled) // dur, 0)
        # float32 a * b + c with one rounding (the product is exact in
        # float64), then the cap.
        refill = (windows.astype(F32).astype(np.float64) * thr
                  + tokens.astype(np.float64)).astype(F32)
        refilled = np.minimum(q(refill), maxc)
        sketch_cells = (r[:, None] * CMS_DEPTH + np.arange(CMS_DEPTH)) \
            * CMS_WIDTH + cms_columns(key)
        est = np.where(app, self.p_cms.reshape(-1)[sketch_cells].min(axis=1),
                       F32(0))
        avail = np.where(fresh, np.maximum(q(maxc - est), F32(0)), refilled)
        acq = count.astype(F32)

        def ok_for(surv):
            prefix = group_prefix(gid, np.where(surv & app, count, 0))
            return (thr > 0) & (q(prefix.astype(F32) + acq) <= avail)

        def blocked_for(surv):
            return app & ~ok_for(surv)

        def commit(surv):
            ok = ok_for(surv)
            admitted = app & ok & surv
            hot = self.p_hot.reshape(-1)
            owner_cells = (r[:, None] * CMS_DEPTH + np.arange(CMS_DEPTH)) \
                * CMS_WIDTH + cms_columns(stored)
            hot_est = hot[sketch_cells].min(axis=1)
            owner_est = hot[owner_cells].min(axis=1)
            promoted = admitted & fresh & ((stored == 0)
                                           | (q(hot_est + acq) >= owner_est))
            set_last(self.p_key, cell, key, promoted | (admitted & ~fresh))
            stamp = (app & ~fresh & (windows >= 1)) | promoted
            self.p_filled.reshape(-1)[cell[stamp]] = now
            touch = app & (~fresh | promoted)
            set_last(self.p_tokens, cell, avail, touch)
            spend = admitted & touch
            flat_tokens = self.p_tokens.reshape(-1)
            _sub_at(flat_tokens, cell[spend], acq[spend], q)
            # Only spent cells can have gone below 0.
            flat_tokens[cell[spend]] = np.maximum(flat_tokens[cell[spend]],
                                                  F32(0))
            for sketch in (self.p_cms.reshape(-1), hot):
                vals = sketch[sketch_cells]
                on = admitted[:, None] & (vals <= vals.min(axis=1,
                                                          keepdims=True))
                _sub_at(sketch, sketch_cells[on],
                        -np.broadcast_to(acq[:, None], on.shape)[on], q)
            return app & ~ok

        return blocked_for, commit

    def _degrade_entry(self, now, res, cand) -> np.ndarray:
        rid = self.d_rule[np.where(res >= 0, res, 0)]
        has = cand & (rid >= 0)
        r = np.where(has, rid, 0)
        st = np.where(has, self.d_state[r], CLOSED)
        due = (st == OPEN) & (np.where(has, self.d_retry[r], 0) <= now)
        probe = has & due & first_occurrence(np.where(has & due, rid, -1))
        blocked = has & ((st == HALF_OPEN) | ((st == OPEN) & ~probe))
        self.d_state[rid[probe]] = HALF_OPEN
        return blocked

    # -- the exit step -----------------------------------------------------

    def exit(self, now: int, res, origin, count, admitted, rt_ms, error
             ) -> None:
        """One exit step over the lanes of an entry step; only the
        ``admitted`` ones complete (with ``rt_ms`` and ``error``)."""
        now = int(now)
        self._roll(now)
        valid = admitted & (res >= 0)
        rt = np.clip(rt_ms, 0, RT_CLIP)
        self._commit(self._nodes4(res, origin),
                     [(E_SUCCESS, np.where(valid, count, 0)),
                      (E_EXCEPTION, np.where(valid & error, count, 0)),
                      (E_RT, np.where(valid, rt, 0))],
                     -valid.astype(np.int64), now)
        if self.d_res.size:
            self._degrade_exit(now, res, valid, count, rt_ms, error)

    def _degrade_exit(self, now, res, valid, count, rt_ms, error) -> None:
        q = self.q
        start = now - now % np.maximum(self.d_stat, 1)
        stale = self.d_win_start != start
        self.d_win[stale] = 0
        self.d_win_start = start
        rid = self.d_rule[np.where(res >= 0, res, 0)]
        has = valid & (rid >= 0)
        r = rid[has]
        c = count[has]
        slow = (self.d_grade[r] == 0) & (rt_ms[has].astype(F32) > self.d_thr[r])
        err = error[has]
        bad = np.where(self.d_grade[r] == 0, slow, err)
        np.add.at(self.d_win[:, 0], r, c)
        np.add.at(self.d_win[:, 1], r, np.where(err, c, 0))
        np.add.at(self.d_win[:, 2], r, np.where(slow, c, 0))
        on_half = self.d_state[r] == HALF_OPEN
        half_bad = np.zeros(self.d_res.size, bool)
        half_good = np.zeros(self.d_res.size, bool)
        half_bad[r[on_half & bad]] = True
        half_good[r[on_half & ~bad]] = True
        total = self.d_win[:, 0].astype(F32)
        den = np.maximum(total, F32(1))
        slow_r = q(self.d_win[:, 2].astype(F32) / den)
        err_c = self.d_win[:, 1].astype(F32)
        err_r = q(err_c / den)
        trip_slow = (slow_r > self.d_slow) | ((self.d_slow >= 1)
                                               & (slow_r >= 1))
        trip = np.where(self.d_grade == 0, trip_slow, err_r > self.d_thr)
        trip = np.where(self.d_grade == 2, err_c > self.d_thr, trip)
        trip &= self.d_win[:, 0] >= self.d_min
        to_open = ((self.d_state == CLOSED) & trip) | (
            (self.d_state == HALF_OPEN) & half_bad)
        to_closed = (self.d_state == HALF_OPEN) & half_good & ~half_bad
        self.d_state[to_open] = OPEN
        self.d_state[to_closed] = CLOSED
        self.d_retry = np.where(to_open, self.d_tw + now, self.d_retry)
        self.d_win[to_closed] = 0

    # -- what the comparison reads -------------------------------------------

    def snapshot(self) -> Dict:
        """The committed state in node space: running totals [E, nodes],
        sealed seconds {second ms: [E, nodes]}, the second still being
        staged (its ms and [E, nodes]), thread gauges [nodes], and each
        degrade rule's (resource, state, retry ms)."""
        return {
            "totals": self.totals.copy(),
            "seconds": dict(self.seconds),
            "staging": (self.sec_stamp, self.sec.copy()),
            "threads": self.threads.copy(),
            "breakers": np.stack([self.d_res, self.d_state, self.d_retry],
                                 axis=1) if self.d_res.size
            else np.zeros((0, 3), np.int64),
        }
