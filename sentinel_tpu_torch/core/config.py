"""Layered static configuration (port of ``sentinel_tpu/core/config.py``,
the keys this package reads).

Reference: ``core:config/SentinelConfig.java``. Environment variables
(the literal dotted key or its ``CSP_SENTINEL_*`` upper-snake form)
override values set with :meth:`SentinelConfig.set`, which override a
properties file named by ``$CSP_SENTINEL_CONFIG_FILE`` (default
``./sentinel.properties``, read once, at the first read or write), which
overrides the defaults. Keys keep the reference's dotted names.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

# Keys read by this package.
LOG_DIR = "csp.sentinel.log.dir"
CHARSET = "csp.sentinel.charset"
COLD_FACTOR = "csp.sentinel.flow.cold.factor"
STATISTIC_MAX_RT = "csp.sentinel.statistic.max.rt"
# The environment variable naming the properties file.
CONFIG_FILE_ENV = "CSP_SENTINEL_CONFIG_FILE"
# The metric log (metrics/writer.py): the file name's app and the roll and
# trim limits (reference: SentinelConfig's metric file keys).
APP_NAME = "project.name"
APP_TYPE = "csp.sentinel.app.type"
SINGLE_METRIC_FILE_SIZE = "csp.sentinel.metric.file.single.size"
TOTAL_METRIC_FILE_COUNT = "csp.sentinel.metric.file.total.count"
LEASE_ENABLED = "csp.sentinel.lease.enabled"
# The ops plane (transport/): the dashboards a heartbeat registers with
# (comma-separated ``host:port``), the command center's port, the
# heartbeat's cadence and the address it reports.
DASHBOARD_SERVER = "csp.sentinel.dashboard.server"
API_PORT = "csp.sentinel.api.port"
HEARTBEAT_INTERVAL_MS = "csp.sentinel.heartbeat.interval.ms"
HEARTBEAT_CLIENT_IP = "csp.sentinel.heartbeat.client.ip"
# Shared secret for /registry/machine (dashboard-side keys follow the
# sentinel.dashboard.* naming); ONE constant so the sender and the gate
# cannot drift onto different keys.
HEARTBEAT_TOKEN = "sentinel.dashboard.heartbeat.token"
# The instant window's geometry and the prioritized-borrow wait cap, read
# once at engine construction (reference: IntervalProperty /
# SampleCountProperty / OccupyTimeoutProperty); runtime retunes go
# through the engine's push properties.
STATISTIC_INTERVAL_MS = "csp.sentinel.statistic.interval.ms"
STATISTIC_SAMPLE_COUNT = "csp.sentinel.statistic.sample.count"
OCCUPY_TIMEOUT_MS = "csp.sentinel.occupy.timeout.ms"
# profile.syncEvery: every Nth device dispatch waits for a true step wall
# (StepTimer sampling cadence; the rest record the enqueue wall only).
PROFILE_SYNC_EVERY = "csp.sentinel.profile.syncEvery"
# trace.sampleEvery: every Nth BLOCKED entry is retained as a decision
# trace (0 disables); trace.capacity bounds the host-side ring.
TELEMETRY_TRACE_SAMPLE_EVERY = "csp.sentinel.telemetry.trace.sampleEvery"
TELEMETRY_TRACE_CAPACITY = "csp.sentinel.telemetry.trace.capacity"
# Pipelined admission: entry cycles allowed in flight at once (1 = the
# synchronous ping-pong, 2 = double buffering); how long a cycle waits to
# fold late concurrent callers in; comma-separated ladder widths to
# pre-allocate staging buffers for (empty = every width up to max_batch).
PIPELINE_INFLIGHT_DEPTH = "csp.sentinel.pipeline.inflight.depth"
PIPELINE_LINGER_US = "csp.sentinel.pipeline.linger.us"
PIPELINE_POOL_WIDTHS = "csp.sentinel.pipeline.pool.widths"
# timeseries.seconds: device-resident flight-recorder ring length in
# seconds (0 disables recording entirely: no ring tensors on the device);
# timeseries.history.seconds bounds the compacted host-side spill.
TELEMETRY_TIMESERIES_SECONDS = "csp.sentinel.telemetry.timeseries.seconds"
TELEMETRY_TIMESERIES_HISTORY = \
    "csp.sentinel.telemetry.timeseries.history.seconds"
# shard.slices: the flowId slice ring the population telescope attributes
# keys to (``telemetry/population.py:slice_of``).
CLUSTER_SHARD_SLICES = "csp.sentinel.cluster.shard.slices"
# Namespace telescope (telemetry/population.py), riding the spill fold.
# topk: Space-Saving summary size (error floor total/k); cms.*: count-min
# geometry (cold-tail error (e/width)*total at confidence 1-e^-depth);
# hll.precision: global cardinality registers (2^p, stderr
# 1.04/sqrt(2^p)); slice.precision: the cheaper per-slice and per-window
# register sets; window.seconds: churn-window length; churn.history:
# sealed windows retained; baseline.*: the EWMA cardinality-growth alarm
# (z-score vs prior baseline).
POPULATION_ENABLED = "csp.sentinel.population.enabled"
POPULATION_TOPK = "csp.sentinel.population.topk"
POPULATION_CMS_DEPTH = "csp.sentinel.population.cms.depth"
POPULATION_CMS_WIDTH = "csp.sentinel.population.cms.width"
POPULATION_HLL_PRECISION = "csp.sentinel.population.hll.precision"
POPULATION_SLICE_PRECISION = "csp.sentinel.population.slice.precision"
POPULATION_WINDOW_SECONDS = "csp.sentinel.population.window.seconds"
POPULATION_CHURN_HISTORY = "csp.sentinel.population.churn.history"
POPULATION_BASELINE_ALPHA = "csp.sentinel.population.baseline.alpha"
POPULATION_BASELINE_ZSCORE = "csp.sentinel.population.baseline.zscore"
# Slot-table admission (core/slots.py). budget: device slot-table size
# (0 = off: registry rows == device rows); registry.capacity: the host
# name-table size in slot mode (hot + cold namespace); max.steals: steal
# ceiling per rebalance cycle; hysteresis.pct: a challenger must beat the
# victim's observed rate by this margin before a steal; spill.max: spilled
# row records retained host-side (LRU past it, a dropped record rehydrates
# cold, counted); stale.seconds: telescope staleness horizon for the
# freeze gate.
SLOTS_BUDGET = "csp.sentinel.slots.budget"
SLOTS_REGISTRY_CAPACITY = "csp.sentinel.slots.registry.capacity"
SLOTS_MAX_STEALS = "csp.sentinel.slots.max.steals"
SLOTS_HYSTERESIS_PCT = "csp.sentinel.slots.hysteresis.pct"
SLOTS_SPILL_MAX = "csp.sentinel.slots.spill.max"
SLOTS_STALE_SECONDS = "csp.sentinel.slots.stale.seconds"
# Resilience of the remote touchpoints (resilience/): the seed every retry
# policy of the process draws from, the token client's breaker, and the
# aggregate remote-wait budget of one entry()'s cluster token check.
RESILIENCE_SEED = "csp.sentinel.resilience.seed"
RESILIENCE_BREAKER_FAILURES = "csp.sentinel.resilience.breaker.failure.threshold"
RESILIENCE_BREAKER_OPEN_MS = "csp.sentinel.resilience.breaker.open.ms"
RESILIENCE_BREAKER_PROBES = "csp.sentinel.resilience.breaker.half.open.probes"
RESILIENCE_ENTRY_BUDGET_MS = "csp.sentinel.resilience.cluster.entry.budget.ms"
# spans.sampleEvery: every Nth cluster-checked entry carries a W3C-style
# trace context across the token-server wire (0 disables); spans.capacity
# bounds the host-side span ring.
TELEMETRY_SPANS_SAMPLE_EVERY = "csp.sentinel.telemetry.spans.sampleEvery"
TELEMETRY_SPANS_CAPACITY = "csp.sentinel.telemetry.spans.capacity"
# The token server's admission queue (cluster/server.py): its bound in
# groups, the watermark past which submissions shed OVERLOADED, the
# deadline a queued group may wait, the retry-after hint of a shed, the
# per-connection burst cap and the idle-connection reap; client.backoff:
# the least time an HA / sharded client skips a leader that shed it;
# rls.max.concurrent: the Envoy RLS service's in-flight ShouldRateLimit
# calls, past which a call sheds at once with CODE_UNKNOWN
# (envoy_rls/service.py).
OVERLOAD_QUEUE_MAX_GROUPS = "csp.sentinel.overload.queue.max.groups"
OVERLOAD_QUEUE_WATERMARK_PCT = "csp.sentinel.overload.queue.watermark.pct"
OVERLOAD_DEADLINE_MS = "csp.sentinel.overload.deadline.ms"
OVERLOAD_RETRY_AFTER_MS = "csp.sentinel.overload.retry.after.ms"
OVERLOAD_CONN_MAX_BURST = "csp.sentinel.overload.conn.max.burst"
OVERLOAD_IDLE_TIMEOUT_S = "csp.sentinel.overload.idle.timeout.s"
OVERLOAD_RLS_MAX_CONCURRENT = "csp.sentinel.overload.rls.max.concurrent"
OVERLOAD_CLIENT_BACKOFF_MS = "csp.sentinel.overload.client.backoff.ms"
# The token server's wire path (cluster/reactor.py). reactor.enabled: the
# selectors-based multiplexing frontend (false = the thread-per-connection
# socketserver); coalesce.max.batch: max requests folded into one group;
# inflight.depth: fused wire batches in flight on the device at once;
# outbuf.max.bytes: per-connection reply backlog bound (past it reads
# pause and parsed requests shed OVERLOADED); read.chunk.bytes: recv size
# per readable socket per loop cycle; workers: the pool for non-FLOW
# frames; rls.batched: the Envoy RLS service submits each call's
# descriptors as one group through a coalescing batcher.
WIRE_REACTOR_ENABLED = "csp.sentinel.wire.reactor.enabled"
WIRE_COALESCE_MAX_BATCH = "csp.sentinel.wire.coalesce.max.batch"
WIRE_INFLIGHT_DEPTH = "csp.sentinel.wire.inflight.depth"
WIRE_OUTBUF_MAX_BYTES = "csp.sentinel.wire.outbuf.max.bytes"
WIRE_READ_CHUNK_BYTES = "csp.sentinel.wire.read.chunk.bytes"
WIRE_WORKERS = "csp.sentinel.wire.workers"
WIRE_RLS_BATCHED = "csp.sentinel.wire.rls.batched"
# SLO engine and alerting (slo/): csp.sentinel.slo.* tunes evaluation,
# csp.sentinel.alert.* the alert store and the webhook fan-out.
SLO_BASELINE_ALPHA = "csp.sentinel.slo.baseline.alpha"
SLO_BASELINE_ZSCORE = "csp.sentinel.slo.baseline.zscore"
SLO_BASELINE_WARMUP_SECONDS = "csp.sentinel.slo.baseline.warmup.seconds"
SLO_BASELINE_MIN_EVENTS = "csp.sentinel.slo.baseline.min.events"
SLO_ROLLOUT_ABORT = "csp.sentinel.slo.rollout.abort"
ALERT_HISTORY_CAPACITY = "csp.sentinel.alert.history.capacity"
ALERT_WEBHOOK_URLS = "csp.sentinel.alert.webhook.urls"
ALERT_WEBHOOK_TIMEOUT_MS = "csp.sentinel.alert.webhook.timeout.ms"
ALERT_WEBHOOK_RETRIES = "csp.sentinel.alert.webhook.retries"
# Closed-loop adaptive limiting (adaptive/). enabled: autonomous
# actuation is opt-in; the loop senses and proposes nothing until it is
# true (or ``engine.adaptive.enable()``).
ADAPTIVE_ENABLED = "csp.sentinel.adaptive.enabled"
ADAPTIVE_INTERVAL_SECONDS = "csp.sentinel.adaptive.interval.seconds"
ADAPTIVE_STEP_PCT = "csp.sentinel.adaptive.step.pct"
ADAPTIVE_INCREASE_PCT = "csp.sentinel.adaptive.increase.pct"
ADAPTIVE_DECREASE_PCT = "csp.sentinel.adaptive.decrease.pct"
ADAPTIVE_HYSTERESIS_PCT = "csp.sentinel.adaptive.hysteresis.pct"
ADAPTIVE_COOLDOWN_SECONDS = "csp.sentinel.adaptive.cooldown.seconds"
ADAPTIVE_FREEZE_STALE_SECONDS = "csp.sentinel.adaptive.freeze.stale.seconds"
ADAPTIVE_ABORT_BACKOFF_SECONDS = "csp.sentinel.adaptive.abort.backoff.seconds"
ADAPTIVE_SHADOW_SECONDS = "csp.sentinel.adaptive.shadow.seconds"
ADAPTIVE_CANARY_SECONDS = "csp.sentinel.adaptive.canary.seconds"
ADAPTIVE_CANARY_BPS = "csp.sentinel.adaptive.canary.bps"
ADAPTIVE_HISTORY_CAPACITY = "csp.sentinel.adaptive.history.capacity"
# Latency waterfall (telemetry/waterfall.py). enabled: per-request stage
# stamping on the wire path; history.seconds: sealed per-second records
# retained; exemplar.every: sampling cadence among traced requests;
# sentry.*: the per-stage budget regression sentry on the SLO windows.
WATERFALL_ENABLED = "csp.sentinel.waterfall.enabled"
WATERFALL_HISTORY_SECONDS = "csp.sentinel.waterfall.history.seconds"
WATERFALL_EXEMPLAR_EVERY = "csp.sentinel.waterfall.exemplar.every"
WATERFALL_SENTRY_ENABLED = "csp.sentinel.waterfall.sentry.enabled"
WATERFALL_SENTRY_MIN_EVENTS = "csp.sentinel.waterfall.sentry.min.events"
# Control-plane audit journal (telemetry/journal.py). path: empty = the
# in-memory tail only; capacity: the bounded in-memory tail;
# rotate.bytes: the fsync'd segment rotation threshold of the JSONL file.
JOURNAL_PATH = "csp.sentinel.journal.path"
JOURNAL_CAPACITY = "csp.sentinel.journal.capacity"
JOURNAL_ROTATE_BYTES = "csp.sentinel.journal.rotate.bytes"
# Fleet telemetry federation (telemetry/fleet.py). history.seconds:
# fleet-wide seconds the collector retains; stale.ms: how long a leader
# may go without a successful payload before it reports stale;
# max.seconds: complete seconds one fleetTelemetry reply page carries.
FLEET_HISTORY_SECONDS = "csp.sentinel.fleet.history.seconds"
FLEET_STALE_MS = "csp.sentinel.fleet.stale.ms"
FLEET_MAX_SECONDS = "csp.sentinel.fleet.max.seconds"
# The leader's self-reported name on a fleet page (the HA machine id).
CLUSTER_HA_MACHINE_ID = "csp.sentinel.cluster.ha.machine.id"
# Cluster HA (cluster/ha.py): the failover client's deadline before it
# serves degraded-quota verdicts, its reconnect cadence, the degraded
# share divisor when the map lists no clients, and the leader's shared
# checkpoint file and publish period.
CLUSTER_HA_FAILOVER_DEADLINE_MS = "csp.sentinel.cluster.ha.failover.deadline.ms"
CLUSTER_HA_RECONNECT_MS = "csp.sentinel.cluster.ha.reconnect.ms"
CLUSTER_HA_DEGRADED_DIVISOR = "csp.sentinel.cluster.ha.degraded.divisor"
CLUSTER_HA_CHECKPOINT_PATH = "csp.sentinel.cluster.ha.checkpoint.path"
CLUSTER_HA_CHECKPOINT_PERIOD_MS = "csp.sentinel.cluster.ha.checkpoint.period.ms"
# Sharded leaders (cluster/sharding.py): the per-slice handoff files'
# base path (the HA checkpoint path when unset).
CLUSTER_SHARD_HANDOFF_PATH = "csp.sentinel.cluster.shard.handoff.path"
# Chaos campaign (chaos/): the program clock's origin, the default
# episode count, driven seconds per episode, faults per schedule, and the
# ops surface's episode cap.
CHAOS_EPOCH_MS = "csp.sentinel.chaos.epoch.ms"
CHAOS_EPISODES = "csp.sentinel.chaos.episodes"
CHAOS_SECONDS_PER_EPISODE = "csp.sentinel.chaos.seconds.per.episode"
CHAOS_MAX_FAULTS = "csp.sentinel.chaos.max.faults"
CHAOS_MAX_EPISODES = "csp.sentinel.chaos.max.episodes"
# Shard rebalancer (cluster/rebalance.py): slices moved per applied plan,
# per-slice cooldown, the skew deadband, the fleet staleness that
# freezes it, the backoff after a failed certification, driven seconds
# per certification, and the sensing window.
REBALANCE_MAX_SLICES = "csp.sentinel.rebalance.max.slices.per.epoch"
REBALANCE_COOLDOWN_MS = "csp.sentinel.rebalance.cooldown.ms"
REBALANCE_DEADBAND_PCT = "csp.sentinel.rebalance.skew.deadband.pct"
REBALANCE_STALE_MS = "csp.sentinel.rebalance.stale.ms"
REBALANCE_BACKOFF_MS = "csp.sentinel.rebalance.abort.backoff.ms"
REBALANCE_CERTIFY_SECONDS = "csp.sentinel.rebalance.certify.seconds"
REBALANCE_WINDOW_SECONDS = "csp.sentinel.rebalance.window.seconds"
# The trace-replay simulator (simulator/): the simulated timebase origin
# for traces that carry none, the widest ladder width one simulated
# second's demand is chunked into, and the cap on drill replays.
SIM_EPOCH_MS = "csp.sentinel.sim.epoch.ms"
SIM_MAX_BATCH = "csp.sentinel.sim.max.batch"
SIM_DRILL_MAX_SECONDS = "csp.sentinel.sim.drill.max.seconds"
# LLM admission (llm/): the streaming-reservation ledger's capacity, the
# idle time after which a lease is an abandoned generation (evicted on
# the fold), and the up-front reservation when the caller gives no
# estimate.
LLM_MAX_STREAMS = "csp.sentinel.llm.max.streams"
LLM_IDLE_EVICT_MS = "csp.sentinel.llm.idle.evict.ms"
LLM_DEFAULT_ESTIMATE_TOKENS = "csp.sentinel.llm.default.estimate.tokens"

DEFAULT_LEASE_ENABLED = "true"
DEFAULT_APP_NAME = "sentinel-tpu-app"
DEFAULT_CHARSET = "utf-8"
DEFAULT_COLD_FACTOR = 3
DEFAULT_STATISTIC_MAX_RT = 4900
DEFAULT_SINGLE_METRIC_FILE_SIZE = 50 * 1024 * 1024
DEFAULT_TOTAL_METRIC_FILE_COUNT = 6
DEFAULT_PROFILE_SYNC_EVERY = 64
DEFAULT_TELEMETRY_TRACE_SAMPLE_EVERY = 64
DEFAULT_TELEMETRY_TRACE_CAPACITY = 256
DEFAULT_PIPELINE_INFLIGHT_DEPTH = 2
DEFAULT_PIPELINE_LINGER_US = 100
DEFAULT_TELEMETRY_TIMESERIES_SECONDS = 128
DEFAULT_TELEMETRY_TIMESERIES_HISTORY = 1024
DEFAULT_CLUSTER_SHARD_SLICES = 64
DEFAULT_CLUSTER_HA_FAILOVER_DEADLINE_MS = 3_000
DEFAULT_CLUSTER_HA_RECONNECT_MS = 250
# 1 = the full global threshold locally (single-client deployments);
# fleets list their clients in the map for the sum-of-shares bound.
DEFAULT_CLUSTER_HA_DEGRADED_DIVISOR = 1
DEFAULT_CLUSTER_HA_CHECKPOINT_PERIOD_MS = 5_000
# Two days past epoch 0: campaign stamps stay far from the wall clock.
DEFAULT_CHAOS_EPOCH_MS = 172_800_000
DEFAULT_CHAOS_EPISODES = 25
DEFAULT_CHAOS_SECONDS_PER_EPISODE = 12
DEFAULT_CHAOS_MAX_FAULTS = 6
DEFAULT_CHAOS_MAX_EPISODES = 50
DEFAULT_REBALANCE_MAX_SLICES = 4
DEFAULT_REBALANCE_COOLDOWN_MS = 60_000
DEFAULT_REBALANCE_DEADBAND_PCT = 0.25
DEFAULT_REBALANCE_STALE_MS = 10_000
DEFAULT_REBALANCE_BACKOFF_MS = 120_000
DEFAULT_REBALANCE_CERTIFY_SECONDS = 8
DEFAULT_REBALANCE_WINDOW_SECONDS = 30
# One day past epoch 0: simulated stamps stay far from the wall clock.
DEFAULT_SIM_EPOCH_MS = 86_400_000
DEFAULT_SIM_MAX_BATCH = 512
DEFAULT_SIM_DRILL_MAX_SECONDS = 300
DEFAULT_LLM_MAX_STREAMS = 4096
DEFAULT_LLM_IDLE_EVICT_MS = 30_000
DEFAULT_LLM_DEFAULT_ESTIMATE_TOKENS = 128
DEFAULT_POPULATION_TOPK = 64
DEFAULT_POPULATION_CMS_DEPTH = 4
DEFAULT_POPULATION_CMS_WIDTH = 512
DEFAULT_POPULATION_HLL_PRECISION = 11
DEFAULT_POPULATION_SLICE_PRECISION = 7
DEFAULT_POPULATION_WINDOW_SECONDS = 10
DEFAULT_POPULATION_CHURN_HISTORY = 360
DEFAULT_POPULATION_BASELINE_ALPHA = 0.2
DEFAULT_POPULATION_BASELINE_ZSCORE = 4.0
DEFAULT_SLOTS_BUDGET = 0
DEFAULT_SLOTS_REGISTRY_CAPACITY = 16384
DEFAULT_SLOTS_MAX_STEALS = 8
DEFAULT_SLOTS_HYSTERESIS_PCT = 20.0
DEFAULT_SLOTS_SPILL_MAX = 4096
DEFAULT_SLOTS_STALE_SECONDS = 30
DEFAULT_RESILIENCE_BREAKER_FAILURES = 3
DEFAULT_RESILIENCE_BREAKER_OPEN_MS = 5_000
DEFAULT_RESILIENCE_BREAKER_PROBES = 1
# Well under the client's 2 s request timeout: a degraded token server
# costs one entry a bounded, configured wait, never a socket timeout per
# cluster rule.
DEFAULT_RESILIENCE_ENTRY_BUDGET_MS = 500
DEFAULT_TELEMETRY_SPANS_SAMPLE_EVERY = 64
DEFAULT_TELEMETRY_SPANS_CAPACITY = 256
DEFAULT_OVERLOAD_QUEUE_MAX_GROUPS = 512
DEFAULT_OVERLOAD_QUEUE_WATERMARK_PCT = 80
DEFAULT_OVERLOAD_DEADLINE_MS = 2_000
DEFAULT_OVERLOAD_RETRY_AFTER_MS = 100
DEFAULT_OVERLOAD_CONN_MAX_BURST = 1024
DEFAULT_OVERLOAD_IDLE_TIMEOUT_S = 300
DEFAULT_OVERLOAD_RLS_MAX_CONCURRENT = 64
DEFAULT_OVERLOAD_CLIENT_BACKOFF_MS = 250
DEFAULT_WIRE_COALESCE_MAX_BATCH = 1024
DEFAULT_WIRE_INFLIGHT_DEPTH = 2
DEFAULT_WIRE_OUTBUF_MAX_BYTES = 1_048_576
DEFAULT_WIRE_READ_CHUNK_BYTES = 131_072
DEFAULT_WIRE_WORKERS = 4
DEFAULT_SLO_BASELINE_ALPHA = 0.2
DEFAULT_SLO_BASELINE_ZSCORE = 4.0
DEFAULT_SLO_BASELINE_WARMUP_SECONDS = 30
DEFAULT_SLO_BASELINE_MIN_EVENTS = 10
DEFAULT_ALERT_HISTORY_CAPACITY = 256
DEFAULT_ALERT_WEBHOOK_TIMEOUT_MS = 2_000
DEFAULT_ALERT_WEBHOOK_RETRIES = 3
DEFAULT_ADAPTIVE_INTERVAL_SECONDS = 5
DEFAULT_ADAPTIVE_STEP_PCT = 0.25
DEFAULT_ADAPTIVE_INCREASE_PCT = 0.10
DEFAULT_ADAPTIVE_DECREASE_PCT = 0.30
DEFAULT_ADAPTIVE_HYSTERESIS_PCT = 0.10
DEFAULT_ADAPTIVE_COOLDOWN_SECONDS = 30
DEFAULT_ADAPTIVE_FREEZE_STALE_SECONDS = 5
DEFAULT_ADAPTIVE_ABORT_BACKOFF_SECONDS = 120
DEFAULT_ADAPTIVE_SHADOW_SECONDS = 5
DEFAULT_ADAPTIVE_CANARY_SECONDS = 5
DEFAULT_ADAPTIVE_CANARY_BPS = 1_000
DEFAULT_ADAPTIVE_HISTORY_CAPACITY = 256
DEFAULT_WATERFALL_HISTORY_SECONDS = 600
DEFAULT_WATERFALL_EXEMPLAR_EVERY = 8
DEFAULT_WATERFALL_SENTRY_MIN_EVENTS = 50
DEFAULT_JOURNAL_CAPACITY = 512
DEFAULT_JOURNAL_ROTATE_BYTES = 4 * 1024 * 1024
DEFAULT_FLEET_HISTORY_SECONDS = 512
DEFAULT_FLEET_STALE_MS = 5_000
DEFAULT_FLEET_MAX_SECONDS = 16
DEFAULT_API_PORT = 8719
DEFAULT_HEARTBEAT_INTERVAL_MS = 10_000


def _env_key(key: str) -> str:
    return key.upper().replace(".", "_").replace("-", "_")


def _parse_properties(text: str) -> Dict[str, str]:
    """``key=value`` / ``key: value`` lines; ``#`` and ``!`` comments."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "!")):
            continue
        for sep in ("=", ":"):
            if sep in line:
                k, _, v = line.partition(sep)
                out[k.strip()] = v.strip()
                break
    return out


class SentinelConfig:
    """Process-wide key/value config: environment, then ``set``, then the
    properties file, then defaults."""

    def __init__(self):
        self._lock = threading.RLock()
        self._config: Dict[str, str] = {LEASE_ENABLED: DEFAULT_LEASE_ENABLED}
        self._loaded = False

    def _ensure_loaded(self):
        if self._loaded:
            return
        with self._lock:
            if self._loaded:
                return
            self._loaded = True
            defaults = {
                CHARSET: DEFAULT_CHARSET,
                SINGLE_METRIC_FILE_SIZE: str(DEFAULT_SINGLE_METRIC_FILE_SIZE),
                TOTAL_METRIC_FILE_COUNT: str(DEFAULT_TOTAL_METRIC_FILE_COUNT),
                COLD_FACTOR: str(DEFAULT_COLD_FACTOR),
                STATISTIC_MAX_RT: str(DEFAULT_STATISTIC_MAX_RT),
                API_PORT: str(DEFAULT_API_PORT),
                HEARTBEAT_INTERVAL_MS: str(DEFAULT_HEARTBEAT_INTERVAL_MS),
            }
            for k, v in defaults.items():
                self._config.setdefault(k, v)
            path = os.environ.get(CONFIG_FILE_ENV, "sentinel.properties")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    self._config.update(_parse_properties(f.read()))
            except OSError:
                pass
            # Env overrides: literal dotted key or CSP_SENTINEL_* form.
            for key in list(self._config) + [APP_NAME, DASHBOARD_SERVER,
                                             LOG_DIR]:
                for env in (key, _env_key(key)):
                    if env in os.environ:
                        self._config[key] = os.environ[env]

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        self._ensure_loaded()
        with self._lock:
            for env in (key, _env_key(key)):
                if env in os.environ:
                    return os.environ[env]
            return self._config.get(key, default)

    def set(self, key: str, value: str) -> None:
        self._ensure_loaded()
        with self._lock:
            self._config[key] = str(value)

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key)
        try:
            return int(v) if v is not None else default
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        v = self.get(key)
        try:
            return float(v) if v is not None else default
        except ValueError:
            return default

    def lease_enabled(self) -> bool:
        return (self.get(LEASE_ENABLED) or DEFAULT_LEASE_ENABLED).lower() \
            != "false"

    def log_dir(self) -> str:
        d = self.get(LOG_DIR)
        if d:
            return d
        return os.path.join(os.path.expanduser("~"), "logs", "csp")

    def app_name(self) -> str:
        return self.get(APP_NAME) or DEFAULT_APP_NAME

    def app_type(self) -> int:
        return self.get_int(APP_TYPE, 0)

    def charset(self) -> str:
        return self.get(CHARSET) or DEFAULT_CHARSET

    def statistic_max_rt(self) -> int:
        return self.get_int(STATISTIC_MAX_RT, DEFAULT_STATISTIC_MAX_RT)

    def api_port(self) -> int:
        return self.get_int(API_PORT, DEFAULT_API_PORT)

    def dashboard_server(self) -> Optional[str]:
        return self.get(DASHBOARD_SERVER)

    def heartbeat_interval_ms(self) -> int:
        return self.get_int(HEARTBEAT_INTERVAL_MS,
                            DEFAULT_HEARTBEAT_INTERVAL_MS)

    def single_metric_file_size(self) -> int:
        return self.get_int(SINGLE_METRIC_FILE_SIZE,
                            DEFAULT_SINGLE_METRIC_FILE_SIZE)

    def total_metric_file_count(self) -> int:
        return self.get_int(TOTAL_METRIC_FILE_COUNT,
                            DEFAULT_TOTAL_METRIC_FILE_COUNT)

    def pipeline_inflight_depth(self) -> int:
        v = self.get_int(PIPELINE_INFLIGHT_DEPTH,
                         DEFAULT_PIPELINE_INFLIGHT_DEPTH)
        return v if v > 0 else DEFAULT_PIPELINE_INFLIGHT_DEPTH

    def pipeline_linger_us(self) -> int:
        v = self.get_int(PIPELINE_LINGER_US, DEFAULT_PIPELINE_LINGER_US)
        return v if v >= 0 else DEFAULT_PIPELINE_LINGER_US

    def pipeline_pool_widths(self) -> tuple:
        """Parsed ladder widths to pre-allocate staging buffers for; () =
        the caller's default. Malformed entries are dropped."""
        out = []
        for part in (self.get(PIPELINE_POOL_WIDTHS) or "").split(","):
            try:
                w = int(part.strip())
            except ValueError:
                continue
            if w > 0:
                out.append(w)
        return tuple(out)

    def cluster_shard_slices(self) -> int:
        v = self.get_int(CLUSTER_SHARD_SLICES, DEFAULT_CLUSTER_SHARD_SLICES)
        return v if v > 0 else DEFAULT_CLUSTER_SHARD_SLICES

    # Namespace telescope (telemetry/population.py).

    def population_enabled(self) -> bool:
        return (self.get(POPULATION_ENABLED) or "true").lower() != "false"

    def population_topk(self) -> int:
        v = self.get_int(POPULATION_TOPK, DEFAULT_POPULATION_TOPK)
        return v if v > 0 else DEFAULT_POPULATION_TOPK

    def population_cms_depth(self) -> int:
        v = self.get_int(POPULATION_CMS_DEPTH, DEFAULT_POPULATION_CMS_DEPTH)
        return v if v > 0 else DEFAULT_POPULATION_CMS_DEPTH

    def population_cms_width(self) -> int:
        v = self.get_int(POPULATION_CMS_WIDTH, DEFAULT_POPULATION_CMS_WIDTH)
        return v if v >= 8 else DEFAULT_POPULATION_CMS_WIDTH

    def population_hll_precision(self) -> int:
        v = self.get_int(POPULATION_HLL_PRECISION,
                         DEFAULT_POPULATION_HLL_PRECISION)
        return v if 4 <= v <= 16 else DEFAULT_POPULATION_HLL_PRECISION

    def population_slice_precision(self) -> int:
        v = self.get_int(POPULATION_SLICE_PRECISION,
                         DEFAULT_POPULATION_SLICE_PRECISION)
        return v if 4 <= v <= 16 else DEFAULT_POPULATION_SLICE_PRECISION

    def population_window_seconds(self) -> int:
        v = self.get_int(POPULATION_WINDOW_SECONDS,
                         DEFAULT_POPULATION_WINDOW_SECONDS)
        return v if v > 0 else DEFAULT_POPULATION_WINDOW_SECONDS

    def population_churn_history(self) -> int:
        v = self.get_int(POPULATION_CHURN_HISTORY,
                         DEFAULT_POPULATION_CHURN_HISTORY)
        return v if v > 0 else DEFAULT_POPULATION_CHURN_HISTORY

    def population_baseline_alpha(self) -> float:
        v = self.get_float(POPULATION_BASELINE_ALPHA,
                           DEFAULT_POPULATION_BASELINE_ALPHA)
        return v if 0.0 < v <= 1.0 else DEFAULT_POPULATION_BASELINE_ALPHA

    def population_baseline_zscore(self) -> float:
        v = self.get_float(POPULATION_BASELINE_ZSCORE,
                           DEFAULT_POPULATION_BASELINE_ZSCORE)
        return v if v > 0.0 else DEFAULT_POPULATION_BASELINE_ZSCORE

    # Slot-table admission (core/slots.py): the only readers of the
    # csp.sentinel.slots.* keys.

    def slots_budget(self) -> int:
        v = self.get_int(SLOTS_BUDGET, DEFAULT_SLOTS_BUDGET)
        return v if v >= 0 else DEFAULT_SLOTS_BUDGET

    def slots_registry_capacity(self) -> int:
        v = self.get_int(SLOTS_REGISTRY_CAPACITY,
                         DEFAULT_SLOTS_REGISTRY_CAPACITY)
        return v if v > 0 else DEFAULT_SLOTS_REGISTRY_CAPACITY

    def slots_max_steals(self) -> int:
        v = self.get_int(SLOTS_MAX_STEALS, DEFAULT_SLOTS_MAX_STEALS)
        return v if v > 0 else DEFAULT_SLOTS_MAX_STEALS

    def slots_hysteresis_pct(self) -> float:
        v = self.get_float(SLOTS_HYSTERESIS_PCT,
                           DEFAULT_SLOTS_HYSTERESIS_PCT)
        return v if v >= 0.0 else DEFAULT_SLOTS_HYSTERESIS_PCT

    def slots_spill_max(self) -> int:
        v = self.get_int(SLOTS_SPILL_MAX, DEFAULT_SLOTS_SPILL_MAX)
        return v if v > 0 else DEFAULT_SLOTS_SPILL_MAX

    def slots_stale_seconds(self) -> int:
        v = self.get_int(SLOTS_STALE_SECONDS, DEFAULT_SLOTS_STALE_SECONDS)
        return v if v > 0 else DEFAULT_SLOTS_STALE_SECONDS

    # The token server's admission queue (cluster/server.py): the only
    # readers of the csp.sentinel.overload.* keys.

    def overload_queue_max_groups(self) -> int:
        v = self.get_int(OVERLOAD_QUEUE_MAX_GROUPS,
                         DEFAULT_OVERLOAD_QUEUE_MAX_GROUPS)
        return v if v > 0 else DEFAULT_OVERLOAD_QUEUE_MAX_GROUPS

    def overload_queue_watermark_pct(self) -> int:
        v = self.get_int(OVERLOAD_QUEUE_WATERMARK_PCT,
                         DEFAULT_OVERLOAD_QUEUE_WATERMARK_PCT)
        return min(v, 100) if v > 0 else DEFAULT_OVERLOAD_QUEUE_WATERMARK_PCT

    def overload_deadline_ms(self) -> int:
        v = self.get_int(OVERLOAD_DEADLINE_MS, DEFAULT_OVERLOAD_DEADLINE_MS)
        return v if v > 0 else DEFAULT_OVERLOAD_DEADLINE_MS

    def overload_retry_after_ms(self) -> int:
        v = self.get_int(OVERLOAD_RETRY_AFTER_MS,
                         DEFAULT_OVERLOAD_RETRY_AFTER_MS)
        return v if v > 0 else DEFAULT_OVERLOAD_RETRY_AFTER_MS

    def overload_conn_max_burst(self) -> int:
        v = self.get_int(OVERLOAD_CONN_MAX_BURST,
                         DEFAULT_OVERLOAD_CONN_MAX_BURST)
        return v if v > 0 else DEFAULT_OVERLOAD_CONN_MAX_BURST

    def overload_idle_timeout_s(self) -> int:
        v = self.get_int(OVERLOAD_IDLE_TIMEOUT_S,
                         DEFAULT_OVERLOAD_IDLE_TIMEOUT_S)
        return v if v > 0 else DEFAULT_OVERLOAD_IDLE_TIMEOUT_S

    def overload_client_backoff_ms(self) -> int:
        v = self.get_int(OVERLOAD_CLIENT_BACKOFF_MS,
                         DEFAULT_OVERLOAD_CLIENT_BACKOFF_MS)
        return v if v > 0 else DEFAULT_OVERLOAD_CLIENT_BACKOFF_MS

    def overload_rls_max_concurrent(self) -> int:
        v = self.get_int(OVERLOAD_RLS_MAX_CONCURRENT,
                         DEFAULT_OVERLOAD_RLS_MAX_CONCURRENT)
        return v if v > 0 else DEFAULT_OVERLOAD_RLS_MAX_CONCURRENT

    # The wire path (cluster/reactor.py): the only readers of the
    # csp.sentinel.wire.* keys.

    def wire_reactor_enabled(self) -> bool:
        return (self.get(WIRE_REACTOR_ENABLED) or "true").lower() != "false"

    def wire_coalesce_max_batch(self) -> int:
        v = self.get_int(WIRE_COALESCE_MAX_BATCH,
                         DEFAULT_WIRE_COALESCE_MAX_BATCH)
        return v if v > 0 else DEFAULT_WIRE_COALESCE_MAX_BATCH

    def wire_inflight_depth(self) -> int:
        v = self.get_int(WIRE_INFLIGHT_DEPTH, DEFAULT_WIRE_INFLIGHT_DEPTH)
        return v if v > 0 else DEFAULT_WIRE_INFLIGHT_DEPTH

    def wire_outbuf_max_bytes(self) -> int:
        v = self.get_int(WIRE_OUTBUF_MAX_BYTES,
                         DEFAULT_WIRE_OUTBUF_MAX_BYTES)
        return v if v > 0 else DEFAULT_WIRE_OUTBUF_MAX_BYTES

    def wire_read_chunk_bytes(self) -> int:
        v = self.get_int(WIRE_READ_CHUNK_BYTES,
                         DEFAULT_WIRE_READ_CHUNK_BYTES)
        return v if v > 0 else DEFAULT_WIRE_READ_CHUNK_BYTES

    def wire_workers(self) -> int:
        v = self.get_int(WIRE_WORKERS, DEFAULT_WIRE_WORKERS)
        return v if v > 0 else DEFAULT_WIRE_WORKERS

    def wire_rls_batched(self) -> bool:
        return (self.get(WIRE_RLS_BATCHED) or "false").lower() == "true"

    # Cluster HA, sharding, chaos and rebalancer (cluster/ha.py,
    # cluster/sharding.py, chaos/, cluster/rebalance.py): the only
    # readers of their keys.

    def cluster_ha_machine_id(self) -> Optional[str]:
        return self.get(CLUSTER_HA_MACHINE_ID)

    def cluster_ha_failover_deadline_ms(self) -> int:
        v = self.get_int(CLUSTER_HA_FAILOVER_DEADLINE_MS,
                         DEFAULT_CLUSTER_HA_FAILOVER_DEADLINE_MS)
        return v if v > 0 else DEFAULT_CLUSTER_HA_FAILOVER_DEADLINE_MS

    def cluster_ha_reconnect_ms(self) -> int:
        v = self.get_int(CLUSTER_HA_RECONNECT_MS,
                         DEFAULT_CLUSTER_HA_RECONNECT_MS)
        return v if v > 0 else DEFAULT_CLUSTER_HA_RECONNECT_MS

    def cluster_ha_degraded_divisor(self) -> int:
        v = self.get_int(CLUSTER_HA_DEGRADED_DIVISOR,
                         DEFAULT_CLUSTER_HA_DEGRADED_DIVISOR)
        return v if v > 0 else DEFAULT_CLUSTER_HA_DEGRADED_DIVISOR

    def cluster_ha_checkpoint_path(self) -> Optional[str]:
        return self.get(CLUSTER_HA_CHECKPOINT_PATH)

    def cluster_ha_checkpoint_period_ms(self) -> int:
        v = self.get_int(CLUSTER_HA_CHECKPOINT_PERIOD_MS,
                         DEFAULT_CLUSTER_HA_CHECKPOINT_PERIOD_MS)
        return v if v > 0 else DEFAULT_CLUSTER_HA_CHECKPOINT_PERIOD_MS

    def cluster_shard_handoff_path(self) -> Optional[str]:
        return self.get(CLUSTER_SHARD_HANDOFF_PATH)

    def chaos_epoch_ms(self) -> int:
        v = self.get_int(CHAOS_EPOCH_MS, DEFAULT_CHAOS_EPOCH_MS)
        return v if v > 0 else DEFAULT_CHAOS_EPOCH_MS

    def chaos_episodes(self) -> int:
        v = self.get_int(CHAOS_EPISODES, DEFAULT_CHAOS_EPISODES)
        return v if v > 0 else DEFAULT_CHAOS_EPISODES

    def chaos_seconds_per_episode(self) -> int:
        v = self.get_int(CHAOS_SECONDS_PER_EPISODE,
                         DEFAULT_CHAOS_SECONDS_PER_EPISODE)
        return v if v > 0 else DEFAULT_CHAOS_SECONDS_PER_EPISODE

    def chaos_max_faults(self) -> int:
        v = self.get_int(CHAOS_MAX_FAULTS, DEFAULT_CHAOS_MAX_FAULTS)
        return v if v > 0 else DEFAULT_CHAOS_MAX_FAULTS

    def chaos_max_episodes(self) -> int:
        v = self.get_int(CHAOS_MAX_EPISODES, DEFAULT_CHAOS_MAX_EPISODES)
        return v if v > 0 else DEFAULT_CHAOS_MAX_EPISODES

    def rebalance_max_slices_per_epoch(self) -> int:
        v = self.get_int(REBALANCE_MAX_SLICES, DEFAULT_REBALANCE_MAX_SLICES)
        return v if v > 0 else DEFAULT_REBALANCE_MAX_SLICES

    def rebalance_cooldown_ms(self) -> int:
        v = self.get_int(REBALANCE_COOLDOWN_MS, DEFAULT_REBALANCE_COOLDOWN_MS)
        return v if v > 0 else DEFAULT_REBALANCE_COOLDOWN_MS

    def rebalance_skew_deadband_pct(self) -> float:
        v = self.get_float(REBALANCE_DEADBAND_PCT,
                           DEFAULT_REBALANCE_DEADBAND_PCT)
        return v if 0.0 < v <= 10.0 else DEFAULT_REBALANCE_DEADBAND_PCT

    def rebalance_stale_ms(self) -> int:
        v = self.get_int(REBALANCE_STALE_MS, DEFAULT_REBALANCE_STALE_MS)
        return v if v > 0 else DEFAULT_REBALANCE_STALE_MS

    def rebalance_abort_backoff_ms(self) -> int:
        v = self.get_int(REBALANCE_BACKOFF_MS, DEFAULT_REBALANCE_BACKOFF_MS)
        return v if v >= 0 else DEFAULT_REBALANCE_BACKOFF_MS

    def rebalance_certify_seconds(self) -> int:
        v = self.get_int(REBALANCE_CERTIFY_SECONDS,
                         DEFAULT_REBALANCE_CERTIFY_SECONDS)
        return v if v > 1 else DEFAULT_REBALANCE_CERTIFY_SECONDS

    def rebalance_window_seconds(self) -> int:
        v = self.get_int(REBALANCE_WINDOW_SECONDS,
                         DEFAULT_REBALANCE_WINDOW_SECONDS)
        return v if v > 0 else DEFAULT_REBALANCE_WINDOW_SECONDS

    # SLO and alerting (slo/): the only readers of the csp.sentinel.slo.*
    # and csp.sentinel.alert.* keys.

    def slo_baseline_alpha(self) -> float:
        v = self.get_float(SLO_BASELINE_ALPHA, DEFAULT_SLO_BASELINE_ALPHA)
        return v if 0.0 < v < 1.0 else DEFAULT_SLO_BASELINE_ALPHA

    def slo_baseline_zscore(self) -> float:
        v = self.get_float(SLO_BASELINE_ZSCORE, DEFAULT_SLO_BASELINE_ZSCORE)
        return v if v > 0 else DEFAULT_SLO_BASELINE_ZSCORE

    def slo_baseline_warmup_seconds(self) -> int:
        v = self.get_int(SLO_BASELINE_WARMUP_SECONDS,
                         DEFAULT_SLO_BASELINE_WARMUP_SECONDS)
        return v if v >= 0 else DEFAULT_SLO_BASELINE_WARMUP_SECONDS

    def slo_baseline_min_events(self) -> int:
        v = self.get_int(SLO_BASELINE_MIN_EVENTS,
                         DEFAULT_SLO_BASELINE_MIN_EVENTS)
        return v if v >= 0 else DEFAULT_SLO_BASELINE_MIN_EVENTS

    def slo_rollout_abort(self) -> bool:
        return (self.get(SLO_ROLLOUT_ABORT) or "true").lower() != "false"

    def alert_history_capacity(self) -> int:
        v = self.get_int(ALERT_HISTORY_CAPACITY,
                         DEFAULT_ALERT_HISTORY_CAPACITY)
        return v if v > 0 else DEFAULT_ALERT_HISTORY_CAPACITY

    def alert_webhook_urls(self) -> list:
        raw = self.get(ALERT_WEBHOOK_URLS) or ""
        return [u.strip() for u in raw.split(",") if u.strip()]

    def alert_webhook_timeout_ms(self) -> int:
        v = self.get_int(ALERT_WEBHOOK_TIMEOUT_MS,
                         DEFAULT_ALERT_WEBHOOK_TIMEOUT_MS)
        return v if v > 0 else DEFAULT_ALERT_WEBHOOK_TIMEOUT_MS

    def alert_webhook_retries(self) -> int:
        v = self.get_int(ALERT_WEBHOOK_RETRIES,
                         DEFAULT_ALERT_WEBHOOK_RETRIES)
        return v if v >= 0 else DEFAULT_ALERT_WEBHOOK_RETRIES

    # Adaptive limiting (adaptive/): the only readers of the
    # csp.sentinel.adaptive.* keys.

    def adaptive_enabled(self) -> bool:
        return (self.get(ADAPTIVE_ENABLED) or "false").lower() == "true"

    def adaptive_interval_seconds(self) -> int:
        v = self.get_int(ADAPTIVE_INTERVAL_SECONDS,
                         DEFAULT_ADAPTIVE_INTERVAL_SECONDS)
        return v if v > 0 else DEFAULT_ADAPTIVE_INTERVAL_SECONDS

    def adaptive_step_pct(self) -> float:
        v = self.get_float(ADAPTIVE_STEP_PCT, DEFAULT_ADAPTIVE_STEP_PCT)
        return v if 0.0 < v <= 1.0 else DEFAULT_ADAPTIVE_STEP_PCT

    def adaptive_increase_pct(self) -> float:
        v = self.get_float(ADAPTIVE_INCREASE_PCT,
                           DEFAULT_ADAPTIVE_INCREASE_PCT)
        return v if v > 0.0 else DEFAULT_ADAPTIVE_INCREASE_PCT

    def adaptive_decrease_pct(self) -> float:
        v = self.get_float(ADAPTIVE_DECREASE_PCT,
                           DEFAULT_ADAPTIVE_DECREASE_PCT)
        return v if 0.0 < v < 1.0 else DEFAULT_ADAPTIVE_DECREASE_PCT

    def adaptive_hysteresis_pct(self) -> float:
        v = self.get_float(ADAPTIVE_HYSTERESIS_PCT,
                           DEFAULT_ADAPTIVE_HYSTERESIS_PCT)
        return v if v >= 0.0 else DEFAULT_ADAPTIVE_HYSTERESIS_PCT

    def adaptive_cooldown_seconds(self) -> int:
        v = self.get_int(ADAPTIVE_COOLDOWN_SECONDS,
                         DEFAULT_ADAPTIVE_COOLDOWN_SECONDS)
        return v if v >= 0 else DEFAULT_ADAPTIVE_COOLDOWN_SECONDS

    def adaptive_freeze_stale_seconds(self) -> int:
        v = self.get_int(ADAPTIVE_FREEZE_STALE_SECONDS,
                         DEFAULT_ADAPTIVE_FREEZE_STALE_SECONDS)
        return v if v > 0 else DEFAULT_ADAPTIVE_FREEZE_STALE_SECONDS

    def adaptive_abort_backoff_seconds(self) -> int:
        v = self.get_int(ADAPTIVE_ABORT_BACKOFF_SECONDS,
                         DEFAULT_ADAPTIVE_ABORT_BACKOFF_SECONDS)
        return v if v >= 0 else DEFAULT_ADAPTIVE_ABORT_BACKOFF_SECONDS

    def adaptive_shadow_seconds(self) -> int:
        v = self.get_int(ADAPTIVE_SHADOW_SECONDS,
                         DEFAULT_ADAPTIVE_SHADOW_SECONDS)
        return v if v >= 0 else DEFAULT_ADAPTIVE_SHADOW_SECONDS

    def adaptive_canary_seconds(self) -> int:
        v = self.get_int(ADAPTIVE_CANARY_SECONDS,
                         DEFAULT_ADAPTIVE_CANARY_SECONDS)
        return v if v >= 0 else DEFAULT_ADAPTIVE_CANARY_SECONDS

    def adaptive_canary_bps(self) -> int:
        v = self.get_int(ADAPTIVE_CANARY_BPS, DEFAULT_ADAPTIVE_CANARY_BPS)
        return v if 0 < v <= 10_000 else DEFAULT_ADAPTIVE_CANARY_BPS

    def adaptive_history_capacity(self) -> int:
        v = self.get_int(ADAPTIVE_HISTORY_CAPACITY,
                         DEFAULT_ADAPTIVE_HISTORY_CAPACITY)
        return v if v > 0 else DEFAULT_ADAPTIVE_HISTORY_CAPACITY

    # Latency waterfall (telemetry/waterfall.py): the only readers of the
    # csp.sentinel.waterfall.* keys.

    def waterfall_enabled(self) -> bool:
        return (self.get(WATERFALL_ENABLED) or "true").lower() != "false"

    def waterfall_history_seconds(self) -> int:
        v = self.get_int(WATERFALL_HISTORY_SECONDS,
                         DEFAULT_WATERFALL_HISTORY_SECONDS)
        return v if v > 0 else DEFAULT_WATERFALL_HISTORY_SECONDS

    def waterfall_exemplar_every(self) -> int:
        v = self.get_int(WATERFALL_EXEMPLAR_EVERY,
                         DEFAULT_WATERFALL_EXEMPLAR_EVERY)
        return v if v > 0 else DEFAULT_WATERFALL_EXEMPLAR_EVERY

    def waterfall_sentry_enabled(self) -> bool:
        return (self.get(WATERFALL_SENTRY_ENABLED)
                or "true").lower() != "false"

    def waterfall_sentry_min_events(self) -> int:
        v = self.get_int(WATERFALL_SENTRY_MIN_EVENTS,
                         DEFAULT_WATERFALL_SENTRY_MIN_EVENTS)
        return v if v > 0 else DEFAULT_WATERFALL_SENTRY_MIN_EVENTS

    # Journal and fleet (telemetry/journal.py, telemetry/fleet.py): the
    # only readers of the csp.sentinel.journal.* and csp.sentinel.fleet.*
    # keys.

    def journal_path(self) -> Optional[str]:
        v = self.get(JOURNAL_PATH)
        return v if v else None

    def journal_capacity(self) -> int:
        v = self.get_int(JOURNAL_CAPACITY, DEFAULT_JOURNAL_CAPACITY)
        return v if v > 0 else DEFAULT_JOURNAL_CAPACITY

    def journal_rotate_bytes(self) -> int:
        v = self.get_int(JOURNAL_ROTATE_BYTES, DEFAULT_JOURNAL_ROTATE_BYTES)
        return v if v > 0 else DEFAULT_JOURNAL_ROTATE_BYTES

    def fleet_history_seconds(self) -> int:
        v = self.get_int(FLEET_HISTORY_SECONDS, DEFAULT_FLEET_HISTORY_SECONDS)
        return v if v > 0 else DEFAULT_FLEET_HISTORY_SECONDS

    def fleet_stale_ms(self) -> int:
        v = self.get_int(FLEET_STALE_MS, DEFAULT_FLEET_STALE_MS)
        return v if v > 0 else DEFAULT_FLEET_STALE_MS

    def fleet_max_seconds(self) -> int:
        v = self.get_int(FLEET_MAX_SECONDS, DEFAULT_FLEET_MAX_SECONDS)
        return v if v > 0 else DEFAULT_FLEET_MAX_SECONDS

    # Simulator (simulator/) and LLM admission (llm/): the only readers of
    # the csp.sentinel.sim.* and csp.sentinel.llm.* keys.

    def sim_epoch_ms(self) -> int:
        v = self.get_int(SIM_EPOCH_MS, DEFAULT_SIM_EPOCH_MS)
        return v if v > 0 else DEFAULT_SIM_EPOCH_MS

    def sim_max_batch(self) -> int:
        v = self.get_int(SIM_MAX_BATCH, DEFAULT_SIM_MAX_BATCH)
        return v if v > 0 else DEFAULT_SIM_MAX_BATCH

    def sim_drill_max_seconds(self) -> int:
        v = self.get_int(SIM_DRILL_MAX_SECONDS,
                         DEFAULT_SIM_DRILL_MAX_SECONDS)
        return v if v > 0 else DEFAULT_SIM_DRILL_MAX_SECONDS

    def llm_max_streams(self) -> int:
        v = self.get_int(LLM_MAX_STREAMS, DEFAULT_LLM_MAX_STREAMS)
        return v if v > 0 else DEFAULT_LLM_MAX_STREAMS

    def llm_idle_evict_ms(self) -> int:
        v = self.get_int(LLM_IDLE_EVICT_MS, DEFAULT_LLM_IDLE_EVICT_MS)
        return v if v > 0 else DEFAULT_LLM_IDLE_EVICT_MS

    def llm_default_estimate_tokens(self) -> int:
        v = self.get_int(LLM_DEFAULT_ESTIMATE_TOKENS,
                         DEFAULT_LLM_DEFAULT_ESTIMATE_TOKENS)
        return v if v > 0 else DEFAULT_LLM_DEFAULT_ESTIMATE_TOKENS

    def reset_for_tests(self) -> None:
        with self._lock:
            self._config = {LEASE_ENABLED: DEFAULT_LEASE_ENABLED}
            self._loaded = False


config = SentinelConfig()
