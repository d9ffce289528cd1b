"""Chip smoke for the PyTorch port (``sentinel_tpu_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; none is caught):

1. Device: CUDA must be available; prints the card, the count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compiles ``sentinel_tpu_torch/csrc/segmented_prefix.cu`` (and
   the headers it includes) and ``csrc/cluster_acquire.cu``, one nvcc for
   each, for sm_90a, and the client shim ``csrc/sentinel_shim.cpp`` with
   the host C++ compiler, all three started together, and prints the
   ``-Xptxas -v`` register / shared-memory lines and the shim's build
   time.
3. Kernel vs plain: the segmented-prefix kernel against the plain sort +
   cumsum version on the card, bit-equal, at N in {1, 8, 64, 512, 1000, 1024,
   2048, 8192}, K in {1, 3}, M in {1, 2}, with the 256 and near-2^24 value
   edges, the id patterns a radix sort gets wrong (``full_int32``,
   ``all_distinct``, ``all_equal``), and N in {16384, 65536}, above the
   block sort's capacity, where the launcher takes the tile walk; device
   times for both (CUDA-graph replay), the kernel's per-call time with
   host dispatch, the card's bound for the function's least work (bytes,
   or an N log N sort-and-scan), and at N=8192, K=3, M=2 the tile walk's
   device time on the same inputs (``previous_ms``).
4. Main path: ``SentinelEngine(capacity=32768)`` with the bench headline
   rules (10,000 resources; flow on every 10th, degrade on every 20th,
   param on every 40th, one system rule), 32 check_batch + complete_batch
   rounds at widths 2048 and 8192 on an advancing clock (bucket and
   second boundaries) plus one mixed-count batch; prints rule-checks/s,
   per-step ms, host syncs per step and kernel launches per entry step;
   requires the kernel to have run, and through the block sort only.
   A profile of a few rounds at width 8192 gives the device busy share,
   the kernels that take the most device time, and the prefix kernel's
   own time and share; the trace's kernel names must show the block sort
   alone, as many times as the wrapper counted.
5. Parity: the same 8-round sequence at width 2048 on ``cuda`` and on
   ``cpu`` with a blocking rule mix; decisions and integer state must be
   equal, float state within FLOAT_RTOL.
6. API: ``sentinel_tpu_torch.reset(capacity=32768)`` on the card, the
   bench's 10,000 resources with flow (every 10th; DEFAULT, WARM_UP,
   RATE_LIMITER, WARM_UP_RATE_LIMITER by ``(i // 10) % 4``), param (every
   40th), degrade (``i % 20 == 5``) and authority (``i % 50 == 5``)
   rules, so every path of ``entry()`` carries traffic: 8 threads x 5,000
   ``with st.entry(...)`` pairs on the real clock (60% unruled, 38%
   leased, 2% device path; 20% inside ``context_enter``), timed per pair
   and class; the engine lock's waits and holds by taker (callers'
   device steps, the committer's flushes) and its busy share of the
   window; 16 device-path pairs alone after the window, for scale; the
   committer's flushes and their widths, the prefix launches by shape
   (block sort only), ``fail_open_count`` (must be 0), the lease ring
   (must be ``"native"``); then a system rule must stand every fast path
   down, and ``close()`` must leave the committer's queues empty with no
   failed flush. A seeded single-threaded script of 2,000 entry/exit pairs, 8 to
   each 5 ms step of the port's frozen clock, then runs on ``cuda`` and on
   ``cpu``: verdicts and ``node_snapshot()`` must be equal. Prints one
   ``{"api": ...}`` line.
7. Pipeline: a fresh default engine with the API phase's resources and
   rules, warmed at widths 1, 8 and 64, under ``start_pipeline(max_batch=8,
   linger_s=0.0002)``: 16 threads of ``with st.entry(...)`` pairs on the
   real clock for 10 s over the API phase's class mix, every one of them
   decided on the card in the collector's cycles. Prints one
   ``{"pipeline": ...}`` line: pairs/s, pair ms by class, blocked shares,
   ``pipeline_stats()``, the cycles' ladder widths, ``step_timer``, the
   engine lock's held share, prefix launches by shape, host-to-device
   copies per batch, the trace ring's counts and ``fail_open_count``; no
   cycle may fail open, batching must engage, the kernel must run (block
   sort only), the thread gauges must drain and the trace pump must see
   no error. Then, under the frozen clock, each on a fresh engine: 100
   tickets straight to the collector come back in FIFO order (50 pass, 50
   FLOW) with two cycles in flight, and 40 more entries allocate no
   staging buffer; 16 threads x 10 entries on a count-25 rule pass exactly
   25; a seeded 90-op stream gives the same verdicts synchronously on
   ``cuda``, pipelined on ``cuda`` and pipelined on ``cpu``, and the two
   pipelined ``node_snapshot()``s agree.
8. Slots: first card against CPU, with identical injected clocks: the
   reference's differential oracle (16 names, ``FlowRule(count=3)`` on
   names 0, 5 and 10, Zipf weights, 10 simulated seconds x 20 pairs, slot
   budgets 8 and 64) and its storm drill (budget 3, ``slots.evict.storm``
   armed after=2, times=2) give the same verdicts, ``slots.status()``,
   event histories, ``timeseries_view`` and state (ring included) on both;
   the budget-8 engine evicts, its twin does not, and their verdicts are
   equal. Then a timed run at a deployment's size:
   ``SentinelEngine(slot_budget=4098)``, 4,000 resources with leaseable
   QPS rules (pinned hot) and an unruled Zipf(1.2) tail of 12,000 names
   contesting the 96 dynamic slots, 10 simulated seconds of 1,024 leased
   and 64 tail pairs and one fold each. It must evict, rehydrate and pass
   cold, never block cold or evict a pinned resource, never fail open,
   and conserve every PASS (device totals at the current slots + spill
   records + cold tallies = pairs served). Prints one ``{"slots": ...}``
   line: pairs/s, pair latency by class, hit rate, steals, evictions and
   rehydrations, the surgeries (count, ms, bytes each way), the spill ms,
   the prefix launches by shape (block sort only) and the peak memory.
   The phase must end within 120 s.
9. Boot: the engine's boot surface, each part on the card and on the CPU
   with identical injected clocks. (1) Config: engines built under
   ``csp.sentinel.statistic.interval.ms`` 2000, ``.sample.count`` 4 and
   ``csp.sentinel.occupy.timeout.ms`` 250 must seed (2000, 4, 250); a
   seeded stream of 500 ``with eng.entry(...)`` pairs over 5 simulated
   seconds (a leased QPS quota, a leased warm-up rule, a rate limiter, an
   exception-ratio breaker, an unruled name) must give the same verdicts
   and state on both; then ``window_geometry_property`` (1000 ms / 2) and
   ``occupy_timeout_property`` (250) are pushed (accepted, then an equal
   push returns False) and the stream runs again. (2) Warm restart: five
   ``save_checkpoint``s of the main path's engine (capacity 32,768; the
   lock-held ms, the save ms, the file's bytes), which must leave its
   state unchanged; the file restored into a fresh card engine and a
   fresh CPU engine must give the twelve tensors bit for bit (the thread
   gauges zero) and the same decisions over the next 8 batches at width
   8192; the slot phase's engine (budget 4,098) saved and restored on
   both must give back its slot assignment; a ``CheckpointTimer`` every
   0.5 s over at least 3 s of the API phase's traffic on one thread must
   write at least 4 files, all loadable. (3) SPI: the two checkers of
   ``tests/test_spi.py`` in torch (a cap on ``count > 3``, 2 PASS a
   second per cluster row from the rotated ``w1``) over 250 pairs in 2.5
   simulated seconds on the API phase's engine kind (capacity 8,192, as
   its parity script): the same verdicts, reasons and ``rule_slot``s,
   ``node_snapshot`` and state on both, every pair a device entry while
   registered, the leased pairs back after unregistering; and one
   ``check_batch`` at width 8192 with the cap checker must launch the
   prefix kernel 4 times. Prints one ``{"boot": ...}`` line with the
   prefix launches by shape (block sort only); the phase must end within
   60 s.
10. Rollout: staged rollout and the metric log, each part on the card and
   on the CPU with identical injected clocks and seeded streams. (1) The
   main path's engine kind (capacity 32,768, the headline rules) with a
   candidate staged through ``rollout.load_candidate``: finite QPS counts
   on 100 flow-ruled resources (half DEFAULT, half RATE_LIMITER), one
   param rule, one authority white list; 8 check_batch + complete_batch
   rounds at width 8192 and 8 at 2048, 130 ms apart. Decisions,
   ``shadow_counts()`` and the whole state (shadow included) must be
   equal; a second card engine ENFORCING the merged rules over the same
   stream must tally, per resource, what the shadow's would-pass and
   would-block counters hold. Prints entry ms, prefix launches and host
   syncs per step with the candidate (beside the main path's without),
   and the shadow's device bytes. Both engines' metric logs are sealed
   at the stream's end: the files and their ``.idx`` must be byte-equal
   and a ``MetricSearcher`` reads every line back. (2) A bad candidate
   (count 0 on the same 100 resources) in canary at 2,500 bps, 4 rounds
   at 8192 from 64 origins: every lane's verdict is its host
   ``in_canary`` prediction; then 0 bps governs no lane and 10,000 every
   lane. (3) The guardrail's ``tick()`` once a simulated second until it
   aborts; then ``shadow_counts()`` is None, a headline round at 8192 is
   back to 15.0625 syncs, a ``MetricTimerListener`` thread writes at
   least 2 seconds, the leases come back (system rule removed), and a
   promoted candidate's rules are live and equal on card and CPU. (4) The
   slot phase's oracle engine at budget 8 (it steals and rehydrates) with
   a datasource-staged candidate, 10 simulated seconds: card = CPU,
   shadow included, and every surgery leaves the touched shadow columns
   zero. Prints one ``{"rollout": ...}`` line with each part's seconds
   and the prefix launches by shape (block sort only); the phase must
   end within 60 s.
11. Cluster: the cluster token path on the card (BASELINE config #4,
   the 64-node mesh). (1) The acquire kernel (``csrc/cluster_acquire.cu``)
   against its plain form at N in {1, 8, 64, 256, 1024, 4096} over 64
   flows, on seeded lanes that hit every status with unknown and
   out-of-range slots: ``ok``, ``can_wait`` and ``passed`` bit-equal;
   kernel ms (CUDA-graph replay), call ms, plain ms and the bound (bytes,
   operations, or the longest same-slot run as a dependent chain, with
   its derivation). (2) ``DefaultTokenService`` on the card and on the
   CPU over one seeded stream on a frozen clock (bench.py:231's 64 flows
   and batches of 512, GLOBAL and AVG_LOCAL, a prioritized share, a rule
   push halfway, param tokens): every TokenResult, the window state and
   ``metrics_snapshot`` equal. (3) The wire mesh of bench.py:1106: 64
   GLOBAL flows, the limiter lifted, the reactor on the card, 8 threads x
   8 connections with 64 requests in flight each, a 5 s settle and two 4
   s windows; every reply OK, the server's OK verdicts equal the replies,
   and after the window empties one burst's replies equal the server's
   window total; acquires/s, ``wire_stats()``, host ms per fused batch
   and the device share of one profiled batch. (4) The API phase's
   engine kind as the client of a port token server on the card in a
   process of its own (this script with ``--client-token-server``,
   started as the phase starts, as a token server is deployed apart
   from its clients; in this process it would share the
   interpreter lock with the four client threads, and a stall there
   outlasts the entry budget): 64 cluster-mode rules (GLOBAL, 2 a
   second, local fallback), the service warmed before the port binds,
   every entry sampled, 4 threads of pairs for 10 s: pair p50/p99, the
   remote requests' ms on the client and the service's on the server, no
   fallback, no flow admitted over 2 in any second, the engine's passes
   equal the server's OK verdicts, three stitched spans per entry; then
   the server stops answering and 8 entries fall back inside the entry
   budget until the breaker opens, and after the server stops the check
   is local. Counts are zeroed before (3) and read after (4), the
   server's in its process. The phase must end within 60 s. Prints one
   ``{"cluster": ...}`` line.
12. Pod: the pod path (``parallel/cluster.py``, ``parallel/namespaces.py``)
   on the card. (a) Eight shards of the main path's configuration
   (capacity 32,768, the 10,000 resources, the 128-second ring each), the
   flow rules on every 10th resource cluster-mode at 5 a second and the
   param rules on every 40th cluster-mode at 3, half the lanes on those
   resources; a pod batch of 8,192 (1,024 a shard) for 16 rounds 50 ms
   apart on a frozen clock, with exits. Per cluster rule and second the
   pod admits at most the threshold plus (D - 1) x its largest per-shard
   admission in one step, and no rule admits in the step after its pod
   total reached the threshold; 4 x D prefix launches a step, host syncs
   a step at most D x 15.0625; entry ms per step and per shard, pod
   rule-checks/s, the reduction's ms and bytes. (b) The same kind of
   stream at the cut size (4 shards, capacity 8,192, 2,000 resources, 256
   lanes a shard, 6 rounds) on the card and the CPU: every decision and
   every leaf equal. (c) A 2 x 4 pod with a global-scope and a pod-scope
   rule: the bounds of ``tests/test_namespaces.py:80-135``. (d) NCCL at
   world size 1 (a FileStore): the distributed drivers equal the
   one-process drivers at D = 1, and the all_reduce's ms. (e) At the cut
   size a candidate staged pod-wide: its summed shadow counters equal the
   counts of a pod enforcing it; the pod checkpoint saved and restored on
   the card; the global reads equal the sums of the shards' reads. Counts
   are zeroed before (a)'s rounds and read after them. The phase must end
   within 60 s. Prints one ``{"pod": ...}`` line.
13. Control: the control plane that rides the once-per-second fold. (a-c)
   The main path's configuration (capacity 32,768, the 10,000 resources
   and headline rules) on an injected clock, 17 simulated seconds of four
   width-2048 batches a second with exits and one fold a second, on the
   card and then on the CPU: after 4 s, availability objectives load on 64
   resources (a 10 s / 2 s page pair and a 30 s / 5 s ticket pair) and
   adaptive targets on 16 tunable flow rules; a burst on ``res0`` (its
   rule tightened to 8 a second) fires and resolves both alerts and raises
   ``abort_signal``; the loop proposes, shadows, canaries and promotes
   ``res1000`` (64 -> 128 under 96 a second) and proposes a decrease of
   ``res1010`` (exits at 50 ms against a 1 ms p99 target) that the
   guardrail aborts, leaving the last-known-good rules live. Decisions,
   every fold's alert store, ``abort_signal`` and guardrail states, the
   shadow counters, the SLO status, the decision log, the live rules, the
   journal's records, ``why_query`` and ``explain_trace`` (less the window
   the trace pump reads at its own time) must be equal on both; the
   webhook must deliver every transition to a loopback endpoint; the
   card's journal directory must recover in a fresh engine (records, the
   decision log and the alert log). Prints the fold's ms with and without
   objectives, the render's ms, entry ms / host syncs / prefix launches a
   step with no candidate, in shadow and in canary, the journal's bytes
   and its record-with-fsync ms. (d) The pipeline under 16 callers for
   4 s on a card engine that is also an embedded token server answering 4
   loopback connections: every sealed second's pipeline, batch and wire
   counts equal the observations filed in it, their totals equal the
   pipeline's harvests, the token service's harvested batches and the
   replies; the wire stages reconcile with the RTT and the exemplars
   resolve to stitched spans. (e) Three port leaders (engine + token
   server; cut to 200 resources so a second fits a frame) under one
   ``FleetView``: every settled fleet cell is the sum of the leaders' own
   ``timeseries_view`` cells. (f) With objectives and idle targets loaded
   the main path's step stays at 15.0625 host syncs and 4.0 prefix
   launches. (g) No thread the phase started is alive after its engines
   close. The phase must end within 60 s. Prints one ``{"control": ...}``
   line.
14. HA: the HA token cluster (``cluster/ha.py``, ``cluster/sharding.py``,
   ``cluster/rebalance.py``, ``chaos/``). (1) Failover, on the card and
   then on the CPU under the port's frozen clock: a 3-seat ``ClusterMap``
   in process, eight GLOBAL flows of 40 a second; leader A grants 17 of
   each, publishes its cluster checkpoint, grants 3 more; the
   ``cluster.ha.leader.crash`` seam kills it on a wire request; an epoch-2
   map promotes B, which restores A's 8 rows and admits: every flow
   admits exactly 40 + 3 across the handoff (the grants since the
   publish), every grant equal on card and CPU, and the role flip journals
   its map apply as cause. Prints rows restored, promote, save and
   restore ms and the file's bytes. (2) BENCH_19's shard_mesh on
   loopback on the card: 3 leaders each owning a third of a 64-slice ring
   (WRONG_SLICE checks and slice epochs live), 6 threads x 11
   connections with 256 requests in flight each, a settle and two 2.5 s
   windows: acquires/s in total and per leader, no WRONG_SLICE. A map
   push to the rebalance drill's skew (A owning slices 0-31) re-seats the
   leaders 0.25 s before the clients route: WRONG_SLICE answers in that
   lag, none once every thread's burst follows the new map. (3) The
   rebalance drill on that mesh: ``propose`` moves slices 0-3 off A,
   ``certify`` (campaign seed 0) on the card and on the CPU gives the
   bench record's verdict sha256 on both, ``apply`` pushes the map (with
   its WRONG_SLICE lag and heal) under the journal chain apply ->
   certify -> propose, a window after the move, ``rollback``. (4) The
   chaos campaign (seed 14), its first 10 episodes on the card and on
   the CPU: every episode's verdict and fault sha256 equal, 0 violations,
   episodes/s. Acquire launches are zeroed before each card run and read
   after it; no thread the phase started is left. The phase must end
   within 90 s. Prints one ``{"ha": ...}`` line.
15. LLM admission and the trace-replay simulator (``llm/``,
   ``simulator/``, ``adapters/llm_gateway.py``), each part on the card
   and then on the same machine's CPU. (1) bench.py:675-760's
   llm_admission shape as it is, under the port's frozen clock: capacity
   1,024, 8 models at 1e9 tokens/s lowered onto ``llm:*`` flow rules,
   6,000 mixed 1/4/16-token acquires, then 400 gateway cycles (open 64,
   the mock server's SSE ticks, close): mixed acquires/s, tokens/s,
   cycles/s, admit p50/p99 and the reconciliation delta (must be 0); a
   cut of 600 acquires and 40 cycles gives the same verdicts, ledger
   stats and state on card and CPU. (2) bench.py:551's replay,
   ``flash_crowd`` 600 s seed 7, at the main path's 32,768 rows, widths
   warmed: the card's verdict sha256, series, counts and ``rt_hist``
   equal the CPU's; the sha is printed beside the JAX package's
   (``d0a27aec…``), with trace seconds per wall second and the steps.
   (3) ``run_demo(60, 0)``: the same verdict sha, objective, stream
   counts, final counts and promotions on card and CPU, the ledger
   drained, no silent drop, at least one TPS promotion; printed beside
   ``478b073c…``. (4) Open reservations saved on the card restore into a
   CPU engine with equal ledger rows and windows. (5) ``MSG_STREAM_TICK``
   (open, tick, close, block, unknown stream, bad sub-op, truncated
   frame, abort) through both frontends: the same reply bytes on card
   and CPU and on both frontends. Prefix launches are zeroed before each
   card run and read after it (llm: parts 1, 4, 5; sim: parts 2, 3); no
   thread left. The phase must end within 180 s. Prints one ``{"llm":
   ...}`` line.
16. Rule datasources (``datasource/``, ``cluster/__main__.py``). (a) The
   main path's engine kind (capacity 32,768, the 10,000 resources, the
   headline's degrade, param and system rules) as the card's default
   engine and a ``device="cpu"`` twin; each connector (file, HTTP,
   Eureka, Spring Cloud Config, Nacos, Consul, Apollo, Redis, ZooKeeper,
   etcd where ``grpc`` and ``protobuf`` are present, the in-process push
   and poll sources) reads its in-repo fake server on loopback twice, one
   connector bound to ``st.load_flow_rules``, one to the twin's manager.
   The headline's 1,000 flow rules arrive as one JSON document, then five
   timed pushes alternate a document tightening 16 resources to 5 a
   second and the full one; the first width-8192 ``check_batch`` after
   each push (a fresh second of the port's frozen clock) must enforce
   it: every tightened resource admits exactly 5, the others all, with
   verdicts equal on card and CPU. Poll connectors run at 100 ms, cut
   from the reference's 3,000. Prints push -> enforcing step ms (p50,
   max) per connector, the recompile step's ms and the prefix launches.
   (b) ``StandaloneTokenServer`` in process on the card, its rules file
   (two namespaces, polled every 200 ms) rewritten mid-run: a
   ``ClusterTokenClient``'s TokenResults through the wire equal a CPU
   twin's (OK, BLOCKED past the count, NO_RULE_EXISTS for the removed
   namespace); then ``python -m sentinel_tpu_torch.cluster`` once as a
   subprocess (on ``cuda`` by default): its listening line and one OK
   acquire. (c) Two ``StandaloneHAParticipant`` seats with the map-file
   flip of ``tests/test_cluster_ha.py:730``: the successor restores the
   published row at epoch 2 and the grants across the handoff total the
   threshold plus the grants since the publish, on the card as on the
   CPU. Acquire launches are zeroed before (b) and read after (c); no
   thread left. The phase must end within 90 s. Prints one
   ``{"datasource": ...}`` line.
17. The framework adapters and the Envoy RLS service (``adapters/``,
   ``envoy_rls/``). (a) The main path's engine kind (capacity 32,768,
   the 10,000 resources, the headline rules, whose system rule keeps
   every entry on the device path) as the card's default engine, with
   1,000 gateway routes of four rules each (route-wide, client IP, an
   exact / prefix / regex ``X-Tier`` header pattern, a ``user`` URL
   parameter; the 16 Zipf-head routes' route-wide rule at 5 a second)
   and 64 API groups on path prefixes: 8 threads of ``gateway_entry`` ->
   exit for 4 s (routes and client IPs Zipf(1.2)), then the WSGI and ASGI
   middlewares and the gRPC server interceptor (a loopback echo server)
   for 2 s each; requests/s and p50/p99 per adapter, no tight route over
   5 x (seconds + 1) passes. A frozen-clock script (100 gateway, 30 WSGI
   and 30 ASGI requests, cut to 100 routes: a CPU step with 4,000
   gateway rules is slow) gives the same verdicts, blocked counts and
   ``node_snapshot`` rows on the card and on the CPU. (b) BASELINE.json
   configuration #5: domain ``mesh``, 10,000 descriptors (1,000 with a
   ``generic_key`` entry; 500 at 5 a second, the rest 1e6),
   ``SentinelEnvoyRlsService(device=...)`` under ``serve_grpc`` on
   loopback, 64 v3 channels (8 threads x 8, one call in flight on each)
   of 1-3 Zipf(1.2) descriptors a call, 5 s direct then 5 s batched
   (``csp.sentinel.wire.rls.batched``): calls/s, RTT p50/p99, the fused
   widths, sheds, acquire launches by width, no tight descriptor granted
   over 5 x (seconds + 1); 300 frozen-clock calls a mode give the same
   answers on the card and on the CPU; ``python -m
   sentinel_tpu_torch.envoy_rls`` answers a v2 and a v3 call. Prefix
   launches are read over (a)'s card runs, acquire launches over (b)'s;
   no thread left. The phase must end within 150 s. Prints one
   ``{"edge": ...}`` line.
18. The command center and the OpenMetrics exporter (``transport/``,
   ``telemetry/exporter.py``). The main path's engine kind (capacity
   32,768, the headline's 10,000 resources and rules) as the card's
   default engine under ``st.init_ops_plane(port=0)``: the metric timer
   writes into a temporary log directory and the heartbeat posts every
   200 ms to a loopback dashboard stub. One after the other over
   loopback: 100 of each read command (``version``, ``api``,
   ``getRules``, ``cnode``, ``clusterNode``, ``systemStatus``,
   ``telemetry``, ``leases``, ``getSwitch``), p50/p99 ms each; 5
   ``setRules`` pushes of the headline's 1,000 flow rules, each
   tightening one resource to 5 a second, and one width-8192
   ``check_batch`` after each that must enforce it (push -> enforcing
   step ms); 20 ``GET /metrics`` (bytes, ms, the in-process render's ms),
   whose content type is the OpenMetrics one and whose pass and block
   totals equal ``telemetry_counts()`` for every resource. The ``metric``
   command returns the seconds the timer sealed, and the stub received a
   heartbeat with the bound port. Then a frozen-clock script (every
   family and a gateway route pushed through the commands, 200 entries,
   the read-back of 11 commands) through a ``CommandCenter`` on a card
   engine and one on a CPU engine (capacity 8,192) gives equal answers,
   apart from the values of named timing fields; the event-loop center
   gives the card engine's answers. ``shutdown_ops_plane`` leaves the
   port refusing, no thread and the default engine closed. Prefix
   launches over the timed part and the card's script. The phase must
   end within 60 s. Prints one ``{"ops": ...}`` line, also when a check
   fails.
19. The dashboard (``dashboard/``). The main path's engine kind as the
   card's default engine under ``st.init_ops_plane(port=0)``, its
   heartbeat (every 200 ms, with a token) aimed at an in-process
   ``DashboardServer`` with auth on: the time until the dashboard lists
   the machine as healthy; two sealed width-8192 seconds, each fetched by
   ``MetricFetcher.fetch_once`` (ms, nodes saved), whose PASS per
   resource must equal the step's admitted lanes; 5 pushes of the
   headline's 1,000 flow rules through the dashboard's ``/v1/rules``,
   each enforced at the next width-8192 step (push -> enforcing step
   ms); 20 top-resource queries (ranked by volume) and 5 ``/metrics``
   scrapes (bytes, ms, the render's ms; the latest pass per resource
   equal to the repository's); 401 without a session and for a wrong
   password; ``/cluster/assign`` flipping the engine to a token server,
   whose acquires through the shim then grant 3 of 5. A frozen-clock script (every family
   and a gateway route pushed through a dashboard, 200 entries, the
   metric log fetched, the dashboard's read-back) over a card engine and
   over a CPU engine gives equal answers. Prefix and acquire launches
   over the timed part and the card's script. The phase must end within
   60 s. Prints one ``{"dashboard": ...}`` line, also when a check fails.
20. The native token client (``native.py``, the C++ shim). bench.py:840's
   loopback against a port ``ClusterTokenServer`` on the card in a
   process of its own (64 GLOBAL flows at 1e9; 3 warm and 20 timed
   512-request ``request_tokens_batch`` calls through one handle:
   acquires/s, every one OK), 1,000 ``request_token`` calls (p50 / p99
   ms); ``native_now_ms`` within 50 ms of the wall clock; a frozen-clock
   script (acquires, then ``demos/remote_bridge_demo.py``'s remote
   entries: 3 of 5 pass on ``checkout``, the param rule on ``search``
   blocks) against a server on a card engine equal to one on a CPU
   engine. Acquire launches by width and prefix launches. The phase must
   end within 45 s. Prints one ``{"native": ...}`` line, also when a
   check fails.
21. The reference suite. (i) The JAX package's own main-path test files
   (``tests/test_torch_ref_main.py``: ``test_flow``, ``test_degrade``,
   ``test_param_flow``, ``test_authority_system``, ``test_occupy``,
   ``test_warmup_oracle``, ``test_flow_batch_semantics``, ``test_lease``)
   loaded against the port by ``tests/test_torch_refsuite.py``, with the
   engine on the card, in a child ``python3 chip_smoke.py
   --reference-suite OUT`` that runs them under pytest (``--noconftest``:
   ``tests/conftest.py`` imports JAX; ``-m 'not slow'``, the accounting
   test deselected); its log goes to ``smoke_logs/reference/``. No case
   may fail or error, the strict xfails (the reference's C3) must fail,
   and the prefix kernel must have launched; prints the counts, seconds
   and launches by shape. (ii) The within-batch invariants of
   ``tests/test_flow_batch_semantics.py`` on one numpy ``EntryBatch`` at
   2048 and 8192 lanes over 1,000 resources (count-0 origin rules ahead
   of a shared QPS rule and a shared rate limiter, THREAD-grade lanes
   asking up to 5 tokens, pre-passed and pre-blocked lanes, open
   breakers): decisions and state on the card bit-equal to the CPU's,
   the serial reference's invariants held, and the per-resource admitted
   totals equal under three permutations of the batch. The phase must
   end within 180 s. Prints one ``{"reference": ...}`` line, also when a
   check fails.
22. The smoke's wall time, the kernels line (both kernels, with the pod,
   control, HA, LLM, simulator, datasource, edge, ops, dashboard, native
   and reference paths' launches), the card line, and the final
   ``{"ok": true, ...}``.

Every engine above carries the 128-second flight ring by default: the
main path prints its bytes, holds ``host_syncs_per_round`` at 15.0625 and
checks that the spilled history's PASS per resource equals the device
totals; the parity phase compares the card's ring with the CPU's. Each
phase prints ``torch.cuda.memory_allocated()`` at its start (what earlier
phases still hold) and ``torch.cuda.max_memory_allocated()`` over it.

It imports the port only — never JAX or the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# The port itself: a copy of this script outside the repository fails here,
# before it prints anything.
import sentinel_tpu_torch as st
from sentinel_tpu_torch import convert
from sentinel_tpu_torch.cluster import codec as ccodec
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import (
    H2D, EntryBatch, ExitBatch, make_entry_batch_np, make_exit_batch_np,
    to_device)
from sentinel_tpu_torch.core.checkpoint import _load_npz, _state_arrays
from sentinel_tpu_torch.core.config import LOG_DIR, config
from sentinel_tpu_torch.core.engine import SentinelEngine
from sentinel_tpu_torch.models import authority as A
from sentinel_tpu_torch.models import degrade as D
from sentinel_tpu_torch.models import flow as F
from sentinel_tpu_torch.models import param_flow as P
from sentinel_tpu_torch.models import system as Y
from sentinel_tpu_torch.native import build_error
from sentinel_tpu_torch.ops import prefix_cuda
from sentinel_tpu_torch.ops.segment import segmented_prefix_plain
from sentinel_tpu_torch.simulator.replay import ReplayEngine
from sentinel_tpu_torch.utils import time_util
from sentinel_tpu_torch.utils.device import SYNCS

NOW0 = 1_700_000_000_000
CAPACITY = 32_768
N_RESOURCES = 10_000
ROUNDS = 32
WIDTHS = (2048, 8192)
PARITY_ROUNDS = 8
PARITY_WIDTH = 2048
FLOAT_RTOL = 1e-6  # float32 state: same arithmetic on both devices
# Host syncs of one check_batch + complete_batch round on the main path
# (PERF.md section 5): the flight ring's fold must not add one.
HOST_SYNCS_PER_ROUND = 15.0625
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM fp32, outside the tensor cores
CTX = "sentinel_default_context"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernel against its plain version
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    """Wall time of one call as a caller pays it: CUDA events around a
    Python loop of ``reps`` calls, host dispatch included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    CUDA events around its replays, so no host dispatch is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replays = 5
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def radix_passes(ids: np.ndarray) -> int:
    """8-bit passes the block sort runs on these ids, summed over the K
    pairs: the digits of (id + 1 mod 2^32) that differ between keys."""
    total = 0
    for row in ids.reshape(ids.shape[0], -1):
        if row.size == 0:
            continue
        keys = row.astype(np.int64).astype(np.uint32) + np.uint32(1)
        diff = int(np.bitwise_or.reduce(keys ^ keys[0]))
        total += sum(1 for s in range(0, 32, 8) if (diff >> s) & 0xFF)
    return total


def prefix_bound(ids: np.ndarray, m: int):
    """Least time the card could take for the function, the larger of:
    its bytes (ids + values read once, prefix + is_first written once)
    over the HBM rate, and its least operations — a sort and a scan,
    K * N * ceil(log2 N) * (M+1) — over the fp32 rate. Returns
    ``(bound_ms, bound_by)``."""
    k, n = ids.shape
    nbytes = k * n * (4 + 4 * m + 4 * m + 1)
    ops = k * n * max(1, math.ceil(math.log2(max(n, 2)))) * (m + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations"
    return t_bytes, "bytes"


def algorithm_ops_estimate(ids: np.ndarray, m: int, design: str) -> int:
    """An estimate, computed and not measured, of the element operations
    the kernel that ran spends on these ids: for the block sort one key
    placement per key per radix pass plus the scan's K * N * M adds; for
    the tile walk its N(N-1)/2 * K * (M+1) compare-adds. It counts
    elements, not instructions: ranking one key takes several integer
    instructions and each pass also scans 256 counters a warp."""
    k, n = ids.shape
    if design == "tile_walk":
        return n * (n - 1) // 2 * k * (m + 1)
    return radix_passes(ids) * n + k * n * m


I32 = np.iinfo(np.int32)


def prefix_case(rng, n: int, k: int, m: int, edge: str, dev):
    """Inputs of one case: row-like ids (0..N/4, 10% -1) and small counts,
    or a value edge (``256``, ``2^24``), or an id pattern a radix sort
    gets wrong: repeats from a pool of INT32_MIN, INT32_MAX, -1, -7, 0 and
    large keys of both signs (``full_int32``), a permutation spread over
    the int32 range (``all_distinct``), or INT32_MIN everywhere
    (``all_equal``)."""
    ids = rng.integers(0, max(1, n // 4), size=(k, n)).astype(np.int32)
    ids[rng.random((k, n)) < 0.1] = -1
    vals = rng.integers(0, 4, size=(k, n, m)).astype(np.float32)
    if edge == "full_int32":
        pool = np.concatenate([[I32.min, I32.max, -1, -7, 0],
                               rng.integers(2**30, I32.max, size=8),
                               rng.integers(I32.min + 1, -2**30, size=8)])
        ids = rng.choice(pool, size=(k, n)).astype(np.int32)
    elif edge == "all_distinct":
        step = (2**32 - 1) // n
        ids = np.stack([rng.permutation(n).astype(np.int64) * step + I32.min
                        for _ in range(k)]).astype(np.int32)
    elif edge == "all_equal":
        ids[:] = I32.min
    elif edge == "256":
        vals[:] = rng.integers(250, 257, size=(k, n, m))
    elif edge == "2^24":
        # One segment whose running sum reaches 2^24 - 1 exactly at the
        # last row: a head value, then n - 2 ones, then a trailing 0.
        ids[:, :] = 7
        vals[:] = 0
        vals[:, 0, :] = 2**24 - 1 - (n - 2)
        vals[:, 1:n - 1, :] = 1
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev))


MAIN_SHAPE = (8192, 3, 2, "random")


def kernel_phase(dev):
    rng = np.random.default_rng(20261017)
    max_err = 0.0
    main_shape = None
    # N = 1024: the pod path's width a shard.
    cases = [(n, k, m, "random")
             for n in (1, 8, 64, 512, 1000, 1024, 2048, 8192)
             for k in (1, 3) for m in (1, 2)]
    cases += [(2048, 3, 2, "256"), (8192, 1, 2, "256"), (64, 1, 1, "2^24"),
              (1000, 3, 2, "2^24")]
    cases += [(n, k, 2, pattern)
              for pattern in ("full_int32", "all_distinct", "all_equal")
              for n, k in ((2048, 3), (8192, 3), (16384, 1))]
    cases += [(16384, 1, 2, "random"), (65536, 1, 2, "random")]
    for n, k, m, edge in cases:
        ids, vals = prefix_case(rng, n, k, m, edge, dev)
        tiles_before = prefix_cuda.tile_launches
        prefix, first = prefix_cuda.segmented_prefix_cuda(ids, vals)
        design = ("tile_walk" if prefix_cuda.tile_launches > tiles_before
                  else "block_radix_sort")
        torch.cuda.synchronize()
        for kk in range(k):
            want_p, want_f = segmented_prefix_plain(ids[kk], vals[kk])
            if not (torch.equal(prefix[kk], want_p)
                    and torch.equal(first[kk], want_f)):
                raise AssertionError(f"kernel != plain at N={n} K={k} M={m} "
                                     f"edge={edge} pair {kk}")
            max_err = max(max_err, float((prefix[kk] - want_p).abs().max())
                          if n else 0.0)
        if edge == "2^24" and not bool((prefix[:, -1, :] == 2**24 - 1).all()):
            raise AssertionError(f"2^24 edge at N={n} did not reach 2^24 - 1")
        reps = 200 if n <= 2048 else 50 if n <= 16384 else 10

        def kernel():
            prefix_cuda.segmented_prefix_cuda(ids, vals)

        def tiles():
            prefix_cuda.segmented_prefix_tiles_cuda(ids, vals)

        def plain():
            for kk in range(k):
                segmented_prefix_plain(ids[kk], vals[kk])

        kernel_ms = device_ms(kernel, reps)
        call_ms = time_ms(kernel, reps)
        plain_ms = device_ms(plain, max(10, reps // 5))
        ids_np = ids.cpu().numpy()
        bound_ms, bound_by = prefix_bound(ids_np, m)
        row = {"shape": {"N": n, "K": k, "M": m, "values": edge},
               "design": design, "bit_equal": True, "kernel_ms": kernel_ms,
               "call_ms": call_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "algorithm_ops_estimate": algorithm_ops_estimate(
                   ids_np, m, design)}
        if (n, k, m, edge) == MAIN_SHAPE:
            # The tile walk on the same inputs, in this call: the kernel
            # the block sort replaced on the main path.
            tile_p, tile_f = prefix_cuda.segmented_prefix_tiles_cuda(ids, vals)
            if not (torch.equal(tile_p, prefix) and torch.equal(tile_f, first)):
                raise AssertionError("tile walk != block sort at the main "
                                     "shape")
            row["previous_ms"] = device_ms(tiles, reps)
            main_shape = row
        print(json.dumps(row), flush=True)
    return main_shape, max_err


# ---------------------------------------------------------------------------
# Phases 4-5: the engine
# ---------------------------------------------------------------------------


def load_rules(eng, tight: bool) -> None:
    """Bench headline rules (``bench.py`` bench_throughput); ``tight``
    swaps in thresholds that block, every flow behavior and authority
    rules, for the parity phase."""
    n = N_RESOURCES
    if not tight:
        flow = [F.FlowRule(resource=f"res{i}", count=1e9)
                for i in range(0, n, 10)]
        param = [P.ParamFlowRule(f"res{i}", param_idx=0, count=1e9)
                 for i in range(0, n, 40)]
        auth = []
    else:
        behaviors = (C.CONTROL_BEHAVIOR_DEFAULT, C.CONTROL_BEHAVIOR_WARM_UP,
                     C.CONTROL_BEHAVIOR_RATE_LIMITER,
                     C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER)
        flow = [F.FlowRule(resource=f"res{i}", count=1 + (i // 10) % 4,
                           control_behavior=behaviors[(i // 10) % 4],
                           warm_up_period_sec=3, max_queueing_time_ms=300,
                           grade=(C.FLOW_GRADE_THREAD if i % 70 == 0
                                  else C.FLOW_GRADE_QPS))
                for i in range(0, n, 10)]
        param = [P.ParamFlowRule(f"res{i}", param_idx=0, count=2)
                 for i in range(0, n, 40)]
        auth = [A.AuthorityRule(resource=f"res{i}", limit_app="appA",
                                strategy=C.AUTHORITY_BLACK)
                for i in range(5, n, 50)]
    degrade = [D.DegradeRule(resource=f"res{i}", count=100 if not tight else 2,
                             grade=i % 3, time_window=10 if not tight else 1,
                             min_request_amount=5 if not tight else 2)
               for i in range(0, n, 20)]
    eng.flow_rules.load_rules(flow)
    eng.degrade_rules.load_rules(degrade)
    eng.param_rules.load_rules(param)
    eng.authority_rules.load_rules(auth)
    eng.system_rules.load_rules([Y.SystemRule(qps=1e12)])


class Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


def make_engine(dev, tight: bool):
    clock = Clock(NOW0)
    eng = SentinelEngine(capacity=CAPACITY, device=dev, clock=clock)
    reg = eng.registry
    ent = reg.entrance_row(CTX)
    cluster = np.array([reg.cluster_row(f"res{i}")
                        for i in range(N_RESOURCES)], np.int32)
    dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                   for i in range(N_RESOURCES)], np.int32)
    origin_a = reg.origin_id("appA")
    load_rules(eng, tight)
    return eng, clock, cluster, dn, origin_a


def entry_buf(rng, width, cluster, dn, origin_a, mixed=False):
    buf = make_entry_batch_np(width)
    pick = rng.integers(0, N_RESOURCES, size=width)
    buf["cluster_row"][:] = cluster[pick]
    buf["dn_row"][:] = dn[pick]
    buf["count"][:] = rng.integers(1, 4, size=width) if mixed else 1
    buf["origin_id"][:] = np.where(rng.random(width) < 0.2, origin_a, -3)
    buf["param_hash"][:, 0] = rng.integers(1, 1 << 31, size=width)
    buf["param_present"][:, 0] = True
    return buf


def exit_buf(rng, ebuf, reason):
    width = ebuf["cluster_row"].shape[0]
    buf = make_exit_batch_np(width)
    for f in ("cluster_row", "dn_row", "origin_row", "entry_in", "count",
              "param_hash", "param_present"):
        buf[f][:] = ebuf[f]
    ok = reason == 0
    buf["cluster_row"][~ok] = -1
    buf["success"][:] = ok
    buf["rt_ms"][:] = rng.integers(1, 250, size=width)
    buf["error"][:] = rng.random(width) < 0.2
    return buf


def memory_mark() -> int:
    """Reset the peak counter; the bytes allocated now (what earlier
    phases still hold)."""
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def memory_report(at_start: int) -> dict:
    peak = torch.cuda.max_memory_allocated()
    return {"at_start": at_start, "peak": peak,
            "peak_above_start": peak - at_start}


def ring_bytes(ring) -> int:
    return sum(t.numel() * t.element_size() for t in ring)


def headline_rounds(eng, clock, cluster, dn, origin_a, rng, width, dev):
    """One warm-up round and ROUNDS timed check_batch + complete_batch
    rounds of the headline stream at ``width`` (50 ms apart: bucket and
    second boundaries; the middle round with mixed acquire counts).
    Returns (the result line, admitted tokens)."""
    admitted_tokens = 0

    def check(batch):
        return eng.harvest_decisions(eng.check_batch(batch))[0]

    # Batches staged and copied to the card before the timed rounds.
    bufs = [entry_buf(rng, width, cluster, dn, origin_a,
                      mixed=(r == ROUNDS // 2)) for r in range(ROUNDS + 1)]
    batches = [to_device(b, dev) for b in bufs]
    # Warm-up round (allocations, first load of the kernel).
    reason, ebuf = check(batches[ROUNDS]), bufs[ROUNDS]
    admitted_tokens += int(ebuf["count"][reason == 0].sum())
    eng.complete_batch(to_device(exit_buf(rng, ebuf, reason), dev))
    torch.cuda.synchronize()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    SYNCS.count = 0
    entry_s = exit_s = 0.0
    for r in range(ROUNDS):
        clock.now += 50  # 32 rounds x 50 ms: bucket + second boundaries
        t0 = time.perf_counter()
        reason, ebuf = check(batches[r]), bufs[r]
        entry_s += time.perf_counter() - t0
        admitted_tokens += int(ebuf["count"][reason == 0].sum())
        xb = to_device(exit_buf(rng, ebuf, reason), dev)
        t0 = time.perf_counter()
        eng.complete_batch(xb)
        torch.cuda.synchronize()
        exit_s += time.perf_counter() - t0
    launches = prefix_cuda.launches
    syncs = SYNCS.count
    if launches <= 0:
        raise AssertionError("main path never launched the prefix kernel")
    if prefix_cuda.tile_launches:
        raise AssertionError(f"main path at width {width} took the tile "
                             "walk, not the block sort")
    return {
        "width": width, "rounds": ROUNDS,
        "rule_checks_per_s": width * ROUNDS / entry_s,
        "entry_step_ms": entry_s / ROUNDS * 1e3,
        "exit_step_ms": exit_s / ROUNDS * 1e3,
        "prefix_launches": launches,
        "prefix_launches_per_entry_step": launches / ROUNDS,
        "prefix_design": "block_radix_sort",
        "host_syncs_per_round": syncs / ROUNDS,
    }, admitted_tokens


def main_path_phase(dev):
    """Drive the engine at the headline size; returns (per-width results,
    kernel launches during the measured rounds, the engine and its rows,
    still open)."""
    mem0 = memory_mark()
    eng, clock, cluster, dn, origin_a = make_engine(dev, tight=False)
    rng = np.random.default_rng(7)
    results = {}
    admitted_tokens = 0
    total_launches = 0
    for width in WIDTHS:
        results[width], admitted = headline_rounds(
            eng, clock, cluster, dn, origin_a, rng, width, dev)
        admitted_tokens += admitted
        total_launches += results[width]["prefix_launches"]
        print(json.dumps({"main_path": results[width]}), flush=True)
        syncs = results[width]["host_syncs_per_round"]
        if syncs != HOST_SYNCS_PER_ROUND:
            raise AssertionError(f"host syncs per round {syncs} at "
                                 f"width {width}, not {HOST_SYNCS_PER_ROUND}")
    # Output check: every admitted token committed PASS to its DefaultNode
    # and ClusterNode rows, and every admitted entry has exited.
    st = eng.state
    passes = int(st.telemetry.totals[0].sum()) + int(st.sec.counts[0].sum())
    if passes != 2 * admitted_tokens:
        raise AssertionError(f"committed PASS {passes} != 2 x admitted "
                             f"tokens {admitted_tokens}")
    if int(st.cur_threads.sum()) != 0:
        raise AssertionError("thread gauges did not return to 0")
    # The flight recorder: the completed seconds' PASS per resource in the
    # spilled history equal the device's cumulative PASS totals (the fold
    # moves every completed second into both).
    if st.flight is None:
        raise AssertionError("the default engine carries no flight ring")
    view = eng.timeseries_view(now_ms=clock.now)
    ring_pass = {}
    for sec in view["seconds"]:
        for res, r in sec["resources"].items():
            ring_pass[res] = ring_pass.get(res, 0) + r["pass"]
    totals = eng.state.telemetry.totals[C.MetricEvent.PASS].cpu().numpy()
    for res, row in eng.registry.resources().items():
        if ring_pass.get(res, 0) != int(totals[row]):
            raise AssertionError(f"{res}: ring PASS {ring_pass.get(res, 0)} "
                                 f"!= device totals {int(totals[row])}")
    print(json.dumps({"main_path_check": {
        "admitted_tokens": admitted_tokens, "committed_pass": passes,
        "flight_ring_seconds": eng.flight_seconds,
        "flight_ring_bytes": ring_bytes(eng.state.flight),
        "ring_seconds_spilled": len(view["seconds"]),
        "ring_pass_total": sum(ring_pass.values()),
        "ring_pass_equals_device_totals": True,
        "memory_bytes": memory_report(mem0)}}),
          flush=True)
    # The engine stays open for the boot phase's warm restart.
    main = {"eng": eng, "clock": clock, "cluster": cluster, "dn": dn,
            "origin_a": origin_a}
    return results, total_launches, main


def profile_phase(dev, rounds: int = 8, width: int = 8192):
    """Where one round's time goes on the card: ``torch.profiler`` over a
    few main-path rounds (after warm-up), kernel time summed by name
    against the host wall clock. Prints the device busy share and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    eng, clock, cluster, dn, origin_a = make_engine(dev, tight=False)
    rng = np.random.default_rng(13)
    bufs = [entry_buf(rng, width, cluster, dn, origin_a)
            for _ in range(rounds + 2)]
    batches = [to_device(b, dev) for b in bufs]

    def one_round(i):
        clock.now += 50
        reason, _ = eng.harvest_decisions(eng.check_batch(batches[i]))
        eng.complete_batch(to_device(exit_buf(rng, bufs[i], reason), dev))

    for i in range(rounds, rounds + 2):
        one_round(i)
    torch.cuda.synchronize()
    prefix_cuda.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(rounds):
            one_round(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = prefix_cuda.launches
    eng.close()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    prefix = [e for e in kernels if "segmented_prefix" in e.key]
    prefix_us = sum(e.self_device_time_total for e in prefix)
    # The trace's own kernel names: the main path ran the block sort and
    # nothing else, as many times as the wrapper counted.
    if not prefix or any("segmented_prefix_block_kernel" not in e.key
                         for e in prefix):
        raise AssertionError("profiled main path did not run the block sort "
                             f"alone: {[e.key for e in prefix]}")
    if sum(e.count for e in prefix) != counted:
        raise AssertionError(f"trace shows {sum(e.count for e in prefix)} "
                             f"prefix kernels, the wrapper counted {counted}")
    print(json.dumps({"profile": {
        "width": width, "rounds": rounds,
        "wall_ms_per_round": wall_ms / rounds,
        "device_ms_per_round": dev_us / 1e3 / rounds,
        "device_busy_share": dev_us / 1e3 / wall_ms,
        "device_ops_per_round": sum(e.count for e in kernels) / rounds,
        "prefix_kernel": {
            "names": [e.key[:80] for e in prefix],
            "count_per_round": sum(e.count for e in prefix) / rounds,
            "ms_per_round": prefix_us / 1e3 / rounds,
            "share_of_device_time": prefix_us / dev_us if dev_us else 0.0},
        "top": [{"name": e.key[:80], "count_per_round": e.count / rounds,
                 "ms_per_round": e.self_device_time_total / 1e3 / rounds}
                for e in top]}}), flush=True)


def compare_states(x, y, path=""):
    """Two states as ``convert.state_to_numpy`` gives them: the same keys,
    integer tensors equal, float tensors within FLOAT_RTOL."""
    if set(x) != set(y):
        raise AssertionError(f"{path}: fields {sorted(set(x) ^ set(y))} "
                             "differ between cuda and cpu")
    for k in x:
        if isinstance(x[k], dict):
            compare_states(x[k], y[k], f"{path}.{k}")
            continue
        if x[k].dtype != y[k].dtype:
            raise AssertionError(f"{path}.{k}: dtype {x[k].dtype} vs "
                                 f"{y[k].dtype}")
        if x[k].dtype.kind == "f":
            np.testing.assert_allclose(x[k], y[k], rtol=FLOAT_RTOL,
                                       atol=0, err_msg=f"{path}.{k}")
        elif not np.array_equal(x[k], y[k]):
            raise AssertionError(f"{path}.{k} differs between cuda "
                                 "and cpu")


def parity_phase():
    mem0 = memory_mark()
    runs = {}
    for dev in ("cuda", "cpu"):
        eng, clock, cluster, dn, origin_a = make_engine(dev, tight=True)
        rng = np.random.default_rng(11)
        decs = []
        for r in range(PARITY_ROUNDS):
            clock.now += 170
            ebuf = entry_buf(rng, PARITY_WIDTH, cluster, dn, origin_a,
                             mixed=(r % 3 == 2))
            dec = eng.check_batch(ebuf)
            decs.append({f: getattr(dec, f).cpu().numpy()
                         for f in dec._fields})
            clock.now += 20
            eng.complete_batch(exit_buf(rng, ebuf, decs[-1]["reason"]))
        runs[dev] = (decs, convert.state_to_numpy(eng.state))
        eng.close()
    blocked = 0
    for r, (a, b) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        for f in a:
            if not np.array_equal(a[f], b[f]):
                raise AssertionError(f"round {r}: decisions.{f} differ "
                                     "between cuda and cpu")
        blocked += int((a["reason"] > 0).sum())

    cuda_state, cpu_state = runs["cuda"][1], runs["cpu"][1]
    if "flight" not in cuda_state or "flight" not in cpu_state:
        raise AssertionError("a parity engine carries no flight ring")
    compare_states(cuda_state, cpu_state)
    ring_seconds = int((cuda_state["flight"]["stamps"] >= 0).sum())
    if ring_seconds < 1:
        raise AssertionError("the parity run folded no second into the ring")
    print(json.dumps({"parity": {"rounds": PARITY_ROUNDS,
                                 "width": PARITY_WIDTH,
                                 "blocked_decisions": blocked,
                                 "decisions_bit_equal": True,
                                 "int_state_equal": True,
                                 "flight_ring_equal": True,
                                 "flight_ring_seconds": ring_seconds,
                                 "float_rtol": FLOAT_RTOL,
                                 "memory_bytes": memory_report(mem0)}}),
          flush=True)


# ---------------------------------------------------------------------------
# Phase 6: the st.entry path through the module API
# ---------------------------------------------------------------------------

API_THREADS = 8
API_PAIRS = 5_000
API_MIX = (0.60, 0.38, 0.02)  # unruled, leased, device path
API_PARITY_OPS = 2_000
API_PARITY_MIX = (0.55, 0.42, 0.03)
API_PARITY_CAPACITY = 8_192
# Pairs per 5 ms step of the frozen clock: every advance flushes the
# committer (one entry and one exit batch), ~4,000 steps a run at one
# pair a step.
API_PARITY_OPS_PER_STEP = 8
API_PARAM_KEYS = 16
API_ALONE_PAIRS = 16
API_BEHAVIORS = ("DEFAULT", "WARM_UP", "RATE_LIMITER", "WARM_UP_RATE_LIMITER")


def api_pools():
    """Resource names by the path ``entry()`` takes for them."""
    n = N_RESOURCES
    pools = {
        "leased_default_param": range(0, n, 40),
        "leased_warm_up": range(10, n, 40),
        "device_rate_limiter": range(20, n, 40),
        "device_warm_up_rate_limiter": range(30, n, 40),
        "device_degrade_or_authority": sorted(set(range(5, n, 20))
                                              | set(range(5, n, 50))),
        "unruled": [i for i in range(n) if i % 10 in (1, 2, 3, 4)],
    }
    return {k: [f"res{i}" for i in v] for k, v in pools.items()}


def api_engine(dev, capacity=CAPACITY, register=True):
    """A fresh default engine with the API phase's rules, so every path of
    ``entry()`` has resources; ``register`` interns the bench's 10,000
    resources up front, as the bench does."""
    eng = st.reset(capacity=capacity, device=dev)
    reg = eng.registry
    ent = reg.entrance_row(CTX)
    for i in range(N_RESOURCES if register else 0):
        reg.cluster_row(f"res{i}")
        reg.default_row(CTX, f"res{i}", ent)
    behaviors = [getattr(C, f"CONTROL_BEHAVIOR_{b}") for b in API_BEHAVIORS]
    st.load_flow_rules([
        st.FlowRule(resource=f"res{i}", count=2 + (i // 40) % 4,
                    control_behavior=behaviors[(i // 10) % 4],
                    warm_up_period_sec=2, max_queueing_time_ms=20)
        for i in range(0, N_RESOURCES, 10)])
    st.load_param_flow_rules([st.ParamFlowRule(f"res{i}", param_idx=0,
                                               count=2)
                              for i in range(0, N_RESOURCES, 40)])
    st.load_degrade_rules([
        st.DegradeRule(resource=f"res{i}", count=0.5,
                       grade=C.DEGRADE_GRADE_EXCEPTION_RATIO, time_window=1,
                       min_request_amount=5)
        for i in range(5, N_RESOURCES, 20)])
    st.load_authority_rules([
        st.AuthorityRule(resource=f"res{i}", limit_app="appA",
                         strategy=C.AUTHORITY_BLACK)
        for i in range(5, N_RESOURCES, 50)])
    pools = api_pools()
    for res in pools["leased_default_param"] + pools["leased_warm_up"]:
        if res not in eng._leases:
            raise AssertionError(f"{res} should be leased")
    for name in pools:
        if name.startswith("device") and any(r in eng._leases
                                             for r in pools[name]):
            raise AssertionError(f"a {name} resource is leased")
    return eng


def api_pick(rng, pools, mix):
    """One request: (class, resource, context origin or None, args,
    traced error)."""
    r = rng.random()
    if r < mix[0]:
        cls = "unruled"
    elif r < mix[0] + mix[1]:
        cls = ("leased_default_param", "leased_warm_up")[int(rng.integers(2))]
    else:
        cls = ("device_rate_limiter", "device_warm_up_rate_limiter",
               "device_degrade_or_authority")[int(rng.integers(3))]
    pool = pools[cls]
    res = pool[int(rng.integers(len(pool)))]
    origin = ("appA", "appB")[int(rng.integers(2))] \
        if rng.random() < 0.2 else None
    args = (int(rng.integers(API_PARAM_KEYS)),)
    return cls, res, origin, args, rng.random() < 0.1


def api_pair(res, origin, args, error, prioritized=False):
    """One ``with st.entry(...)`` pair; the verdict (``"pass"`` or the
    exception's type)."""
    if origin is not None:
        st.context_enter("ctx", origin)
    try:
        with st.entry(res, args=args, prioritized=prioritized):
            if error:
                st.trace(RuntimeError("business error"))
        return "pass"
    except st.BlockException as ex:
        return type(ex).__name__
    finally:
        if origin is not None:
            st.exit_context()


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else None


class TimedLock:
    """The engine lock, with each outermost hold's wait to acquire and its
    hold timed and keyed by the taking thread's role (the committer's
    thread, the pipeline's collector, the trace pump, or a caller) and the
    function that took it. The engine only takes its lock with ``with``;
    reentrant holds are not timed again."""

    ROLES = {"sentinel-torch-stats-committer": "committer",
             "sentinel-torch-pipeline": "collector",
             "sentinel-torch-trace-pump": "trace_pump"}

    def __init__(self, inner):
        self._inner = inner
        self._local = threading.local()
        self.samples = []  # (key, wait_s, hold_s); list.append is atomic

    def __enter__(self):
        local = self._local
        depth = getattr(local, "depth", 0)
        t0 = time.perf_counter()
        self._inner.acquire()
        if depth == 0:
            role = self.ROLES.get(threading.current_thread().name, "caller")
            taker = sys._getframe(1)
            while taker.f_code.co_name == "__enter__":  # the engine's take
                taker = taker.f_back
            local.key = f"{role}:{taker.f_code.co_name}"
            local.t_req, local.t_acq = t0, time.perf_counter()
        local.depth = depth + 1
        return self

    def __exit__(self, *exc):
        local = self._local
        local.depth -= 1
        if local.depth == 0:
            self.samples.append((local.key, local.t_acq - local.t_req,
                                 time.perf_counter() - local.t_acq))
        self._inner.release()
        return False

    def report(self, wall_s):
        by_key = {}
        for key, wait, hold in self.samples:
            by_key.setdefault(key, []).append((wait, hold))
        out = {}
        for key, xs in sorted(by_key.items()):
            waits = [w * 1e3 for w, _ in xs]
            holds = [h * 1e3 for _, h in xs]
            out[key] = {"n": len(xs),
                        "wait_ms": {"p50": pct(waits, 50),
                                    "p99": pct(waits, 99),
                                    "sum_s": sum(waits) / 1e3},
                        "hold_ms": {"p50": pct(holds, 50),
                                    "p99": pct(holds, 99),
                                    "sum_s": sum(holds) / 1e3}}
        held = sum(h for _, _, h in self.samples)
        return {"busy_share": held / wall_s, "held_s": held, "by": out}


def api_timed(eng):
    """8 threads x 5,000 pairs on the real clock; per-class latency and
    blocked share, and what the committer did meanwhile."""
    pools = api_pools()
    eng.warmup()
    committer_widths = lambda c: (dict(c.entry_widths), dict(c.exit_widths))
    # Start the committer before the window so its flushes are counted.
    api_pair("res1", None, (), False)
    committer = eng.committer
    flushes0 = committer.flushes
    widths0 = committer_widths(committer)
    results = [None] * API_THREADS
    barrier = threading.Barrier(API_THREADS + 1)

    def worker(t):
        rng = np.random.default_rng(1000 + t)
        out = []
        barrier.wait()
        for _ in range(API_PAIRS):
            cls, res, origin, args, error = api_pick(rng, pools, API_MIX)
            t0 = time.perf_counter()
            verdict = api_pair(res, origin, args, error)
            out.append((cls, time.perf_counter() - t0, verdict))
        results[t] = out

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(API_THREADS)]
    for th in threads:
        th.start()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    eng._lock.samples.clear()
    barrier.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    wall_s = time.perf_counter() - t0
    lock = eng._lock.report(wall_s)
    eng._flush_committer()  # the window's last commits land on the card
    launches = prefix_cuda.launches
    tile = prefix_cuda.tile_launches
    by_shape = dict(prefix_cuda.launches_by_shape)
    flushes = committer.flushes - flushes0
    widths = committer_widths(committer)
    rows = [r for out in results for r in out]
    if len(rows) != API_THREADS * API_PAIRS:
        raise AssertionError("a caller thread did not finish")
    by_cls = {}
    for cls, dt, verdict in rows:
        by_cls.setdefault(cls, []).append((dt, verdict))

    def lat(prefixes, scale):
        xs = [dt * scale for c, v in by_cls.items()
              if c.startswith(prefixes) for dt, _ in v]
        return {"n": len(xs), "p50": pct(xs, 50), "p99": pct(xs, 99)}

    if launches <= 0:
        raise AssertionError("the API phase never launched the prefix kernel")
    if tile:
        raise AssertionError("the API phase took the tile walk")
    # The same device-path pairs with no other caller, for scale.
    alone = []
    for res in pools["device_degrade_or_authority"][:API_ALONE_PAIRS]:
        t1 = time.perf_counter()
        api_pair(res, None, (0,), False)
        alone.append((time.perf_counter() - t1) * 1e3)
    return {
        "threads": API_THREADS, "pairs_per_thread": API_PAIRS,
        "wall_s": wall_s,
        "pairs_per_s": len(rows) / wall_s,
        "leased_pair_us": lat("leased", 1e6),
        "unruled_pair_us": lat("unruled", 1e6),
        "device_path_pair_ms": lat("device", 1e3),
        "device_path_pair_ms_alone": {"n": len(alone), "p50": pct(alone, 50),
                                      "max": max(alone)},
        "engine_lock": lock,
        "blocked_share": {c: sum(v != "pass" for _, v in xs) / len(xs)
                          for c, xs in sorted(by_cls.items())},
        "committer_flushes": flushes,
        "flush_entry_widths": {
            w: n - widths0[0].get(w, 0) for w, n in sorted(widths[0].items())},
        "flush_exit_widths": {
            w: n - widths0[1].get(w, 0) for w, n in sorted(widths[1].items())},
        "prefix_launches": launches,
        "prefix_launches_block_sort": launches - tile,
        "prefix_launches_by_shape": {
            f"K={k},N={n},M={m}": c for (k, n, m), c in sorted(by_shape.items())},
    }


def api_script(dev):
    """The seeded single-threaded script on ``dev`` under the frozen
    clock: (verdicts, node_snapshot, seconds)."""
    t0 = time.perf_counter()
    time_util.freeze_time(NOW0)
    try:
        # Rows only for the ruled resources and the script's traffic: the
        # CPU run pays for every row in each of its ~4,000 steps.
        eng = api_engine(dev, capacity=API_PARITY_CAPACITY, register=False)
        waits = []
        submit = eng._submit_entry

        def recorded(*a, **k):
            out = submit(*a, **k)
            waits.append(out[1])
            return out

        eng._submit_entry = recorded
        pools = api_pools()
        rng = np.random.default_rng(23)
        verdicts = []
        for op in range(API_PARITY_OPS):
            if op % API_PARITY_OPS_PER_STEP == 0:
                time_util.advance_time(5)  # flushes the committer first
            cls, res, origin, args, error = api_pick(rng, pools,
                                                     API_PARITY_MIX)
            prioritized = cls.startswith("device") and rng.random() < 0.2
            n_waits = len(waits)
            verdict = api_pair(res, origin, args, error, prioritized)
            if verdict == "pass" and len(waits) > n_waits and waits[-1] > 0:
                verdict = "wait"
            verdicts.append(verdict)
        snapshot = eng.node_snapshot()
        committer = eng.committer
        eng.close()
        failures = committer.failures if committer is not None else 0
        if eng.fail_open_count or failures:
            raise AssertionError(f"{dev}: fail_open_count "
                                 f"{eng.fail_open_count}, committer "
                                 f"failures {failures}")
    finally:
        time_util.unfreeze_time()
    return verdicts, snapshot, time.perf_counter() - t0


def api_phase(dev):
    # Block logs stay inside the checkout (``smoke_logs/``, gitignored).
    config.set(LOG_DIR, str(Path(__file__).resolve().parent / "smoke_logs"))
    mem0 = memory_mark()
    t0 = time.perf_counter()
    eng = api_engine(dev)
    eng._lock = TimedLock(eng._lock)
    out = {"lease_ring": eng.lease_ring}
    if out["lease_ring"] != "native":
        raise AssertionError("the lease ring did not build natively: "
                             f"{build_error()}")
    out.update(api_timed(eng))
    out["fail_open_count"] = eng.fail_open_count
    if eng.fail_open_count:
        raise AssertionError(f"fail_open_count {eng.fail_open_count}")
    st.load_system_rules([st.SystemRule(qps=1e12)])
    out["leases_after_system_rule"] = len(eng._leases)
    out["unruled_fastpath_after_system_rule"] = eng._unruled_fastpath
    if eng._leases or eng._unruled_fastpath:
        raise AssertionError("a fast path survived the system rule")
    committer = eng.committer
    eng.close()
    out["committer_pending_after_close"] = list(committer.pending())
    if committer.pending() != (0, 0) or eng.committer is not None:
        raise AssertionError("close() left queued commits")
    out["committer_failures"] = committer.failures
    if committer.failures:
        raise AssertionError(f"{committer.failures} committer flushes failed")
    timed_s = time.perf_counter() - t0

    runs = {d: api_script(d) for d in ("cuda", "cpu")}
    (vc, sc, tc), (vp, sp, tp) = runs["cuda"], runs["cpu"]
    if vc != vp:
        first = next(i for i, (a, b) in enumerate(zip(vc, vp)) if a != b)
        raise AssertionError(f"API parity: op {first} is {vc[first]} on "
                             f"cuda and {vp[first]} on cpu")
    if set(sc) != set(sp):
        raise AssertionError("API parity: node_snapshot resources differ")
    for res in sc:
        for k, v in sc[res].items():
            if not math.isclose(v, sp[res][k], rel_tol=FLOAT_RTOL, abs_tol=0):
                raise AssertionError(f"API parity: {res}.{k} {v} on cuda, "
                                     f"{sp[res][k]} on cpu")
    out["parity"] = {
        "ops": API_PARITY_OPS, "verdicts_equal": True,
        "node_snapshot_equal": True,
        "verdict_counts": {v: vc.count(v) for v in sorted(set(vc))},
        "cuda_s": tc, "cpu_s": tp}
    out["timed_part_s"] = timed_s
    out["phase_s"] = time.perf_counter() - t0
    out["memory_bytes"] = memory_report(mem0)
    print(json.dumps({"api": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 7: pipelined admission
# ---------------------------------------------------------------------------

PIPE_THREADS = 16
PIPE_WINDOW_S = 10.0
PIPE_MAX_BATCH = 8       # below the producer count (bench.py:338-340)
PIPE_LINGER_S = 0.0002   # bench.py's latency section
PIPE_STREAM_OPS = 90
PIPE_STREAM_SEED = 11


def stream_ops(seed: int, n: int = PIPE_STREAM_OPS):
    """A seeded entry/exit stream of ``tests/test_pipeline.py``'s kind:
    three resources (a QPS quota, a THREAD gauge, a rate limiter), mixed
    acquire counts, random holds and clock advances."""
    import random

    rng = random.Random(seed)
    ops, live = [], []
    for i in range(n):
        if rng.random() < 0.15:
            ops.append(("advance", rng.choice([1, 40, 300, 1000])))
        if live and rng.random() < 0.4:
            ops.append(("exit", live.pop(rng.randrange(len(live)))))
        res = rng.choice(["sa", "sa", "st_thread", "sr"])
        ops.append(("entry", i, res, rng.choice([1, 1, 2, 3])))
        live.append(i)
    return ops


def stream_rules():
    return [st.FlowRule(resource="sa", count=25),
            st.FlowRule(resource="st_thread", count=3,
                        grade=C.FLOW_GRADE_THREAD),
            st.FlowRule(resource="sr", count=40,
                        control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                        max_queueing_time_ms=0)]


def run_stream(ops):
    """The stream through the module API; the verdict of each entry."""
    verdicts, held = [], {}
    for op in ops:
        if op[0] == "advance":
            time_util.advance_time(op[1])
        elif op[0] == "entry":
            try:
                held[op[1]] = st.entry(op[2], count=op[3])
                verdicts.append("pass")
            except st.BlockException as ex:
                verdicts.append(type(ex).__name__)
        elif op[1] in held:
            held.pop(op[1]).exit()
    for h in held.values():
        h.exit()
    return verdicts


def frozen_engine(dev, rules, capacity=512):
    """A fresh default engine under the port's frozen clock."""
    time_util.freeze_time(NOW0)
    eng = st.reset(capacity=capacity, device=dev)
    st.load_flow_rules(rules)
    return eng


def ticket_fields(eng, resource, context="t_ctx"):
    reg = eng.registry
    cr, dr, orow, oid = reg.resolve_entry(
        resource, context, "", reg.entrance_row(context), 0)
    return dict(cluster_row=cr, dn_row=dr, origin_row=orow, origin_id=oid,
                origin_named=False, context_id=reg.context_id(context),
                count=1, prioritized=False, entry_in=False,
                skip_cluster=False, pre_blocked=False, params=())


def pipeline_card_checks(dev):
    """The frozen-clock checks of the pipeline on the card."""
    out = {}
    try:
        # 1. FIFO tickets with two cycles in flight, then a warm pool.
        eng = frozen_engine(dev, [st.FlowRule(resource="deep", count=50),
                                  st.FlowRule(resource="pool", count=1e9)])
        eng.warmup((1, 8))
        pipe = eng.start_pipeline(max_batch=PIPE_MAX_BATCH, linger_s=0.0)
        tickets = [pipe.submit_entry(ticket_fields(eng, "deep"))
                   for _ in range(100)]
        for t in tickets:
            if not t.done.wait(30.0):
                raise AssertionError("a ticket never resolved")
        reasons = [t.reason for t in tickets]
        if reasons != [0] * 50 + [int(C.BlockReason.FLOW)] * 50:
            raise AssertionError(f"ticket verdicts out of FIFO order: "
                                 f"{reasons}")
        if pipe.max_inflight < 2:
            raise AssertionError("the double buffer never engaged")
        for _ in range(6):
            st.entry("pool").exit()
        allocated = pipe.pool.allocated
        for _ in range(40):
            st.entry("pool").exit()
        if pipe.pool.allocated != allocated:
            raise AssertionError("a warm pipeline allocated a staging buffer")
        pinned = all(buf.block.is_pinned() for stack in pipe.pool._free.values()
                     for buf in stack)
        if not pipe.pool.pinned or not pinned:
            raise AssertionError("a staging buffer on the card is not pinned")
        out["fifo_tickets"] = {"tickets": 100, "passed": reasons.count(0),
                               "inflight_depth_max": pipe.max_inflight,
                               "pool_allocated": pipe.pool.allocated,
                               "pool_reused": pipe.pool.reused,
                               "buffers_pinned": True}
        eng.close()

        # 2. A shared quota under 16 concurrent callers.
        eng = frozen_engine(dev, [st.FlowRule(resource="conc", count=25)])
        eng.start_pipeline(max_batch=PIPE_MAX_BATCH, linger_s=0.0005)
        passed = []

        def worker():
            n = 0
            for _ in range(10):
                h = st.entry_ok("conc")
                if h:
                    n += 1
                    h.exit()
            passed.append(n)

        threads = [threading.Thread(target=worker)
                   for _ in range(PIPE_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if sum(passed) != 25:
            raise AssertionError(f"{sum(passed)} of 160 passed a count-25 "
                                 "rule")
        out["shared_quota"] = {"attempts": 160, "passed": sum(passed)}
        eng.close()

        # 3. The same stream synchronously on the card, pipelined on the
        # card, pipelined on the CPU.
        ops = stream_ops(PIPE_STREAM_SEED)
        runs = {}
        for name, d, piped in (("sync_cuda", dev, False),
                               ("pipelined_cuda", dev, True),
                               ("pipelined_cpu", "cpu", True)):
            eng = frozen_engine(d, stream_rules())
            if piped:
                eng.start_pipeline(max_batch=PIPE_MAX_BATCH, linger_s=0.0005)
            verdicts = run_stream(ops)
            eng.stop_pipeline()
            runs[name] = (verdicts, eng.node_snapshot(), eng.fail_open_count)
            eng.close()
        want = runs["sync_cuda"][0]
        for name, (verdicts, _, fail_open) in runs.items():
            if verdicts != want:
                first = next(i for i, (a, b) in enumerate(zip(verdicts, want))
                             if a != b)
                raise AssertionError(f"stream op {first}: {verdicts[first]} "
                                     f"{name}, {want[first]} sync_cuda")
            if fail_open:
                raise AssertionError(f"{name}: fail_open_count {fail_open}")
        sc, sp = runs["pipelined_cuda"][1], runs["pipelined_cpu"][1]
        if set(sc) != set(sp):
            raise AssertionError("pipelined node_snapshot resources differ")
        for res in sc:
            for k, v in sc[res].items():
                if not math.isclose(v, sp[res][k], rel_tol=FLOAT_RTOL,
                                    abs_tol=0):
                    raise AssertionError(f"pipelined {res}.{k}: {v} on cuda, "
                                         f"{sp[res][k]} on cpu")
        out["stream"] = {"ops": len(ops), "entries": len(want),
                         "verdicts_equal": True, "node_snapshot_equal": True,
                         "verdict_counts": {v: want.count(v)
                                            for v in sorted(set(want))}}
    finally:
        time_util.unfreeze_time()
    return out


def pipeline_phase(dev):
    """16 producers of ``st.entry`` pairs for a fixed window under the
    pipeline, then the frozen-clock card checks; prints the
    ``{"pipeline": ...}`` line."""
    t0 = time.perf_counter()
    mem0 = memory_mark()
    pools = api_pools()
    eng = api_engine(dev)
    eng.warmup((1, 8, 64))
    eng._lock = TimedLock(eng._lock)
    pipe = eng.start_pipeline(max_batch=PIPE_MAX_BATCH, linger_s=PIPE_LINGER_S)
    results = [None] * PIPE_THREADS
    barrier = threading.Barrier(PIPE_THREADS + 1)
    window = {}

    def worker(t):
        rng = np.random.default_rng(2000 + t)
        out = []
        barrier.wait()
        end = window["end"]
        while time.perf_counter() < end:
            cls, res, origin, args, error = api_pick(rng, pools, API_MIX)
            t1 = time.perf_counter()
            verdict = api_pair(res, origin, args, error)
            out.append((cls, time.perf_counter() - t1, verdict))
        results[t] = out

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(PIPE_THREADS)]
    for th in threads:
        th.start()
    torch.cuda.synchronize()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    h2d0 = H2D.copies
    eng.step_timer.snapshot(reset=True)
    eng._lock.samples.clear()
    t1 = time.perf_counter()
    window["end"] = t1 + PIPE_WINDOW_S
    barrier.wait()
    for th in threads:
        th.join()
    wall_s = time.perf_counter() - t1
    lock = eng._lock.report(wall_s)
    eng.stop_pipeline()
    torch.cuda.synchronize()
    launches = prefix_cuda.launches
    tile = prefix_cuda.tile_launches
    by_shape = dict(prefix_cuda.launches_by_shape)
    h2d = H2D.copies - h2d0
    steps = eng.step_timer.snapshot()
    stats = eng.pipeline_stats()
    inflight_left = pipe.inflight_depth_now()
    eng._flush_committer()
    threads_left = int(eng.state.cur_threads.sum())
    eng.traces.drain()
    traces = eng.traces.snapshot(limit=0)
    fail_open = eng.fail_open_count
    committer = eng.committer
    eng.close()
    rows = [r for out in results for r in out]
    by_cls = {}
    for cls, dt, verdict in rows:
        by_cls.setdefault(cls, []).append((dt, verdict))
    all_ms = [dt * 1e3 for _, dt, _ in rows]
    batches = sum(steps.get(k, {}).get("dispatches", 0)
                  for k in ("entry", "exit"))

    if stats["failOpenCycles"] or fail_open:
        raise AssertionError(f"failOpenCycles {stats['failOpenCycles']}, "
                             f"fail_open_count {fail_open}")
    if stats["batched"] <= stats["cycles"]:
        raise AssertionError(f"batching never engaged: {stats['batched']} "
                             f"entries in {stats['cycles']} cycles")
    if launches <= 0 or tile:
        raise AssertionError(f"prefix launches {launches}, tile walk {tile}")
    if inflight_left or threads_left:
        raise AssertionError(f"after stop: {inflight_left} cycles in flight, "
                             f"thread gauges sum to {threads_left}")
    if traces["errors"]:
        raise AssertionError(f"trace pump errors {traces['errors']}")
    if committer is not None and (committer.pending() != (0, 0)
                                  or committer.failures):
        raise AssertionError(f"committer after close: {committer.pending()} "
                             f"pending, {committer.failures} failures")
    out = {
        "threads": PIPE_THREADS, "window_s": PIPE_WINDOW_S,
        "max_batch": PIPE_MAX_BATCH, "linger_s": PIPE_LINGER_S,
        "wall_s": wall_s, "pairs": len(rows),
        "pairs_per_s": len(rows) / wall_s,
        "pair_ms": {"p50": pct(all_ms, 50), "p99": pct(all_ms, 99)},
        "pair_ms_by_class": {
            c: {"n": len(xs), "p50": pct([dt * 1e3 for dt, _ in xs], 50),
                "p99": pct([dt * 1e3 for dt, _ in xs], 99)}
            for c, xs in sorted(by_cls.items())},
        "blocked_share": {c: sum(v != "pass" for _, v in xs) / len(xs)
                          for c, xs in sorted(by_cls.items())},
        "pipeline_stats": stats,
        "mean_cycle_width": stats["batched"] / stats["cycles"],
        "entry_cycle_ladder_widths": dict(sorted(pipe.widths.items())),
        "step_timer": steps,
        "engine_lock": lock,
        "prefix_launches": launches,
        "prefix_launches_block_sort": launches - tile,
        "prefix_launches_by_shape": {
            f"K={k},N={n},M={m}": c for (k, n, m), c in sorted(by_shape.items())},
        "h2d_copies": h2d,
        "h2d_copies_per_batch": h2d / batches if batches else None,
        "h2d_copies_per_entry_cycle": h2d / stats["cycles"],
        "traces": {k: traces[k] for k in ("seenBlocked", "recorded",
                                          "droppedBatches", "errors")},
        "fail_open_count": fail_open,
        "inflight_after_stop": inflight_left,
        "thread_gauges_after_stop": threads_left,
        "committer_started": committer is not None,
    }
    out["card_checks"] = pipeline_card_checks(dev)
    out["phase_s"] = time.perf_counter() - t0
    out["memory_bytes"] = memory_report(mem0)
    print(json.dumps({"pipeline": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 8: slot-table admission and the once-per-second fold
# ---------------------------------------------------------------------------

SLOT_ORACLE_NAMES = 16
SLOT_ORACLE_SECONDS = 10
SLOT_ORACLE_PAIRS = 20
# The timed run at a deployment's size (docs/OPERATIONS.md "Slot-table
# admission": registry 16,384 names, 8 steals a tick, 20% hysteresis):
# 4,096 usable device rows, 4,000 of them pinned by leaseable QPS rules.
SLOT_BUDGET = 4098
SLOT_RULED = 4000
SLOT_TAIL = 12000
SLOT_LEASED_PER_S = 1024
SLOT_TAIL_PER_S = 64
SLOT_SECONDS = 10
SLOT_PHASE_LIMIT_S = 120.0


class SlotRun:
    """One slot-mode engine on an injected clock, its event sink kept."""

    def __init__(self, dev, budget, flow=()):
        from sentinel_tpu_torch.core import context as ctx_mod

        ctx_mod.replace_context(None)
        self.clock = Clock(NOW0)
        self.eng = SentinelEngine(device=dev, clock=self.clock,
                                  slot_budget=budget)
        self.events = []
        self.eng.slots.event_sink = self.events.append
        if flow:
            self.eng.flow_rules.load_rules(
                [F.FlowRule(resource=r, count=c) for r, c in flow])

    def serve(self, res) -> str:
        try:
            self.eng.entry(res).exit()
            return "P"
        except st.BlockException:
            return "B"

    def second(self):
        """Land the second's leased commits, step the clock, run the fold
        (``timeseries_view`` flushes the committer and spills)."""
        self.eng._flush_committer()
        self.clock.now += 1000
        return self.eng.timeseries_view(now_ms=self.clock.now)

    def result(self, verdicts):
        from sentinel_tpu_torch.core import context as ctx_mod

        eng = self.eng
        view = eng.timeseries_view(now_ms=self.clock.now)
        with eng._lock:
            state = convert.state_to_numpy(eng.state)
        out = {"verdicts": "".join(verdicts), "status": eng.slots.status(),
               "events": list(self.events), "view": view, "state": state,
               "fail_open": eng.fail_open_count}
        committer = eng.committer
        eng.close()
        out["committer_failures"] = committer.failures if committer else 0
        ctx_mod.replace_context(None)
        return out


def slot_oracle(dev):
    """The reference's differential oracle (tests/test_slots.py): a
    6-usable-slot engine and a 62-usable-slot twin on one Zipf stream."""
    import random

    names = [f"oracle{i}" for i in range(SLOT_ORACLE_NAMES)]
    flow = [(names[i], 3) for i in (0, 5, 10)]
    weights = [1.0 / (i + 1) ** 1.2 for i in range(SLOT_ORACLE_NAMES)]
    out = {}
    for budget in (8, 64):
        run = SlotRun(dev, budget, flow)
        rng = random.Random(1234)
        verdicts = []
        for _ in range(SLOT_ORACLE_SECONDS):
            for _ in range(SLOT_ORACLE_PAIRS):
                verdicts.append(run.serve(
                    rng.choices(names, weights=weights)[0]))
            run.second()
        out[budget] = run.result(verdicts)
    return out


def slot_storm(dev):
    """The reference's storm drill: budget 3 (one usable slot),
    ``slots.evict.storm`` armed after=2, times=2."""
    from sentinel_tpu_torch.resilience.faults import FaultInjector

    run = SlotRun(dev, 3)
    plan = [["alpha"] * 3, ["alpha"] * 2, [], ["beta"] * 3,
            ["alpha"] * 2 + ["beta"], ["alpha", "beta"]]
    verdicts = []
    with FaultInjector(seed=99, scope_thread=True) as inj:
        inj.arm("slots.evict.storm", mode="error", after=2, times=2)
        for second in plan:
            for res in second:
                verdicts.append(run.serve(res))
            run.second()
    return run.result(verdicts)


def slot_exactness():
    """Card against CPU: the oracle and the storm drill give the same
    verdicts, statuses, event histories, views and states on both."""
    runs = {dev: {"oracle": slot_oracle(dev), "storm": slot_storm(dev)}
            for dev in ("cuda", "cpu")}
    cuda, cpu = runs["cuda"], runs["cpu"]
    pairs = [(f"oracle{b}", cuda["oracle"][b], cpu["oracle"][b])
             for b in (8, 64)] + [("storm", cuda["storm"], cpu["storm"])]
    for name, a, b in pairs:
        for k in ("verdicts", "status", "events", "view"):
            if a[k] != b[k]:
                raise AssertionError(f"slot {name}: {k} differs between "
                                     "cuda and cpu")
        compare_states(a["state"], b["state"], name)
        if a["fail_open"] or a["committer_failures"]:
            raise AssertionError(f"slot {name}: fail-open {a['fail_open']}, "
                                 f"committer failures "
                                 f"{a['committer_failures']}")
    small, twin = cuda["oracle"][8], cuda["oracle"][64]
    if small["verdicts"] != twin["verdicts"]:
        raise AssertionError("eviction changed a verdict on the card")
    if small["status"]["evictionsTotal"] <= 0 \
            or twin["status"]["evictionsTotal"] != 0:
        raise AssertionError("the budget-8 engine must evict and the "
                             "budget-64 twin must not")
    if cuda["storm"]["status"]["stormsTotal"] != 2:
        raise AssertionError("the storm drill did not storm twice")
    return {
        "oracle_verdicts": small["verdicts"].count("P"),
        "oracle_blocks": small["verdicts"].count("B"),
        "oracle_budget8": {k: small["status"][k] for k in (
            "evictionsTotal", "rehydrationsTotal", "coldPassTotal",
            "hitRate")},
        "storm_events": len(cuda["storm"]["events"]),
        "storm_status": {k: cuda["storm"]["status"][k] for k in (
            "stormsTotal", "evictionsTotal", "rehydrationsTotal",
            "coldPassTotal")},
        "cuda_equals_cpu": True,
    }


def slot_timed(dev):
    """4,000 pinned leaseable resources and a Zipf(1.2) tail of 12,000
    unruled names contesting the 96 dynamic slots, 10 simulated seconds
    of 1,024 leased and 64 tail pairs each, one fold a second."""
    torch.cuda.synchronize()
    mem0 = memory_mark()  # the engine's own state counts above it
    run = SlotRun(dev, SLOT_BUDGET)
    eng, slots = run.eng, run.eng.slots
    ruled = [f"slot_hot{i}" for i in range(SLOT_RULED)]
    tail = [f"slot_tail{i}" for i in range(SLOT_TAIL)]
    surgeries = []

    execute = slots._execute

    def timed_execute(evicts, admits, now_ms):
        torch.cuda.synchronize()
        b0 = (slots.surgery_h2d_bytes_total, slots.surgery_d2h_bytes_total)
        t0 = time.perf_counter()
        execute(evicts, admits, now_ms)
        torch.cuda.synchronize()
        surgeries.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "evicts": len(evicts), "admits": len(admits),
            "h2d_bytes": slots.surgery_h2d_bytes_total - b0[0],
            "d2h_bytes": slots.surgery_d2h_bytes_total - b0[1]})

    slots._execute = timed_execute
    t0 = time.perf_counter()
    eng.flow_rules.load_rules([F.FlowRule(resource=r, count=1e9)
                               for r in ruled])
    pin_s = time.perf_counter() - t0
    pin_surgery = surgeries.pop() if surgeries else None
    missing = [r for r in ruled if slots.current(r) is None
               or r not in eng._leases]
    if missing:
        raise AssertionError(f"{len(missing)} ruled resources are not "
                             "pinned hot and leased")
    eng.warmup((1,))

    spill = eng._spill_flight
    folds = []

    def timed_spill(now_ms=None):
        n = len(surgeries)
        t1 = time.perf_counter()
        spill(now_ms)
        torch.cuda.synchronize()
        took = (time.perf_counter() - t1) * 1e3
        folds.append({"ms": took, "surgery_ms": sum(
            x["ms"] for x in surgeries[n:])})

    eng._spill_flight = timed_spill
    torch.cuda.synchronize()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    import hashlib

    # The draws, made up front (the tail as bench.py draws its Zipf
    # churn); their hash says whether two runs served the same stream.
    rng = np.random.default_rng(20)
    pick = np.random.default_rng(21)
    draws = []
    digest = hashlib.sha256()
    for _ in range(SLOT_SECONDS):
        leased = pick.integers(0, SLOT_RULED, size=SLOT_LEASED_PER_S)
        tail_i = np.minimum(rng.zipf(1.2, size=SLOT_TAIL_PER_S), SLOT_TAIL) - 1
        digest.update(leased.tobytes())
        digest.update(tail_i.tobytes())
        draws.append((leased, tail_i))
    leased_us, tail_ms, served = [], [], 0
    t0 = time.perf_counter()
    for leased, tail_i in draws:
        for i in leased:
            t1 = time.perf_counter()
            if run.serve(ruled[int(i)]) != "P":
                raise AssertionError("a leased pair blocked at count 1e9")
            leased_us.append((time.perf_counter() - t1) * 1e6)
        for i in tail_i:
            t1 = time.perf_counter()
            if run.serve(tail[int(i)]) != "P":
                raise AssertionError("an unruled pair blocked")
            tail_ms.append((time.perf_counter() - t1) * 1e3)
        served += SLOT_LEASED_PER_S + SLOT_TAIL_PER_S
        run.second()
    eng._flush_committer()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = prefix_cuda.launches
    tile = prefix_cuda.tile_launches
    by_shape = dict(prefix_cuda.launches_by_shape)
    memory = memory_report(mem0)
    status = slots.status()

    # Conservation: every served PASS is on the device at its current
    # slot, in a spill record, or in a cold tally.
    PASS = C.MetricEvent.PASS
    with eng._lock:
        state = eng.state
        dev_pass = (state.telemetry.totals[PASS]
                    + state.sec.counts[PASS].to(torch.int64)).cpu().numpy()
        ring = state.flight
        flight_bytes = ring_bytes(ring) if ring is not None else 0
    on_device = sum(int(dev_pass[slot])
                    for slot in slots.resources().values())
    in_spill = sum(int(rec.tel_totals[PASS]) + int(rec.sec_counts[PASS])
                   for rec in slots._spill.values())
    in_cold = sum(int(vec[PASS]) for vec in slots._cold.values())
    ruled_set = set(ruled)
    evicted_pinned = [e["resource"] for e in run.events
                      if e["e"] == "slotEvict" and e["resource"] in ruled_set]
    committer = eng.committer
    failures = committer.failures if committer is not None else 0
    fail_open = eng.fail_open_count

    if status["evictionsTotal"] <= 0 or status["rehydrationsTotal"] <= 0 \
            or status["coldPassTotal"] <= 0:
        raise AssertionError(f"the slot table did not churn: {status}")
    if status["coldBlockTotal"] != 0:
        raise AssertionError(f"coldBlockTotal {status['coldBlockTotal']}")
    if evicted_pinned:
        raise AssertionError(f"pinned resources evicted: {evicted_pinned[:5]}")
    if fail_open or failures:
        raise AssertionError(f"fail-open {fail_open}, committer failures "
                             f"{failures}")
    if on_device + in_spill + in_cold != served:
        raise AssertionError(
            f"PASS not conserved: device {on_device} + spill {in_spill} + "
            f"cold {in_cold} != served {served}")
    if launches <= 0 or tile:
        raise AssertionError(f"prefix launches {launches}, tile walk {tile}")
    if eng.registry.overflow_count:
        raise AssertionError(f"registry overflow {eng.registry.overflow_count}")
    ms = [x["ms"] for x in surgeries]
    spill_ms = [f["ms"] - f["surgery_ms"] for f in folds]
    by_kind = {}
    for x in surgeries:
        k = by_kind.setdefault(f"evicts={x['evicts']},admits={x['admits']}",
                               {"n": 0, "h2d_bytes": x["h2d_bytes"],
                                "d2h_bytes": x["d2h_bytes"], "ms": []})
        k["n"] += 1
        k["ms"].append(x["ms"])
    for k in by_kind.values():
        k["ms_p50"] = pct(k.pop("ms"), 50)
    # The engine stays open for the boot phase's slot-mode checkpoint.
    return run, {
        "budget": SLOT_BUDGET, "ruled": SLOT_RULED, "tail_names": SLOT_TAIL,
        "seconds": SLOT_SECONDS, "pairs": served, "wall_s": wall_s,
        "draws_sha256": digest.hexdigest()[:16],
        "pairs_per_s": served / wall_s,
        "leased_pair_us": {"n": len(leased_us), "p50": pct(leased_us, 50),
                           "p99": pct(leased_us, 99)},
        "tail_pair_ms": {"n": len(tail_ms), "p50": pct(tail_ms, 50),
                         "p99": pct(tail_ms, 99)},
        "hit_rate": status["hitRate"],
        "steals": status["stealsTotal"],
        "evictions": status["evictionsTotal"],
        "rehydrations": status["rehydrationsTotal"],
        "cold_pass": status["coldPassTotal"],
        "status": status,
        "pin_load_s": pin_s, "pin_surgery": pin_surgery,
        "surgeries": {
            "n": len(surgeries), "ms_p50": pct(ms, 50),
            "ms_max": max(ms) if ms else None,
            "h2d_bytes_total": sum(x["h2d_bytes"] for x in surgeries),
            "d2h_bytes_total": sum(x["d2h_bytes"] for x in surgeries),
            "by_kind": by_kind},
        "folds": len(folds),
        "spill_ms_p50": pct(spill_ms, 50),
        "fold_ms_p50": pct([f["ms"] for f in folds], 50),
        "conservation": {"served": served, "on_device": on_device,
                         "in_spill": in_spill, "in_cold": in_cold},
        "prefix_launches": launches,
        "prefix_launches_block_sort": launches - tile,
        "prefix_launches_by_shape": {
            f"K={k},N={n},M={m}": c for (k, n, m), c in sorted(by_shape.items())},
        "flight_ring_bytes": flight_bytes,
        "memory_bytes": memory,
    }


def slot_phase(dev):
    t0 = time.perf_counter()
    out = {"exactness": slot_exactness()}
    out["exactness_s"] = time.perf_counter() - t0
    run, out["timed"] = slot_timed(dev)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"slots": out}), flush=True)
    if out["phase_s"] > SLOT_PHASE_LIMIT_S:
        raise AssertionError(f"slot phase took {out['phase_s']:.1f} s, over "
                             f"{SLOT_PHASE_LIMIT_S} s")
    return out, run


# ---------------------------------------------------------------------------
# Phase 9: the engine's boot surface (config seeding, checkpoints, SPI)
# ---------------------------------------------------------------------------

BOOT_KEYS = {"csp.sentinel.statistic.interval.ms": ("2000", "1000"),
             "csp.sentinel.statistic.sample.count": ("4", "2"),
             "csp.sentinel.occupy.timeout.ms": ("250", "500")}
BOOT_CAPACITY = 1_024
# Cut from 2,000 stream pairs over 20 s and 1,000 SPI pairs over 10 s, at
# the same rates, to keep the phase well inside its 60 s: on an H100
# (700 W) it took 57.3 s with 1,000 and 500.
BOOT_STREAM_PAIRS = 500
BOOT_STREAM_SECONDS = 5
BOOT_PAIRS_PER_STEP = 8
BOOT_SAVES = 5
BOOT_RESTORE_BATCHES = 8
BOOT_RESTORE_WIDTH = 8_192
BOOT_TIMER_PERIOD_S = 0.5
BOOT_TIMER_WINDOW_S = 3.0
BOOT_TIMER_MIN_FILES = 4
BOOT_SPI_PAIRS = 250
BOOT_SPI_STEP_MS = 10
BOOT_PHASE_LIMIT_S = 60.0
CKPT_DIR = Path(__file__).resolve().parent / "smoke_logs" / "checkpoints"


def boot_stream_ops(seed: int = 31):
    """(resource, count, prioritized, error) per pair: a leased QPS quota,
    a leased warm-up rule and an unruled name on the host, a rate limiter
    and a degraded resource on the device path."""
    rng = np.random.default_rng(seed)
    names = ("bq", "bw", "bu", "brl", "bd")
    ops = []
    for _ in range(BOOT_STREAM_PAIRS):
        res = names[int(rng.choice(5, p=(0.3, 0.3, 0.3, 0.05, 0.05)))]
        ops.append((res, int(rng.integers(1, 3)),
                    res == "bq" and rng.random() < 0.005,
                    res == "bd" and rng.random() < 0.6))
    return ops


def boot_rules(eng) -> None:
    """The stream's rules, compiled at once: a compile that the committer's
    background flush ran would intern the rules' rows at a moment set by
    thread timing, so row numbers would differ between two runs."""
    eng.flow_rules.load_rules([
        st.FlowRule(resource="bq", count=20),
        st.FlowRule(resource="bw", count=60,
                    control_behavior=C.CONTROL_BEHAVIOR_WARM_UP,
                    warm_up_period_sec=5),
        st.FlowRule(resource="brl", count=25,
                    control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                    max_queueing_time_ms=10)])
    eng.degrade_rules.load_rules([st.DegradeRule(
        resource="bd", count=0.5, grade=C.DEGRADE_GRADE_EXCEPTION_RATIO,
        time_window=2, min_request_amount=5)])
    with eng._lock, eng._on_stream():
        eng._ensure_compiled()


class BusinessError(Exception):
    """The error a guarded call of the boot stream raises (traced by the
    entry's ``with`` block as an exception, never a block)."""


def boot_drive(eng, clock, ops):
    """Each pair ``with eng.entry(...)``, 8 to a clock step, the
    committer flushed before every step (so leased commits land in the
    second they were admitted in on both devices): the verdict of each."""
    from sentinel_tpu_torch.core import context as ctx_mod

    step_ms = BOOT_STREAM_SECONDS * 1000 * BOOT_PAIRS_PER_STEP \
        // BOOT_STREAM_PAIRS
    waits = []
    submit = eng._submit_entry

    def recorded(*a, **k):
        out = submit(*a, **k)
        waits.append(out[1])
        return out

    eng._submit_entry = recorded
    verdicts = []
    try:
        for i, (res, count, prioritized, error) in enumerate(ops):
            if i % BOOT_PAIRS_PER_STEP == 0:
                eng._flush_committer()
                clock.now += step_ms
            n = len(waits)
            try:
                with eng.entry(res, count=count, prioritized=prioritized):
                    if error:
                        raise BusinessError()
            except st.BlockException as ex:
                verdicts.append(type(ex).__name__)
                continue
            except BusinessError:
                pass
            verdicts.append("wait" if len(waits) > n and waits[-1] > 0
                            else "pass")
        eng._flush_committer()
    finally:
        del eng._submit_entry
        ctx_mod.replace_context(None)
    return verdicts


def boot_config_run(dev, ops):
    """Engine under 2000 / 4 / 250 from config: the stream, then the two
    push properties (accepted, then an equal push refused), the stream
    again."""
    from sentinel_tpu_torch.core import context as ctx_mod

    t0 = time.perf_counter()
    # A pooled context of an earlier engine on this thread holds that
    # engine's rows: retire it, or the rows interned here would differ.
    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    for key, (value, _) in BOOT_KEYS.items():
        config.set(key, value)
    clock = Clock(NOW0)
    try:
        eng = SentinelEngine(capacity=BOOT_CAPACITY, device=dev, clock=clock)
    finally:
        for key, (_, default) in BOOT_KEYS.items():
            config.set(key, default)
    seeded = (eng._spec1.interval_ms, eng._spec1.buckets,
              eng._occupy_timeout_ms)
    if seeded != (2000, 4, 250):
        raise AssertionError(f"{dev}: config seeded {seeded}, not "
                             "(2000, 4, 250)")
    boot_rules(eng)
    out = {"seeded": seeded, "first": boot_drive(eng, clock, ops)}
    with eng._lock:
        out["first_state"] = convert.state_to_numpy(eng.state)
    push = ({"intervalMs": 1000, "sampleCount": 2}, 250)
    out["push"] = [eng.window_geometry_property.update_value(push[0]),
                   eng.occupy_timeout_property.update_value(push[1])]
    out["equal_push"] = [eng.window_geometry_property.update_value(push[0]),
                         eng.occupy_timeout_property.update_value(push[1])]
    out["pushed"] = (eng._spec1.interval_ms, eng._spec1.buckets,
                     eng._occupy_timeout_ms)
    if out["push"] != [True, True] or out["equal_push"] != [False, False] \
            or out["pushed"] != (1000, 2, 250):
        raise AssertionError(f"{dev}: pushes {out['push']}, equal pushes "
                             f"{out['equal_push']}, pushed {out['pushed']}")
    out["second"] = boot_drive(eng, clock, ops)
    with eng._lock:
        out["second_state"] = convert.state_to_numpy(eng.state)
    out["fail_open"] = eng.fail_open_count
    committer = eng.committer
    eng.close()
    out["committer_failures"] = committer.failures if committer else 0
    out["s"] = time.perf_counter() - t0
    return out


def boot_config(dev):
    ops = boot_stream_ops()
    runs = {d: boot_config_run(d, ops) for d in (dev, "cpu")}
    card, cpu = runs[dev], runs["cpu"]
    for part in ("first", "second"):
        if card[part] != cpu[part]:
            i = next(i for i, (a, b) in enumerate(zip(card[part], cpu[part]))
                     if a != b)
            raise AssertionError(f"boot config stream ({part}) pair {i}: "
                                 f"{card[part][i]} on the card, "
                                 f"{cpu[part][i]} on the CPU")
        compare_states(card[f"{part}_state"], cpu[f"{part}_state"],
                       f"boot config {part}")
    for name, run in runs.items():
        if run["fail_open"] or run["committer_failures"]:
            raise AssertionError(f"boot config {name}: fail-open "
                                 f"{run['fail_open']}, committer failures "
                                 f"{run['committer_failures']}")
    verdicts = card["first"] + card["second"]
    if not {"pass", "FlowException", "DegradeException"} <= set(verdicts):
        raise AssertionError(f"the boot stream blocked too little: "
                             f"{sorted(set(verdicts))}")
    return {"pairs": 2 * len(ops), "card_s": card["s"], "cpu_s": cpu["s"],
            "seeded": card["seeded"],
            "pushed": card["pushed"], "push": card["push"],
            "equal_push": card["equal_push"], "card_equals_cpu": True,
            "verdict_counts": {v: verdicts.count(v)
                               for v in sorted(set(verdicts))}}


def restored_equal(eng, arrays, what):
    """The engine's persisted tensors equal the file's, bit for bit, on the
    engine's device; the thread gauges zero."""
    got = _state_arrays(eng.state)
    for name, want in arrays.items():
        t = got[name]
        if t.device.type != eng.device.type or tuple(t.shape) != want.shape \
                or t.dtype != torch.from_numpy(want).dtype:
            raise AssertionError(f"{what}: {name} is {t.dtype}"
                                 f"{list(t.shape)} on {t.device}")
        if name == "cur_threads":
            if int(t.abs().sum()):
                raise AssertionError(f"{what}: cur_threads not zero")
        elif not np.array_equal(t.cpu().numpy(), want):
            raise AssertionError(f"{what}: {name} differs from the file")


def boot_restart(dev, main, slot_run):
    """Warm restart at the main path's size and in slot mode, and the
    background timer."""
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    meng, mclock = main["eng"], main["clock"]
    out = {}
    # The main-path engine must come out unchanged: a device copy of its
    # whole state, compared after the saves.
    with meng._lock:
        before = [t.clone() for t in state_tensors(meng.state)]
    inner = meng._lock
    meng._lock = TimedLock(inner)
    path = str(CKPT_DIR / "main.npz")
    save_ms = []
    for _ in range(BOOT_SAVES):
        t0 = time.perf_counter()
        st.save_checkpoint(meng, path)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    holds = [h * 1e3 for key, _, h in meng._lock.samples
             if key.endswith(":save_checkpoint")]
    meng._lock = inner
    if len(holds) != BOOT_SAVES:
        raise AssertionError(f"{len(holds)} save lock holds for "
                             f"{BOOT_SAVES} saves")
    with meng._lock:
        after = state_tensors(meng.state)
        if len(after) != len(before) or not all(
                torch.equal(a, b) for a, b in zip(before, after)):
            raise AssertionError("a save changed the main-path engine's state")
    _, arrays = _load_npz(path)
    with meng._lock:
        for name, t in _state_arrays(meng.state).items():
            if not np.array_equal(t.cpu().numpy(), arrays[name]):
                raise AssertionError(f"main checkpoint: {name} differs from "
                                     "the engine")
    del before, after
    out["main"] = {
        "capacity": meng.capacity, "file_bytes": os.path.getsize(path),
        "persisted_bytes": sum(a.nbytes for a in arrays.values()),
        "lock_held_ms": {"p50": pct(holds, 50), "max": max(holds)},
        "save_ms": {"p50": pct(save_ms, 50), "max": max(save_ms)}}
    # Restore into a fresh card engine and a fresh CPU engine; the next
    # batches decide the same on both.
    restored = {}
    for d in (dev, "cpu"):
        clock = Clock(mclock.now)
        eng = SentinelEngine(capacity=CAPACITY, device=d, clock=clock)
        load_rules(eng, tight=False)
        if d == dev:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.restore_checkpoint(eng, path)
        if d == dev:
            torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        restored_equal(eng, arrays, f"main restore on {d}")
        restored[d] = (eng, clock, restore_ms)
    out["main"]["restore_ms"] = restored[dev][2]
    out["main"]["restore_ms_cpu"] = restored["cpu"][2]
    rng = np.random.default_rng(41)
    for r in range(BOOT_RESTORE_BATCHES):
        buf = entry_buf(rng, BOOT_RESTORE_WIDTH, main["cluster"], main["dn"],
                        main["origin_a"], mixed=(r % 2 == 1))
        decs = []
        for d in (dev, "cpu"):
            eng, clock, _ = restored[d]
            clock.now += 50
            dec = eng.check_batch(buf)
            decs.append({f: getattr(dec, f).cpu().numpy()
                         for f in dec._fields})
        for f in decs[0]:
            if not np.array_equal(decs[0][f], decs[1][f]):
                raise AssertionError(f"restored batch {r}: decisions.{f} "
                                     "differ between the card and the CPU")
    restored["cpu"][0].close()
    out["main"].update({"restored_bit_equal": True,
                        "next_batches_equal": BOOT_RESTORE_BATCHES})
    # Slot mode: the slot phase's engine after its timed run.
    seng = slot_run.eng
    spath = str(CKPT_DIR / "slots.npz")
    t0 = time.perf_counter()
    st.save_checkpoint(seng, spath)
    slot_save_ms = (time.perf_counter() - t0) * 1e3
    saved = seng.slots.checkpoint_dict()
    seng.close()
    _, sarrays = _load_npz(spath)
    for d in (dev, "cpu"):
        from sentinel_tpu_torch.core import context as ctx_mod

        ctx_mod.replace_context(None)
        eng = SentinelEngine(device=d, clock=Clock(slot_run.clock.now),
                             slot_budget=SLOT_BUDGET)
        st.restore_checkpoint(eng, spath)
        if eng.slots.checkpoint_dict() != saved:
            raise AssertionError(f"slot restore on {d}: the assignment "
                                 "differs from the saved one")
        restored_equal(eng, sarrays, f"slot restore on {d}")
        eng.close()
    out["slots"] = {"budget": SLOT_BUDGET, "hot": len(saved["hot"]),
                    "file_bytes": os.path.getsize(spath),
                    "persisted_bytes": sum(a.nbytes for a in
                                           sarrays.values()),
                    "save_ms": slot_save_ms, "assignment_equal": True}
    out["timer"] = boot_timer(dev)
    return out, (restored[dev][0], restored[dev][1], buf)


def state_tensors(state):
    """Every tensor of a state, in field order."""
    out = []
    for v in state:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(state_tensors(v))
    return out


def boot_timer(dev):
    """A CheckpointTimer every 0.5 s on the API phase's engine while one
    thread serves its traffic mix: each save goes to a file of its own,
    every file must load and no save may fail."""
    eng = api_engine(dev)
    paths, failures = [], []

    def save(engine, _path):
        path = str(CKPT_DIR / f"timer{len(paths)}.npz")
        try:
            st.save_checkpoint(engine, path)
        except Exception as ex:  # noqa: BLE001 — counted, then re-raised
            failures.append(repr(ex))
            raise
        paths.append(path)

    pools = api_pools()
    rng = np.random.default_rng(43)
    timer = st.CheckpointTimer(eng, str(CKPT_DIR / "timer.npz"),
                               period_s=BOOT_TIMER_PERIOD_S, save=save)
    pairs = 0
    t0 = time.perf_counter()
    timer.start()
    try:
        # At least the window; on until the timer has written its files
        # (a slow host's compression can stretch a period).
        while time.perf_counter() - t0 < BOOT_TIMER_WINDOW_S or (
                len(paths) < BOOT_TIMER_MIN_FILES
                and time.perf_counter() - t0 < 4 * BOOT_TIMER_WINDOW_S):
            _, res, origin, args, error = api_pick(rng, pools, API_MIX)
            api_pair(res, origin, args, error)
            pairs += 1
    finally:
        timer.stop()
    window_s = time.perf_counter() - t0
    for path in paths:
        _load_npz(path)
    committer = eng.committer
    eng.close()
    if failures or len(paths) < BOOT_TIMER_MIN_FILES:
        raise AssertionError(f"timer wrote {len(paths)} files, failures "
                             f"{failures}")
    if eng.fail_open_count or (committer and committer.failures):
        raise AssertionError("the timer run failed open")
    return {"period_s": BOOT_TIMER_PERIOD_S, "window_s": window_s,
            "pairs": pairs, "files": len(paths), "all_load": True,
            "failures": 0}


def cap_big_acquires(state, rules, batch, now_ms, candidate):
    """tests/test_spi.py:91's checker: no acquire of more than 3."""
    return candidate & (batch.count > 3)


def two_per_second(state, rules, batch, now_ms, candidate):
    """tests/test_spi.py:112's checker: 2 PASS a second per cluster row."""
    from sentinel_tpu_torch.ops import window as W

    used = W.row_totals(state.w1, batch.cluster_row)[:, C.MetricEvent.PASS]
    return candidate & (used >= 2)


def boot_spi_run(dev):
    """The API phase's engine kind (capacity 8,192 as its parity script)
    under the frozen clock: ``BOOT_SPI_PAIRS`` pairs 10 ms apart with both
    checkers registered, then leased pairs after unregistering them."""
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.core import spi

    t0 = time.perf_counter()
    time_util.freeze_time(NOW0)
    try:
        ctx_mod.replace_context(None)
        ctx_mod.bump_generation()
        eng = api_engine(dev, capacity=API_PARITY_CAPACITY, register=False)
        # Five names a class: ~3 pairs a name a second, so the 2-a-second
        # checker has rows to block.
        pools = {k: v[:5] for k, v in api_pools().items()}
        device_calls = []
        submit = eng._submit_entry

        def counted(*a, **k):
            device_calls.append(1)
            return submit(*a, **k)

        eng._submit_entry = counted
        decisions = []
        step = eng._entry_step

        def recorded(*a, **k):
            state, dec = step(*a, **k)
            decisions.append((dec.reason.cpu().numpy().tolist(),
                              dec.rule_slot.cpu().numpy().tolist()))
            return state, dec

        eng._entry_step = recorded
        spi.register_device_checker(cap_big_acquires, order=-1)
        spi.register_device_checker(two_per_second, order=1)
        rng = np.random.default_rng(47)
        verdicts = []
        try:
            for _ in range(BOOT_SPI_PAIRS):
                time_util.advance_time(BOOT_SPI_STEP_MS)
                _, res, origin, args, error = api_pick(rng, pools,
                                                       API_PARITY_MIX)
                count = int(rng.integers(1, 6))
                if origin is not None:
                    st.context_enter("ctx", origin)
                try:
                    with st.entry(res, count=count, args=args):
                        if error:
                            st.trace(RuntimeError("business error"))
                    verdicts.append("pass")
                except st.BlockException as ex:
                    verdicts.append(type(ex).__name__)
                finally:
                    if origin is not None:
                        st.exit_context()
        finally:
            spi.unregister_device_checker(cap_big_acquires)
            spi.unregister_device_checker(two_per_second)
        eng._entry_step = step
        registered_calls = len(device_calls)
        time_util.advance_time(1000)
        leased = pools["leased_default_param"] + pools["leased_warm_up"]
        for res in leased:
            api_pair(res, None, (0,), False)
        leased_device_calls = len(device_calls) - registered_calls
        snapshot = eng.node_snapshot()
        with eng._lock:
            state = convert.state_to_numpy(eng.state)
        out = {"verdicts": verdicts, "decisions": decisions,
               "registered_device_calls": registered_calls,
               "leased_pairs": len(leased),
               "leased_after_unregister": len(leased) - leased_device_calls,
               "snapshot": snapshot, "state": state,
               "fail_open": eng.fail_open_count}
        committer = eng.committer
        eng.close()
        out["committer_failures"] = committer.failures if committer else 0
    finally:
        time_util.unfreeze_time()
    out["s"] = time.perf_counter() - t0
    return out


def boot_spi(dev, restored_main):
    runs = {d: boot_spi_run(d) for d in (dev, "cpu")}
    card, cpu = runs[dev], runs["cpu"]
    for k in ("verdicts", "decisions"):
        if card[k] != cpu[k]:
            raise AssertionError(f"boot SPI: {k} differ between the card "
                                 "and the CPU")
    if set(card["snapshot"]) != set(cpu["snapshot"]):
        raise AssertionError("boot SPI: node_snapshot resources differ")
    for res, row in card["snapshot"].items():
        for k, v in row.items():
            if not math.isclose(v, cpu["snapshot"][res][k],
                                rel_tol=FLOAT_RTOL, abs_tol=0):
                raise AssertionError(f"boot SPI: {res}.{k} {v} on the card, "
                                     f"{cpu['snapshot'][res][k]} on the CPU")
    compare_states(card["state"], cpu["state"], "boot SPI")
    for name, run in runs.items():
        if run["registered_device_calls"] != BOOT_SPI_PAIRS:
            raise AssertionError(
                f"boot SPI {name}: {run['registered_device_calls']} device "
                f"entries for {BOOT_SPI_PAIRS} pairs: a pair took a fast "
                "path while a checker was registered")
        if run["leased_after_unregister"] != run["leased_pairs"]:
            raise AssertionError(f"boot SPI {name}: the lease did not come "
                                 "back after unregistering")
        if run["fail_open"] or run["committer_failures"]:
            raise AssertionError(f"boot SPI {name}: fail-open")
    custom = int(C.BlockReason.CUSTOM)
    by_slot = {}
    for reason, slot in card["decisions"]:
        for r, s in zip(reason, slot):
            if r == custom:
                by_slot[s] = by_slot.get(s, 0) + 1
    if set(by_slot) != {0, 1}:
        raise AssertionError(f"CUSTOM blocks by checker index {by_slot}")
    blocked = card["verdicts"].count("BlockException")
    # One check_batch at the main path's width with the cap checker, on
    # the restored card engine: the splice keeps the 4 launches a step.
    from sentinel_tpu_torch.core import spi

    eng, clock, buf = restored_main
    spi.register_device_checker(cap_big_acquires)
    try:
        buf = dict(buf)
        buf["count"] = buf["count"].copy()
        buf["count"][::97] = 4
        clock.now += 50
        torch.cuda.synchronize()
        before = prefix_cuda.launches
        dec = eng.check_batch(buf)
        reason = dec.reason.cpu().numpy()
        launches = prefix_cuda.launches - before
    finally:
        spi.unregister_device_checker(cap_big_acquires)
    eng.close()
    if launches != 4:
        raise AssertionError(f"{launches} prefix launches for one entry "
                             "step with a checker, not 4")
    if int((reason == custom).sum()) != len(buf["count"][::97]):
        raise AssertionError("the cap checker did not block its lanes")
    return {"pairs": BOOT_SPI_PAIRS,
            "seconds": BOOT_SPI_PAIRS * BOOT_SPI_STEP_MS / 1000,
            "card_s": card["s"], "cpu_s": cpu["s"],
            "card_equals_cpu": True,
            "verdict_counts": {v: card["verdicts"].count(v)
                               for v in sorted(set(card["verdicts"]))},
            "custom_by_checker_index": by_slot,
            "custom_blocked_pairs": blocked,
            "device_entries_while_registered": card["registered_device_calls"],
            "leased_after_unregister": card["leased_after_unregister"],
            "check_batch_width": len(buf["count"]),
            "check_batch_prefix_launches": launches,
            "check_batch_custom_lanes": int((reason == custom).sum())}


def boot_phase(dev, main, slot_run):
    t0 = time.perf_counter()
    mem0 = memory_mark()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    out = {"config": boot_config(dev)}
    out["config_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["restart"], restored_main = boot_restart(dev, main, slot_run)
    out["restart_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["spi"] = boot_spi(dev, restored_main)
    out["spi_s"] = time.perf_counter() - t1
    if prefix_cuda.launches <= 0 or prefix_cuda.tile_launches:
        raise AssertionError(f"boot phase prefix launches "
                             f"{prefix_cuda.launches}, tile walk "
                             f"{prefix_cuda.tile_launches}")
    out["prefix_launches"] = prefix_cuda.launches
    out["prefix_launches_by_shape"] = {
        f"K={k},N={n},M={m}": c
        for (k, n, m), c in sorted(prefix_cuda.launches_by_shape.items())}
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"boot": out}), flush=True)
    if out["phase_s"] > BOOT_PHASE_LIMIT_S:
        raise AssertionError(f"boot phase took {out['phase_s']:.1f} s, over "
                             f"{BOOT_PHASE_LIMIT_S} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: staged rollout (shadow lanes, canary, guardrail) and the metric log
# ---------------------------------------------------------------------------

ROLLOUT_RULED = 100        # candidate QPS counts on 100 flow-ruled resources
ROLLOUT_ROUNDS = 8         # check_batch + complete_batch rounds per width
ROLLOUT_WIDTHS = (8192, 2048)
ROLLOUT_STEP_MS = 130      # bucket and second boundaries
ROLLOUT_PARAM_VALUES = 16
CANARY_BPS = 2500
CANARY_ROUNDS = 4
CANARY_ORIGINS = 64
TIMER_PERIOD_S = 0.1
ROLLOUT_PHASE_LIMIT_S = 60.0
METRIC_LOG_DIR = Path(__file__).resolve().parent / "smoke_logs" / "metric_log"


def rollout_candidate():
    """Finite QPS counts on 100 of the flow-ruled resources (half DEFAULT,
    half RATE_LIMITER), one param rule and one authority white list."""
    flow = []
    for k in range(ROLLOUT_RULED):
        rule = {"resource": f"res{10 * k}", "count": 2}
        if k % 2:
            rule.update(controlBehavior=C.CONTROL_BEHAVIOR_RATE_LIMITER,
                        maxQueueingTimeMs=100)
        flow.append(rule)
    return {"flow": flow,
            "paramFlow": [{"resource": "res40", "paramIdx": 0, "count": 1}],
            "authority": [{"resource": "res5", "limitApp": "appB",
                           "strategy": C.AUTHORITY_WHITE}]}


def cut_candidate():
    """A bad candidate: count 0 on the same 100 resources."""
    return {"flow": [{"resource": f"res{10 * k}", "count": 0}
                     for k in range(ROLLOUT_RULED)]}


def rollout_buf(rng, width, cluster, dn, origin_a):
    """The headline stream with a small param space (the candidate's
    param rule sees repeated values) and a quarter of the lanes on the
    candidate's 100 resources."""
    buf = entry_buf(rng, width, cluster, dn, origin_a)
    pick = rng.integers(0, ROLLOUT_RULED, size=width) * 10
    hot = rng.random(width) < 0.25
    buf["cluster_row"][hot] = cluster[pick[hot]]
    buf["dn_row"][hot] = dn[pick[hot]]
    buf["param_hash"][:, 0] = rng.integers(1, ROLLOUT_PARAM_VALUES + 1,
                                           size=width)
    return buf


def rollout_exit_buf(rng, ebuf, reason):
    """Exits that keep every breaker closed in both worlds (RT 1-50 ms,
    no business error), so the oracle's enforced completions and the live
    ones feed the same verdicts."""
    buf = exit_buf(rng, ebuf, reason)
    buf["rt_ms"][:] = rng.integers(1, 51, size=len(reason))
    buf["error"][:] = False
    return buf


def canary_buf(rng, width, cluster, origins):
    """Lanes on the candidate's 100 resources from 64 distinct origins."""
    buf = make_entry_batch_np(width)
    pick = rng.integers(0, ROLLOUT_RULED, size=width) * 10
    buf["cluster_row"][:] = cluster[pick]
    buf["count"][:] = 1
    buf["origin_id"][:] = np.asarray(origins)[
        rng.integers(0, len(origins), size=width)]
    return buf


def tree_bytes(tree) -> int:
    """Device bytes of a NamedTuple of tensors (nested)."""
    total = 0
    for v in tree:
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, tuple):
            total += tree_bytes(v)
    return total


def decisions_np(dec):
    return {f: getattr(dec, f).cpu().numpy() for f in dec._fields}


def rollout_shadow(dev, card: bool):
    """Part 1 on one device: the main path's engine kind with the staged
    candidate, ROLLOUT_ROUNDS rounds at each width. On the card also the
    times, launches and syncs per step, the shadow's bytes and the
    oracle; returns (printed numbers, what card and CPU must share, the
    engine and its rows)."""
    from sentinel_tpu_torch.ops import step as S

    eng, clock, cluster, dn, origin_a = make_engine(dev, tight=False)
    with eng._lock, eng._on_stream():
        eng._ensure_compiled()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng.rollout.load_candidate("rollout-v2", rollout_candidate())
    with eng._lock, eng._on_stream():
        eng._ensure_compiled()
    torch.cuda.synchronize()
    out = {"shadow_state_bytes": tree_bytes(eng.state.shadow),
           "shadow_rules_bytes": tree_bytes(eng._shadow_rules),
           "allocated_by_compile": torch.cuda.memory_allocated() - before}
    rng = np.random.default_rng(17)
    stream, decs = [], []
    for width in ROLLOUT_WIDTHS:
        bufs = [rollout_buf(rng, width, cluster, dn, origin_a)
                for _ in range(ROLLOUT_ROUNDS)]
        batches = [to_device(b, dev) for b in bufs]
        torch.cuda.synchronize()
        launches0, syncs0 = prefix_cuda.launches, SYNCS.count
        entry_s = 0.0
        for b, batch in zip(bufs, batches):
            clock.now += ROLLOUT_STEP_MS
            t0 = time.perf_counter()
            dec = eng.check_batch(batch)
            reason = eng.harvest_decisions(dec)[0]
            entry_s += time.perf_counter() - t0
            decs.append(decisions_np(dec))
            eng.complete_batch(to_device(rollout_exit_buf(rng, b, reason),
                                         dev))
            stream.append((clock.now, b))
        torch.cuda.synchronize()
        out[f"width_{width}"] = {
            "entry_step_ms": entry_s / ROLLOUT_ROUNDS * 1e3,
            "prefix_launches_per_entry_step":
                (prefix_cuda.launches - launches0) / ROLLOUT_ROUNDS,
            "host_syncs_per_round": (SYNCS.count - syncs0) / ROLLOUT_ROUNDS}
    counts = eng.shadow_counts()
    with eng._lock:
        state = convert.state_to_numpy(eng.state)
    if "shadow" not in state:
        raise AssertionError("the candidate's shadow world is missing")
    would_block = int(counts[S.SH_WOULD_BLOCK].sum())
    if would_block <= 0 or int(counts[S.SH_LIVE_BLOCK].sum()) != 0:
        raise AssertionError(f"shadow would-block {would_block}, live block "
                             f"{int(counts[S.SH_LIVE_BLOCK].sum())}: the "
                             "candidate must block and the live world not")
    out["would_block"] = would_block
    out["would_block_by_family"] = {
        name: int(counts[ch].sum()) for name, ch in (
            ("authority", S.SH_WB_AUTHORITY), ("param", S.SH_WB_PARAM),
            ("flow", S.SH_WB_FLOW))}
    if card:
        out["oracle"] = rollout_oracle(dev, eng, stream, counts)
    share = {"decisions": decs, "shadow_counts": counts, "state": state}
    return out, share, (eng, clock, cluster, dn, origin_a)


def rollout_oracle(dev, eng, stream, counts):
    """A second card engine ENFORCING the merged rule set over the same
    stream: its per-resource tallies equal the shadow's would-pass /
    would-block counters on every cluster row."""
    from sentinel_tpu_torch.ops import step as S

    spec = eng.rollout.device_spec()
    oracle, clock, _, _, _ = make_engine(dev, tight=False)
    try:
        for fam, attr in (("flow", "flow_rules"), ("degrade", "degrade_rules"),
                          ("authority", "authority_rules"),
                          ("system", "system_rules"),
                          ("param", "param_rules")):
            getattr(oracle, attr).load_rules(spec[fam])
        rng = np.random.default_rng(23)
        n_rows = eng.capacity
        passed = np.zeros(n_rows, np.int64)
        blocked = np.zeros(n_rows, np.int64)
        for now, b in stream:
            clock.now = now
            reason = oracle.harvest_decisions(
                oracle.check_batch(to_device(b, dev)))[0]
            rows = b["cluster_row"]
            ok = rows >= 0
            np.add.at(passed, rows[ok & (reason == 0)],
                      b["count"][ok & (reason == 0)])
            np.add.at(blocked, rows[ok & (reason > 0)],
                      b["count"][ok & (reason > 0)])
            oracle.complete_batch(to_device(rollout_exit_buf(rng, b, reason),
                                            dev))
        cluster_rows = np.array(sorted(eng.registry.resources().values()))
        for name, want, ch in (("pass", passed, S.SH_WOULD_PASS),
                               ("block", blocked, S.SH_WOULD_BLOCK)):
            got = counts[ch][cluster_rows]
            if not np.array_equal(got, want[cluster_rows]):
                bad = cluster_rows[np.nonzero(got != want[cluster_rows])[0]]
                raise AssertionError(
                    f"shadow would-{name} differs from the enforcing engine "
                    f"on rows {bad[:8].tolist()}")
        return {"resources_compared": int(len(cluster_rows)),
                "enforced_pass": int(passed.sum()),
                "enforced_block": int(blocked.sum()),
                "equal_to_shadow": True}
    finally:
        oracle.close()


def rollout_seal(eng, clock, dev_name):
    """The metric log of the parity stream's engine: one timer tick at the
    stream's end into a fresh directory; returns the directory."""
    import shutil

    from sentinel_tpu_torch.metrics.timer import MetricTimerListener
    from sentinel_tpu_torch.metrics.writer import MetricWriter

    d = METRIC_LOG_DIR / dev_name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    writer = MetricWriter(app="rollout", base_dir=str(d))
    lines = MetricTimerListener(eng, writer).tick(clock.now)
    writer.close()
    if lines <= 0:
        raise AssertionError("the seal wrote no metric line")
    return d, lines


def rollout_canary(dev, run):
    """Part 2: the bad candidate enforced for a 2,500 bps canary slice,
    then the 0 and 10,000 bps edges; every lane's verdict is its host
    prediction. Part 3: the guardrail's ticks until it aborts."""
    from sentinel_tpu_torch.rollout import canary
    from sentinel_tpu_torch.rollout.manager import _salt_for

    eng, clock, cluster, _, _ = run
    eng.rollout.abort("rollout-v2", reason="next part")
    origins = [eng.registry.origin_id(f"origin{i}")
               for i in range(CANARY_ORIGINS)]
    eng.rollout.load_candidate("cut", cut_candidate(), stage="canary",
                               canary_bps=CANARY_BPS)
    salt = _salt_for("cut")
    rng = np.random.default_rng(29)
    decs, in_slice = [], 0
    plan = [CANARY_BPS] * CANARY_ROUNDS + [0, 10_000]
    for bps in plan:
        if bps != eng.rollout.active_set().canary_bps:
            eng.rollout.set_stage("cut", "canary", canary_bps=bps)
        b = canary_buf(rng, 8192, cluster, origins)
        clock.now += ROLLOUT_STEP_MS
        dec = eng.check_batch(to_device(b, dev))
        decs.append(decisions_np(dec))
        want = np.array([canary.in_canary(int(o), int(c), salt, bps)
                         for o, c in zip(b["origin_id"], b["context_id"])])
        got = decs[-1]["reason"] > 0
        if not np.array_equal(got, want):
            raise AssertionError(f"canary at {bps} bps: "
                                 f"{int((got != want).sum())} lanes differ "
                                 "from the host prediction")
        if bps == CANARY_BPS:
            in_slice += int(want.sum())
        eng.complete_batch(to_device(rollout_exit_buf(
            rng, b, decs[-1]["reason"]), dev))
    if decs[-2]["reason"].any() or not (decs[-1]["reason"] > 0).all():
        raise AssertionError("canary edges: 0 bps must govern no lane and "
                             "10,000 bps every lane")
    # Part 3: shadow again, one tick per simulated second until abort.
    eng.rollout.set_stage("cut", "shadow")
    ticks = [eng.rollout.tick(now_ms=clock.now)]
    while ticks[-1].get("status") != "aborted" and len(ticks) < 8:
        b = canary_buf(rng, 8192, cluster, origins)
        clock.now += 1000
        reason = eng.harvest_decisions(eng.check_batch(to_device(b, dev)))[0]
        eng.complete_batch(to_device(rollout_exit_buf(rng, b, reason), dev))
        ticks.append(eng.rollout.tick(now_ms=clock.now))
    if ticks[-1].get("status") != "aborted" \
            or eng.rollout.active_name is not None \
            or eng.shadow_counts() is not None:
        raise AssertionError(f"the guardrail did not abort: {ticks[-1]}")
    return {"canary_lanes": in_slice,
            "canary_lanes_of": CANARY_ROUNDS * 8192,
            "guardrail_windows": len(ticks) - 1,
            "ended": eng.rollout.candidate("cut").ended_reason}, \
        {"decisions": decs, "ticks": ticks}


def rollout_promote(run):
    """After the abort: the leases come back once the system rule goes; a
    second candidate stands them down again, and its promote makes its
    rules live and brings them back."""
    eng = run[0]
    eng.system_rules.load_rules([])
    leases = len(eng._leases)
    eng.rollout.load_candidate("v3", {"flow": [{"resource": "res0",
                                                "count": 5}]})
    gated = len(eng._leases)
    eng.rollout.promote("v3")
    with eng._lock, eng._on_stream():
        eng._ensure_compiled()
    live = {r.resource: r.count for r in eng.flow_rules.get_rules()}
    if leases <= 0 or gated != 0 or len(eng._leases) != leases \
            or live.get("res0") != 5 or eng.shadow_counts() is not None:
        raise AssertionError(f"promote: leases {leases} -> {gated} -> "
                             f"{len(eng._leases)}, res0 count "
                             f"{live.get('res0')}")
    with eng._lock:
        return {"leases_back": leases, "promoted_rule_count": 5}, \
            convert.state_to_numpy(eng.rules)


def rollout_slots(dev):
    """Part 4: the slot phase's oracle engine (budget 8: it steals and
    rehydrates) with a datasource-staged candidate; every surgery leaves
    the touched shadow columns zero."""
    import random

    from sentinel_tpu_torch.ops.window import MIN_RT_EMPTY

    names = [f"oracle{i}" for i in range(SLOT_ORACLE_NAMES)]
    live = [(names[i], 3) for i in (0, 5, 10)]
    run = SlotRun(dev, 8, live)
    eng = run.eng
    checked = []
    execute = eng.slots._execute

    def zeroed(evicts, admits, now_ms):
        execute(evicts, admits, now_ms)
        touched = sorted({s for _, s, _ in evicts} | {s for _, s in admits})
        with eng._lock:
            sh = eng.state.shadow
            if sh is None or sh.counts[:, touched].any() \
                    or sh.w1.counts[:, :, touched].any() \
                    or (sh.w1.min_rt[:, touched] != MIN_RT_EMPTY).any():
                raise AssertionError(f"surgery on slots {touched} left "
                                     "shadow columns")
        checked.append(len(touched))

    eng.slots._execute = zeroed
    staged = [F.FlowRule(resource=r, count=c) for r, c in live] + [
        F.FlowRule(resource=names[0], count=1, candidate_set="slotc"),
        F.FlowRule(resource=names[3], count=2, candidate_set="slotc")]
    eng.flow_rules.load_rules(staged)
    if eng.rollout.active_name != "slotc":
        raise AssertionError("the tagged rules did not stage a candidate")
    weights = [1.0 / (i + 1) ** 1.2 for i in range(SLOT_ORACLE_NAMES)]
    rng = random.Random(1234)
    verdicts = []
    for _ in range(SLOT_ORACLE_SECONDS):
        for _ in range(SLOT_ORACLE_PAIRS):
            verdicts.append(run.serve(rng.choices(names, weights=weights)[0]))
        run.second()
    counts = eng.shadow_counts()
    out = run.result(verdicts)
    out["shadow_counts"] = counts
    out["surgeries_checked"] = len(checked)
    return out


def rollout_timer(eng, clock, dev):
    """A MetricTimerListener on the card engine's own thread writes the
    seconds the stream seals while it runs."""
    import shutil

    from sentinel_tpu_torch.metrics.searcher import MetricSearcher
    from sentinel_tpu_torch.metrics.timer import MetricTimerListener
    from sentinel_tpu_torch.metrics.writer import MetricWriter

    d = METRIC_LOG_DIR / "timer"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    cluster = np.array([eng.registry.get_cluster_row(f"res{i}")
                        for i in range(N_RESOURCES)], np.int32)
    rng = np.random.default_rng(31)
    timer = MetricTimerListener(eng, MetricWriter(app="timer",
                                                  base_dir=str(d)),
                                period_s=TIMER_PERIOD_S).start()
    t0 = time.perf_counter()
    try:
        for _ in range(3):
            b = make_entry_batch_np(2048)
            b["cluster_row"][:] = cluster[rng.integers(0, N_RESOURCES,
                                                       size=2048)]
            b["count"][:] = 1
            eng.check_batch(to_device(b, dev))
            clock.now += 1000
            time.sleep(3 * TIMER_PERIOD_S)
    finally:
        timer.stop()
    window = time.perf_counter() - t0
    seconds = sorted({n.timestamp for n in
                      MetricSearcher(str(d), "timer").find(0)})
    if len(seconds) < 2:
        raise AssertionError(f"the timer wrote {len(seconds)} seconds in "
                             f"{window:.2f} s")
    return {"seconds_written": len(seconds), "window_s": window}


def rollout_phase(dev, main_results):
    import gc

    from sentinel_tpu_torch.metrics.searcher import MetricSearcher

    t0 = time.perf_counter()
    # Earlier phases' closed engines are freed now, not during the phase,
    # so the peak above the start is this phase's own.
    gc.collect()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    out, parts = {}, {}
    runs, shares = {}, {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        t1 = time.perf_counter()
        nums, shares[name], runs[name] = rollout_shadow(d, name == "card")
        if name == "card":
            out["shadow"] = nums
            out["shadow"]["without_candidate"] = {
                f"width_{w}": {k: main_results[w][k] for k in (
                    "entry_step_ms", "prefix_launches_per_entry_step",
                    "host_syncs_per_round")} for w in WIDTHS}
        parts[f"shadow_{name}_s"] = time.perf_counter() - t1
    a, b = shares["card"], shares["cpu"]
    for r, (x, y) in enumerate(zip(a["decisions"], b["decisions"])):
        for f in x:
            if not np.array_equal(x[f], y[f]):
                raise AssertionError(f"rollout round {r}: decisions.{f} "
                                     "differ between the card and the CPU")
    if not np.array_equal(a["shadow_counts"], b["shadow_counts"]):
        raise AssertionError("shadow_counts differ between card and CPU")
    compare_states(a["state"], b["state"], "rollout")

    t1 = time.perf_counter()
    logs = {n: rollout_seal(runs[n][0], runs[n][1], n) for n in runs}
    files = {n: {p.name: p.read_bytes() for p in sorted(d.iterdir())}
             for n, (d, _) in logs.items()}
    if files["card"] != files["cpu"] or not any(
            k.endswith(".idx") for k in files["card"]):
        raise AssertionError("the metric log files differ between the card "
                             "and the CPU")
    found = MetricSearcher(str(logs["card"][0]), "rollout").find(
        0, recommend_lines=logs["card"][1] + 1)
    if len(found) != logs["card"][1]:
        raise AssertionError(f"the searcher read {len(found)} of "
                             f"{logs['card'][1]} lines")
    out["metric_log"] = {"lines": logs["card"][1],
                         "seconds": len({n.timestamp for n in found}),
                         "files": sorted(files["card"]),
                         "bytes": sum(len(v) for v in files["card"].values()),
                         "card_equals_cpu": True}
    parts["metric_log_s"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    canary = {n: rollout_canary(runs[n][0].device, runs[n]) for n in runs}
    out["canary"] = canary["card"][0]
    for r, (x, y) in enumerate(zip(canary["card"][1]["decisions"],
                                   canary["cpu"][1]["decisions"])):
        for f in x:
            if not np.array_equal(x[f], y[f]):
                raise AssertionError(f"canary round {r}: decisions.{f} "
                                     "differ between the card and the CPU")
    if canary["card"][1]["ticks"] != canary["cpu"][1]["ticks"]:
        raise AssertionError("guardrail ticks differ between card and CPU")
    with runs["card"][0]._lock, runs["cpu"][0]._lock:
        compare_states(convert.state_to_numpy(runs["card"][0].state),
                       convert.state_to_numpy(runs["cpu"][0].state),
                       "canary")
    parts["canary_guardrail_s"] = time.perf_counter() - t1

    # Teardown: a main-path round on the card is back to its syncs.
    t1 = time.perf_counter()
    eng, clock, cluster, dn, origin_a = runs["card"]
    clock.now += 1000 - clock.now % 1000
    after, _ = headline_rounds(eng, clock, cluster, dn, origin_a,
                               np.random.default_rng(7), 8192, dev)
    out["after_abort"] = {k: after[k] for k in (
        "entry_step_ms", "prefix_launches_per_entry_step",
        "host_syncs_per_round")}
    if after["host_syncs_per_round"] != HOST_SYNCS_PER_ROUND:
        raise AssertionError(f"host syncs per round {after['host_syncs_per_round']}"
                             f" after the abort, not {HOST_SYNCS_PER_ROUND}")
    out["timer"] = rollout_timer(eng, clock, dev)
    promoted = {n: rollout_promote(runs[n]) for n in runs}
    out["promote"] = promoted["card"][0]
    compare_states(promoted["card"][1], promoted["cpu"][1], "promoted_rules")
    for n in runs:
        runs[n][0].close()
    parts["teardown_s"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    slots = {n: rollout_slots(d) for n, d in (("card", dev), ("cpu", "cpu"))}
    x, y = slots["card"], slots["cpu"]
    for k in ("verdicts", "status", "events", "view"):
        if x[k] != y[k]:
            raise AssertionError(f"rollout slots: {k} differs between the "
                                 "card and the CPU")
    compare_states(x["state"], y["state"], "rollout_slots")
    if not np.array_equal(x["shadow_counts"], y["shadow_counts"]):
        raise AssertionError("slot-mode shadow_counts differ")
    if x["status"]["evictionsTotal"] <= 0 or x["surgeries_checked"] <= 0 \
            or x["fail_open"] or x["committer_failures"]:
        raise AssertionError(f"rollout slots: {x['status']}")
    out["slots"] = {"surgeries_checked": x["surgeries_checked"],
                    "evictions": x["status"]["evictionsTotal"],
                    "rehydrations": x["status"]["rehydrationsTotal"],
                    "would_block": int(x["shadow_counts"][1].sum()),
                    "card_equals_cpu": True}
    parts["slots_s"] = time.perf_counter() - t1

    if prefix_cuda.launches <= 0 or prefix_cuda.tile_launches:
        raise AssertionError(f"rollout phase prefix launches "
                             f"{prefix_cuda.launches}, tile walk "
                             f"{prefix_cuda.tile_launches}")
    out["prefix_launches"] = prefix_cuda.launches
    out["prefix_launches_by_shape"] = {
        f"K={k},N={n},M={m}": c
        for (k, n, m), c in sorted(prefix_cuda.launches_by_shape.items())}
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"rollout": out}), flush=True)
    if out["phase_s"] > ROLLOUT_PHASE_LIMIT_S:
        raise AssertionError(f"rollout phase took {out['phase_s']:.1f} s, "
                             f"over {ROLLOUT_PHASE_LIMIT_S} s")
    return out



# ---------------------------------------------------------------------------
# Phase 11: the cluster token path
# ---------------------------------------------------------------------------

CLUSTER_PHASE_LIMIT_S = 60.0
ACQUIRE_WIDTHS = (1, 8, 64, 256, 1024, 4096)
ACQUIRE_FLOWS = 64
ACQUIRE_INTERVALS = (1000, 700, 7000, 3000)
# The acquire scan's bound: one same-slot run is a dependent chain; each
# step waits on an add, a fused multiply-add, a compare-select and an add,
# at 4 cycles apiece, at the H100 SXM's 1,980 MHz boost clock.
CHAIN_CYCLES_PER_STEP = 16
SM_CLOCK_HZ = 1.98e9
ACQUIRE_BYTES_PER_LANE = 4 * 6 + 2 + 1 + 1 + 4  # 6 x 4 B + 2 bools in; out
ACQUIRE_FLOPS_PER_LANE = 8
SERVICE_BATCHES = 24
SERVICE_WIDTH = 512           # bench.py:231 bench_token_service
SERVICE_FLOW0 = 1000
MESH_FLOW0 = 6000             # bench.py:1106 bench_wire_mesh
MESH_THREADS, MESH_CONNS, MESH_BURST = 8, 8, 64
MESH_SETTLE_S, MESH_WINDOW_S = 5.0, 4.0
CLIENT_FLOW0 = 7000
CLIENT_FLOWS = 64
CLIENT_COUNT = 2              # per flow per second: blocks within a second
CLIENT_THREADS = 4
CLIENT_WINDOW_S = 10.0
CLIENT_FALLBACK_PAIRS = 8


def acquire_case(rng, n: int, dev):
    """Seeded lanes for the acquire scan at width ``n`` over 64 flows:
    thresholds with fractions, intervals that do not divide 1000 (so the
    rounding pins matter), usage near the thresholds, 30% prioritized
    lanes with a backlog, 5% unknown (-1) and 5% out-of-range slots."""
    slots = rng.integers(0, ACQUIRE_FLOWS, size=n)
    r = rng.random(n)
    slots[r < 0.05] = -1
    oob = (r >= 0.05) & (r < 0.10)
    slots[oob] = rng.integers(ACQUIRE_FLOWS, ACQUIRE_FLOWS + 8,
                              size=int(oob.sum()))
    if n >= 8:  # at least one lane of each kind, whatever the draw
        slots[-2:] = (-1, ACQUIRE_FLOWS + 3)
    thr_tab = (rng.integers(1, 60, ACQUIRE_FLOWS)
               / rng.choice([1, 3, 7], ACQUIRE_FLOWS)).astype(np.float32)
    iv_tab = rng.choice(ACQUIRE_INTERVALS, ACQUIRE_FLOWS)
    idx = np.where(slots >= 0, slots % ACQUIRE_FLOWS, 0)
    thr = thr_tab[idx]
    interval = iv_tab[idx].astype(np.float32)
    base = np.floor(rng.random(n) * thr * interval / 1000.0 * 1.1)
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        slots=slots.astype(np.int32),
        counts=rng.integers(1, 4, n).astype(np.float32),
        base=base.astype(np.float32), thr=thr,
        interval=interval,
        prioritized=rng.random(n) < 0.3,
        waiting=rng.integers(0, 3, n).astype(np.float32)).items()}
    iv = t.pop("interval")
    t["qps_scale"] = torch.full_like(iv, 1000.0) / iv  # the service's form
    t["known"] = t["slots"] >= 0
    return t


def acquire_args(t):
    return (t["slots"], t["counts"], t["base"], t["thr"], t["qps_scale"],
            t["known"], t["prioritized"], t["waiting"], ACQUIRE_FLOWS, 0.8)


def acquire_bound(slots: np.ndarray):
    """Least time for the scan on these lanes, the larger of: its bytes
    (each input read once, each output written once) over the HBM rate;
    its float operations over the fp32 rate; and its longest same-slot
    run as a dependent chain (each step a few dependent float operations,
    CHAIN_CYCLES_PER_STEP cycles at the boost clock)."""
    n = slots.shape[0]
    inside = slots[(slots >= 0) & (slots < ACQUIRE_FLOWS)]
    run = int(np.bincount(inside).max()) if inside.size else 1
    run = max(run, 1)
    t_bytes = n * ACQUIRE_BYTES_PER_LANE / HBM_BYTES_PER_S * 1e3
    t_ops = n * ACQUIRE_FLOPS_PER_LANE / FP32_OPS_PER_S * 1e3
    t_chain = run * CHAIN_CYCLES_PER_STEP / SM_CLOCK_HZ * 1e3
    bound = max(t_bytes, t_ops, t_chain)
    derivation = (f"max(bytes {n} x {ACQUIRE_BYTES_PER_LANE} B / 3.35e12 B/s"
                  f" = {t_bytes:.3g} ms, ops {n} x {ACQUIRE_FLOPS_PER_LANE}"
                  f" / 67e12 = {t_ops:.3g} ms, chain {run} steps x "
                  f"{CHAIN_CYCLES_PER_STEP} cycles / 1.98 GHz = "
                  f"{t_chain:.3g} ms)")
    return bound, ("bytes" if bound == t_bytes else "operations"), run, \
        derivation


def zero_cluster_counts():
    """Every kernel count of the cluster path to 0: just before a run of
    the path that the kernels line reports."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    CA.launches = 0
    CA.launches_by_width.clear()
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()


def read_cluster_counts():
    """The counts since :func:`zero_cluster_counts`, just after the run."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    return {"acquire": CA.launches,
            "acquire_by_width": dict(CA.launches_by_width),
            "prefix": prefix_cuda.launches,
            "prefix_by_shape": dict(prefix_cuda.launches_by_shape)}


def cluster_kernel(dev):
    """The acquire kernel against its plain form on the card at every
    width of the pad ladder the wire path takes, bit for bit."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    rng = np.random.default_rng(20261018)
    rows = {}
    for n in ACQUIRE_WIDTHS:
        t = acquire_case(rng, n, dev)
        args = acquire_args(t)
        ok, cw, passed = CA.acquire_scan_cuda(*args)
        torch.cuda.synchronize()
        want = CA.acquire_scan_plain(*args)
        if not (torch.equal(ok, want[0]) and torch.equal(cw, want[1])
                and torch.equal(passed.view(torch.int32),
                                want[2].view(torch.int32))):
            raise AssertionError(f"acquire kernel != plain at N={n}")
        known = t["known"]
        statuses = {"ok": int(ok.sum()), "should_wait": int(cw.sum()),
                    "blocked": int((known & ~ok & ~cw).sum()),
                    "no_rule": int((~known).sum()),
                    "out_of_range": int((t["slots"] >= ACQUIRE_FLOWS).sum())}
        if n >= 64 and min(statuses.values()) == 0:
            raise AssertionError(f"N={n} misses a status: {statuses}")
        reps = 200 if n <= 256 else 50
        bound, bound_by, run, derivation = acquire_bound(
            t["slots"].cpu().numpy())
        rows[n] = {
            "shape": {"N": n, "flows": ACQUIRE_FLOWS}, "bit_equal": True,
            "max_abs_err": float((passed - want[2]).abs().max()),
            "statuses": statuses,
            "kernel_ms": device_ms(lambda: CA.acquire_scan_cuda(*args), reps),
            "call_ms": time_ms(lambda: CA.acquire_scan_cuda(*args), reps),
            "plain_ms": time_ms(lambda: CA.acquire_scan_plain(*args),
                                max(3, reps // 20)),
            "bound_ms": bound, "bound_by": bound_by, "longest_run": run,
            "bound_derivation": derivation}
        print(json.dumps({"acquire_kernel": rows[n]}), flush=True)
    return rows


def service_stream(seed: int = 23):
    """A seeded stream for ``DefaultTokenService`` at bench.py:231's
    configuration: 64 flows, batches of 512, GLOBAL and AVG_LOCAL rules,
    a prioritized share, unknown flows, a rule push halfway (counts,
    geometry, one flow gone, one new) and param tokens with duplicate
    values. -> (rules, pushed rules, ops)."""
    rng = np.random.default_rng(seed)

    def rule(i, count, ttype, interval):
        return F.FlowRule(resource=f"clus{i}", count=count, cluster_mode=True,
                          cluster_config={"flowId": SERVICE_FLOW0 + i,
                                          "thresholdType": ttype,
                                          "windowIntervalMs": interval})

    spec = [(float(rng.integers(20, 200)), int(i % 2),
             int(rng.choice([1000, 2000]))) for i in range(64)]
    rules = [rule(i, *spec[i]) for i in range(64)]
    pushed = [rule(i, c * (0.5 if i % 3 == 0 else 1.0), t,
                   3000 if i % 7 == 0 else iv)
              for i, (c, t, iv) in enumerate(spec) if i != 5]
    pushed.append(rule(64, 50.0, 1, 1000))
    ops = []
    for b in range(SERVICE_BATCHES):
        fids = SERVICE_FLOW0 + (rng.zipf(1.3, SERVICE_WIDTH) - 1) % 66
        batch = [(int(f), int(rng.integers(1, 4)), bool(rng.random() < 0.2))
                 for f in fids]
        params = [(SERVICE_FLOW0 + int(rng.integers(0, 8)),
                   int(rng.integers(1, 3)),
                   [int(v) for v in rng.integers(0, 4, 3)]) for _ in range(8)]
        ops.append((int(rng.integers(0, 300)), batch, params))
    return rules, pushed, ops


def run_service(dev, rules, pushed, ops):
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

    time_util.freeze_time(NOW0)
    try:
        svc = DefaultTokenService(device=dev)
        svc.rules.load_rules("default", rules)
        for _ in range(3):
            svc.connections.connect("default")
        results, walls = [], []
        for b, (dt, batch, params) in enumerate(ops):
            if b == len(ops) // 2:
                svc.rules.load_rules("default", pushed)
            time_util.advance_time(dt)
            t0 = time.perf_counter()
            results.append(svc.request_tokens(batch))
            walls.append((time.perf_counter() - t0) * 1e3)
            results.append([svc.request_param_token(f, c, v)
                            for f, c, v in params])
        state = convert.state_to_numpy(svc._state)
        return results, state, svc.metrics_snapshot(), walls
    finally:
        time_util.unfreeze_time()


def cluster_service(dev):
    """``DefaultTokenService`` on the card and on the CPU over one seeded
    stream on a frozen clock: every TokenResult, the window state and
    ``metrics_snapshot`` equal."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    stream = service_stream()
    before = CA.launches
    card = run_service(dev, *stream)
    launches = CA.launches - before
    cpu = run_service("cpu", *stream)
    if card[0] != cpu[0]:
        raise AssertionError("token service card != cpu results")
    for k in card[1]["win"]:
        if not np.array_equal(card[1]["win"][k], cpu[1]["win"][k]):
            raise AssertionError(f"token service window {k}: card != cpu")
    if card[2] != cpu[2]:
        raise AssertionError("metrics_snapshot card != cpu")
    flat = [r for batch in card[0] for r in batch]
    statuses = {}
    for r in flat:
        statuses[int(r.status)] = statuses.get(int(r.status), 0) + 1
    if not {0, 1, 2, 3} <= set(statuses):
        raise AssertionError(f"service stream misses a status: {statuses}")
    return {"batches": SERVICE_BATCHES, "width": SERVICE_WIDTH,
            "results": len(flat), "statuses": statuses,
            "card_equals_cpu": True, "acquire_launches": launches,
            "batch_ms_p50": {"card": pct(card[3], 50), "cpu": pct(cpu[3], 50)}}


class ServiceTally:
    """Server-side accounting around a token service's dispatch / harvest
    split: the host ms of each fused batch (its dispatch plus its
    harvest), and every OK verdict by flowId and by second."""

    def __init__(self, svc):
        self.svc = svc
        self.lock = threading.Lock()
        self.host_ms = []
        self.ok = {}
        self.ok_by_second = {}
        self._dispatch_ms = {}
        dispatch, harvest = svc.dispatch_tokens, svc.harvest_tokens

        def timed_dispatch(requests, now_ms=None):
            t0 = time.perf_counter()
            ticket = dispatch(requests, now_ms)
            with self.lock:
                self._dispatch_ms[id(ticket)] = \
                    (time.perf_counter() - t0) * 1e3
            return ticket

        def counted_harvest(ticket):
            t0 = time.perf_counter()
            out = harvest(ticket)
            sec = ticket.now_ms // 1000
            with self.lock:
                self.host_ms.append((time.perf_counter() - t0) * 1e3
                                    + self._dispatch_ms.pop(id(ticket), 0.0))
                for req, r in zip(ticket.requests, out):
                    if r.status == 0 and req[0] is not None:
                        f = int(req[0])
                        self.ok[f] = self.ok.get(f, 0) + 1
                        key = (f, sec)
                        self.ok_by_second[key] = \
                            self.ok_by_second.get(key, 0) + 1
            return out

        svc.dispatch_tokens = timed_dispatch
        svc.harvest_tokens = counted_harvest

    def detach(self):
        del self.svc.dispatch_tokens, self.svc.harvest_tokens


def mesh_burst(conns, frames):
    """One burst on every connection; -> (replies, ok replies)."""
    replies = ok = 0
    for s, _ in conns:
        s.sendall(frames)
    for s, reader in conns:
        got = 0
        while got < MESH_BURST:
            data = s.recv(65536)
            if not data:
                raise AssertionError("mesh connection closed")
            for body in reader.feed(data):
                resp = ccodec.decode_response(body)
                got += 1
                replies += 1
                ok += resp.status == 0
    return replies, ok


def cluster_mesh(dev):
    """bench.py:1106 bench_wire_mesh: 64 GLOBAL flows (count 1e9), the
    limiter lifted, the reactor on the card, 8 threads x 8 connections
    with a 64-request burst in flight each, a settle and two windows."""
    import socket as _socket

    from sentinel_tpu_torch.cluster.constants import MSG_FLOW
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer, pad_width
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

    svc = DefaultTokenService(device=dev, max_allowed_qps=1e12)
    svc.rules.load_rules("default", [
        F.FlowRule(resource=f"wm{i}", count=1e9, cluster_mode=True,
                   cluster_config={"flowId": MESH_FLOW0 + i,
                                   "thresholdType": 1})
        for i in range(64)])
    for w in (MESH_BURST, 256, 1024, 4096):  # warm the allocator
        svc.request_tokens([(MESH_FLOW0, 1, False)] * w)
    # The mesh's traffic is the run the kernels line reports: its counts
    # start here and are read once the server stops, before the replay.
    zero_cluster_counts()
    tally = ServiceTally(svc)
    server = ClusterTokenServer(svc, host="127.0.0.1", port=0).start()
    stop = threading.Event()
    replies = [0] * MESH_THREADS
    ok = [0] * MESH_THREADS
    errors = []
    barrier = threading.Barrier(MESH_THREADS + 1)
    conns_all = [None] * MESH_THREADS

    def frames_of(tid):
        return b"".join(ccodec.encode_request(
            xid + 1, MSG_FLOW, ccodec.encode_flow_request(
                MESH_FLOW0 + (tid * MESH_CONNS + xid) % 64, 1, False))
            for xid in range(MESH_BURST))

    def worker(tid):
        try:
            conns = []
            for _ in range(MESH_CONNS):
                s = _socket.create_connection(
                    ("127.0.0.1", server.bound_port), timeout=10)
                s.settimeout(10)
                s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
                conns.append((s, ccodec.FrameReader()))
            conns_all[tid] = conns
            frames = frames_of(tid)
            barrier.wait()
            while not stop.is_set():
                r, o = mesh_burst(conns, frames)
                replies[tid] += r
                ok[tid] += o
        except Exception as ex:  # noqa: BLE001 -- reported below
            errors.append(repr(ex))
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(MESH_THREADS)]
    for t in threads:
        t.start()
    barrier.wait()
    time.sleep(MESH_SETTLE_S)
    rates = []
    for _ in range(2):
        r0, o0 = sum(replies), sum(ok)
        t0 = time.perf_counter()
        time.sleep(MESH_WINDOW_S)
        dt = time.perf_counter() - t0
        rates.append({"acquires_per_s": (sum(replies) - r0) / dt,
                      "ok_per_s": (sum(ok) - o0) / dt})
    stop.set()
    for t in threads:
        t.join(timeout=30)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"mesh workers failed: {errors}")
    total_replies, total_ok = sum(replies), sum(ok)
    if total_ok != total_replies:
        raise AssertionError(f"mesh: {total_replies - total_ok} replies "
                             "not OK")
    # The window empties; one burst on one thread's connections (well
    # inside a window), then the server's own window total must equal the
    # replies the clients counted.
    time.sleep(1.1)
    final_r, final_ok = mesh_burst(conns_all[0], frames_of(0))
    snap = svc.metrics_snapshot()
    window_pass = int(sum(v["pass"] for v in snap.values()))
    if not final_ok == final_r == window_pass:
        raise AssertionError(f"mesh final burst: {final_r} replies, "
                             f"{final_ok} OK, server window {window_pass}")
    served_ok = sum(tally.ok.values())
    if served_ok != total_replies + final_r:
        raise AssertionError(f"server OK verdicts {served_ok} != replies "
                             f"{total_replies + final_r}")
    for conns in conns_all:
        for s, _ in conns:
            s.close()
    wire = server.wire_stats() or {}
    server.stop()
    counts = read_cluster_counts()
    tally.detach()
    # Device share of a fused batch: one replay at the mesh's p50 width.
    from torch.profiler import ProfilerActivity, profile

    width = pad_width(max(1, int(wire.get("coalescedBatchP50", 1))))
    batch = [(MESH_FLOW0 + i % 64, 1, False) for i in range(width)]
    svc.request_tokens(batch)
    reps = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            svc.request_tokens(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return {
        "windows": rates, "connections": MESH_THREADS * MESH_CONNS,
        "pipelined_per_conn": MESH_BURST, "replies": total_replies,
        "all_ok": True, "final_burst": final_r,
        "server_window_pass": window_pass,
        "rtt_ms": {"p50": wire.get("rttP50Ms"), "p99": wire.get("rttP99Ms")},
        "coalesced_batch": {"p50": wire.get("coalescedBatchP50"),
                            "max": wire.get("coalescedBatchMax")},
        "fused_batches": wire.get("fusedBatches"),
        "queue_wait_p50_ms": wire.get("queueWaitP50Ms"),
        "coalesce_wait_p50_ms": wire.get("coalesceWaitP50Ms"),
        "host_ms_per_fused_batch": {"p50": pct(tally.host_ms, 50),
                                    "p99": pct(tally.host_ms, 99),
                                    "batches": len(tally.host_ms)},
        "profiled_batch": {"width": width, "wall_ms": wall_ms,
                           "device_ms": dev_ms,
                           "device_share": dev_ms / wall_ms,
                           "device_ops": sum(e.count for e in kernels) / reps},
        "counts": counts}


def client_remote_stats(eng):
    """The engine client's remote acquires as its spans saw them: the
    request's ms on the client (send to reply, inside the entry's budget)
    and the service's on the server, their tails, and the statuses."""
    req, svc, status = [], [], {}
    for tr in eng.spans.traces():
        for sp in tr["spans"]:
            if sp["name"] == "cluster.token_request":
                req.append(sp["durationUs"] / 1e3)
                k = str(sp["attributes"].get("status"))
                status[k] = status.get(k, 0) + 1
            elif sp["name"] == "cluster.token_service":
                svc.append(sp["durationUs"] / 1e3)
    return {"requests": len(req), "status": status,
            "request_ms": {"p50": pct(req, 50), "p99": pct(req, 99),
                           "max": max(req, default=None)},
            "service_ms": {"p50": pct(svc, 50), "p99": pct(svc, 99),
                           "max": max(svc, default=None)},
            "threads_alive": threading.active_count()}


def client_flows():
    """The client run's 64 cluster-mode flow rules, on 64 of the API
    phase's unruled resources, with local fallback."""
    return [F.FlowRule(resource=res, count=CLIENT_COUNT, cluster_mode=True,
                       cluster_config={"flowId": CLIENT_FLOW0 + i,
                                       "thresholdType": 1,
                                       "fallbackToLocalWhenFail": True})
            for i, res in enumerate(api_pools()["unruled"][:CLIENT_FLOWS])]


def client_token_server(device, flows="client"):
    """``--client-token-server DEVICE [FLOWS]``: a token server in a
    process of its own, for the cluster phase's client run (``client``:
    the 64 flows of :func:`client_flows`) or the native phase's shim
    (``native``: :func:`native_flows`). Its service holds the flows'
    server rules and is warmed by a no-rule probe before the port binds,
    as the standalone server warms its own; a :class:`ServiceTally`
    counts its OK verdicts. It prints ``{"port": N}``, then answers one JSON line
    for each command line on its standard input: ``zero`` (the kernel
    counts to 0), ``report`` (the tally, the counts and the service's
    host ms), ``halfopen`` (its replies turn to garbage, the half-open
    seam) and ``stop`` (the server stops; the last report)."""
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.ops import cluster_acquire
    from sentinel_tpu_torch.resilience import faults

    proto, sys.stdout = sys.stdout, sys.stderr  # stdout: replies only

    def reply(obj):
        proto.write(json.dumps(obj) + "\n")
        proto.flush()

    dev = torch.device(device)
    if dev.type == "cuda":
        cluster_acquire.build()
    svc = DefaultTokenService(device=dev)
    svc.rules.load_rules("default", [
        F.FlowRule(resource=r.resource, count=r.count, cluster_mode=True,
                   cluster_config={"flowId": r.cluster_config["flowId"],
                                   "thresholdType": 1})
        for r in (native_flows() if flows == "native" else client_flows())])
    svc.request_tokens([(None, 0, False)])
    tally = ServiceTally(svc)
    server = ClusterTokenServer(svc, host="127.0.0.1", port=0).start()
    reply({"port": server.bound_port})
    injector = None

    def report():
        with tally.lock:
            return {"ok": {str(f): k for f, k in tally.ok.items()},
                    "ok_by_second": [[f, sec, k] for (f, sec), k
                                     in tally.ok_by_second.items()],
                    "host_ms": {"p50": pct(tally.host_ms, 50),
                                "p99": pct(tally.host_ms, 99),
                                "batches": len(tally.host_ms)},
                    "counts": read_cluster_counts()}

    try:
        for line in sys.stdin:
            cmd = line.strip()
            if cmd == "zero":
                zero_cluster_counts()
                reply({"zero": True})
            elif cmd == "report":
                reply(report())
            elif cmd == "halfopen":
                injector = faults.FaultInjector(seed=5).__enter__()
                injector.arm("cluster.ha.halfopen", "garbage", garbage=b"")
                reply({"halfopen": True})
            elif cmd == "stop":
                break
            else:
                reply({"error": f"unknown command {cmd!r}"})
    finally:
        server.stop()
        if injector is not None:
            injector.__exit__(None, None, None)
        tally.detach()
    reply(report())
    return 0


class TokenServerProcess:
    """The parent's end of :func:`client_token_server`: one JSON line in
    answer to each command, within a deadline. The process starts at
    once; :meth:`ready` waits for its port."""

    def __init__(self, dev, flows="client"):
        import queue

        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--client-token-server", str(dev), flows],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=str(Path(__file__).resolve().parent))
        self._lines = queue.Queue()
        threading.Thread(target=self._pump, daemon=True,
                         name="smoke-token-server-out").start()
        self.port = None

    def ready(self, timeout_s=60.0):
        if self.port is None:
            self.port = self._read(timeout_s)["port"]
        return self

    def _pump(self):
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def _read(self, timeout_s):
        import queue

        try:
            line = self._lines.get(timeout=timeout_s)
        except queue.Empty:
            raise AssertionError(f"token server process silent for "
                                 f"{timeout_s} s") from None
        if line is None:
            raise AssertionError(f"token server process exited with "
                                 f"{self.proc.wait()}")
        out = json.loads(line)
        if "error" in out:
            raise AssertionError(f"token server process: {out['error']}")
        return out

    def cmd(self, name, timeout_s=30.0):
        self.proc.stdin.write(name + "\n")
        self.proc.stdin.flush()
        return self._read(timeout_s)

    def stop(self):
        """The last report; the process has ended when this returns."""
        out = self.cmd("stop")
        self.proc.stdin.close()
        if self.proc.wait(timeout=30) != 0:
            raise AssertionError(f"token server process exited with "
                                 f"{self.proc.returncode}")
        return out

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def cluster_client(dev, server):
    """The API phase's engine kind on the card as the token client of a
    port token server in a process of its own (``server``, a
    :class:`TokenServerProcess`):
    64 cluster-mode flow rules on 64 of its unruled resources (GLOBAL,
    CLIENT_COUNT a second, local fallback), every entry sampled for
    spans, a few threads of ``with st.entry`` pairs on the real clock;
    then the server stops answering (the half-open seam) and the entries
    fall back inside the entry budget until the breaker opens; then the
    server stops."""
    from sentinel_tpu_torch.telemetry.spans import SpanCollector

    flows = client_flows()
    server.ready()
    eng = api_engine(dev, capacity=API_PARITY_CAPACITY, register=False)
    eng.flow_rules.load_rules(eng.flow_rules.get_rules() + flows)
    eng.spans = SpanCollector(sample_every=1, capacity=1 << 16)
    eng.cluster.set_to_client("127.0.0.1", server.port,
                              request_timeout_s=2.0)
    if eng.cluster.client_if_active() is None:
        raise AssertionError("engine client did not connect")
    names = [r.resource for r in flows]
    # The entries from here on are the client's run, in both processes.
    zero_cluster_counts()
    server.cmd("zero")
    for res in names[:4]:  # first steps of each kind, untimed
        api_pair(res, None, (), False)
    base_entries = len(names[:4])
    lat, verdicts = [], []
    lock = threading.Lock()
    stop_at = time.perf_counter() + CLIENT_WINDOW_S

    def worker(tid):
        rng = np.random.default_rng(100 + tid)
        while time.perf_counter() < stop_at:
            # 70% of the traffic on 8 hot flows: they block every second.
            i = int(rng.integers(8)) if rng.random() < 0.7 \
                else int(rng.integers(CLIENT_FLOWS))
            t0 = time.perf_counter()
            v = api_pair(names[i], None, (), False)
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
                verdicts.append(v)

    prefix_before = prefix_cuda.launches
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(CLIENT_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=CLIENT_WINDOW_S + 30)
    if any(t.is_alive() for t in threads):
        raise AssertionError("client threads still in an entry 30 s after "
                             "the window")
    entries = len(verdicts)
    prefix_launches = prefix_cuda.launches - prefix_before
    remote = client_remote_stats(eng)
    served = server.cmd("report")
    remote["service_host_ms"] = served["host_ms"]
    ok_by_second = {(f, sec): k for f, sec, k in served["ok_by_second"]}
    if eng.cluster_fallback_count or eng.fail_open_count:
        raise AssertionError(f"fallbacks {eng.cluster_fallback_count}, "
                             f"fail-open {eng.fail_open_count} under load; "
                             f"remote {remote}, resilience "
                             f"{eng.resilience_stats()}")
    over = {k: v for k, v in ok_by_second.items() if v > CLIENT_COUNT}
    if over:
        raise AssertionError(f"admitted over the threshold: {over}")
    tele = eng.telemetry_snapshot()["resources"]
    engine_pass = sum(tele.get(r, {}).get("passTotal", 0) for r in names)
    server_pass = sum(served["ok"].values())
    if engine_pass != server_pass:
        raise AssertionError(f"engine cluster passes {engine_pass} != "
                             f"server OK verdicts {server_pass}")
    traces = eng.spans.traces()
    shapes = set()
    for tr in traces:
        by_id = {sp["spanId"]: sp for sp in tr["spans"]}
        shapes.add(tuple(sorted(
            (sp["name"], by_id[sp["parentSpanId"]]["name"]
             if sp["parentSpanId"] in by_id else "")
            for sp in tr["spans"])))
    want_shape = (("cluster.token_request", "sentinel.entry"),
                  ("cluster.token_service", "cluster.token_request"),
                  ("sentinel.entry", ""))
    if shapes != {want_shape} or len(traces) != entries + base_entries:
        raise AssertionError(f"span trees {shapes}, {len(traces)} traces "
                             f"for {entries + base_entries} entries")
    # The server stops answering: every acquire times out inside the
    # entry's budget and falls back; three failures open the breaker.
    fb_lat = []
    server.cmd("halfopen")
    for k in range(CLIENT_FALLBACK_PAIRS):
        t0 = time.perf_counter()
        api_pair(names[8 + k], None, (), False)
        fb_lat.append((time.perf_counter() - t0) * 1e3)
    stats = eng.resilience_stats()
    budget = eng.cluster_entry_budget_ms
    if (stats["clusterFallbackCount"] != CLIENT_FALLBACK_PAIRS
            or stats["tokenClientBreaker"]["state"] != "OPEN"
            or max(fb_lat) > budget + 250):
        raise AssertionError(f"fallback: {stats['clusterFallbackCount']}, "
                             f"breaker {stats['tokenClientBreaker']}, "
                             f"latency {fb_lat} ms against {budget} ms")
    last = server.stop()
    deadline = time.monotonic() + 10
    while eng.cluster.client_if_active() is not None:
        if time.monotonic() > deadline:
            raise AssertionError("client still active after server stop")
        time.sleep(0.02)
    if api_pair(names[20], None, (), False) != "pass":
        raise AssertionError("local check after the server stopped")
    counts = read_cluster_counts()
    eng.close()
    # The acquires ran in the server's process, the entry steps in this.
    counts["acquire"] = last["counts"]["acquire"]
    counts["acquire_by_width"] = {int(w): k for w, k in
                                  last["counts"]["acquire_by_width"].items()}
    blocked = sum(v != "pass" for v in verdicts)
    return {
        "threads": CLIENT_THREADS, "window_s": CLIENT_WINDOW_S,
        "entries": entries, "entries_per_s": entries / CLIENT_WINDOW_S,
        "blocked_share": blocked / max(entries, 1),
        "pair_ms": {"p50": pct(lat, 50), "p99": pct(lat, 99)},
        "server_ok": server_pass, "engine_cluster_passes": engine_pass,
        "max_ok_per_flow_second": max(ok_by_second.values()),
        "prefix_launches_per_entry_step": prefix_launches / max(entries, 1),
        "remote": remote,
        "spans_per_sampled_entry": 3, "traces": len(traces),
        "fallback": {"pairs": CLIENT_FALLBACK_PAIRS,
                     "pair_ms": {"p50": pct(fb_lat, 50), "max": max(fb_lat)},
                     "budget_ms": budget,
                     "cluster_fallback_count": stats["clusterFallbackCount"],
                     "breaker": stats["tokenClientBreaker"]["state"],
                     "rejected": stats["tokenClientBreaker"]["rejectedCount"]},
        "counts": counts}


def cluster_runs(dev, server):
    """The cluster phase's four parts, each timed; ``server`` is the
    client run's token server process."""
    out, parts = {}, {}
    t1 = time.perf_counter()
    out["kernel"] = cluster_kernel(dev)
    parts["kernel_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["service"] = cluster_service(dev)
    parts["service_s"] = time.perf_counter() - t1
    # The path's two runs, the wire mesh and the engine client: each zeroes
    # the counts just before its traffic and reads them just after.
    t1 = time.perf_counter()
    out["mesh"] = cluster_mesh(dev)
    parts["mesh_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["client"] = cluster_client(dev, server)
    parts["client_s"] = time.perf_counter() - t1
    return out, parts


def cluster_phase(dev):
    """The cluster token path on the card: the acquire kernel at every
    width, the service card against CPU, the 64-connection wire mesh, and
    an engine as the token client. Prints one ``{"cluster": ...}`` line."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    # The client run's token server starts now, in a process of its own,
    # and is ready by the time the mesh has run.
    server = TokenServerProcess(dev)
    try:
        out, parts = cluster_runs(dev, server)
    finally:
        server.kill()
    runs = {"mesh": out["mesh"].pop("counts"),
            "client": out["client"].pop("counts")}
    for run, c in runs.items():
        if c["acquire"] <= 0 or (run == "client" and c["prefix"] <= 0):
            raise AssertionError(f"cluster {run} run launched acquire "
                                 f"{c['acquire']}, prefix {c['prefix']} "
                                 "times")
    by_width, by_shape = {}, {}
    for c in runs.values():
        for w, k in c["acquire_by_width"].items():
            by_width[w] = by_width.get(w, 0) + k
        for sh, k in c["prefix_by_shape"].items():
            by_shape[sh] = by_shape.get(sh, 0) + k
    out["acquire_launches"] = sum(c["acquire"] for c in runs.values())
    out["acquire_launches_by_run"] = {
        run: {str(w): k for w, k in sorted(c["acquire_by_width"].items())}
        for run, c in runs.items()}
    out["acquire_launches_by_width"] = {
        str(w): k for w, k in sorted(by_width.items())}
    out["prefix_launches"] = sum(c["prefix"] for c in runs.values())
    out["prefix_launches_by_shape"] = {
        f"K={k},N={n},M={m}": c
        for (k, n, m), c in sorted(by_shape.items())}
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"cluster": out}), flush=True)
    if out["phase_s"] > CLUSTER_PHASE_LIMIT_S:
        raise AssertionError(f"cluster phase took {out['phase_s']:.1f} s, "
                             f"over {CLUSTER_PHASE_LIMIT_S} s")
    return out


def acquire_kernel_entry(cluster):
    """The acquire kernel's entry of the kernels line, at the width its
    main run (the wire mesh and the engine client) launched most."""
    by_width = {int(w): c
                for w, c in cluster["acquire_launches_by_width"].items()}
    width = max((w for w in ACQUIRE_WIDTHS),
                key=lambda w: (by_width.get(w, 0), w))
    row = cluster["kernel"][width]
    return {
        "name": "cluster_acquire",
        "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/cluster_acquire.cu",
        "replaces": "sentinel_tpu/cluster/token_service.py:136",
        "replaces_function": "acquire_step",
        "replaces_kind": "xla_scan",
        "launches": cluster["acquire_launches"],
        "launches_by_width": cluster["acquire_launches_by_width"],
        "bit_equal": True,
        "max_abs_err": max(r["max_abs_err"]
                           for r in cluster["kernel"].values()),
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "bound_derivation": row["bound_derivation"],
        "call_ms": row["call_ms"],
        "library_ms": None,
        "shape": row["shape"],
    }


# ---------------------------------------------------------------------------
# Phase 12: the pod
# ---------------------------------------------------------------------------

POD_SHARDS = 8
POD_PER_SHARD = 1_024          # a pod batch of 8,192
POD_ROUNDS = 16
POD_STEP_MS = 50
POD_START_MS = 400             # the rounds cross a second boundary
POD_FLOW_COUNT = 5             # cluster flow rules on every 10th resource
POD_PARAM_COUNT = 3            # cluster param rules on every 40th
POD_HOT_SHARE = 0.5            # lanes on the cluster-ruled resources
POD_PARAM_VALUES = 8
# The cut of parts (b) and (e): shards, capacity, resources (cluster and
# default rows must fit the capacity), lanes a shard, rounds.
POD_CUT = {"shards": 4, "capacity": 8_192, "resources": 2_000,
           "per_shard": 256, "rounds": 6}
POD_DCN = (2, 4)
POD_DCN_PER_SHARD = 8
POD_NCCL_ROUNDS = 4
POD_PHASE_LIMIT_S = 60.0
POD_CKPT = CKPT_DIR / "pod.npz"


def pod_world(dev, capacity=CAPACITY, n_resources=N_RESOURCES,
              flight_seconds=128, flow_count=POD_FLOW_COUNT,
              param_count=POD_PARAM_COUNT, degrade=True, flow=None):
    """The main path's configuration as one shard of a pod: the bench's
    resources with DefaultNode rows, its degrade rules (every 20th) and
    system rule, and its flow (every 10th) and param (every 40th) rules
    made cluster-mode with finite counts, so admission binds pod-wide.
    ``flow`` replaces the flow rules. Returns (rows, rule pack, a fresh
    shard state)."""
    from sentinel_tpu_torch.core.registry import NodeRegistry
    from sentinel_tpu_torch.ops import step as S

    reg = NodeRegistry(capacity)
    ent = reg.entrance_row(CTX)
    names = [f"res{i}" for i in range(n_resources)]
    rows = {"cluster": np.array([reg.cluster_row(n) for n in names],
                                np.int32),
            "dn": np.array([reg.default_row(CTX, n, ent) for n in names],
                           np.int32),
            "ruled": np.arange(0, n_resources, 10),
            "param_ruled": np.arange(0, n_resources, 40)}
    if flow is None:
        flow = [F.FlowRule(resource=f"res{i}", count=flow_count,
                           cluster_mode=True)
                for i in range(0, n_resources, 10)]
    param = [P.ParamFlowRule(f"res{i}", param_idx=0, count=param_count,
                             cluster_mode=True)
             for i in range(0, n_resources, 40)]
    deg = ([D.DegradeRule(resource=f"res{i}", count=100, grade=i % 3,
                          time_window=10, min_request_amount=5)
            for i in range(0, n_resources, 20)] if degrade else [])
    ft, _ = F.compile_flow_rules(flow, reg, capacity, device=dev)
    dt, di = D.compile_degrade_rules(deg, reg, capacity, device=dev)
    pt = P.compile_param_rules(param, reg, capacity, device=dev)
    pack = S.RulePack(
        flow=ft, degrade=dt,
        authority=A.compile_authority_rules([], reg, capacity, device=dev),
        system=Y.compile_system_rules([Y.SystemRule(qps=1e12)], device=dev),
        param=pt)
    one = S.make_state(capacity, ft.num_rules, NOW0,
                       degrade=D.make_degrade_state(dt, di),
                       param=P.make_param_state(pt.num_rules, device=dev),
                       device=dev, flight_seconds=flight_seconds)
    return rows, pack, one


def pod_stream(rows, n_shards, per_shard, rounds, seed):
    """Seeded pod batches: half the lanes on the cluster-ruled resources,
    the rest over every resource, one of POD_PARAM_VALUES values at
    param index 0, acquire count 1."""
    rng = np.random.default_rng(seed)
    n_res = rows["cluster"].shape[0]
    out = []
    for _ in range(rounds):
        width = n_shards * per_shard
        buf = make_entry_batch_np(width)
        hot = rng.random(width) < POD_HOT_SHARE
        pick = np.where(hot, rng.choice(rows["ruled"], size=width),
                        rng.integers(0, n_res, size=width))
        buf["cluster_row"][:] = rows["cluster"][pick]
        buf["dn_row"][:] = rows["dn"][pick]
        buf["count"][:] = 1
        buf["param_hash"][:, 0] = rng.integers(1, POD_PARAM_VALUES + 1,
                                               size=width)
        buf["param_present"][:, 0] = True
        out.append(buf)
    return out


def pod_exit_buf(ebuf, reason, seed):
    """Completions of the admitted lanes, from a per-round seed (so card
    and CPU runs given equal verdicts get equal exits)."""
    return exit_buf(np.random.default_rng(seed), ebuf, reason)


def pod_drive(dev, rows, pack, one, stream, n_shards, start_ms=NOW0,
              step_ms=POD_STEP_MS, on_step=None, shadow_rules=None):
    """The one-process pod over a stream with exits; returns (the decisions
    of every round as numpy, the pod). ``on_step(k, now, pod)`` runs
    before each entry step (outside any timing)."""
    from sentinel_tpu_torch.parallel import cluster as PPC

    if shadow_rules is not None and one.shadow is None:
        raise AssertionError("a candidate needs a shard state with a shadow")
    pod = PPC.make_pod_state(n_shards, one)
    entry, exit_ = PPC.make_pod_steps(dev, shadow_rules=shadow_rules)
    decs, now = [], start_ms
    for k, ebuf in enumerate(stream):
        now += step_ms
        if on_step is not None:
            on_step(k, now, pod)
        pod, dec = entry(pod, pack, to_device(ebuf, dev), now)
        decs.append(decisions_np(dec))
        pod = exit_(pod, pack, to_device(pod_exit_buf(
            ebuf, decs[-1]["reason"], 1000 + k), dev), now + 10)
    return decs, pod


def pod_window_pass(pod, now):
    """int64[R]: the pod-global PASS in the window at ``now`` (before a
    step): each shard's rotated window summed over the shards."""
    from sentinel_tpu_torch.ops import step as S
    from sentinel_tpu_torch.ops import window as W
    from sentinel_tpu_torch.parallel import cluster as PPC

    n = pod.cur_threads.shape[0]
    return sum(PPC.pass_counts(W.rotate(PPC.shard(pod.w1, d), now,
                                        S.SPEC_1S)).to(torch.int64)
               for d in range(n)).cpu().numpy()


def pod_full(dev):
    """Part (a): D = 8 shards of the main path's configuration, a pod
    batch of 8,192 for 16 rounds 50 ms apart with exits. The written
    contracts per cluster rule and second; launches, syncs, times."""
    from sentinel_tpu_torch.parallel import cluster as PPC

    rows, pack, one = pod_world(dev)
    stream = pod_stream(rows, POD_SHARDS, POD_PER_SHARD, POD_ROUNDS + 1, 5)
    n, b = POD_SHARDS, POD_PER_SHARD
    ruled_rows = rows["cluster"][rows["ruled"]]
    pre = {}  # round -> the pod-global PASS of each ruled row before it
    # Warm-up round on its own pod (allocations, the kernel's first load).
    pod_drive(dev, rows, pack, one, stream[POD_ROUNDS:], n)
    torch.cuda.synchronize()
    pod = PPC.make_pod_state(n, one)
    entry, exit_ = PPC.make_pod_steps(dev)
    batches = [to_device(e, dev) for e in stream[:POD_ROUNDS]]
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    SYNCS.count = 0
    entry_s = exit_s = 0.0
    now = NOW0 + POD_START_MS
    decs, times = [], []
    for k in range(POD_ROUNDS):
        now += POD_STEP_MS
        if k > 0:
            pre[k] = pod_window_pass(pod, now)[ruled_rows]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pod, dec = entry(pod, pack, batches[k], now)
        reason = dec.reason.cpu().numpy()
        entry_s += time.perf_counter() - t0
        decs.append(reason)
        times.append(now)
        xb = to_device(pod_exit_buf(stream[k], reason, 2000 + k), dev)
        t0 = time.perf_counter()
        pod = exit_(pod, pack, xb, now + 10)
        torch.cuda.synchronize()
        exit_s += time.perf_counter() - t0
    launches = prefix_cuda.launches
    by_shape = dict(prefix_cuda.launches_by_shape)
    syncs = SYNCS.count / POD_ROUNDS
    if launches != 4 * n * POD_ROUNDS:
        raise AssertionError(f"pod path launched the prefix kernel "
                             f"{launches} times in {POD_ROUNDS} steps, not "
                             f"4 x {n} a step")
    if prefix_cuda.tile_launches:
        raise AssertionError("the pod path took the tile walk")
    if syncs > n * HOST_SYNCS_PER_ROUND:
        raise AssertionError(f"{syncs} host syncs per pod step, over "
                             f"{n} x {HOST_SYNCS_PER_ROUND}")

    # The written contracts (docs/SEMANTICS.md:46-50), per cluster rule.
    thr = POD_FLOW_COUNT
    per_sec, step_max = {}, {}
    flow_blocks = param_blocks = 0
    for k, (reason, t) in enumerate(zip(decs, times)):
        lanes = stream[k]["cluster_row"]
        ok = reason == 0
        flow_blocks += int((reason == C.BlockReason.FLOW).sum())
        param_blocks += int((reason == C.BlockReason.PARAM_FLOW).sum())
        per_shard = np.stack([
            np.bincount(lanes[d * b:(d + 1) * b][ok[d * b:(d + 1) * b]],
                        minlength=CAPACITY)[ruled_rows] for d in range(n)])
        step = per_shard.sum(axis=0)
        sec = t // 1000
        per_sec[sec] = per_sec.get(sec, 0) + step
        step_max[sec] = np.maximum(step_max.get(sec, 0), per_shard.max(0))
        if k in pre:
            full = pre[k] >= thr
            if (step[full] > 0).any():
                raise AssertionError(
                    f"round {k}: {int((step[full] > 0).sum())} cluster "
                    "rules admitted after their pod total reached the "
                    "threshold")
    worst = 0
    for sec, total in per_sec.items():
        bound = thr + (n - 1) * step_max[sec]
        if (total > bound).any():
            raise AssertionError(f"second {sec}: a cluster rule admitted "
                                 "over threshold + (D - 1) x its largest "
                                 "per-shard step")
        worst = max(worst, int((total - thr).max()))
    if flow_blocks <= 0 or param_blocks <= 0:
        raise AssertionError(f"cluster rules did not bind: {flow_blocks} "
                             f"flow, {param_blocks} param blocks")

    # The reduction on its own: the last step's contributions, summed.
    prepared = [PPC.prepare(PPC.shard(pod, d), pack, now,
                            cluster_param=True)[1] for d in range(n)]
    reduce_ms = time_ms(lambda: PPC.sum_contributions(prepared), 20)
    out = {
        "shards": n, "lanes_per_shard": b, "rounds": POD_ROUNDS,
        "pod_entry_ms_per_step": entry_s / POD_ROUNDS * 1e3,
        "pod_entry_ms_per_shard": entry_s / POD_ROUNDS / n * 1e3,
        "pod_exit_ms_per_step": exit_s / POD_ROUNDS * 1e3,
        "pod_rule_checks_per_s": n * b * POD_ROUNDS / entry_s,
        "reduction_ms_per_step": reduce_ms,
        "reduction_bytes_per_step": n * PPC.contribution_bytes(prepared[0]),
        "reduction_bytes_per_shard": PPC.contribution_bytes(prepared[0]),
        "host_syncs_per_pod_step": syncs,
        "prefix_launches": launches,
        "prefix_launches_per_pod_step": launches / POD_ROUNDS,
        "prefix_launches_by_shape": {f"K={k},N={m},M={v}": c for (k, m, v), c
                                     in sorted(by_shape.items())},
        "flow_blocks": flow_blocks, "param_blocks": param_blocks,
        "largest_overshoot_over_threshold": worst,
        "contract_checks": {"per_second_bound": True,
                            "stop_after_threshold": len(pre)},
        "pod_state_bytes": tree_bytes(pod),
    }
    return out, pod


def pod_reads(pod):
    """Part (e), reads: the global reads equal the sums of the shards'."""
    from sentinel_tpu_torch.ops import step as S
    from sentinel_tpu_torch.parallel import cluster as PPC

    n = pod.cur_threads.shape[0]
    tele = PPC.global_telemetry_counts(pod)
    views = [S.telemetry_view(PPC.shard(pod, d)) for d in range(n)]
    for f in tele._fields:
        want = sum(getattr(v, f).to(torch.int64) for v in views)
        if not torch.equal(getattr(tele, f), want):
            raise AssertionError(f"global_telemetry_counts.{f} is not the "
                                 "sum of the shards'")
    fl = PPC.global_flight_recorder(pod)
    if not (pod.flight.stamps == fl.stamps).all():
        raise AssertionError("flight stamps differ between shards")
    for f in ("events", "attr", "hist", "slot_attr"):
        want = sum(getattr(PPC.shard(pod.flight, d), f).to(torch.int64)
                   for d in range(n))
        if not torch.equal(getattr(fl, f), want):
            raise AssertionError(f"global_flight_recorder.{f} is not the "
                                 "sum of the shards'")
    seconds = int((fl.stamps >= 0).sum())
    if seconds < 1:
        raise AssertionError("the pod folded no second into its ring")
    return {"telemetry_equal": True, "flight_equal": True,
            "flight_seconds_folded": seconds}


def pod_states_equal(x, y, what):
    """Every leaf equal, float leaves too (no tolerance)."""
    from sentinel_tpu_torch.parallel import cluster as PPC

    for i, (a, b) in enumerate(zip(PPC.tree_leaves(x), PPC.tree_leaves(y),
                                   strict=True)):
        if a.dtype != b.dtype or a.shape != b.shape \
                or not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{what}: leaf {i} differs")


def pod_cut(dev, seed=6, shadow=False):
    """The cut configuration on one device: (rows, pack, one, stream)."""
    c = POD_CUT
    rows, pack, one = pod_world(dev, capacity=c["capacity"],
                                n_resources=c["resources"])
    stream = pod_stream(rows, c["shards"], c["per_shard"], c["rounds"], seed)
    return rows, pack, one, stream


def pod_card_cpu(dev):
    """Part (b): the cut stream on the card and on the CPU; every decision
    and every leaf equal. Returns the card's pod for the checkpoint."""
    runs, packs = {}, {}
    for d in (dev, "cpu"):
        rows, packs[d], one, stream = pod_cut(d)
        runs[d] = pod_drive(d, rows, packs[d], one, stream,
                            POD_CUT["shards"])
    blocked = 0
    for k, (a, b) in enumerate(zip(runs[dev][0], runs["cpu"][0])):
        for f in a:
            if not np.array_equal(a[f], b[f]):
                raise AssertionError(f"pod round {k}: decisions.{f} differ "
                                     "between card and CPU")
        blocked += int((a["reason"] > 0).sum())
    pod_states_equal(runs[dev][1], runs["cpu"][1], "pod card vs CPU")
    if blocked <= 0:
        raise AssertionError("the cut pod stream blocked nothing")
    return {"blocked_decisions": blocked, "decisions_equal": True,
            "state_equal": True}, runs[dev][1], packs[dev]


def pod_two_axes(dev):
    """Part (c): a 2 x 4 pod with one global-scope rule (res0, 10 a
    second) and one pod-scope rule (res10, 6 a second): the bound checks
    of tests/test_namespaces.py:80-135."""
    from sentinel_tpu_torch.parallel import namespaces as PNS

    flow = [F.FlowRule(resource="res0", count=10, cluster_mode=True,
                       cluster_config={"scope": "global"}),
            F.FlowRule(resource="res10", count=6, cluster_mode=True)]
    rows, pack, one = pod_world(dev, capacity=1_024, n_resources=100,
                                flight_seconds=8, flow=flow)
    s, p = POD_DCN
    b = POD_DCN_PER_SHARD
    entry, _ = PNS.make_dcn_pod_steps(dev)

    def run(row, per, t, pod):
        buf = make_entry_batch_np(s * p * b)
        for d in range(s * p):
            buf["cluster_row"][d * b:d * b + per] = rows["cluster"][row]
        buf["count"][:] = 1
        pod, dec = entry(pod, pack, to_device(buf, dev), t)
        r = dec.reason.cpu().numpy().reshape(s, p * b)
        return pod, [int((x == 0).sum()) for x in r]

    pod = PNS.make_dcn_pod_state(s, p, one)
    pod, a1 = run(10, 3, NOW0, pod)           # pod scope: a quota a slice
    if not all(6 <= a <= 6 + (p - 1) * 3 for a in a1):
        raise AssertionError(f"pod-scope rule admitted {a1} per slice")
    pod, a2 = run(10, 3, NOW0 + 1, pod)
    if a2 != [0, 0]:
        raise AssertionError(f"pod-scope rule admitted {a2} after its quota")
    pod, g1 = run(0, 2, NOW0 + 2, pod)        # global scope: one quota
    if not 10 <= sum(g1) <= 10 + (s * p - 1) * 2:
        raise AssertionError(f"global-scope rule admitted {g1}")
    pod, g2 = run(0, 2, NOW0 + 3, pod)
    if sum(g2) != 0:
        raise AssertionError(f"global-scope rule admitted {g2} after its "
                             "quota")
    return {"shape": [s, p], "pod_scope_admitted": a1,
            "global_scope_admitted": g1, "bounds_hold": True}


def pod_nccl(dev):
    """Part (d): torch.distributed with NCCL at world size 1 (a FileStore:
    no network) against the one-process driver at D = 1 on shard 0's
    lanes of the full-width stream; then the all_reduce's own time at the
    full-width contribution."""
    import torch.distributed as dist

    from sentinel_tpu_torch.parallel import cluster as PPC
    from sentinel_tpu_torch.parallel import namespaces as PNS

    store_path = Path(__file__).resolve().parent / "smoke_logs" / "nccl_store"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    if store_path.exists():
        store_path.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1),
                            rank=0, world_size=1)
    try:
        rows, pack, one = pod_world(dev)
        stream = pod_stream(rows, 1, POD_PER_SHARD, POD_NCCL_ROUNDS, 8)
        out = {}
        for kind in ("pod", "dcn"):
            if kind == "pod":
                dentry, dexit = PPC.make_dist_pod_steps(device=dev)
                oentry, oexit = PPC.make_pod_steps(dev)
                pod = PPC.make_pod_state(1, one)
            else:
                dentry, dexit = PNS.make_dist_dcn_pod_steps(1, 1, device=dev)
                oentry, oexit = PNS.make_dcn_pod_steps(dev)
                pod = PNS.make_dcn_pod_state(1, 1, one)
            state = PPC.tree_map(lambda x: x.clone(), one)
            now = NOW0
            for k, ebuf in enumerate(stream):
                now += POD_STEP_MS
                state, ddec = dentry(state, pack, to_device(ebuf, dev), now)
                pod, odec = oentry(pod, pack, to_device(ebuf, dev), now)
                for f in ddec._fields:
                    if not torch.equal(getattr(ddec, f), getattr(odec, f)):
                        raise AssertionError(f"NCCL {kind} round {k}: "
                                             f"decisions.{f} differ")
                xb = to_device(pod_exit_buf(
                    ebuf, ddec.reason.cpu().numpy(), 3000 + k), dev)
                state = dexit(state, pack, xb, now + 10)
                pod = oexit(pod, pack, xb, now + 10)
            index = 0 if kind == "pod" else (0, 0)
            pod_states_equal(state, PPC.shard(pod, index), f"NCCL {kind}")
            out[f"{kind}_equal"] = True
        own = PPC.prepare(state, pack, now, cluster_param=True)[1]
        out["all_reduce_ms"] = time_ms(
            lambda: PPC.all_reduce_contribution(own), 20)
        out["all_reduce_bytes"] = PPC.contribution_bytes(own)
        out["world_size"] = dist.get_world_size()
        out["backend"] = str(dist.get_backend())
    finally:
        dist.destroy_process_group()
    return out


def pod_candidate(dev):
    """Part (e), rollout: at the cut size, a candidate (the cluster rules,
    no breakers) staged pod-wide on a pod whose live rules block nothing;
    its shadow counters summed over the shards must equal the live counts
    of a second pod ENFORCING the candidate on the same stream."""
    from sentinel_tpu_torch.ops import step as S
    from sentinel_tpu_torch.parallel import cluster as PPC

    c = POD_CUT
    rows, cand, cand_one = pod_world(dev, capacity=c["capacity"],
                                     n_resources=c["resources"],
                                     degrade=False)
    _, live, one = pod_world(dev, capacity=c["capacity"],
                             n_resources=c["resources"], flow_count=1e9,
                             param_count=1e9)
    one = one._replace(shadow=S.make_shadow_state(
        c["capacity"], cand, cand_one.degrade, device=dev))
    stream = pod_stream(rows, c["shards"], c["per_shard"], c["rounds"], 9)
    _, shadow_pod = pod_drive(dev, rows, live, one, stream, c["shards"],
                              shadow_rules=cand)
    _, enforcing = pod_drive(dev, rows, cand, cand_one, stream, c["shards"])
    counts = PPC.global_shadow_counts(shadow_pod)
    per_shard = sum(shadow_pod.shadow.counts[d] for d in range(c["shards"]))
    if not torch.equal(counts, per_shard):
        raise AssertionError("global_shadow_counts is not the sum of the "
                             "shards'")
    tele = PPC.global_telemetry_counts(enforcing)
    for name, ch, ev in (("pass", S.SH_WOULD_PASS, C.MetricEvent.PASS),
                         ("block", S.SH_WOULD_BLOCK, C.MetricEvent.BLOCK)):
        if not torch.equal(counts[ch], tele.totals[ev]):
            bad = int((counts[ch] != tele.totals[ev]).sum())
            raise AssertionError(f"pod candidate would-{name} differs from "
                                 f"the enforcing pod on {bad} rows")
    would_block = int(counts[S.SH_WOULD_BLOCK].sum())
    if would_block <= 0:
        raise AssertionError("the pod candidate would block nothing")
    return {"would_pass": int(counts[S.SH_WOULD_PASS].sum()),
            "would_block": would_block, "equals_enforcing_pod": True}


def pod_checkpoint(dev, pod, pack):
    """Part (e), checkpoint: the card pod of part (b) saved, restored
    into a fresh card template, leaf for leaf; both step on equal."""
    from sentinel_tpu_torch.core.checkpoint import (
        restore_pod_checkpoint, save_pod_checkpoint)
    from sentinel_tpu_torch.parallel import cluster as PPC

    POD_CKPT.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    save_pod_checkpoint(pod, str(POD_CKPT))
    save_ms = (time.perf_counter() - t0) * 1e3
    rows, _, one, stream = pod_cut(dev, seed=12)
    template = PPC.make_pod_state(POD_CUT["shards"], one)
    t0 = time.perf_counter()
    restored = restore_pod_checkpoint(template, str(POD_CKPT))
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    pod_states_equal(pod, restored, "restored pod")
    entry, _ = PPC.make_pod_steps(dev)
    now = NOW0 + 5_000
    _, a = entry(pod, pack, to_device(stream[0], dev), now)
    _, b = entry(restored, pack, to_device(stream[0], dev), now)
    if not torch.equal(a.reason, b.reason):
        raise AssertionError("the restored pod decides otherwise")
    return {"save_ms": save_ms, "restore_ms": restore_ms,
            "file_bytes": POD_CKPT.stat().st_size,
            "leaves": len(PPC.tree_leaves(pod)), "restored_equal": True}


def pod_phase(dev):
    """The pod path on the card: (a) full width with the written
    contracts, (b) card = CPU at the cut size, (c) two axes, (d) NCCL at
    world size 1, (e) the pod-wide candidate, the checkpoint and the
    global reads. Counts are zeroed before (a)'s rounds and read after
    them. Prints one ``{"pod": ...}`` line."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    # What earlier phases left running beside the pod's host-bound loop.
    out = {"threads_at_start": sorted(t.name for t in threading.enumerate())}
    parts = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        result = fn(*args)
        parts[f"{name}_s"] = time.perf_counter() - t1
        print(json.dumps({"pod_part": name, "s": parts[f"{name}_s"],
                          "peak_bytes_so_far":
                              torch.cuda.max_memory_allocated()}),
              flush=True)
        return result

    out["full"], full_pod = part("full", pod_full, dev)
    # The reads while the full pod is the only one held, then it goes.
    out["reads"] = part("reads", pod_reads, full_pod)
    del full_pod
    out["card_cpu"], cut_pod, cut_pack = part("card_cpu", pod_card_cpu, dev)
    out["two_axes"] = part("two_axes", pod_two_axes, dev)
    out["nccl"] = part("nccl", pod_nccl, dev)
    out["candidate"] = part("candidate", pod_candidate, dev)
    out["checkpoint"] = part("checkpoint", pod_checkpoint, dev, cut_pod,
                             cut_pack)
    del cut_pod
    out["cut"] = POD_CUT
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"pod": out}), flush=True)
    if out["phase_s"] > POD_PHASE_LIMIT_S:
        raise AssertionError(f"pod phase took {out['phase_s']:.1f} s, over "
                             f"{POD_PHASE_LIMIT_S} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the control plane that rides the once-per-second fold
# ---------------------------------------------------------------------------

CONTROL_WIDTH = 2048
CONTROL_STEP_MS = 250            # four width-2048 batches a simulated second
CONTROL_SECONDS = 17
CONTROL_WARM_S = 4               # seconds before objectives and targets load
CONTROL_OBJECTIVES = tuple(f"res{10 * i}" for i in range(64))
CONTROL_TARGETS = tuple(f"res{1000 + 10 * i}" for i in range(16))
CONTROL_BURN = "res0"            # an objective's resource, tightened to 8/s
CONTROL_BURN_COUNT = 8
CONTROL_BURN_LANES = 64
CONTROL_BURN_SECONDS = (4, 8)
CONTROL_UP = CONTROL_TARGETS[0]  # count 64 under 96/s: promoted to 128
CONTROL_UP_COUNT = 64
CONTROL_UP_LANES = 24
CONTROL_UP_SECONDS = (4, 10)
CONTROL_DOWN = CONTROL_TARGETS[1]  # RT 50 ms against 1 ms: a decrease
CONTROL_DOWN_COUNT = 6000          # that the guardrail aborts
CONTROL_DOWN_LANES = 1024
CONTROL_DOWN_SECONDS = (10, 17)
CONTROL_DOWN_RT_MS = 50
# Drill-speed knobs (``tests/test_adaptive.py``'s, with a one-second
# cadence) and a journal tail that holds the whole run.
CONTROL_KEYS = {
    "csp.sentinel.adaptive.interval.seconds": "1",
    "csp.sentinel.adaptive.shadow.seconds": "1",
    "csp.sentinel.adaptive.canary.seconds": "1",
    "csp.sentinel.adaptive.cooldown.seconds": "4",
    "csp.sentinel.adaptive.abort.backoff.seconds": "30",
    "csp.sentinel.adaptive.step.pct": "1.0",
    "csp.sentinel.adaptive.increase.pct": "1.0",
    "csp.sentinel.adaptive.decrease.pct": "0.5",
    "csp.sentinel.journal.capacity": "4096",
}
CONTROL_ABORT_WINDOWS = 2
CONTROL_PIPE_THREADS = 16
CONTROL_PIPE_WINDOW_S = 4.0
CONTROL_WIRE_CONNS = 4
CONTROL_WIRE_BURST = 16
CONTROL_WIRE_FLOWS = 8
CONTROL_FLEET_LEADERS = 3
CONTROL_FLEET_SECONDS = 3
# A leader's page carries each second's whole resource map and the health
# of every resource the SLO manager baselines, in one u16-framed JSON
# entity (at most 64,000 bytes): a second with thousands of active
# resources cannot be framed and is skipped, loudly (the reference's
# bound). The leaders therefore serve 200 resources.
CONTROL_FLEET_CUT = {"capacity": 8_192, "resources": 200}
CONTROL_PHASE_LIMIT_S = 60.0
CONTROL_DIR = Path(__file__).resolve().parent / "smoke_logs" / "control"
# Read at pump time from the live window (the reference's trace ring does
# the same), so it depends on when the pump ran, not on the device.
TRACE_WINDOW_FIELDS = ("window", "windowAtTrace")


def control_lanes():
    """Per batch: the resource index of every lane. The scenario's
    resources get fixed shares; the rest of each batch is the headline's
    uniform traffic over the other resources (one seeded stream)."""
    rng = np.random.default_rng(41)
    special = {0} | {int(r[3:]) for r in CONTROL_TARGETS}
    pool = np.array([i for i in range(N_RESOURCES) if i not in special])
    out = []
    for s in range(CONTROL_SECONDS):
        for _ in range(1000 // CONTROL_STEP_MS):
            lanes = []
            for res, n, (a, b) in (
                    (CONTROL_BURN, CONTROL_BURN_LANES, CONTROL_BURN_SECONDS),
                    (CONTROL_UP, CONTROL_UP_LANES, CONTROL_UP_SECONDS),
                    (CONTROL_DOWN, CONTROL_DOWN_LANES,
                     CONTROL_DOWN_SECONDS)):
                if a <= s < b:
                    lanes += [int(res[3:])] * n
            rest = CONTROL_WIDTH - len(lanes)
            lanes = np.concatenate([np.array(lanes, np.int64),
                                    rng.choice(pool, size=rest)])
            out.append((s, rng.permutation(lanes)))
    return out


def control_rules(eng):
    """The headline rules with the scenario's three thresholds."""
    counts = {CONTROL_BURN: CONTROL_BURN_COUNT, CONTROL_UP: CONTROL_UP_COUNT,
              CONTROL_DOWN: CONTROL_DOWN_COUNT}
    eng.flow_rules.load_rules([
        F.FlowRule(resource=f"res{i}",
                   count=counts.get(f"res{i}", 1e9))
        for i in range(0, N_RESOURCES, 10)])


def control_objectives(eng):
    from sentinel_tpu_torch.slo.objectives import BurnWindow, SloObjective

    eng.slo.load_objectives([SloObjective(
        resource=r, objective=0.99, min_events=1,
        windows=(BurnWindow(10, 2, 2.0, "page"),
                 BurnWindow(30, 5, 6.0, "ticket")))
        for r in CONTROL_OBJECTIVES])


def control_targets(eng):
    from sentinel_tpu_torch.adaptive.controller import AdaptiveTarget

    eng.adaptive.load_targets([AdaptiveTarget(
        resource=r, max_block_rate=0.05,
        rt_p99_ms=1.0 if r == CONTROL_DOWN else 0.0,
        floor=1.0, ceiling=1e6, min_entries=8) for r in CONTROL_TARGETS])
    eng.adaptive.enable()


class _Hook:
    """A loopback webhook endpoint (``http.server``) that keeps the
    bodies it was sent."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        received = self.received = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                received.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, fmt, *args):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="smoke-webhook-endpoint")
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}/hook"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


class _HookTimer:
    """Times every call of the fold's parts: ``{name: (owner, attr)}``,
    each wrapped in place for the ``with`` block (a call nested in another
    counts in both)."""

    def __init__(self, targets):
        self.targets, self.ms = targets, {name: [] for name in targets}
        self.saved = []

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            orig = getattr(owner, attr)
            self.saved.append((owner, attr, orig))

            def timed(*a, _orig=orig, _ms=self.ms[name], **kw):
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                _ms.append((time.perf_counter() - t0) * 1e3)
                return out

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in self.saved:
            setattr(owner, attr, orig)


def _plain(obj):
    """As the journal file holds it: JSON types only."""
    return json.loads(json.dumps(obj, sort_keys=True, default=str))


def _strip_trace_window(obj):
    if isinstance(obj, dict):
        return {k: _strip_trace_window(v) for k, v in obj.items()
                if k not in TRACE_WINDOW_FIELDS}
    if isinstance(obj, list):
        return [_strip_trace_window(v) for v in obj]
    return obj


def _alerts_view(eng):
    snap = eng.slo.alerts_snapshot()
    snap.pop("webhook")
    return snap


def control_run(dev, lanes, hook_url, journal_path):
    """The scenario on ``dev``: 4 s of headline traffic, then objectives
    on 64 resources and targets on 16 flow rules load, a burst burns
    CONTROL_BURN's objective, the loop promotes CONTROL_UP and sees its
    decrease of CONTROL_DOWN aborted by the guardrail. The fold runs once
    a simulated second. Returns what the card and the CPU must agree on,
    the measurements, and the open engine."""
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.slo.webhook import AlertWebhook

    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    clock = Clock(NOW0)
    eng = SentinelEngine(capacity=CAPACITY, device=dev, clock=clock,
                         journal_path=journal_path)
    eng.rollout.abort_windows = CONTROL_ABORT_WINDOWS
    eng.slo.webhook = AlertWebhook(urls=[hook_url], timeout_ms=2000,
                                   retries=2)
    reg = eng.registry
    ent = reg.entrance_row(CTX)
    cluster = np.array([reg.cluster_row(f"res{i}")
                        for i in range(N_RESOURCES)], np.int32)
    dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                   for i in range(N_RESOURCES)], np.int32)
    load_rules(eng, tight=False)
    control_rules(eng)
    rng = np.random.default_rng(43)
    down_row = cluster[int(CONTROL_DOWN[3:])]
    cuda = dev == "cuda" or getattr(dev, "type", None) == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    decisions, folds, shadow, steps = [], [], [], []
    fired_at = {}
    spill_ms = {"without": [], "with": []}
    prefix_cuda.launches = 0
    launches_total = 0
    from sentinel_tpu_torch.core import engine as engine_mod

    with _HookTimer({"render": (engine_mod, "second_to_dict"),
                     "slo_ingest": (eng.slo, "ingest"),
                     "slo_evaluate": (eng.slo, "evaluate"),
                     "waterfall_roll": (eng.waterfall, "roll"),
                     "population_roll": (eng.population, "roll"),
                     "adaptive_tick": (eng.adaptive, "on_spill")}) as hooks:
        for k, (s, pick) in enumerate(lanes):
            if s == CONTROL_WARM_S and k % (1000 // CONTROL_STEP_MS) == 0:
                control_objectives(eng)
                control_targets(eng)
            clock.now = NOW0 + s * 1000 + (k % (1000 // CONTROL_STEP_MS)) \
                * CONTROL_STEP_MS
            buf = make_entry_batch_np(CONTROL_WIDTH)
            buf["cluster_row"][:] = cluster[pick]
            buf["dn_row"][:] = dn[pick]
            buf["count"][:] = 1
            stage = getattr(eng.rollout.active_set(), "stage", None)
            batch = to_device(buf, dev)
            sync()
            s0, l0 = SYNCS.count, prefix_cuda.launches
            t0 = time.perf_counter()
            reason, _ = eng.harvest_decisions(eng.check_batch(batch))
            entry_ms = (time.perf_counter() - t0) * 1e3
            steps.append((stage, entry_ms, SYNCS.count - s0,
                          prefix_cuda.launches - l0))
            decisions.append(reason.copy())
            # Sample the verdicts now, in order, so the pump never drops a
            # batch behind a slower step.
            eng.traces.drain()
            xb = make_exit_batch_np(CONTROL_WIDTH)
            ok = reason == 0
            xb["cluster_row"][:] = np.where(ok, buf["cluster_row"], -1)
            xb["dn_row"][:] = buf["dn_row"]
            xb["count"][:] = 1
            xb["success"][:] = ok
            xb["rt_ms"][:] = np.where(buf["cluster_row"] == down_row,
                                      CONTROL_DOWN_RT_MS,
                                      rng.integers(1, 90, CONTROL_WIDTH))
            eng.complete_batch(to_device(xb, dev), now_ms=clock.now + 20)
            sync()
            if k % (1000 // CONTROL_STEP_MS) == 1000 // CONTROL_STEP_MS - 1:
                # The once-per-second fold, at the next second's start.
                clock.now = NOW0 + (s + 1) * 1000
                t0 = time.perf_counter()
                eng.slo_refresh(now_ms=clock.now)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                if s:  # the first fold pays first-use costs
                    spill_ms["with" if s >= CONTROL_WARM_S
                             else "without"].append(ms)
                snap = _alerts_view(eng)
                for a in snap["active"]:
                    fired_at.setdefault(a["key"], clock.now)
                folds.append({"t": clock.now, "alerts": snap,
                              "abortSignal": eng.slo.abort_signal(),
                              "adaptive": eng.adaptive.guardrail_state(),
                              "rollout": eng.rollout.guardrail_state()})
                counts = eng.shadow_counts()
                shadow.append(None if counts is None else counts.tolist())
    launches_total = prefix_cuda.launches
    burn_stamp = NOW0 + CONTROL_BURN_SECONDS[0] * 1000 + 500
    agree = {
        "decisions": decisions,
        "folds": folds,
        "shadow": shadow,
        "slo_status": eng.slo.status(),
        "history": _plain(eng.adaptive.history()),
        "adaptive_status": eng.adaptive.status(),
        "live_flow": [(r.resource, r.count)
                      for r in eng.flow_rules.get_rules()],
        "lkg": [(r.resource, r.count)
                for r in eng.adaptive.last_known_good()["flow"]],
        "journal": _plain(eng.journal.replay()),
        "traces": {k: v for k, v in eng.traces.snapshot(limit=0).items()
                   if k != "traces"},
        "why": eng.why_query(CONTROL_BURN, stamp_ms=burn_stamp),
        "why_newest": eng.why_query(CONTROL_BURN),
        "explain": _strip_trace_window(eng.explain_trace(CONTROL_BURN)),
    }
    measured = {"steps": steps, "spill_ms": spill_ms,
                "hook_ms": hooks.ms, "prefix_launches": launches_total,
                "fired_at": fired_at}
    return agree, measured, eng


def _diff(a, b, path="control"):
    """The first path where two nested results differ (None if equal)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return None if np.array_equal(a, b) else path
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return f"{path}: keys {sorted(set(a) ^ set(b))}"
        for k in a:
            d = _diff(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: length {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = _diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} vs {b!r}"


def _p(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def control_scenario(dev, out):
    """Parts (a)-(c): the scenario on the card, then on the CPU; every
    result equal; the card's journal directory recovered in a fresh
    engine; the measurements."""
    from sentinel_tpu_torch.telemetry.journal import ControlPlaneJournal

    lanes = control_lanes()
    hook = _Hook()
    jdir = CONTROL_DIR / "journal"
    jdir.mkdir(parents=True, exist_ok=True)
    for f in jdir.iterdir():
        f.unlink()
    jpath = str(jdir / "audit.jsonl")
    try:
        t0 = time.perf_counter()
        card, measured, card_eng = control_run(dev, lanes, hook.url, jpath)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu, _, cpu_eng = control_run("cpu", lanes, hook.url, "")
        cpu_s = time.perf_counter() - t0
        diff = _diff(card, cpu)
        if diff:
            raise AssertionError(f"control: card and CPU differ at {diff}")
        # The alert arc: the burn fired a page and a ticket, both resolved.
        events = card["folds"][-1]["alerts"]["events"]
        kinds = [(e["type"], e["alert"]["severity"]) for e in events]
        for want in (("fired", "page"), ("resolved", "page"),
                     ("fired", "ticket")):
            if want not in kinds:
                raise AssertionError(f"control: no {want} transition: "
                                     f"{kinds}")
        others = sorted({e["alert"]["resource"] for e in events}
                        - {CONTROL_BURN})
        if others:
            raise AssertionError(f"control: alerts on {others}")
        signals = [f["abortSignal"] for f in card["folds"] if f["abortSignal"]]
        if not signals:
            raise AssertionError("control: the page never reached "
                                 "abort_signal")
        # The loop: one promote of CONTROL_UP (64 -> 128), one guardrail
        # abort of CONTROL_DOWN with the last-known-good rules live.
        hist = card["history"]["events"]
        promotes = [e for e in hist if e["kind"] == "promote"]
        aborts = [e for e in hist if e["kind"] == "abort"]
        if [[(c["resource"], c["from"], c["to"]) for c in e["changes"]]
                for e in promotes] != [[(CONTROL_UP, float(CONTROL_UP_COUNT),
                                         2.0 * CONTROL_UP_COUNT)]]:
            raise AssertionError(f"control: promotions {promotes}")
        if len(aborts) != 1 or "guardrail" not in aborts[0]["reason"] \
                or not aborts[0]["lkgIntact"]:
            raise AssertionError(f"control: aborts {aborts}")
        live = dict(card["live_flow"])
        if live[CONTROL_UP] != 2.0 * CONTROL_UP_COUNT \
                or live[CONTROL_DOWN] != CONTROL_DOWN_COUNT \
                or card["live_flow"] != card["lkg"]:
            raise AssertionError("control: live rules are not the "
                                 "last-known-good set")
        proposed = [c["to"] for e in hist if e["kind"] == "propose"
                    for c in e["changes"] if c["resource"] == CONTROL_DOWN]
        if proposed != [CONTROL_DOWN_COUNT * 0.5]:
            raise AssertionError(f"control: decreases proposed {proposed}")
        if not any(s is not None for s in card["shadow"]):
            raise AssertionError("control: no shadow counters while a "
                                 "candidate was staged")
        why = card["why"]
        if (why["verdict"] or {}).get("reason") != "FLOW" \
                or why["verdict"]["provenance"] is None:
            raise AssertionError(f"control: why_query {why['verdict']}")
        if card["explain"] is None \
                or card["explain"]["verdict"]["reason"] != "FLOW":
            raise AssertionError("control: explain_trace found no FLOW "
                                 "trace")
        # The webhook delivered both engines' transitions.
        n_events = len(events)
        deadline = time.perf_counter() + 10
        while len(hook.received) < 2 * n_events \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        if len(hook.received) != 2 * n_events:
            raise AssertionError(f"control: webhook got "
                                 f"{len(hook.received)} of {2 * n_events}")
        # (c) the card's journal recovers in a fresh engine.
        for eng in (card_eng, cpu_eng):
            eng.close()
        fresh = SentinelEngine(capacity=1024, device=dev, journal_path=jpath)
        try:
            if _plain(fresh.journal.replay()) != card["journal"] \
                    or fresh.journal.last_seq != card["journal"][-1]["seq"]:
                raise AssertionError("control: recovered journal differs")
            if _plain(fresh.adaptive.history()) != card["history"]:
                raise AssertionError("control: recovered decision log "
                                     "differs")
            if _plain(fresh.slo.alerts_snapshot()["events"]) != \
                    _plain(events):
                raise AssertionError("control: recovered alert log differs")
        finally:
            fresh.close()
        files = sorted(jdir.iterdir())
        jbytes = sum(f.stat().st_size for f in files)
        probe = ControlPlaneJournal(lambda: NOW0,
                                    path=str(CONTROL_DIR / "probe.jsonl"))
        fsync_ms = []
        for i in range(32):
            t1 = time.perf_counter()
            probe.record("probe", i=i)
            fsync_ms.append((time.perf_counter() - t1) * 1e3)
        probe.close()
        (CONTROL_DIR / "probe.jsonl").unlink()
    finally:
        hook.stop()
    steps = measured["steps"]

    def by(stage):
        rows = [x for x in steps if x[0] == stage]
        return {"steps": len(rows),
                "entry_ms_p50": _p([x[1] for x in rows], 50),
                "host_syncs_per_step": (sum(x[2] for x in rows) / len(rows)
                                        if rows else None),
                "prefix_launches_per_step":
                    (sum(x[3] for x in rows) / len(rows) if rows else None)}

    out["slo"] = {
        "objectives": len(CONTROL_OBJECTIVES),
        "transitions": kinds,
        "fired_at_ms": {k: v - NOW0 for k, v in measured["fired_at"].items()},
        "burn": card["slo_status"]["burn"][f"{CONTROL_BURN}:availability"],
        "health": {"instance": card["slo_status"]["health"]["instance"],
                   "resources_scored": len(
                       card["slo_status"]["health"]["resources"]),
                   "below_100_while_burning": {
                       r: h for r, h in card["folds"][CONTROL_BURN_SECONDS[0]][
                           "alerts"]["health"]["resources"].items()
                       if h < 100}},
        "abort_signal_folds": len(signals),
        "slo_refresh_ms_p50": _p(measured["spill_ms"]["with"], 50),
        "spill_ms_p50_without_objectives":
            _p(measured["spill_ms"]["without"], 50),
        "spill_ms_p50_with_objectives": _p(measured["spill_ms"]["with"], 50),
        "render_ms_p50": _p(measured["hook_ms"]["render"], 50),
        "renders": len(measured["hook_ms"]["render"]),
        "fold_parts_ms_p50": {k: _p(v, 50)
                              for k, v in measured["hook_ms"].items()},
        "webhook_posts": len(hook.received),
    }
    out["adaptive"] = {
        "targets": len(CONTROL_TARGETS),
        "decisions": [(e["seq"], e["kind"], e.get("candidate"),
                       [(c["resource"], c["to"])
                        for c in e.get("changes", [])])
                      for e in hist if e["kind"] in (
                          "propose", "canary", "promote", "abort")],
        "live_after": {CONTROL_UP: live[CONTROL_UP],
                       CONTROL_DOWN: live[CONTROL_DOWN]},
        "no_candidate": by(None), "shadow": by("shadow"),
        "canary": by("canary"),
    }
    out["journal"] = {
        "records": len(card["journal"]),
        "kinds": sorted({r["kind"] for r in card["journal"]}),
        "file_bytes": jbytes, "files": len(files),
        "bytes_per_record": jbytes / len(card["journal"]),
        "record_ms_p50_with_fsync": _p(fsync_ms, 50),
        "record_ms_p99_with_fsync": _p(fsync_ms, 99),
        "recovered_equal": True,
        "why_reason": why["verdict"]["reason"],
        "why_blocked_that_second": why["verdict"]["blockedThatSecond"],
    }
    out["card_vs_cpu"] = {"equal": True, "batches": len(lanes),
                          "card_s": card_s, "cpu_s": cpu_s}
    return measured["prefix_launches"]


def control_waterfall(dev, out):
    """(d): the pipeline under 16 callers for 4 s on the card, the
    engine an embedded token server answering traced wire requests; every
    pipeline harvest and every fused token batch lands in the sealed
    seconds, each wire request's stages reconcile with its RTT."""
    import socket

    from sentinel_tpu_torch.cluster.constants import MSG_FLOW
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.telemetry.spans import new_trace_context

    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    eng = SentinelEngine(capacity=CAPACITY, device=dev)
    load_rules(eng, tight=False)
    srv = eng.cluster.set_to_server(host="127.0.0.1", port=0)
    svc = srv.service
    svc.rules.load_rules("default", [
        F.FlowRule(resource=f"wf{i}", count=1e9, cluster_mode=True,
                   cluster_config={"flowId": 7100 + i, "thresholdType": 1})
        for i in range(CONTROL_WIRE_FLOWS)])
    harvested = [0]
    harvest = svc.harvest_tokens

    def counted(ticket):
        got = harvest(ticket)
        harvested[0] += 1
        return got

    svc.harvest_tokens = counted
    svc.request_tokens([(7100, 1, False)] * 4)
    harvested[0] = 0
    wf = eng.waterfall
    # Tally every observation under the second the recorder filed it in
    # (its own clock read, captured per thread).
    tally = {"pipeline": {}, "batch": {}, "wire": {}}
    tally_lock = threading.Lock()
    filed = threading.local()
    recorder_now = wf._now_ms

    def now_ms():
        v = recorder_now()
        filed.sec = v - v % 1000
        return v

    def tallied(kind, fn):
        def observe(*a, **kw):
            fn(*a, **kw)
            with tally_lock:
                tally[kind][filed.sec] = tally[kind].get(filed.sec, 0) + 1
        return observe

    wf._now_ms = now_ms
    wf.observe_pipeline = tallied("pipeline", wf.observe_pipeline)
    wf.observe_batch = tallied("batch", wf.observe_batch)
    wf.observe_wire = tallied("wire", wf.observe_wire)
    eng.start_pipeline(max_batch=8, linger_s=0.0002)
    stop = threading.Event()
    errors, pairs, replies = [], [0], [0]

    def caller(i):
        r = np.random.default_rng(100 + i)
        try:
            while not stop.is_set():
                res = f"res{int(r.integers(0, N_RESOURCES))}"
                try:
                    with eng.entry(res):
                        pass
                except st.BlockException:
                    pass
                pairs[0] += 1
        except Exception as ex:  # noqa: BLE001 — failed below
            errors.append(ex)
        finally:
            ctx_mod.replace_context(None)

    def wire(i):
        try:
            with socket.create_connection(("127.0.0.1", srv.bound_port),
                                          timeout=10) as sock:
                reader = ccodec.FrameReader()
                xid = 0
                while not stop.is_set():
                    frames = []
                    for _ in range(CONTROL_WIRE_BURST):
                        xid += 1
                        body = ccodec.encode_flow_request(
                            7100 + xid % CONTROL_WIRE_FLOWS, 1, False)
                        if xid <= CONTROL_WIRE_BURST:
                            # The first burst traced: its spans stay in
                            # the service's bounded span ring.
                            body = ccodec.append_trace_tlv(
                                body, new_trace_context().traceparent())
                        frames.append(ccodec.encode_request(xid, MSG_FLOW,
                                                            body))
                    sock.sendall(b"".join(frames))
                    got = 0
                    while got < CONTROL_WIRE_BURST:
                        data = sock.recv(65536)
                        if not data:
                            raise OSError("server closed")
                        for b in reader.feed(data):
                            if ccodec.decode_response(b).status != 0:
                                raise AssertionError("wire reply not OK")
                            got += 1
                    replies[0] += got
        except Exception as ex:  # noqa: BLE001 — failed below
            errors.append(ex)

    zero_cluster_counts()
    threads = ([threading.Thread(target=caller, args=(i,))
                for i in range(CONTROL_PIPE_THREADS)]
               + [threading.Thread(target=wire, args=(i,))
                  for i in range(CONTROL_WIRE_CONNS)])
    for t in threads:
        t.start()
    time.sleep(CONTROL_PIPE_WINDOW_S)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    eng.stop_pipeline()
    counts = read_cluster_counts()
    srv_batches = harvested[0]
    eng.cluster.stop()
    if errors:
        raise AssertionError(f"control waterfall: {errors[:3]}")
    if counts["acquire"] != srv_batches:
        raise AssertionError(f"control waterfall: {counts['acquire']} "
                             f"acquire launches for {srv_batches} batches")
    pipe = eng.pipeline_stats()
    eng.slo_refresh(now_ms=eng.now_ms() + 2000)
    snap = wf.snapshot(limit=100)
    recent = snap["recent"]
    for r in recent:
        sec = r["timestamp"]
        got = (r["lanes"].get("pipeline", {}).get("queue", {})
               .get("count", 0), r["coalesce"]["batches"], r["rtt"]["count"])
        want = tuple(tally[k].get(sec, 0) for k in ("pipeline", "batch",
                                                     "wire"))
        if got != want:
            raise AssertionError(f"control waterfall: second {sec} sealed "
                                 f"{got}, observed {want}")
    if {s for t in tally.values() for s in t} - {r["timestamp"]
                                                  for r in recent}:
        raise AssertionError("control waterfall: an observed second was "
                             "not sealed")
    pipe_lane = sum(tally["pipeline"].values())
    batches = sum(tally["batch"].values())
    wire_n = sum(tally["wire"].values())
    if pipe_lane != pipe["harvests"] - pipe["failOpenCycles"] \
            or pipe["failOpenCycles"]:
        raise AssertionError(f"control waterfall: pipeline lane {pipe_lane}"
                             f" vs harvests {pipe['harvests']}")
    if batches != srv_batches:
        raise AssertionError(f"control waterfall: {batches} sealed batches "
                             f"vs the batcher's {srv_batches}")
    if wire_n != replies[0] or snap["lateDrops"]:
        raise AssertionError(f"control waterfall: {wire_n} sealed wire "
                             f"requests vs {replies[0]} replies")
    if snap["reconciliation"]["relativeError"] > 1e-6:
        raise AssertionError(f"control waterfall: stages do not reconcile "
                             f"{snap['reconciliation']}")
    trace_ids = {t["traceId"] for t in svc.spans.traces()}
    if not snap["exemplars"] or any(ex["traceId"] not in trace_ids
                                    for ex in snap["exemplars"]):
        raise AssertionError("control waterfall: an exemplar lost its span")
    cum = snap["cumulative"]
    out["waterfall"] = {
        "window_s": CONTROL_PIPE_WINDOW_S, "callers": CONTROL_PIPE_THREADS,
        "pairs": pairs[0], "pipeline_cycles": pipe["cycles"],
        "pipeline_harvests": pipe["harvests"],
        "wire_connections": CONTROL_WIRE_CONNS, "wire_requests": replies[0],
        "fused_batches": srv_batches, "sealed_seconds": len(recent),
        "per_second_equal": True,
        "pipeline_queue_ms": [cum["pipeline"]["queue"]["p50Ms"],
                              cum["pipeline"]["queue"]["p99Ms"]],
        "pipeline_device_ms": [cum["pipeline"]["device"]["p50Ms"],
                               cum["pipeline"]["device"]["p99Ms"]],
        "wire_queue_ms": [cum["wire"]["queue"]["p50Ms"],
                          cum["wire"]["queue"]["p99Ms"]],
        "wire_device_ms": [cum["wire"]["device"]["p50Ms"],
                           cum["wire"]["device"]["p99Ms"]],
        "wire_rtt_ms": [snap["rtt"]["p50Ms"], snap["rtt"]["p99Ms"]],
        "reconciliation": snap["reconciliation"],
        "device_utilization": [r["deviceUtilization"] for r in recent],
        "sentry": {k: [(w["window"], w["firing"]) for w in v]
                   for k, v in snap["sentry"]["burn"].items()},
        "alerts_active": len(eng.slo.alerts_snapshot()["active"]),
        "kernel_launches": {
            "acquire": counts["acquire"],
            "acquire_by_width": counts["acquire_by_width"],
            "prefix": counts["prefix"],
            "prefix_by_shape": {f"K={k},N={n},M={m}": c for (k, n, m), c
                                in sorted(counts["prefix_by_shape"].items())}},
    }
    eng.close()
    return counts


def control_fleet(dev, out):
    """(e): three port leaders (engine + token server each) on loopback
    under one FleetView: every settled (resource, second) fleet sum is
    the sum of the leaders' own timeseries_view cells."""
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.telemetry import fleet as FL

    cap, n_res = CONTROL_FLEET_CUT["capacity"], CONTROL_FLEET_CUT["resources"]
    clock = Clock(NOW0)
    leaders, servers = [], []
    view = None
    try:
        for li in range(CONTROL_FLEET_LEADERS):
            eng = SentinelEngine(capacity=cap, device=dev, clock=clock)
            reg = eng.registry
            ent = reg.entrance_row(CTX)
            cl = np.array([reg.cluster_row(f"res{i}") for i in range(n_res)],
                          np.int32)
            dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                           for i in range(n_res)], np.int32)
            eng.flow_rules.load_rules([
                F.FlowRule(resource=f"res{i}", count=40 + 20 * li)
                for i in range(0, n_res, 10)])
            leaders.append((eng, cl, dn))
            servers.append(ClusterTokenServer(engine=eng, host="127.0.0.1",
                                              port=0).start())
        rng = np.random.default_rng(47)
        for s in range(CONTROL_FLEET_SECONDS):
            for k in range(1000 // CONTROL_STEP_MS):
                clock.now = NOW0 + s * 1000 + k * CONTROL_STEP_MS
                for eng, cl, dn in leaders:
                    pick = rng.integers(0, n_res, CONTROL_WIDTH)
                    buf = make_entry_batch_np(CONTROL_WIDTH)
                    buf["cluster_row"][:] = cl[pick]
                    buf["dn_row"][:] = dn[pick]
                    buf["count"][:] = 1
                    eng.check_batch(to_device(buf, dev))
        clock.now = NOW0 + CONTROL_FLEET_SECONDS * 1000 + 1
        for eng, _, _ in leaders:
            eng.slo_refresh()
        view = FL.FleetView([(f"L{i}", "127.0.0.1", s.bound_port)
                             for i, s in enumerate(servers)],
                            clock=clock, stale_ms=10_000)
        leaders[0][0].fleet = view
        if not view.wait_connected():
            raise AssertionError("control fleet: leaders not connected")
        t0 = time.perf_counter()
        polled = view.poll()
        poll_ms = (time.perf_counter() - t0) * 1e3
        series = view.series()
        truth = [{x["timestamp"]: x["resources"]
                  for x in eng.timeseries_view()["seconds"]}
                 for eng, _, _ in leaders]
        settled = view.settled_through_ms()
        cells = 0
        for sec in series:
            if sec["timestamp"] > settled:
                continue
            for res, cell in sec["resources"].items():
                for f in FL._SUM_FIELDS:
                    want = sum(int(t.get(sec["timestamp"], {}).get(res, {})
                                   .get(f, 0)) for t in truth)
                    if cell["fleet"][f] != want:
                        raise AssertionError(
                            f"control fleet: {res}@{sec['timestamp']}.{f} "
                            f"{cell['fleet'][f]} != {want}")
                cells += 1
        status = view.status()
        skipped = sum(r["secondsSkipped"] for r in status["leaders"].values())
        if status["staleLeaders"] or skipped \
                or len(series) != CONTROL_FLEET_SECONDS or cells == 0:
            raise AssertionError(
                f"control fleet: {len(series)} seconds, {skipped} skipped, "
                f"{status['staleLeaders']} stale, {cells} cells")
        page = FL.leader_fleet_payload(servers[0], 0, 16)
        out["fleet"] = {
            "leaders": CONTROL_FLEET_LEADERS, "cut": CONTROL_FLEET_CUT,
            "seconds": len(series), "cells_checked": cells,
            "sums_equal": True, "ingested": polled,
            "polls": status["polls"],
            "pages": sum(r["polls"] for r in status["leaders"].values()),
            "poll_ms": poll_ms, "page_bytes": len(page),
            "skew_ms": [r["skewMs"] for r in status["leaders"].values()],
            "settled_through_ms": settled - NOW0,
            "fleet_health": status["fleetHealth"],
        }
    finally:
        for eng, _, _ in leaders:
            eng.close()
        for srv in servers:
            srv.stop()
    if leaders and leaders[0][0].fleet is not None:
        raise AssertionError("control fleet: close() left the view")


def control_syncs(dev, out):
    """(f): objectives on 64 resources and 16 enabled, idle targets add
    no host sync and no launch to the main path's entry step."""
    eng, clock, cluster, dn, origin_a = make_engine(dev, tight=False)
    try:
        control_objectives(eng)
        control_targets(eng)
        rng = np.random.default_rng(7)
        res, _ = headline_rounds(eng, clock, cluster, dn, origin_a, rng,
                                 CONTROL_WIDTH, dev)
        eng.slo_refresh(now_ms=clock.now + 1000)
        if res["host_syncs_per_round"] != HOST_SYNCS_PER_ROUND \
                or res["prefix_launches_per_entry_step"] != 4.0:
            raise AssertionError(f"control: hooks changed the step {res}")
        if eng.adaptive.proposal_count:
            raise AssertionError("control: idle targets proposed")
        out["main_path_with_hooks"] = res
    finally:
        eng.close()


def control_phase(dev):
    """The control plane on the card: (a)-(c) the scenario on the card and
    the CPU, (d) the waterfall, (e) fleet federation, (f) no added device
    work, (g) no thread of the phase alive after its engines close.
    Prints one ``{"control": ...}`` line; returns the prefix launches of
    the scenario's card run and the acquire launches of (d)'s token
    server."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    before = {t.ident for t in threading.enumerate()}
    saved = {k: config.get(k) for k in CONTROL_KEYS}
    for k, v in CONTROL_KEYS.items():
        config.set(k, v)
    out = {"reduced": [f"fleet leaders at capacity "
                       f"{CONTROL_FLEET_CUT['capacity']} with "
                       f"{CONTROL_FLEET_CUT['resources']} resources"]}
    parts = {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        result = fn(*args)
        parts[f"{name}_s"] = time.perf_counter() - t1
        return result

    try:
        launches = part("scenario", control_scenario, dev, out)
    finally:
        with config._lock:
            for k, v in saved.items():
                if v is None:
                    config._config.pop(k, None)
                else:
                    config._config[k] = v
    wf_counts = part("waterfall", control_waterfall, dev, out)
    part("fleet", control_fleet, dev, out)
    part("syncs", control_syncs, dev, out)
    alive = []
    deadline = time.perf_counter() + 5
    while time.perf_counter() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    if alive:
        raise AssertionError(f"control: threads alive after close: {alive}")
    out["threads_left"] = 0
    out["scenario_prefix_launches"] = launches
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"control": out}), flush=True)
    if out["phase_s"] > CONTROL_PHASE_LIMIT_S:
        raise AssertionError(f"control phase took {out['phase_s']:.1f} s, "
                             f"over {CONTROL_PHASE_LIMIT_S} s")
    return {"prefix": launches, "acquire": wf_counts["acquire"],
            "acquire_by_width": wf_counts["acquire_by_width"]}


# ---------------------------------------------------------------------------
# Phase 14: the HA token cluster
# ---------------------------------------------------------------------------

HA_PHASE_LIMIT_S = 90.0
HA_DIR = Path(__file__).resolve().parent / "smoke_logs" / "ha"
HA_FLOWS = tuple(range(9000, 9008))   # eight GLOBAL flows on the leaders
HA_THRESHOLD = 40                     # a second's quota per flow
HA_BEFORE = 17                        # grants per flow before the publish
HA_MARGIN = 3                         # grants per flow after it (lost)
HA_SLICES = 64                        # BENCH_19's shard_mesh ring
HA_LEADERS = ("A", "B", "C")
HA_THREADS_PER_LEADER = 2
HA_CONNS_PER_THREAD = 11              # 66 connections
HA_INFLIGHT = 256                     # a connection's burst, even split
HA_SETTLE_S = 2.0
HA_WINDOW_S = 2.5
HA_ROUTE_LAG_S = 0.25                 # servers re-seat before clients route
HA_HEAL_S = 1.0
HA_EPISODES = 10                      # chaos campaign seed 14, first K
HA_CAMPAIGN_SEED = 14
# The bench record's rebalance drill (3 leaders, 64 slices, A owning
# 0-31): the plan it applied and the certify verdict sha256 it recorded.
HA_DRILL_MOVES = {0: "A->B", 1: "A->C", 2: "A->B", 3: "A->C"}
HA_DRILL_VERDICT = \
    "edb88a7434f6109a761faf92025a91d2c3efd80e927f66a5b7e1f135073ea917"


class _HaHost:
    """The engine stand-in an HA seat journals through."""

    def __init__(self, journal, thresholds_fn):
        self.journal = journal
        self.cluster_degraded_thresholds = thresholds_fn
        self.spans = None


def _ha_rule(fid, count):
    return F.FlowRule(resource=f"ha{fid}", count=count, cluster_mode=True,
                      cluster_config={"flowId": fid, "thresholdType": 1})


def ha_failover(dev):
    """Leader A publishes its cluster checkpoint, the
    ``cluster.ha.leader.crash`` seam kills it on a wire request, B is
    promoted by an epoch-2 map, restores A's rows and admits. Every grant
    is returned for the card = CPU check; across the handoff each flow
    admits exactly its threshold plus the grants made after the publish
    (the Claim-2 margin)."""
    import shutil

    from sentinel_tpu_torch.cluster import ha
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.cluster.constants import TokenResultStatus
    from sentinel_tpu_torch.cluster.state import (
        CLUSTER_SERVER,
        ClusterStateManager,
    )
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import checkpoint as ckpt
    from sentinel_tpu_torch.resilience import FaultInjector
    from sentinel_tpu_torch.telemetry.journal import ControlPlaneJournal

    work = HA_DIR / dev.type
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    path = str(work / "leader.ck")
    time_util.freeze_time(NOW0)
    seats = {}
    try:
        for mid in HA_LEADERS:
            state = ClusterStateManager(device=dev)
            state.server_rules().load_rules(
                "default", [_ha_rule(f, HA_THRESHOLD) for f in HA_FLOWS])
            host = _HaHost(ControlPlaneJournal(time_util.current_time_millis,
                                               path=None),
                           state.server_rules().thresholds)
            state.journal = host.journal
            seats[mid] = ha.ClusterHAManager(
                engine=host, state=state, machine_id=mid,
                checkpoint_path=path, checkpoint_period_s=3600.0,
                server_host="127.0.0.1", device=dev)
        specs = tuple(ha.ClusterServerSpec(m, "127.0.0.1", 0)
                      for m in HA_LEADERS)
        m1 = ha.ClusterMap(epoch=1, servers=specs, clients=("X",))
        for seat in seats.values():
            seat.apply_map(m1)
        a = seats["A"]
        if a.state.mode != CLUSTER_SERVER:
            raise AssertionError("ha failover: A did not lead epoch 1")
        svc_a = a.state.token_server.service
        verdicts = []

        def grant(svc, n):
            got = svc.request_tokens([(f, 1, False) for f in HA_FLOWS
                                      for _ in range(n)])
            verdicts.extend((int(r.status), r.remaining, r.wait_ms,
                             r.epoch) for r in got)
            return got

        grant(svc_a, HA_BEFORE)
        t0 = time.perf_counter()
        a.publish_checkpoint()
        save_ms = (time.perf_counter() - t0) * 1e3
        file_bytes = os.path.getsize(path)
        grant(svc_a, HA_MARGIN)
        # The crash seam fires in A's batcher, before the device step of
        # the one wire request: listener and connections die, no drain.
        with FaultInjector(seed=11) as inj:
            inj.arm("cluster.ha.leader.crash", "error", times=1)
            client = ClusterTokenClient(
                "127.0.0.1", a.state.token_server.bound_port,
                request_timeout_s=2.0, health_gate=None).start()
            try:
                deadline = time.perf_counter() + 5
                while not client.is_connected() \
                        and time.perf_counter() < deadline:
                    time.sleep(0.01)
                crash_reply = int(client.request_token(HA_FLOWS[0]).status)
            finally:
                client.stop()
        if not a.state.token_server.crashed \
                or crash_reply != TokenResultStatus.FAIL:
            raise AssertionError(f"ha failover: crash seam did not fire "
                                 f"(reply {crash_reply})")
        m2 = ha.ClusterMap(epoch=2, servers=(specs[1], specs[0], specs[2]),
                           clients=("X",))
        t0 = time.perf_counter()
        seats["B"].apply_map(m2)
        promote_ms = (time.perf_counter() - t0) * 1e3
        for mid in ("A", "C"):
            seats[mid].apply_map(m2)
        b = seats["B"]
        if b.state.mode != CLUSTER_SERVER or b.rows_restored != len(HA_FLOWS):
            raise AssertionError(f"ha failover: B mode {b.state.mode}, "
                                 f"{b.rows_restored} rows restored")
        got = grant(b.state.token_server.service, HA_THRESHOLD)
        post = {f: sum(1 for i, r in enumerate(got)
                       if r.status == 0 and HA_FLOWS[i // HA_THRESHOLD] == f)
                for f in HA_FLOWS}
        across = {f: HA_BEFORE + HA_MARGIN + post[f] for f in HA_FLOWS}
        if set(across.values()) != {HA_THRESHOLD + HA_MARGIN}:
            raise AssertionError(f"ha failover: grants across the handoff "
                                 f"{across}, want threshold {HA_THRESHOLD}"
                                 f" + margin {HA_MARGIN}")
        restore_ms = []
        for _ in range(3):
            fresh = DefaultTokenService(rules=b.state.server_rules(),
                                        device=dev)
            fresh._ensure_compiled()
            t0 = time.perf_counter()
            ckpt.restore_cluster_checkpoint(fresh, path)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        journal = b.engine.journal.tail(limit=100)
        flip = [r for r in journal if r["kind"] == "haRoleFlip"][-1]
        apply = [r for r in journal if r["kind"] == "clusterMapApply"][-1]
        if flip["causeSeq"] != apply["seq"] or flip["role"] != "SERVER":
            raise AssertionError(f"ha failover: journal {journal}")
        return {
            "verdicts": verdicts,
            "out": {"rows_restored": b.rows_restored,
                    "grants_across_handoff": across[HA_FLOWS[0]],
                    "threshold": HA_THRESHOLD, "margin": HA_MARGIN,
                    "promote_ms": promote_ms, "save_ms": save_ms,
                    "restore_ms": sorted(restore_ms)[1],
                    "file_bytes": file_bytes,
                    "journal": [r["kind"] for r in journal]}}
    finally:
        for seat in seats.values():
            seat.stop()
        time_util.unfreeze_time()


def ha_mesh(dev):
    """BENCH_19's shard_mesh on loopback (3 leaders, 64 slices, 66
    connections, 256 requests in flight on each) with the rebalance drill
    on it: two windows at the even split; a map push to the drill's skew
    (A owning 0-31) with the servers re-seated before the clients route
    (WRONG_SLICE answers) and the heal; ``propose`` -> ``certify``
    (seed 0, on the card and on the CPU) -> ``apply`` -> a window ->
    ``rollback``."""
    import socket as _socket

    from sentinel_tpu_torch.cluster import ha
    from sentinel_tpu_torch.cluster.constants import (
        MSG_FLOW,
        TokenResultStatus,
    )
    from sentinel_tpu_torch.cluster.rebalance import ShardRebalancer
    from sentinel_tpu_torch.cluster.rules import ClusterFlowRuleManager
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.sharding import (
        ShardMap,
        ShardState,
        slice_of,
    )
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.simulator.clock import SimClock
    from sentinel_tpu_torch.telemetry.journal import ControlPlaneJournal

    n = HA_SLICES
    fid_of_slice, fid = {}, 9000
    while len(fid_of_slice) < n:
        fid_of_slice.setdefault(slice_of(fid, n), fid)
        fid += 1
    rules = [_ha_rule(f, 1e9) for f in fid_of_slice.values()]
    even = tuple(HA_LEADERS[i % 3] for i in range(n))
    skew = tuple("A" if i < 32 else ("B" if i < 48 else "C")
                 for i in range(n))
    services, servers = {}, {}
    for mid in HA_LEADERS:
        mgr = ClusterFlowRuleManager()
        mgr.load_rules("default", list(rules))
        svc = DefaultTokenService(mgr, max_allowed_qps=1e12, device=dev)
        svc.set_shard(ShardState(n, 1, {sl: 1 for sl in range(n)
                                        if even[sl] == mid}))
        warm = next(fid_of_slice[sl] for sl in range(n) if even[sl] == mid)
        for w in (HA_INFLIGHT, 1024, 4096):
            svc.request_tokens([(warm, 1, False)] * w)
        services[mid] = svc
        servers[mid] = ClusterTokenServer(svc, host="127.0.0.1",
                                          port=0).start()
    specs = tuple(ha.ClusterServerSpec(m, "127.0.0.1",
                                       servers[m].bound_port)
                  for m in HA_LEADERS)
    cur = {"map": ShardMap(version=1, n_slices=n, servers=specs,
                           slice_owner=even, slice_epoch=(1,) * n)}
    owner_now = list(even)
    gen = [0]
    stop, paused = threading.Event(), threading.Event()
    n_threads = len(HA_LEADERS) * HA_THREADS_PER_LEADER
    replies = [0] * n_threads
    ok = [0] * n_threads
    wrong = [0] * n_threads
    statuses = [{} for _ in range(n_threads)]
    done_gen = [-1] * n_threads  # the routing of each thread's last burst
    errors = []
    barrier = threading.Barrier(n_threads + 1)

    def worker(tid):
        mid = HA_LEADERS[tid % 3]
        conns = []
        try:
            for _ in range(HA_CONNS_PER_THREAD):
                s = _socket.create_connection(
                    ("127.0.0.1", servers[mid].bound_port), timeout=10)
                s.settimeout(10)
                s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
                conns.append((s, ccodec.FrameReader()))
            my_gen, frames, expect = -1, b"", 0
            barrier.wait()
            while not stop.is_set():
                if paused.is_set():
                    time.sleep(0.005)
                    continue
                if my_gen != gen[0]:
                    my_gen = gen[0]
                    fids = [fid_of_slice[sl] for sl in range(n)
                            if owner_now[sl] == mid]
                    expect = max(1, round(HA_INFLIGHT * 3 * len(fids) / n))
                    frames = b"".join(
                        ccodec.encode_request(
                            x + 1, MSG_FLOW, ccodec.encode_flow_request(
                                fids[(tid * expect + x) % len(fids)], 1,
                                False))
                        for x in range(expect))
                for s, _ in conns:
                    s.sendall(frames)
                for s, reader in conns:
                    got = 0
                    while got < expect:
                        data = s.recv(65536)
                        if not data:
                            raise AssertionError("ha mesh: connection "
                                                 "closed")
                        for body in reader.feed(data):
                            status = ccodec.decode_response(body).status
                            got += 1
                            replies[tid] += 1
                            ok[tid] += status == 0
                            wrong[tid] += (status
                                           == TokenResultStatus.WRONG_SLICE)
                            statuses[tid][status] = \
                                statuses[tid].get(status, 0) + 1
                done_gen[tid] = my_gen
        except Exception as ex:  # noqa: BLE001 -- reported below
            errors.append(repr(ex))
            barrier.abort()
        finally:
            for s, _ in conns:
                s.close()

    def window(seconds):
        r0, w0 = list(replies), sum(wrong)
        t0 = time.perf_counter()
        time.sleep(seconds)
        dt = time.perf_counter() - t0
        by = [a - b for a, b in zip(replies, r0)]
        return {"acquires_per_s": sum(by) / dt,
                "per_leader_acquires_per_s": {
                    m: sum(by[t] for t in range(n_threads)
                           if HA_LEADERS[t % 3] == m) / dt
                    for m in HA_LEADERS},
                "wrong_slice": sum(wrong) - w0}

    def push(smap):
        """Re-seat the live shards, then (a lag later) route clients."""
        w0 = sum(wrong)
        for mid in HA_LEADERS:
            services[mid].set_shard(ShardState(
                n, smap.version, {sl: smap.slice_epoch[sl] for sl in range(n)
                                  if smap.slice_owner[sl] == mid}))
        cur["map"] = smap
        time.sleep(HA_ROUTE_LAG_S)
        for sl in range(n):
            owner_now[sl] = smap.slice_owner[sl]
        gen[0] += 1
        # Healed once every thread has finished a burst routed by the new
        # map: no frame of the old routing is left in flight.
        deadline = time.perf_counter() + 20
        while min(done_gen) < gen[0] and time.perf_counter() < deadline:
            time.sleep(0.01)
        healed = window(HA_HEAL_S)
        return {"wrong_slice": sum(wrong) - w0 - healed["wrong_slice"],
                "wrong_slice_after_heal": healed["wrong_slice"]}

    class _Seat:
        @property
        def shard_map(self):
            return cur["map"]

        def transition_pending(self):
            return False

    clock = SimClock(NOW0)

    class _Fleet:
        """Uniform offered load per slice: what the workers send."""

        def settled_through_ms(self):
            return clock.now_ms() - 1000

        def status(self):
            return {"leaders": {m: {"stale": False, "epochRegressed": False}
                                for m in HA_LEADERS}}

        def slice_loads(self, flow_of, n_slices, window_seconds=None,
                        settled_only=True):
            return {"nSlices": n_slices, "seconds": 4,
                    "settledThroughMs": self.settled_through_ms(),
                    "slices": {sl: 1000 for sl in range(n_slices)},
                    "observedByLeader": {}, "unattributed": 0}

    def rebalancer(device):
        return ShardRebalancer(
            ha=_Seat(), fleet=_Fleet(),
            journal=ControlPlaneJournal(clock.now_ms, path=None),
            flow_of=lambda r: None, clock=clock.now_ms, apply_via=push_plan,
            device=device)

    pushes = []

    def push_plan(smap):
        pushes.append(push(smap))

    out = {"leaders": len(HA_LEADERS), "n_slices": n,
           "connections": n_threads * HA_CONNS_PER_THREAD,
           "pipelined_per_conn": HA_INFLIGHT}
    zero_cluster_counts()
    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        barrier.wait(timeout=60)
        time.sleep(HA_SETTLE_S)
        wins = [window(HA_WINDOW_S), window(HA_WINDOW_S)]
        out["windows"] = wins
        best = max(wins, key=lambda w: w["acquires_per_s"])
        out["acquires_per_s"] = best["acquires_per_s"]
        out["per_leader_acquires_per_s"] = best["per_leader_acquires_per_s"]
        if any(w["wrong_slice"] for w in wins):
            raise AssertionError(f"ha mesh: WRONG_SLICE on a settled map: "
                                 f"{wins}")
        # The drill's skewed placement, as a map push.
        skew_map = cur["map"].with_moves(
            {sl: skew[sl] for sl in range(n)})
        out["skew_push"] = push(skew_map)
        paused.set()
        rb = rebalancer(dev)
        proposed = rb.propose()
        if not proposed.get("ok"):
            raise AssertionError(f"ha drill: propose vetoed {proposed}")
        pid = proposed["plan"]["planId"]
        plan = rb.plans[pid]
        moves = {sl: f"{a}->{b}" for sl, (a, b) in plan.moves.items()}
        t0 = time.perf_counter()
        cert = rb.certify(pid, campaign_seed=0)
        certify_s = time.perf_counter() - t0
        rb_cpu = rebalancer(torch.device("cpu"))
        cert_cpu = rb_cpu.certify(rb_cpu.propose()["plan"]["planId"],
                                  campaign_seed=0)
        paused.clear()
        if not cert["ok"] or moves != HA_DRILL_MOVES:
            raise AssertionError(f"ha drill: moves {moves}, cert {cert}")
        shas = (cert["cert"]["verdictSha256"], cert["cert"]["faultSha256"])
        if shas != (cert_cpu["cert"]["verdictSha256"],
                    cert_cpu["cert"]["faultSha256"]) \
                or shas[0] != HA_DRILL_VERDICT:
            raise AssertionError(f"ha drill: certify sha card {shas}, cpu "
                                 f"{cert_cpu['cert']['verdictSha256']}")
        applied = rb.apply(pid)
        if not applied.get("ok"):
            raise AssertionError(f"ha drill: apply vetoed {applied}")
        after = window(HA_WINDOW_S)
        chain = [r["kind"] for r in rb._journal().chain(applied["applySeq"])]
        if chain[:3] != ["rebalanceApply", "rebalanceCertify",
                         "rebalancePropose"]:
            raise AssertionError(f"ha drill: journal chain {chain}")
        skew_after = rb.sense()["skew"]
        rolled = rb.rollback()
        if not rolled.get("ok") or cur["map"].slice_owner != skew:
            raise AssertionError(f"ha drill: rollback {rolled}")
        out["drill"] = {
            "moves": moves, "slices_moved": len(moves),
            "skew_before": plan.skew_before, "skew_after": skew_after,
            "certified": True, "certify_seed": cert["cert"]["seed"],
            "certify_verdict_sha256": shas[0],
            "certify_fault_sha256": shas[1],
            "certify_card_equals_cpu": True,
            "certify_s": certify_s,
            "handoff_margin_grants": cert["cert"]["handoffMarginGrants"],
            "journal_chain": chain,
            "apply_push": pushes[0], "rollback_push": pushes[1],
            "acquires_per_s_after_move": after["acquires_per_s"],
            "per_leader_after_move": after["per_leader_acquires_per_s"]}
        for p in [out["skew_push"]] + pushes:
            if p["wrong_slice"] <= 0 or p["wrong_slice_after_heal"] != 0:
                raise AssertionError(f"ha mesh: push {p}: no WRONG_SLICE "
                                     "in the lag, or not healed after")
    finally:
        stop.set()
        paused.clear()
        for t in threads:
            t.join(timeout=30)
        for srv in servers.values():
            srv.stop()
    counts = read_cluster_counts()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"ha mesh workers failed: {errors}")
    by_status = {}
    for d in statuses:
        for k, v in d.items():
            by_status[int(k)] = by_status.get(int(k), 0) + v
    out["replies"] = sum(replies)
    out["ok_replies"] = sum(ok)
    out["wrong_slice_replies"] = sum(wrong)
    # The leaders' admission queues may shed a burst that waited past
    # their deadline: OVERLOADED, the server's documented overload reply.
    out["overloaded_replies"] = by_status.get(
        int(TokenResultStatus.OVERLOADED), 0)
    out["replies_by_status"] = {str(k): v for k, v
                                in sorted(by_status.items())}
    if set(by_status) - {0, int(TokenResultStatus.WRONG_SLICE),
                         int(TokenResultStatus.OVERLOADED)}:
        raise AssertionError(f"ha mesh: replies by status {by_status}")
    out["counts"] = counts
    return out


def ha_campaign(dev):
    """The chaos campaign (seed 14) on ``dev``: the first HA_EPISODES
    episodes; every episode's verdict and fault sha256s, and episodes/s."""
    from sentinel_tpu_torch.chaos.campaign import ChaosCampaign

    camp = ChaosCampaign(campaign_seed=HA_CAMPAIGN_SEED,
                         episodes=HA_EPISODES, device=dev)
    t0 = time.perf_counter()
    eps = [camp.run_episode(i) for i in range(HA_EPISODES)]
    wall = time.perf_counter() - t0
    return {"shas": [(e.verdict_sha256, e.fault_sha256) for e in eps],
            "violations": sum(len(e.violations) for e in eps),
            "ops": sum(e.ops for e in eps),
            "grants": sum(e.grants for e in eps),
            "episodes_per_s": len(eps) / wall, "wall_s": wall}


def ha_phase(dev):
    """The HA token cluster on the card: (1) failover with a cluster
    checkpoint, card and CPU; (2) the sharded mesh with (3) the rebalance
    drill on the card (its certification on card and CPU); (4) the chaos
    campaign's first episodes on card and CPU. Prints one ``{"ha": ...}``
    line; returns the acquire launches of the card's runs."""
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    mem0 = memory_mark()
    before = {t.ident for t in threading.enumerate()}
    out, parts = {}, {}
    cpu = torch.device("cpu")

    def part(name, fn, *args):
        t1 = time.perf_counter()
        result = fn(*args)
        parts[f"{name}_s"] = time.perf_counter() - t1
        return result

    zero_cluster_counts()
    card = part("failover_card", ha_failover, dev)
    fo_counts = read_cluster_counts()
    host = part("failover_cpu", ha_failover, cpu)
    if card["verdicts"] != host["verdicts"]:
        raise AssertionError("ha failover: card and CPU grants differ")
    out["failover"] = dict(card["out"], grants=len(card["verdicts"]),
                           card_equals_cpu=True,
                           cpu_promote_ms=host["out"]["promote_ms"])
    mesh = part("mesh", ha_mesh, dev)
    mesh_counts = mesh.pop("counts")
    out["mesh"] = mesh
    zero_cluster_counts()
    camp_card = part("campaign_card", ha_campaign, dev)
    camp_counts = read_cluster_counts()
    camp_cpu = part("campaign_cpu", ha_campaign, cpu)
    if camp_card["shas"] != camp_cpu["shas"] or camp_card["violations"] \
            or camp_cpu["violations"]:
        raise AssertionError("ha campaign: card and CPU episodes differ or "
                             "violate")
    out["campaign"] = {
        "seed": HA_CAMPAIGN_SEED, "episodes": HA_EPISODES,
        "violations": 0, "card_equals_cpu": True,
        "episode_shas": camp_card["shas"], "ops": camp_card["ops"],
        "grants": camp_card["grants"],
        "episodes_per_s": camp_card["episodes_per_s"],
        "cpu_episodes_per_s": camp_cpu["episodes_per_s"]}
    runs = {"failover": fo_counts, "mesh": mesh_counts,
            "campaign": camp_counts}
    if dev.type == "cuda":
        for run, c in runs.items():
            if c["acquire"] <= 0:
                raise AssertionError(f"ha {run} run launched the acquire "
                                     "kernel no time")
    by_width = {}
    for c in runs.values():
        for w, k in c["acquire_by_width"].items():
            by_width[w] = by_width.get(w, 0) + k
    out["acquire_launches"] = sum(c["acquire"] for c in runs.values())
    out["acquire_launches_by_run"] = {run: c["acquire"]
                                      for run, c in runs.items()}
    out["acquire_launches_by_width"] = {str(w): k for w, k
                                        in sorted(by_width.items())}
    alive = []
    deadline = time.perf_counter() + 5
    while time.perf_counter() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    if alive:
        raise AssertionError(f"ha: threads alive after the phase: {alive}")
    out["threads_left"] = 0
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"ha": out}), flush=True)
    if out["phase_s"] > HA_PHASE_LIMIT_S:
        raise AssertionError(f"ha phase took {out['phase_s']:.1f} s, over "
                             f"{HA_PHASE_LIMIT_S} s")
    return {"acquire": out["acquire_launches"],
            "acquire_by_width": out["acquire_launches_by_width"]}


# ---------------------------------------------------------------------------
# Phase 15: LLM admission and the trace-replay simulator
# ---------------------------------------------------------------------------

LLM_PHASE_LIMIT_S = 180.0
LLM_DIR = Path(__file__).resolve().parent / "smoke_logs" / "llm"
LLM_MODELS = 8                  # bench.py:700's models at 1e9 tokens/s
LLM_ACQUIRES = 6000             # mixed 1/4/16-token acquires
LLM_CYCLES = 400                # gateway cycles of 64 tokens
LLM_CUT_ACQUIRES = 600          # the card = CPU cut
LLM_CUT_CYCLES = 40
SIM_SECONDS = 600               # bench.py:551's replay: flash_crowd seed 7
SIM_SEED = 7
# The JAX package's replay and demo shas as it runs in this repository
# (ROADMAP C17).
SIM_ANCHOR = \
    "d0a27aec0ec0b6beb9b74a462d4371779988fbe33d9ada5319c524fa631bcba4"
DEMO_ANCHOR = \
    "478b073cd1254f6758e6c7841f65f4b84b962001a15bc0c0e65e20ddc17ed46a"


def zero_prefix_counts():
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()


def read_prefix_counts():
    if prefix_cuda.tile_launches:
        raise AssertionError(f"prefix kernel: {prefix_cuda.tile_launches} "
                             "tile-walk launches")
    return {"launches": prefix_cuda.launches,
            "by_shape": {f"K={k},N={n},M={m}": c for (k, n, m), c
                         in sorted(prefix_cuda.launches_by_shape.items())}}


def _fresh_llm_engine(dev, capacity=1024):
    from sentinel_tpu_torch.core import context as ctx_mod

    # A pooled context of an earlier engine on this thread holds that
    # engine's rows: retire it.
    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    return SentinelEngine(capacity=capacity, device=dev)


def llm_admission(dev, n_acquires, n_cycles):
    """bench.py:675-760's llm_admission shape on ``dev`` under the port's
    frozen clock: 8 models at 1e9 tokens/s, ``n_acquires`` mixed
    1/4/16-token acquires on the lowered ``llm:*`` resources, then
    ``n_cycles`` gateway cycles (open 64, the mock server's SSE ticks,
    close). Returns the rates, the admit latencies, and what the card =
    CPU check compares: every verdict, the ledger's stats and the
    engine's state."""
    from sentinel_tpu_torch.adapters.llm_gateway import (
        LLMGateway,
        MockInferenceServer,
    )
    from sentinel_tpu_torch.llm import TpsRule

    time_util.freeze_time(NOW0)
    eng = _fresh_llm_engine(dev)
    try:
        eng.tps_rules.load_rules([TpsRule(model=f"m{i}",
                                          tokens_per_second=1e9)
                                  for i in range(LLM_MODELS)])
        counts = (1, 4, 16)
        verdicts = []
        for i in range(64):  # warm the leased path
            eng.entry(f"llm:m{i % LLM_MODELS}", count=counts[i % 3]).exit()
        t0 = time.perf_counter()
        tokens = 0
        for i in range(n_acquires):
            c = counts[i % 3]
            try:
                eng.entry(f"llm:m{i % LLM_MODELS}", count=c).exit()
                verdicts.append(0)
            except st.BlockException as ex:
                verdicts.append(type(ex).__name__)
            tokens += c
        dt_entries = time.perf_counter() - t0
        eng._flush_committer()
        gw = LLMGateway(engine=eng, server=MockInferenceServer(seed=1))
        admit_us, streamed = [], 0
        t0 = time.perf_counter()
        for i in range(n_cycles):
            rid, model = f"bench-{i}", f"m{i % LLM_MODELS}"
            ta = time.perf_counter()
            lease = eng.stream_open(rid, model, 64)
            admit_us.append((time.perf_counter() - ta) * 1e6)
            verdicts.append(("open", lease.reserved, lease.debited))
            for line in gw.server.stream(rid, model, 64):
                if line.startswith("data: {"):
                    n = json.loads(line[len("data: "):])["tokens"]
                    verdicts.append(eng.stream_tick(rid, n))
                    streamed += n
            verdicts.append(eng.stream_close(rid))
        dt_streams = time.perf_counter() - t0
        stats = eng.streams.stats()
        eng._flush_committer()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        admit_us.sort()
        return {
            "verdicts": verdicts, "stats": stats,
            "state": convert.state_to_numpy(eng.state),
            "out": {
                "mixed_acquires_per_s": n_acquires / dt_entries,
                "mixed_acquire_tokens_per_s": tokens / dt_entries,
                "stream_cycles_per_s": n_cycles / dt_streams,
                "streamed_tokens_per_s": streamed / dt_streams,
                "admit_p50_us": admit_us[len(admit_us) // 2],
                "admit_p99_us": admit_us[int(0.99 * (len(admit_us) - 1))],
                "reconciliation_delta": stats["outstandingTokens"],
                "steps": eng.step_timer.snapshot()}}
    finally:
        eng.close()
        time_util.unfreeze_time()


def llm_checkpoint(dev, dst_dev=torch.device("cpu")):
    """Open reservations on a ``dev`` engine, saved and restored into a
    fresh ``dst_dev`` engine: the ledger rows, the windows and the
    leases' closes equal."""
    from sentinel_tpu_torch.core import checkpoint as ckpt
    from sentinel_tpu_torch.llm import TpsRule

    LLM_DIR.mkdir(parents=True, exist_ok=True)
    path = str(LLM_DIR / f"streams-{dev.type}.npz")
    rules = [TpsRule(model="m", tokens_per_second=200),
             TpsRule(model="n", tokens_per_second=50)]
    time_util.freeze_time(NOW0)
    src = _fresh_llm_engine(dev)
    try:
        src.tps_rules.load_rules(list(rules))
        src.stream_open("live", "m", 120)
        src.stream_tick("live", 30)
        src.stream_open("other", "n", 40)
        src.stream_tick("other", 45)
        rows = src.streams.checkpoint_rows()
        ckpt.save_checkpoint(src, path)
        src_state = convert.state_to_numpy(src.state)
    finally:
        src.close()
    dst = _fresh_llm_engine(dst_dev)
    try:
        dst.tps_rules.load_rules(list(rules))
        ckpt.restore_checkpoint(dst, path)
        got = dst.streams.checkpoint_rows()
        compare_states({k: src_state[k] for k in ("w1", "w60", "sec")},
                       {k: v for k, v in convert.state_to_numpy(
                           dst.state).items() if k in ("w1", "w60", "sec")})
        closes = [dst.stream_close("live"),
                  dst.stream_close("other", aborted=True)]
    finally:
        dst.close()
        time_util.unfreeze_time()
    if got != rows or closes != [90.0, 0.0]:
        raise AssertionError(f"llm checkpoint: rows {got} != {rows} or "
                             f"closes {closes}")
    return {"rows": len(rows), "file_bytes": os.path.getsize(path)}


def llm_wire(dev):
    """MSG_STREAM_TICK through both frontends against a ``dev`` engine:
    open, tick, close, a second open, a blocked third, an unknown
    stream's tick and abort, an unknown sub-op, a truncated entity, the
    second stream's abort. One frame at a time; the raw replies."""
    from sentinel_tpu_torch.cluster.constants import (
        MSG_STREAM_TICK,
        STREAM_OP_ABORT,
        STREAM_OP_CLOSE,
        STREAM_OP_OPEN,
        STREAM_OP_TICK,
    )
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.llm import TpsRule
    import socket as _socket

    enc = ccodec.encode_stream_request
    script = [enc(STREAM_OP_OPEN, "w1", "m", 60),
              enc(STREAM_OP_TICK, "w1", "", 25), enc(STREAM_OP_CLOSE, "w1"),
              enc(STREAM_OP_OPEN, "w2", "m", 60),
              enc(STREAM_OP_OPEN, "w3", "m", 60),
              enc(STREAM_OP_TICK, "ghost", "", 5),
              enc(STREAM_OP_ABORT, "ghost"), enc(9, "w2"), b"\x00\x03ab",
              enc(STREAM_OP_ABORT, "w2")]
    out = {}
    for reactor in (True, False):
        time_util.freeze_time(NOW0)
        eng = _fresh_llm_engine(dev)
        server = None
        try:
            eng.tps_rules.load_rules([TpsRule(model="m",
                                              tokens_per_second=100)])
            server = ClusterTokenServer(
                DefaultTokenService(device=dev), host="127.0.0.1", port=0,
                reactor=reactor, engine=eng).start()
            raw = []
            with _socket.create_connection(
                    ("127.0.0.1", server.bound_port), timeout=15) as sock:
                sock.settimeout(15)
                reader = ccodec.FrameReader()
                for xid, entity in enumerate(script, 1):
                    sock.sendall(ccodec.encode_request(
                        xid, MSG_STREAM_TICK, entity))
                    frames = []
                    while not frames:
                        data = sock.recv(65536)
                        if not data:
                            raise AssertionError("llm wire: closed")
                        frames = reader.feed(data)
                    raw.append(bytes(frames[0]).hex())
            out["reactor" if reactor else "socketserver"] = raw
        finally:
            if server is not None:
                server.stop()
            eng.close()
            time_util.unfreeze_time()
    if out["reactor"] != out["socketserver"]:
        raise AssertionError("llm wire: the two frontends answer apart")
    return out


class KeptReplay(ReplayEngine):
    """A ``ReplayEngine`` that keeps its engine and counts its steps: the
    batch API it drives is not timed by the engine's step timer (as in
    the reference), so each ``check_batch`` / ``complete_batch`` call's
    host wall is taken here, by kind."""

    def _build_engine(self, clock):
        self.eng = eng = super()._build_engine(clock)
        self.step_ms = {"entry": [], "exit": []}
        for kind, name in (("entry", "check_batch"),
                           ("exit", "complete_batch")):
            fn, walls = getattr(eng, name), self.step_ms[kind]

            def timed(*args, _fn=fn, _walls=walls, **kw):
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                _walls.append((time.perf_counter() - t0) * 1e3)
                return out
            setattr(eng, name, timed)
        return eng


def sim_replay(dev):
    """bench.py:551's replay (flash_crowd, 600 s, seed 7) at the main
    path's 32,768 rows on ``dev``, ladder widths warmed first."""
    from sentinel_tpu_torch.simulator import build_scenario

    trace = build_scenario("flash_crowd", seconds=SIM_SECONDS, seed=SIM_SEED)
    rep = KeptReplay(trace, capacity=CAPACITY, device=dev)
    r = rep.run(warmup=True)
    return {"verdict_sha256": r.verdict_sha256, "series": r.series,
            "offered": r.offered, "passed": r.passed,
            "blocked": r.blocked, "rt_hist": list(r.rt_hist),
            "out": {"trace_seconds": r.seconds,
                    "replay_wall_s": r.replay_wall_s,
                    "total_wall_s": r.total_wall_s,
                    "trace_s_per_wall_s": r.seconds / r.replay_wall_s,
                    "steps": {k: len(v) for k, v in rep.step_ms.items()},
                    "step_p50_ms": {k: pct(v, 50) if v else None
                                    for k, v in rep.step_ms.items()}}}


def llm_phase(dev):
    """LLM admission and the trace-replay simulator on the card, each
    part against the same machine's CPU: (1) bench.py's llm_admission
    shape, and its frozen-clock cut card = CPU; (2) the 600-second
    flash_crowd replay at 32,768 rows; (3) ``run_demo(60, 0)``; (4) a
    save with open reservations restored on the CPU; (5)
    ``MSG_STREAM_TICK`` through both frontends. Prints one ``{"llm": ...}``
    line; returns the prefix launches of the card's llm and sim paths."""
    from sentinel_tpu_torch.adapters.llm_gateway import run_demo

    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    mem0 = memory_mark()
    before = {t.ident for t in threading.enumerate()}
    cpu = torch.device("cpu")
    out, parts, llm_runs, sim_runs = {}, {}, {}, {}

    def part(name, fn, *args):
        t1 = time.perf_counter()
        result = fn(*args)
        parts[f"{name}_s"] = time.perf_counter() - t1
        return result

    zero_prefix_counts()
    bench = part("admission_card", llm_admission, dev, LLM_ACQUIRES,
                 LLM_CYCLES)
    llm_runs["admission"] = read_prefix_counts()
    if bench["out"]["reconciliation_delta"] != 0:
        raise AssertionError("llm admission: reservation tokens neither "
                             "streamed nor released")
    zero_prefix_counts()
    cut_card = part("cut_card", llm_admission, dev, LLM_CUT_ACQUIRES,
                    LLM_CUT_CYCLES)
    llm_runs["cut"] = read_prefix_counts()
    cut_cpu = part("cut_cpu", llm_admission, cpu, LLM_CUT_ACQUIRES,
                   LLM_CUT_CYCLES)
    if cut_card["verdicts"] != cut_cpu["verdicts"] \
            or cut_card["stats"] != cut_cpu["stats"]:
        raise AssertionError("llm admission cut: card and CPU differ")
    compare_states(cut_card["state"], cut_cpu["state"], "llm.cut")
    out["admission"] = dict(bench["out"], models=LLM_MODELS,
                            acquires=LLM_ACQUIRES, cycles=LLM_CYCLES,
                            cut={"acquires": LLM_CUT_ACQUIRES,
                                 "cycles": LLM_CUT_CYCLES,
                                 "card_equals_cpu": True,
                                 "cpu_mixed_acquires_per_s": cut_cpu["out"][
                                     "mixed_acquires_per_s"]})

    zero_prefix_counts()
    rep_card = part("replay_card", sim_replay, dev)
    sim_runs["replay"] = read_prefix_counts()
    rep_cpu = part("replay_cpu", sim_replay, cpu)
    same = {k: rep_card[k] == rep_cpu[k] for k in (
        "verdict_sha256", "series", "offered", "passed", "blocked",
        "rt_hist")}
    if not all(same.values()):
        raise AssertionError(f"sim replay: card and CPU differ: {same}")
    out["replay"] = dict(
        rep_card["out"], scenario="flash_crowd", seed=SIM_SEED,
        capacity=CAPACITY, verdict_sha256=rep_card["verdict_sha256"],
        anchor_sha256=SIM_ANCHOR,
        matches_anchor=rep_card["verdict_sha256"] == SIM_ANCHOR,
        offered=rep_card["offered"], passed=rep_card["passed"],
        card_equals_cpu=True,
        cpu_trace_s_per_wall_s=rep_cpu["out"]["trace_s_per_wall_s"],
        cpu_replay_wall_s=rep_cpu["out"]["replay_wall_s"])

    zero_prefix_counts()
    demo_card = part("demo_card", run_demo, 60, 0, 0.4, 0.2, dev)
    sim_runs["demo"] = read_prefix_counts()
    demo_cpu = part("demo_cpu", run_demo, 60, 0, 0.4, 0.2, cpu)
    for key in ("verdictSha256", "objective", "streams", "finalCounts",
                "tpsPromotes"):
        if demo_card[key] != demo_cpu[key]:
            raise AssertionError(f"llm demo: {key} card {demo_card[key]} "
                                 f"cpu {demo_cpu[key]}")
    if not demo_card["ledgerDrained"] or demo_card["silentDrops"] \
            or demo_card["tpsPromotes"] < 1:
        raise AssertionError(f"llm demo: {demo_card}")
    out["demo"] = dict(demo_card, anchor_sha256=DEMO_ANCHOR,
                       matches_anchor=demo_card["verdictSha256"]
                       == DEMO_ANCHOR, card_equals_cpu=True)

    zero_prefix_counts()
    out["checkpoint"] = dict(part("checkpoint", llm_checkpoint, dev),
                             card_to_cpu_rows_equal=True)
    llm_runs["checkpoint"] = read_prefix_counts()
    zero_prefix_counts()
    wire_card = part("wire_card", llm_wire, dev)
    llm_runs["wire"] = read_prefix_counts()
    wire_cpu = part("wire_cpu", llm_wire, cpu)
    if wire_card != wire_cpu:
        raise AssertionError("llm wire: card and CPU replies differ")
    out["wire"] = {"frames": len(wire_card["reactor"]),
                   "card_equals_cpu": True, "frontends_equal": True}

    def total(runs):
        by = {}
        for c in runs.values():
            for s, k in c["by_shape"].items():
                by[s] = by.get(s, 0) + k
        return {"launches": sum(c["launches"] for c in runs.values()),
                "by_shape": dict(sorted(by.items())), "by_run": runs}

    llm_total, sim_total = total(llm_runs), total(sim_runs)
    if dev.type == "cuda":
        for run, c in list(llm_runs.items()) + list(sim_runs.items()):
            if run != "checkpoint" and c["launches"] <= 0:
                raise AssertionError(f"llm {run} run launched the prefix "
                                     "kernel no time")
    out["prefix_launches"] = {"llm": llm_total, "sim": sim_total}
    alive = []
    deadline = time.perf_counter() + 5
    while time.perf_counter() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    if alive:
        raise AssertionError(f"llm: threads alive after the phase: {alive}")
    out["threads_left"] = 0
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"llm": out}), flush=True)
    if out["phase_s"] > LLM_PHASE_LIMIT_S:
        raise AssertionError(f"llm phase took {out['phase_s']:.1f} s, over "
                             f"{LLM_PHASE_LIMIT_S} s")
    return {"llm": llm_total, "sim": sim_total}


# ---------------------------------------------------------------------------
# Phase 16: rule datasources
# ---------------------------------------------------------------------------


DS_PHASE_LIMIT_S = 90.0
DS_DIR = Path(__file__).resolve().parent / "smoke_logs" / "datasource"
DS_WIDTH = 8192
DS_PUSHES = 5                  # timed pushes a connector, tight / full
DS_REFRESH_MS = 100            # poll connectors: cut from the reference's 3,000
DS_TIGHT = tuple(f"res{i}" for i in range(0, N_RESOURCES, 630))  # 16
DS_TIGHT_COUNT = 5
DS_TIGHT_LANES = 16            # lanes a tightened resource gets a step
DS_CONNECTORS = ("file", "http", "eureka", "spring", "nacos", "consul",
                 "apollo", "redis", "zookeeper", "etcd", "push", "polling")
DS_STANDALONE_REFRESH_MS = 200
DS_HA_THRESHOLD = 10           # a second's quota of the HA seats' flow
DS_HA_BEFORE = 4               # grants before leader A's publish
DS_HA_MARGIN = 2               # grants after it: B's warm start lacks them


def ds_documents():
    """The headline's flow rules (``bench.py:42-89``: count 1e9 on every
    10th resource) as one JSON document, and the same document with the
    16 ``DS_TIGHT`` resources tightened to 5 a second."""
    from sentinel_tpu_torch.datasource import converters as CV

    full = [F.FlowRule(resource=f"res{i}", count=1e9)
            for i in range(0, N_RESOURCES, 10)]
    tight = [F.FlowRule(resource=r.resource, count=DS_TIGHT_COUNT)
             if r.resource in DS_TIGHT else r for r in full]
    return CV.flow_rules_to_json(full), CV.flow_rules_to_json(tight)


def ds_engine(dev, default: bool):
    """The main path's engine kind without its flow rules (those arrive
    through a connector): the default engine (``st.reset``) on ``dev`` or
    a plain engine, the 10,000 rows interned in the same order on both."""
    if default:
        eng = st.reset(capacity=CAPACITY, device=dev)
    else:
        eng = SentinelEngine(capacity=CAPACITY, device=dev)
    reg = eng.registry
    ent = reg.entrance_row(CTX)
    cluster = np.array([reg.cluster_row(f"res{i}")
                        for i in range(N_RESOURCES)], np.int32)
    dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                   for i in range(N_RESOURCES)], np.int32)
    origin_a = reg.origin_id("appA")
    eng.degrade_rules.load_rules([
        D.DegradeRule(resource=f"res{i}", count=100, grade=i % 3,
                      time_window=10, min_request_amount=5)
        for i in range(0, N_RESOURCES, 20)])
    eng.param_rules.load_rules([P.ParamFlowRule(f"res{i}", param_idx=0,
                                                count=1e9)
                                for i in range(0, N_RESOURCES, 40)])
    eng.system_rules.load_rules([Y.SystemRule(qps=1e12)])
    return eng, cluster, dn, origin_a


def ds_connector(name):
    """One connector's in-repo fake server on loopback: (publish(text),
    make() -> a started connector reading it, stop()). Poll connectors
    run at ``DS_REFRESH_MS``; long polls park at most 300-400 ms, so
    ``close()`` joins inside the reference's 1-2 s."""
    from sentinel_tpu_torch import datasource as DS
    from sentinel_tpu_torch.datasource import converters as CV

    conv = CV.flow_rules_from_json
    R = DS_REFRESH_MS
    if name == "file":
        path = DS_DIR / "flow-rules.json"
        tick = [0]

        def publish(text):
            tmp = path.with_suffix(".w")
            tmp.write_text(text)
            os.replace(tmp, path)
            tick[0] += 1  # a distinct mtime for every rewrite
            os.utime(path, (1_600_000_000 + tick[0],) * 2)

        return publish, lambda: DS.FileRefreshableDataSource(
            str(path), conv, recommend_refresh_ms=R).start(), lambda: None
    if name == "http":
        srv = DS.MiniConfigHTTPServer().start()
        return srv.set_document, lambda: DS.HttpRefreshableDataSource(
            srv.url, conv, recommend_refresh_ms=R).start(), srv.stop
    if name == "eureka":
        srv = DS.MiniEurekaServer().start()
        return (lambda text: srv.register("smoke", "i-1",
                                          {"sentinel.flow.rules": text}),
                lambda: DS.EurekaDataSource(
                    [srv.service_url], "smoke", "i-1", "sentinel.flow.rules",
                    conv, recommend_refresh_ms=R).start(), srv.stop)
    if name == "spring":
        srv = DS.MiniSpringConfigServer().start()
        return (lambda text: srv.set_property("smoke", "sentinel.flow.rules",
                                              text),
                lambda: DS.SpringCloudConfigDataSource(
                    srv.addr, "smoke", "sentinel.flow.rules", conv,
                    recommend_refresh_ms=R).start(), srv.stop)
    if name == "nacos":
        srv = DS.MiniNacosServer(max_hold_ms=400).start()
        return (lambda text: srv.publish("sentinel-flow", "DEFAULT_GROUP",
                                         text),
                lambda: DS.NacosDataSource(
                    srv.addr, "sentinel-flow", "DEFAULT_GROUP", conv,
                    poll_timeout_ms=300).start(), srv.stop)
    if name == "consul":
        srv = DS.MiniConsulServer(max_hold_ms=400).start()
        return (lambda text: srv.put("sentinel/flow", text),
                lambda: DS.ConsulDataSource(srv.addr, "sentinel/flow", conv,
                                            wait="300ms").start(), srv.stop)
    if name == "apollo":
        srv = DS.MiniApolloServer(max_hold_ms=400).start()
        return (lambda text: srv.publish("smoke", "application",
                                         "flowRules", text),
                lambda: DS.ApolloDataSource(
                    srv.addr, "smoke", "application", "flowRules", conv,
                    poll_timeout_ms=400).start(), srv.stop)
    if name == "redis":
        from sentinel_tpu_torch.datasource.redis import RespConnection

        srv = DS.MiniRedisServer().start()

        def publish(text):
            conn = RespConnection("127.0.0.1", srv.port)
            try:
                conn.command("SET", "rules/flow", text)
                conn.command("PUBLISH", "rules/flow:chan", text)
            finally:
                conn.close()

        return publish, lambda: DS.RedisDataSource(
            "127.0.0.1", srv.port, "rules/flow", "rules/flow:chan",
            conv).start(), srv.stop
    if name == "zookeeper":
        srv = DS.MiniZooKeeperServer().start()
        return (lambda text: srv.set_node("/sentinel/flow", text.encode()),
                lambda: DS.ZookeeperDataSource(
                    f"127.0.0.1:{srv.port}", "/sentinel/flow", conv).start(),
                srv.stop)
    if name == "etcd":
        srv = DS.MiniEtcdServer().start()
        return (lambda text: srv.put("/sentinel/flow", text),
                lambda: DS.EtcdDataSource(srv.endpoint, "/sentinel/flow",
                                          conv).start(), srv.stop)
    if name == "push":
        broker = DS.InProcessBroker()
        return (lambda text: broker.set("rules/flow", text),
                lambda: DS.BrokerDataSource(broker, "rules/flow", conv),
                lambda: None)
    if name == "polling":
        broker = DS.InProcessBroker()
        return (lambda text: broker.set("rules/flow", text),
                lambda: DS.PollingKVDataSource(
                    broker, "rules/flow", conv,
                    recommend_refresh_ms=R).start(), lambda: None)
    raise ValueError(name)


def ds_batch(step, cluster, dn, origin_a, tight_rows):
    """One seeded width-8192 batch: ``DS_TIGHT_LANES`` lanes on each
    tightened resource, the rest over the 10,000 resources."""
    rng = np.random.default_rng(100 + step)
    buf = entry_buf(rng, DS_WIDTH, cluster, dn, origin_a)
    k = len(DS_TIGHT) * DS_TIGHT_LANES
    buf["cluster_row"][:k] = np.repeat(cluster[tight_rows], DS_TIGHT_LANES)
    buf["dn_row"][:k] = np.repeat(dn[tight_rows], DS_TIGHT_LANES)
    return buf


def ds_holds(eng, count) -> bool:
    """Whether ``eng``'s flow rules are the pushed document whose
    ``DS_TIGHT`` resources have ``count`` (the rules list is swapped
    wholesale by a push, so one rule tells the document)."""
    rules = eng.flow_rules.get_rules()
    return (len(rules) == N_RESOURCES // 10 and rules[0].resource == "res0"
            and rules[0].count == count)


def ds_wait(pred, what, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    while not pred():
        if time.perf_counter() > deadline:
            raise AssertionError(f"datasource: {what} not seen in "
                                 f"{timeout_s} s")
        time.sleep(0.0005)


def ds_pushes(dev, card, twin, docs, rows):
    """Every connector bound to ``st.load_flow_rules`` (the card's
    default engine) and, through a second connector of the same server,
    to the CPU twin's manager: the full document at start, then
    ``DS_PUSHES`` timed pushes alternating tight and full. After each,
    the first step on the card enforces it: the tightened resources
    admit exactly 5 a second, the others all, and the CPU twin's
    verdicts on the same batch are equal."""
    from sentinel_tpu_torch.datasource import bind

    cluster, dn, origin_a = rows
    tight_rows = np.array([int(r[3:]) for r in DS_TIGHT])
    out, launches = {}, {}
    have_etcd = True
    try:
        import grpc  # noqa: F401
        from sentinel_tpu_torch.datasource import etcd  # noqa: F401
    except ImportError:
        have_etcd = False
    step = [0]

    def run(eng, batch, dev_):
        dec = eng.check_batch(to_device(batch, dev_),
                              now_ms=time_util.current_time_millis())
        reason = eng.harvest_decisions(dec)[0]
        if dev_.type == "cuda":
            torch.cuda.synchronize()
        return np.asarray(reason)

    def check(doc_count, name):
        """The card's step, then the twin's; returns the card step's ms."""
        time_util.advance_time(1000)  # a fresh second for every push
        batch = ds_batch(step[0], cluster, dn, origin_a, tight_rows)
        step[0] += 1
        t0 = time.perf_counter()
        reason = run(card, batch, dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        ds_wait(lambda: ds_holds(twin, doc_count), f"{name} on the CPU twin")
        cpu_reason = run(twin, batch, torch.device("cpu"))
        if not np.array_equal(reason, cpu_reason):
            raise AssertionError(f"datasource {name}: card and CPU verdicts "
                                 "differ")
        for i, row in enumerate(tight_rows):
            hit = batch["cluster_row"] == cluster[row]
            admitted = int((reason[hit] == 0).sum())
            want = (DS_TIGHT_COUNT if doc_count == DS_TIGHT_COUNT
                    else int(hit.sum()))
            if admitted != want:
                raise AssertionError(f"datasource {name}: {DS_TIGHT[i]} "
                                     f"admitted {admitted}, not {want}")
        return step_ms

    for name in DS_CONNECTORS:
        if name == "etcd" and not have_etcd:
            out[name] = {"skipped": "no grpc / protobuf on this machine"}
            continue
        publish, make, stop = ds_connector(name)
        publish(docs[0])
        sources = [make(), make()]
        try:
            bind(sources[0], st.load_flow_rules)
            bind(sources[1], twin.flow_rules.load_rules)
            ds_wait(lambda: ds_holds(card, 1e9), f"{name}'s first load")
            check(1e9, name)  # the initial load's step, not timed
            zero_prefix_counts()
            pushes = []
            for k in range(DS_PUSHES):
                count = DS_TIGHT_COUNT if k % 2 == 0 else 1e9
                t0 = time.perf_counter()
                publish(docs[0 if count == 1e9 else 1])
                ds_wait(lambda: ds_holds(card, count), f"{name} push {k}")
                t_seen = time.perf_counter()
                step_ms = check(count, name)
                pushes.append({"seen_ms": (t_seen - t0) * 1e3,
                               "step_ms": step_ms,
                               "push_to_enforce_ms":
                                   (t_seen - t0) * 1e3 + step_ms})
            launches[name] = read_prefix_counts()
        finally:
            for src in sources:
                src.close()
            stop()
        e2e = sorted(p["push_to_enforce_ms"] for p in pushes)
        out[name] = {
            "push_to_enforce_ms_p50": e2e[len(e2e) // 2],
            "push_to_enforce_ms_max": e2e[-1],
            "seen_ms_p50": sorted(p["seen_ms"] for p in pushes)[
                len(pushes) // 2],
            "recompile_step_ms_p50": sorted(p["step_ms"] for p in pushes)[
                len(pushes) // 2],
            "prefix_launches": launches[name]["launches"],
            "prefix_by_shape": launches[name]["by_shape"],
            "card_equals_cpu": True}
        if dev.type == "cuda" and launches[name]["launches"] <= 0:
            raise AssertionError(f"datasource {name}: the pushes' steps "
                                 "launched the prefix kernel no time")
    return out, launches, have_etcd


def ds_standalone_run(dev, path):
    """``StandaloneTokenServer(device=dev)`` fed from ``path`` (two
    namespaces, polled every 200 ms), answering a ``ClusterTokenClient``
    through the wire on the port's frozen clock; the file rewritten
    mid-run (``ns-a``'s count 3 -> 5, ``ns-b`` removed). Returns every
    TokenResult as (status, remaining, wait_ms, epoch)."""
    from sentinel_tpu_torch.cluster.__main__ import StandaloneTokenServer
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient

    v1, v2 = ds_standalone_rules()
    path.write_text(json.dumps(v1))
    time_util.freeze_time(NOW0)
    srv = StandaloneTokenServer(port=0, host="127.0.0.1",
                                rules_path=str(path),
                                refresh_ms=DS_STANDALONE_REFRESH_MS,
                                device=dev).start()
    client = ClusterTokenClient("127.0.0.1", srv.bound_port, "ns-a").start()
    out = []
    try:
        ds_wait(client.is_connected, "the standalone client's connection")

        def tr(flow_id):
            r = client.request_token(flow_id)
            out.append((int(r.status), int(r.remaining), int(r.wait_ms),
                        None if r.epoch is None else int(r.epoch)))

        for _ in range(4):
            tr(900)
        tr(901)
        path.write_text(json.dumps(v2))
        os.utime(path, (1_600_000_100,) * 2)
        rules = srv.service.rules
        ds_wait(lambda: not rules.get_rules("ns-b")
                and rules.get_rules("ns-a")[0].count == 5,
                "the standalone rules file's edit")
        tr(901)
        time_util.advance_time(1100)
        for _ in range(6):
            tr(900)
    finally:
        client.stop()
        srv.stop()
        time_util.unfreeze_time()
    return out


def ds_free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for sock in socks:
        sock.bind(("127.0.0.1", 0))
    ports = [sock.getsockname()[1] for sock in socks]
    for sock in socks:
        sock.close()
    return ports


def ds_standalone_rules():
    def rule(res, count, flow_id):
        return {"resource": res, "count": count, "clusterMode": True,
                "clusterConfig": {"flowId": flow_id, "thresholdType": 1}}

    v1 = {"ns-a": [rule("getUser", 3, 900)], "ns-b": [rule("getItem", 1, 901)]}
    v2 = {"ns-a": [rule("getUser", 5, 900)]}
    return v1, v2


def ds_module_entry(dev, path):
    """``python -m sentinel_tpu_torch.cluster --rules <file> --port <free>``
    once, with no ``--device`` on the card (it serves from ``cuda`` by
    default): its listening line, one OK acquire."""
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.cluster.constants import TokenResultStatus

    path.write_text(json.dumps(ds_standalone_rules()[0]))
    port = ds_free_ports(1)[0]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sentinel_tpu_torch.cluster", "--rules",
         str(path), "--port", str(port), "--host", "127.0.0.1"]
        + ([] if dev.type == "cuda" else ["--device", dev.type]),
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    client = None
    try:
        lines = []
        reader = threading.Thread(
            target=lambda: lines.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=60)
        if not lines or "listening" not in lines[0]:
            raise AssertionError("python -m sentinel_tpu_torch.cluster: no "
                                 f"listening line ({lines}, rc "
                                 f"{proc.poll()})")
        listening_s = time.perf_counter() - t0
        client = ClusterTokenClient("127.0.0.1", port, "ns-a",
                                    request_timeout_s=5.0).start()
        ds_wait(client.is_connected, "the module server's connection")
        r = client.request_token(900)
        if r.status != TokenResultStatus.OK:
            raise AssertionError(f"the module server answered {r.status}")
        return {"listening_line": lines[0].strip(),
                "listening_s": listening_s, "acquire": "OK"}
    finally:
        if client is not None:
            client.stop()
        proc.terminate()
        proc.communicate(timeout=30)


def ds_ha_run(dev):
    """Two ``StandaloneHAParticipant`` seats on ``dev`` with the map-file
    flip of tests/test_cluster_ha.py:730: A leads epoch 1 and grants
    ``DS_HA_BEFORE``, publishes its checkpoint, grants ``DS_HA_MARGIN``
    more; the map file names B leader at epoch 2, B applies it first
    (restoring A's published rows), then A. Every flow grant across the
    handoff must total the threshold plus the margin."""
    from sentinel_tpu_torch.cluster.__main__ import StandaloneHAParticipant
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.cluster.constants import TokenResultStatus

    tag = dev.type
    ck = DS_DIR / f"ha-{tag}.npz"
    ck.unlink(missing_ok=True)
    map_path, rules_path = DS_DIR / f"ha-map-{tag}.json", \
        DS_DIR / f"ha-rules-{tag}.json"
    rules_path.write_text(json.dumps({"default": [{
        "resource": "r", "count": DS_HA_THRESHOLD, "clusterMode": True,
        "clusterConfig": {"flowId": 810, "thresholdType": 1}}]}))
    pa, pb = ds_free_ports(2)

    def servers(epoch, leader=None):
        doc = {"epoch": epoch,
               "servers": [{"machineId": "A", "host": "127.0.0.1",
                            "port": pa},
                           {"machineId": "B", "host": "127.0.0.1",
                            "port": pb}]}
        if leader:
            doc["leader"] = leader
        return json.dumps(doc)

    map_path.write_text(servers(1))
    time_util.freeze_time(NOW0)
    key = "csp.sentinel.cluster.ha.checkpoint.period.ms"
    config.set(key, "3600000")  # no periodic publish inside the scenario
    seats, clients = {}, []
    try:
        for mid in ("A", "B"):
            seats[mid] = StandaloneHAParticipant(
                map_path=str(map_path), machine_id=mid,
                rules_path=str(rules_path), checkpoint_path=str(ck),
                refresh_ms=3_600_000, host="127.0.0.1", device=dev).start()

        def client(port):
            c = ClusterTokenClient("127.0.0.1", port,
                                   health_gate=None).start()
            clients.append(c)
            ds_wait(c.is_connected, f"a client of port {port}")
            return c

        grants = []
        ca = client(pa)
        for _ in range(DS_HA_BEFORE):
            grants.append(int(ca.request_token(810).status))
        seats["A"].ha.publish_checkpoint()
        for _ in range(DS_HA_MARGIN):
            grants.append(int(ca.request_token(810).status))
        map_path.write_text(servers(2, leader="B"))
        t0 = time.perf_counter()
        seats["B"].refresh()
        promote_ms = (time.perf_counter() - t0) * 1e3
        seats["A"].refresh()
        cb = client(pb)
        post = 0
        while post <= DS_HA_THRESHOLD:
            status = int(cb.request_token(810).status)
            grants.append(status)
            if status != int(TokenResultStatus.OK):
                break
            post += 1
        stats = {m: s.state.ha_stats() for m, s in seats.items()}
    finally:
        for c in clients:
            c.stop()
        for s in seats.values():
            s.stop()
        config.set(key, "")
        time_util.unfreeze_time()
    ok = grants.count(int(TokenResultStatus.OK))
    if ok != DS_HA_THRESHOLD + DS_HA_MARGIN:
        raise AssertionError(f"ha seats on {tag}: {ok} grants across the "
                             f"handoff, not {DS_HA_THRESHOLD} + "
                             f"{DS_HA_MARGIN}")
    if stats["B"]["roleName"] != "SERVER" or stats["B"]["epoch"] != 2 \
            or stats["B"]["manager"]["rowsRestored"] != 1 \
            or stats["A"]["roleName"] != "CLIENT":
        raise AssertionError(f"ha seats on {tag}: {stats}")
    return {"grants": grants, "ok": ok, "promote_ms": promote_ms,
            "rows_restored": stats["B"]["manager"]["rowsRestored"],
            "epoch": stats["B"]["epoch"]}


def datasource_phase(dev):
    """Rule datasources on the card: (a) every connector pushing the
    headline's flow rules into the main path's engine kind; (b) the
    standalone token server in process (card = CPU) and as
    ``python -m sentinel_tpu_torch.cluster``; (c) two standalone HA seats
    (card = CPU). Prints one ``{"datasource": ...}`` line; returns the
    card's prefix launches and acquire launches by width."""
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    before = {t.ident for t in threading.enumerate()}
    DS_DIR.mkdir(parents=True, exist_ok=True)
    cpu = torch.device("cpu")
    parts, out = {}, {}

    # (a) pushes into the main path at full width
    t1 = time.perf_counter()
    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    card, cluster, dn, origin_a = ds_engine(dev, default=True)
    twin, *twin_rows = ds_engine(cpu, default=False)
    for a, b in zip((cluster, dn), twin_rows):
        if not np.array_equal(a, b):
            raise AssertionError("datasource: card and CPU rows differ")
    docs = ds_documents()
    # Both engines read the port's clock, frozen for the pushes' steps.
    time_util.freeze_time(NOW0)
    try:
        pushes, launches, have_etcd = ds_pushes(
            dev, card, twin, docs, (cluster, dn, origin_a))
    finally:
        time_util.unfreeze_time()
        twin.close()
        card.close()
    parts["pushes_s"] = time.perf_counter() - t1
    prefix_total = sum(c["launches"] for c in launches.values())
    by_shape = {}
    for c in launches.values():
        for s, k in c["by_shape"].items():
            by_shape[s] = by_shape.get(s, 0) + k
    out["pushes"] = {
        "connectors": pushes, "document_bytes": [len(d) for d in docs],
        "rules": N_RESOURCES // 10, "tightened": len(DS_TIGHT),
        "width": DS_WIDTH, "pushes_per_connector": DS_PUSHES,
        "poll_refresh_ms": DS_REFRESH_MS,
        "poll_refresh_cut_from_ms": 3000, "grpc_present": have_etcd,
        "prefix_launches": prefix_total,
        "prefix_by_shape": dict(sorted(by_shape.items()))}

    # (b) the standalone token server, then (c) the HA seats
    CA.launches = 0
    CA.launches_by_width.clear()
    t1 = time.perf_counter()
    card_tr = ds_standalone_run(dev, DS_DIR / "standalone-cuda.json")
    parts["standalone_card_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    ha_card = ds_ha_run(dev)
    parts["ha_card_s"] = time.perf_counter() - t1
    acquire = {"launches": CA.launches,
               "by_width": {str(w): c for w, c
                            in sorted(CA.launches_by_width.items())}}
    t1 = time.perf_counter()
    cpu_tr = ds_standalone_run(cpu, DS_DIR / "standalone-cpu.json")
    ha_cpu = ds_ha_run(cpu)
    parts["cpu_twins_s"] = time.perf_counter() - t1
    if card_tr != cpu_tr:
        raise AssertionError(f"standalone server: card {card_tr} != CPU "
                             f"{cpu_tr}")
    statuses = [t[0] for t in card_tr]
    from sentinel_tpu_torch.cluster.constants import TokenResultStatus as S

    if statuses[:4] != [S.OK] * 3 + [S.BLOCKED] or statuses[4] != S.OK \
            or statuses[5] != S.NO_RULE_EXISTS \
            or statuses[6:].count(S.OK) != 5:
        raise AssertionError(f"standalone server results {statuses}")
    if ha_card["grants"] != ha_cpu["grants"]:
        raise AssertionError(f"ha seats: card {ha_card['grants']} != CPU "
                             f"{ha_cpu['grants']}")
    if dev.type == "cuda" and acquire["launches"] <= 0:
        raise AssertionError("datasource: the standalone server and the HA "
                             "seats launched the acquire kernel no time")
    t1 = time.perf_counter()
    module = ds_module_entry(dev, DS_DIR / "standalone-module.json")
    parts["module_s"] = time.perf_counter() - t1
    out["standalone"] = {"results": card_tr, "card_equals_cpu": True,
                         "refresh_ms": DS_STANDALONE_REFRESH_MS,
                         "module": module}
    out["ha_seats"] = dict(ha_card, threshold=DS_HA_THRESHOLD,
                           margin=DS_HA_MARGIN, card_equals_cpu=True,
                           cpu_promote_ms=ha_cpu["promote_ms"])
    out["acquire_launches"] = acquire

    alive = []
    deadline = time.perf_counter() + 5
    while time.perf_counter() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    if alive:
        raise AssertionError(f"datasource: threads alive after the phase: "
                             f"{alive}")
    out["threads_left"] = 0
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"datasource": out}), flush=True)
    if out["phase_s"] > DS_PHASE_LIMIT_S:
        raise AssertionError(f"datasource phase took {out['phase_s']:.1f} s, "
                             f"over {DS_PHASE_LIMIT_S} s")
    return {"prefix": prefix_total, "prefix_by_shape": by_shape,
            "acquire": acquire["launches"],
            "acquire_by_width": acquire["by_width"]}


# ---------------------------------------------------------------------------
# Phase 17: the framework adapters and the Envoy RLS service
# ---------------------------------------------------------------------------

EDGE_PHASE_LIMIT_S = 150.0
EDGE_DIR = Path(__file__).resolve().parent / "smoke_logs" / "edge"
EDGE_ROUTES = 1_000            # four gateway rules a route (MAX_PARAMS)
EDGE_TIGHT_ROUTES = 16         # the Zipf head's route-wide rule at 5 a second
EDGE_TIGHT_COUNT = 5
EDGE_APIS = 64                 # API groups on path prefixes
EDGE_CLIENT_IPS = 256
EDGE_USERS = 32
EDGE_THREADS = 8
EDGE_WINDOW_S = 4.0            # gateway_entry traffic on the real clock
EDGE_WEB_WINDOW_S = 2.0        # each of WSGI, ASGI and the gRPC interceptor
EDGE_WEB_PATHS = 64
EDGE_SCRIPT_ROUTES = 100       # card = CPU cut: a CPU step with 4,000
EDGE_SCRIPT_GATEWAY = 100      # gateway rules takes ~170 ms, with 400 ~45;
EDGE_SCRIPT_WEB = 30           # a request 110-170 ms on an H100
EDGE_SCRIPT_TIGHT_WEB = 4      # /web/0-3 at 3 a second in the script
ZIPF_S = 1.2
RLS_DESCRIPTORS = 10_000       # BASELINE.json configuration #5
RLS_TWO_ENTRY_EVERY = 10       # 1,000 descriptors add a generic_key entry
RLS_TIGHT_EVERY = 20           # 500 descriptors at 5 a second
RLS_TIGHT_COUNT = 5
RLS_LOOSE_COUNT = 1e6
RLS_THREADS = 8
RLS_CHANNELS = 64              # bench.py:1106's 64 connections (8 x 8)
RLS_WINDOW_S = 5.0
RLS_SCRIPT_CALLS = 300         # card = CPU cut: a call ~8 ms on either


def zipf_weights(n: int, s: float = ZIPF_S) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def edge_engine(dev):
    """The main path's engine kind as the default engine (the adapters
    enter through ``st.entry``): capacity 32,768, the 10,000 resources
    interned, the headline rules (its system rule keeps every entry on
    the device path)."""
    from sentinel_tpu_torch.core import context as ctx_mod

    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    eng = st.reset(capacity=CAPACITY, device=dev)
    reg = eng.registry
    ent = reg.entrance_row(CTX)
    for i in range(N_RESOURCES):
        reg.cluster_row(f"res{i}")
        reg.default_row(CTX, f"res{i}", ent)
    load_rules(eng, tight=False)
    return eng


def edge_gateway_rules(n_routes: int):
    """Four gateway rules a route: route-wide (5 a second on the first 16,
    1e9 after), per client IP, per ``X-Tier`` header with an exact, prefix
    or regex pattern, per ``user`` URL parameter; one route-wide rule on
    each API group."""
    from sentinel_tpu_torch.adapters import gateway as G

    item = G.GatewayParamFlowItem
    patterns = ((G.PARAM_MATCH_STRATEGY_EXACT, "gold"),
                (G.PARAM_MATCH_STRATEGY_PREFIX, "gold"),
                (G.PARAM_MATCH_STRATEGY_REGEX, "gold-[0-9]+"))
    rules = []
    for r in range(n_routes):
        route = f"route-{r}"
        match, pattern = patterns[r % 3]
        rules += [
            G.GatewayFlowRule(resource=route, count=(
                EDGE_TIGHT_COUNT if r < EDGE_TIGHT_ROUTES else 1e9)),
            G.GatewayFlowRule(resource=route, count=1e9, param_item=item(
                parse_strategy=G.PARAM_PARSE_STRATEGY_CLIENT_IP)),
            G.GatewayFlowRule(resource=route, count=1e9, param_item=item(
                parse_strategy=G.PARAM_PARSE_STRATEGY_HEADER,
                field_name="X-Tier", pattern=pattern, match_strategy=match)),
            G.GatewayFlowRule(resource=route, count=1e9, param_item=item(
                parse_strategy=G.PARAM_PARSE_STRATEGY_URL_PARAM,
                field_name="user")),
        ]
    rules += [G.GatewayFlowRule(resource=f"api-{a}", count=1e9,
                                resource_mode=G.RESOURCE_MODE_CUSTOM_API_NAME)
              for a in range(EDGE_APIS)]
    return rules


def edge_api_definitions():
    from sentinel_tpu_torch.adapters import gateway as G

    return [G.ApiDefinition(f"api-{a}", [G.ApiPredicateItem(
        f"/svc/{a}/", G.PARAM_MATCH_STRATEGY_PREFIX)])
        for a in range(EDGE_APIS)]


def edge_managers(eng, n_routes):
    """The module's default gateway managers (``managers_for`` of the
    default engine) loaded with the phase's API groups and rules."""
    from sentinel_tpu_torch.adapters import gateway as G

    rm, am = G.managers_for(eng)
    am.load_api_definitions(edge_api_definitions())
    rm.load_rules(edge_gateway_rules(n_routes))
    return rm, am


class EdgeDraw:
    """Seeded request draws: routes and client IPs Zipf(1.2), half the
    paths under an API group's prefix."""

    def __init__(self, seed: int, n_routes: int):
        self.rng = np.random.default_rng(seed)
        self.n_routes = n_routes
        self.route_p = zipf_weights(n_routes)
        self.ip_p = zipf_weights(EDGE_CLIENT_IPS)

    def route(self) -> int:
        return int(self.rng.choice(self.n_routes, p=self.route_p))

    def request(self):
        from sentinel_tpu_torch.adapters import gateway as G

        rng = self.rng
        r = self.route()
        return r, G.GatewayRequest(
            path=f"/svc/{int(rng.integers(2 * EDGE_APIS))}/items",
            route=f"route-{r}",
            client_ip=f"10.0.{int(rng.choice(EDGE_CLIENT_IPS, p=self.ip_p))}.1",
            host="api.example",
            headers={"X-Tier": ("gold", "gold-7", "tin")[int(
                rng.integers(3))]},
            params={"user": f"u{int(rng.integers(EDGE_USERS))}"})


def edge_gateway_call(req, rm, am):
    """One ``gateway_entry`` -> exit; the verdict (0 or the exception's
    class name)."""
    from sentinel_tpu_torch.adapters import gateway as G

    try:
        entries = G.gateway_entry(req, rule_manager=rm, api_manager=am)
    except st.BlockException as ex:
        return type(ex).__name__
    for e in reversed(entries):
        e.exit()
    return 0


def ok_wsgi_app(environ, start_response):
    start_response("200 OK", [("Content-Type", "text/plain")])
    return [b"ok"]


async def ok_asgi_app(scope, receive, send):
    await send({"type": "http.response.start", "status": 200,
                "headers": []})
    await send({"type": "http.response.body", "body": b"ok"})


def wsgi_call(app, path):
    seen = []
    body = b"".join(app({"PATH_INFO": path, "REQUEST_METHOD": "GET"},
                        lambda status, headers: seen.append(status)))
    if body not in (b"ok", b"Blocked by Sentinel (flow limiting)"):
        raise AssertionError(f"wsgi body {body!r}")
    return int(seen[0].split()[0])


async def asgi_call(app, path):
    msgs = []

    async def receive():
        return {"type": "http.request"}

    async def send(msg):
        msgs.append(msg)

    await app({"type": "http", "path": path}, receive, send)
    return msgs[0]["status"]


def edge_gateway_script(dev, n_routes=None, n_gateway=None, n_web=None):
    """The card = CPU script on the port's frozen clock: ``n_gateway``
    gateway requests (40 to each 250 ms), then ``n_web`` WSGI and ``n_web``
    ASGI requests over 64 paths (``/web/0-3`` at 3 a second), on a fresh
    default engine of the main path's kind. Returns the verdicts, the
    blocked count per resource and the ``node_snapshot`` rows."""
    import asyncio

    from sentinel_tpu_torch.adapters import SentinelASGIMiddleware
    from sentinel_tpu_torch.adapters import SentinelWSGIMiddleware

    n_routes = n_routes or EDGE_SCRIPT_ROUTES
    n_gateway = n_gateway or EDGE_SCRIPT_GATEWAY
    n_web = n_web or EDGE_SCRIPT_WEB
    time_util.freeze_time(NOW0)
    eng = edge_engine(dev)
    rm = None
    try:
        rm, am = edge_managers(eng, n_routes)
        eng.flow_rules.load_rules(eng.flow_rules.get_rules() + [
            F.FlowRule(resource=f"/web/{k}", count=3)
            for k in range(EDGE_SCRIPT_TIGHT_WEB)])
        draw = EdgeDraw(41, n_routes)
        verdicts, blocked = [], {}
        for i in range(n_gateway):
            r, req = draw.request()
            v = edge_gateway_call(req, rm, am)
            verdicts.append(v)
            if v:
                blocked[req.route] = blocked.get(req.route, 0) + 1
            if i % 40 == 39:
                time_util.advance_time(250)
        paths = [f"/web/{int(draw.rng.choice(EDGE_WEB_PATHS, p=zipf_weights(EDGE_WEB_PATHS)))}"
                 for _ in range(2 * n_web)]
        wsgi = SentinelWSGIMiddleware(ok_wsgi_app)
        for i, path in enumerate(paths[:n_web]):
            code = wsgi_call(wsgi, path)
            verdicts.append(code)
            if code == 429:
                blocked[path] = blocked.get(path, 0) + 1
            if i % 25 == 24:
                time_util.advance_time(250)
        asgi = SentinelASGIMiddleware(ok_asgi_app)

        async def asgi_run():
            out = []
            for i, path in enumerate(paths[n_web:]):
                out.append(await asgi_call(asgi, path))
                if i % 25 == 24:
                    time_util.advance_time(250)
            return out

        for path, code in zip(paths[n_web:], asyncio.run(asgi_run())):
            verdicts.append(code)
            if code == 429:
                blocked[path] = blocked.get(path, 0) + 1
        snap = eng.node_snapshot()
        names = sorted(set(blocked)
                       | {f"route-{r}" for r in range(EDGE_TIGHT_ROUTES)}
                       | {f"api-{a}" for a in range(EDGE_APIS)}
                       | {f"/web/{k}" for k in range(EDGE_WEB_PATHS)})
        rows = {n: snap[n] for n in names if n in snap}
        return {"verdicts": verdicts, "blocked": blocked, "rows": rows}
    finally:
        if rm is not None:
            rm.load_rules([])
        eng.close()
        time_util.unfreeze_time()


def edge_threads(n, target, window_s):
    """``n`` threads running ``target(k, deadline)``; their results."""
    out = [None] * n
    deadline = time.perf_counter() + window_s

    def run(k):
        out[k] = target(k, deadline)

    threads = [threading.Thread(target=run, args=(k,), name=f"edge-{k}")
               for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def edge_rate(results, window_s):
    lat = [x for r in results for x in r["lat_ms"]]
    return {"requests": len(lat), "per_s": len(lat) / window_s,
            "p50_ms": pct(lat, 50), "p99_ms": pct(lat, 99),
            "blocked": sum(r["blocked"] for r in results)}


def edge_timed(dev):
    """(a) on the real clock on the card: 8 threads of ``gateway_entry``
    -> exit over the 1,000 routes, then the WSGI and ASGI middlewares and
    the gRPC server interceptor (a loopback echo server) on the same
    engine. No tight route admits more than 5 a second."""
    import asyncio
    import concurrent.futures

    import grpc

    from sentinel_tpu_torch.adapters import SentinelASGIMiddleware
    from sentinel_tpu_torch.adapters import SentinelWSGIMiddleware
    from sentinel_tpu_torch.adapters.grpc_adapter import (
        SentinelGrpcServerInterceptor)

    eng = edge_engine(dev)
    rm, am = edge_managers(eng, EDGE_ROUTES)
    out = {"gateway_rules": len(rm.get_rules()),
           "param_rules": len(eng.param_rules.get_rules())}
    try:
        # warm: the first steps with the 4,314 param rules compile them
        warm = EdgeDraw(1, EDGE_ROUTES)
        for _ in range(4):
            edge_gateway_call(warm.request()[1], rm, am)
        torch.cuda.synchronize()
        zero_prefix_counts()

        def gateway_worker(k, deadline):
            draw = EdgeDraw(100 + k, EDGE_ROUTES)
            lat, blocked, tight, tried = [], 0, {}, {}
            while time.perf_counter() < deadline:
                r, req = draw.request()
                t0 = time.perf_counter()
                v = edge_gateway_call(req, rm, am)
                lat.append((time.perf_counter() - t0) * 1e3)
                blocked += bool(v)
                if r < EDGE_TIGHT_ROUTES:
                    tried[r] = tried.get(r, 0) + 1
                    if not v:
                        tight[r] = tight.get(r, 0) + 1
            return {"lat_ms": lat, "blocked": blocked, "tight": tight,
                    "tried": tried}

        t0 = time.perf_counter()
        res = edge_threads(EDGE_THREADS, gateway_worker, EDGE_WINDOW_S)
        span_s = time.perf_counter() - t0
        gw = edge_rate(res, span_s)
        passes, tried = {}, {}
        for r in res:
            for route, c in r["tight"].items():
                passes[route] = passes.get(route, 0) + c
            for route, c in r["tried"].items():
                tried[route] = tried.get(route, 0) + c
        bound = EDGE_TIGHT_COUNT * (math.ceil(span_s) + 1)
        over = {f"route-{k}": c for k, c in passes.items() if c > bound}
        if over:
            raise AssertionError(f"edge: tight routes over {bound} passes "
                                 f"in {span_s:.2f} s: {over}")
        # A route tried more often than its quota over the whole span
        # must have been blocked.
        if any(c > bound for c in tried.values()) and gw["blocked"] <= 0:
            raise AssertionError("edge: the tight routes never blocked")
        gw.update({"threads": EDGE_THREADS, "span_s": span_s,
                   "tight_passes": {f"route-{k}": c for k, c
                                    in sorted(passes.items())},
                   "tight_tried": {f"route-{k}": c for k, c
                                   in sorted(tried.items())},
                   "tight_bound": bound})
        out["gateway"] = gw

        paths = [f"/web/{k}" for k in range(EDGE_WEB_PATHS)]
        wsgi = SentinelWSGIMiddleware(ok_wsgi_app)

        def wsgi_worker(k, deadline):
            lat, blocked, i = [], 0, k
            while time.perf_counter() < deadline:
                t0 = time.perf_counter()
                code = wsgi_call(wsgi, paths[i % len(paths)])
                lat.append((time.perf_counter() - t0) * 1e3)
                blocked += code != 200
                i += EDGE_THREADS
            return {"lat_ms": lat, "blocked": blocked}

        out["wsgi"] = edge_rate(edge_threads(EDGE_THREADS, wsgi_worker,
                                             EDGE_WEB_WINDOW_S),
                                EDGE_WEB_WINDOW_S)
        asgi = SentinelASGIMiddleware(ok_asgi_app)

        async def asgi_worker(k, deadline, lat):
            i, blocked = k, 0
            while time.perf_counter() < deadline:
                t0 = time.perf_counter()
                code = await asgi_call(asgi, paths[i % len(paths)])
                lat.append((time.perf_counter() - t0) * 1e3)
                blocked += code != 200
                i += EDGE_THREADS
                await asyncio.sleep(0)
            return blocked

        async def asgi_all():
            deadline = time.perf_counter() + EDGE_WEB_WINDOW_S
            lat = []
            blocked = await asyncio.gather(*(asgi_worker(k, deadline, lat)
                                             for k in range(EDGE_THREADS)))
            return [{"lat_ms": lat, "blocked": sum(blocked)}]

        out["asgi"] = edge_rate(asyncio.run(asgi_all()), EDGE_WEB_WINDOW_S)
        out["asgi"]["tasks"] = EDGE_THREADS

        handler = grpc.method_handlers_generic_handler(
            "edge.Echo", {"Call": grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: req, request_deserializer=lambda b: b,
                response_serializer=lambda b: b)})
        server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=EDGE_THREADS),
            interceptors=[SentinelGrpcServerInterceptor()])
        server.add_generic_rpc_handlers((handler,))
        port = server.add_insecure_port("127.0.0.1:0")
        server.start()
        channels = [grpc.insecure_channel(f"127.0.0.1:{port}")
                    for _ in range(EDGE_THREADS)]
        try:
            def grpc_worker(k, deadline):
                call = channels[k].unary_unary(
                    "/edge.Echo/Call", request_serializer=lambda b: b,
                    response_deserializer=lambda b: b)
                lat, blocked = [], 0
                while time.perf_counter() < deadline:
                    t0 = time.perf_counter()
                    try:
                        if call(b"ping", timeout=10) != b"ping":
                            raise AssertionError("grpc echo")
                    except grpc.RpcError as ex:
                        if ex.code() != grpc.StatusCode.RESOURCE_EXHAUSTED:
                            raise
                        blocked += 1
                    lat.append((time.perf_counter() - t0) * 1e3)
                return {"lat_ms": lat, "blocked": blocked}

            out["grpc"] = edge_rate(edge_threads(
                EDGE_THREADS, grpc_worker, EDGE_WEB_WINDOW_S),
                EDGE_WEB_WINDOW_S)
        finally:
            for ch in channels:
                ch.close()
            server.stop(grace=None).wait()
        torch.cuda.synchronize()
        out["prefix"] = read_prefix_counts()
        snap = eng.node_snapshot()
        out["grpc"]["snapshot"] = snap.get("/edge.Echo/Call")
        if out["grpc"]["snapshot"]["passQps"] <= 0:
            raise AssertionError("edge: the gRPC interceptor admitted nothing")
        for kind in ("gateway", "wsgi", "asgi", "grpc"):
            if out[kind]["requests"] <= 0:
                raise AssertionError(f"edge: no {kind} request served")
        if dev.type == "cuda" and out["prefix"]["launches"] <= 0:
            raise AssertionError("edge: the adapters' entries launched the "
                                 "prefix kernel no time")
    finally:
        rm.load_rules([])
        eng.close()
    return out


# -- (b) Envoy RLS at BASELINE.json configuration #5 -------------------------


def rls_entries(i: int):
    entries = [("destination_cluster", f"svc-{i}")]
    if i % RLS_TWO_ENTRY_EVERY == 0:
        entries.append(("generic_key", f"route-{i // RLS_TWO_ENTRY_EVERY % 100}"))
    return entries


def rls_tight(i: int) -> bool:
    return i % RLS_TIGHT_EVERY == 1


def rls_rules_json() -> str:
    """The ``mesh`` domain's 10,000 descriptors as the module entry
    point's rules file."""
    return json.dumps([{"domain": "mesh", "descriptors": [
        {"resources": [{"key": k, "value": v} for k, v in rls_entries(i)],
         "count": RLS_TIGHT_COUNT if rls_tight(i) else RLS_LOOSE_COUNT}
        for i in range(RLS_DESCRIPTORS)]}])


def rls_service(dev, batched: bool):
    """``SentinelEnvoyRlsService(device=dev)`` with the mode taken from
    ``csp.sentinel.wire.rls.batched``, its rules loaded and its token
    service warmed (a no-rule probe takes no quota)."""
    from sentinel_tpu_torch.envoy_rls import SentinelEnvoyRlsService
    from sentinel_tpu_torch.envoy_rls.__main__ import rules_from_json

    key = "csp.sentinel.wire.rls.batched"
    config.set(key, "true" if batched else "false")
    try:
        svc = SentinelEnvoyRlsService(device=dev)
    finally:
        config.set(key, "")
    if svc.batched != batched:
        raise AssertionError(f"rls: batched={svc.batched} under the key")
    svc.rules.load_rules(rules_from_json(rls_rules_json()))
    svc.token_service.request_tokens([(None, 0, False)])
    return svc


def rls_draws(rng, p):
    return [rls_entries(int(i)) for i in rng.choice(
        RLS_DESCRIPTORS, size=int(rng.integers(1, 4)), p=p)]


def rls_script(dev, batched: bool, n=None):
    """``n`` seeded ``should_rate_limit`` calls on the port's frozen clock
    (1-3 Zipf descriptors, the clock 40 ms on a call): every
    ``(overall_code, [(code, limit_remaining)])``."""
    n = n or RLS_SCRIPT_CALLS
    time_util.freeze_time(NOW0)
    svc = rls_service(dev, batched)
    try:
        rng = np.random.default_rng(55)
        p = zipf_weights(RLS_DESCRIPTORS)
        out = []
        for _ in range(n):
            out.append(svc.should_rate_limit("mesh", rls_draws(rng, p)))
            time_util.advance_time(40)
        return out, svc.overload_stats()
    finally:
        svc.close()
        time_util.unfreeze_time()


def rls_timed(dev, batched: bool):
    """``serve_grpc`` on loopback under 64 v3 channels (8 threads x 8,
    one call in flight on each) for ``RLS_WINDOW_S``: calls/s, RTT (from a
    thread's burst of 8 to each reply's read), the fused batches' widths,
    sheds; no tight descriptor granted more than 5 x (seconds spanned +
    1)."""
    import grpc

    from sentinel_tpu_torch.envoy_rls import proto
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    svc = rls_service(dev, batched)
    widths = []
    ts = svc.token_service
    real = ts._dispatch_device  # under both request_ and dispatch_tokens

    def counted(requests, *a, **k):
        widths.append(sum(r[0] is not None for r in requests))
        return real(requests, *a, **k)

    ts._dispatch_device = counted
    server = svc.serve_grpc("127.0.0.1:0")
    channels = [grpc.insecure_channel(f"127.0.0.1:{server.bound_port}")
                for _ in range(RLS_CHANNELS)]
    path = f"/{proto.SERVICE_NAME_V3}/{proto.METHOD_NAME}"
    per = RLS_CHANNELS // RLS_THREADS

    def request(entries_list):
        req = proto.RateLimitRequestV3()
        req.domain = "mesh"
        for entries in entries_list:
            d = req.descriptors.add()
            for k, v in entries:
                e = d.entries.add()
                e.key, e.value = k, v
        return req

    def worker(k, deadline):
        rng = np.random.default_rng(200 + k)
        p = zipf_weights(RLS_DESCRIPTORS)
        stubs = [channels[k * per + j].unary_unary(
            path, request_serializer=proto.RateLimitRequestV3.SerializeToString,
            response_deserializer=proto.RateLimitResponseV3.FromString)
            for j in range(per)]
        rtt, codes, grants = [], {}, {}
        while time.perf_counter() < deadline:
            draws = [[int(i) for i in rng.choice(
                RLS_DESCRIPTORS, size=int(rng.integers(1, 4)), p=p)]
                for _ in stubs]
            t0 = time.perf_counter()
            futs = []
            for stub, ids in zip(stubs, draws):
                futs.append((stub.future(
                    request([rls_entries(i) for i in ids]), timeout=10), ids))
            for f, ids in futs:
                resp = f.result()
                rtt.append((time.perf_counter() - t0) * 1e3)
                codes[resp.overall_code] = codes.get(resp.overall_code, 0) + 1
                for i, s in zip(ids, resp.statuses):
                    if rls_tight(i) and s.code == proto.CODE_OK:
                        grants[i] = grants.get(i, 0) + 1
        return {"rtt": rtt, "codes": codes, "grants": grants}

    CA.launches = 0
    CA.launches_by_width.clear()
    try:
        t0 = time.perf_counter()
        res = edge_threads(RLS_THREADS, worker, RLS_WINDOW_S)
        span_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {"launches": CA.launches, "by_width": {
            str(w): c for w, c in sorted(CA.launches_by_width.items())}}
    finally:
        for ch in channels:
            ch.close()
        server.stop(grace=None).wait()
        stats = svc.overload_stats()
        svc.close()
    rtt = [x for r in res for x in r["rtt"]]
    codes, grants = {}, {}
    for r in res:
        for c, n in r["codes"].items():
            codes[str(c)] = codes.get(str(c), 0) + n
        for i, n in r["grants"].items():
            grants[i] = grants.get(i, 0) + n
    bound = RLS_TIGHT_COUNT * (math.ceil(span_s) + 1)
    over = {f"svc-{i}": n for i, n in grants.items() if n > bound}
    if over:
        raise AssertionError(f"rls: tight descriptors over {bound} grants "
                             f"in {span_s:.2f} s: {over}")
    if not rtt or codes.get(str(proto.CODE_OK), 0) <= 0 \
            or codes.get(str(proto.CODE_OVER_LIMIT), 0) <= 0:
        raise AssertionError(f"rls: codes {codes}")
    ws = sorted(widths)
    return {
        "mode": "batched" if batched else "direct", "calls": len(rtt),
        "calls_per_s": len(rtt) / span_s, "span_s": span_s,
        "rtt_ms_p50": pct(rtt, 50), "rtt_ms_p99": pct(rtt, 99),
        "codes": codes, "shed": stats["shedCount"],
        "served": stats["servedCount"], "fused_batches": len(ws),
        "fused_width_p50": pct(ws, 50), "fused_width_max": ws[-1] if ws
        else 0, "fused_width_mean": float(np.mean(ws)) if ws else 0.0,
        "batcher": stats.get("batcher"),
        "tight_grants_max": max(grants.values(), default=0),
        "tight_bound": bound, "acquire": launches}


def rls_module_entry(dev):
    """``python -m sentinel_tpu_torch.envoy_rls --rules <10,000
    descriptors> --address 127.0.0.1:0`` (no ``--device`` on the card):
    its serving line, then one v2 and one v3 call answered OK."""
    import re

    import grpc

    from sentinel_tpu_torch.envoy_rls import proto

    path = EDGE_DIR / "rls-rules.json"
    path.write_text(rls_rules_json())
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sentinel_tpu_torch.envoy_rls", "--rules",
         str(path), "--address", "127.0.0.1:0"]
        + ([] if dev.type == "cuda" else ["--device", dev.type]),
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        reader = threading.Thread(
            target=lambda: lines.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=60)
        if not lines or "serving" not in lines[0]:
            raise AssertionError("python -m sentinel_tpu_torch.envoy_rls: "
                                 f"no serving line ({lines}, rc "
                                 f"{proc.poll()})")
        serving_s = time.perf_counter() - t0
        port = int(re.search(r"port (\d+)", lines[0]).group(1))
        answers = {}
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            for v3 in (False, True):
                req_cls = (proto.RateLimitRequestV3 if v3
                           else proto.RateLimitRequest)
                resp_cls = (proto.RateLimitResponseV3 if v3
                            else proto.RateLimitResponse)
                req = req_cls()
                req.domain = "mesh"
                for k, v in rls_entries(2):
                    e = req.descriptors.add().entries.add()
                    e.key, e.value = k, v
                resp = ch.unary_unary(
                    f"/{proto.SERVICE_NAME_V3 if v3 else proto.SERVICE_NAME}"
                    f"/{proto.METHOD_NAME}",
                    request_serializer=req_cls.SerializeToString,
                    response_deserializer=resp_cls.FromString)(
                        req, timeout=10)
                if resp.overall_code != proto.CODE_OK:
                    raise AssertionError(f"the module server answered "
                                         f"{resp.overall_code}")
                answers["v3" if v3 else "v2"] = [
                    (s.code, s.limit_remaining) for s in resp.statuses]
        return {"serving_line": lines[0].strip(), "serving_s": serving_s,
                "answers": answers}
    finally:
        proc.terminate()
        proc.communicate(timeout=30)


def edge_phase(dev):
    """The framework adapters and the Envoy RLS service on the card: (a)
    gateway, WSGI, ASGI and gRPC traffic on the main path's engine kind,
    and a frozen-clock script card = CPU; (b) the RLS service at BASELINE
    configuration #5 over gRPC, direct and batched, a frozen-clock script
    card = CPU in both modes, and ``python -m sentinel_tpu_torch.envoy_rls``.
    Prints one ``{"edge": ...}`` line; returns the card's prefix launches
    (part a) and acquire launches (part b)."""
    import grpc  # noqa: F401 - required: the phase serves gRPC
    from google import protobuf  # noqa: F401 - required by envoy_rls

    from sentinel_tpu_torch.ops import cluster_acquire as CA

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    before = {t.ident for t in threading.enumerate()}
    EDGE_DIR.mkdir(parents=True, exist_ok=True)
    cpu = torch.device("cpu")
    parts, out = {}, {}

    # (a) the adapters on the main path's engine kind
    t1 = time.perf_counter()
    timed = edge_timed(dev)
    parts["adapters_timed_s"] = time.perf_counter() - t1
    prefix_total = timed["prefix"]["launches"]
    prefix_by_shape = dict(timed["prefix"]["by_shape"])
    t1 = time.perf_counter()
    zero_prefix_counts()
    card = edge_gateway_script(dev)
    torch.cuda.synchronize()
    script_prefix = read_prefix_counts()
    parts["adapters_script_card_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    host = edge_gateway_script(cpu)
    parts["adapters_script_cpu_s"] = time.perf_counter() - t1
    for key in ("verdicts", "blocked", "rows"):
        if card[key] != host[key]:
            raise AssertionError(f"edge script: card and CPU {key} differ")
    if not card["blocked"]:
        raise AssertionError("edge script: nothing blocked")
    prefix_total += script_prefix["launches"]
    for s, k in script_prefix["by_shape"].items():
        prefix_by_shape[s] = prefix_by_shape.get(s, 0) + k
    out["adapters"] = dict(
        timed, routes=EDGE_ROUTES, tight_routes=EDGE_TIGHT_ROUTES,
        apis=EDGE_APIS,
        script={"routes": EDGE_SCRIPT_ROUTES,
                "gateway_requests": EDGE_SCRIPT_GATEWAY,
                "wsgi_requests": EDGE_SCRIPT_WEB,
                "asgi_requests": EDGE_SCRIPT_WEB,
                "blocked": card["blocked"], "rows": len(card["rows"]),
                "card_equals_cpu": True, "prefix": script_prefix})

    # (b) Envoy RLS: timed direct and batched, the scripts, the module
    acquire = {"launches": 0, "by_width": {}}

    def add_acquire(c):
        acquire["launches"] += c["launches"]
        for w, n in c["by_width"].items():
            acquire["by_width"][w] = acquire["by_width"].get(w, 0) + n

    rls = {}
    for batched in (False, True):
        t1 = time.perf_counter()
        run = rls_timed(dev, batched)
        parts[f"rls_{run['mode']}_s"] = time.perf_counter() - t1
        add_acquire(run["acquire"])
        rls[run["mode"]] = run
    t1 = time.perf_counter()
    scripts = {}
    for batched in (False, True):
        CA.launches = 0
        CA.launches_by_width.clear()
        card_out, card_stats = rls_script(dev, batched)
        torch.cuda.synchronize()
        add_acquire({"launches": CA.launches, "by_width": {
            str(w): c for w, c in CA.launches_by_width.items()}})
        host_out, host_stats = rls_script(cpu, batched)
        if card_out != host_out:
            raise AssertionError(f"rls script (batched={batched}): card and "
                                 "CPU answers differ")
        codes = [c for c, _ in card_out]
        scripts["batched" if batched else "direct"] = {
            "calls": len(card_out), "ok": codes.count(1),
            "over_limit": codes.count(2), "card_equals_cpu": True,
            "served": card_stats["servedCount"]}
    parts["rls_scripts_s"] = time.perf_counter() - t1
    if scripts["direct"]["over_limit"] <= 0:
        raise AssertionError("rls script: nothing over limit")
    acquire["by_width"] = dict(sorted(acquire["by_width"].items(),
                                      key=lambda kv: int(kv[0])))
    if dev.type == "cuda" and acquire["launches"] <= 0:
        raise AssertionError("rls: the service launched the acquire kernel "
                             "no time")
    t1 = time.perf_counter()
    module = rls_module_entry(dev)
    parts["rls_module_s"] = time.perf_counter() - t1
    out["rls"] = {
        "descriptors": RLS_DESCRIPTORS,
        "two_entry": RLS_DESCRIPTORS // RLS_TWO_ENTRY_EVERY,
        "tight": RLS_DESCRIPTORS // RLS_TIGHT_EVERY,
        "channels": RLS_CHANNELS, "threads": RLS_THREADS,
        "window_s": RLS_WINDOW_S, "direct": rls["direct"],
        "batched": rls["batched"], "script": scripts, "module": module,
        "acquire": acquire}
    out["prefix_launches"] = prefix_total
    out["prefix_by_shape"] = dict(sorted(prefix_by_shape.items()))

    alive = []
    deadline = time.perf_counter() + 5
    while time.perf_counter() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    if alive:
        raise AssertionError(f"edge: threads alive after the phase: {alive}")
    out["threads_left"] = 0
    out["parts_s"] = parts
    out["memory_bytes"] = memory_report(mem0)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"edge": out}), flush=True)
    if out["phase_s"] > EDGE_PHASE_LIMIT_S:
        raise AssertionError(f"edge phase took {out['phase_s']:.1f} s, over "
                             f"{EDGE_PHASE_LIMIT_S} s")
    return {"prefix": prefix_total, "prefix_by_shape": out["prefix_by_shape"],
            "acquire": acquire["launches"],
            "acquire_by_width": acquire["by_width"]}


# ---------------------------------------------------------------------------
# Phase 18: the command center and the OpenMetrics exporter
# ---------------------------------------------------------------------------

OPS_PHASE_LIMIT_S = 60.0
OPS_DIR = Path(__file__).resolve().parent / "smoke_logs" / "ops"
OPS_READ_REPS = 100
# The three reads that each walk the whole table at 10,000 resources
# (26-131 ms p50 on an H100, O1) run half as often: at 100 each they took
# 21 s of the phase's 60 (O1), and a slower host runs every phase ~1.3x
# slower (PERF.md section 6, E2).
OPS_TABLE_READ_REPS = 50
OPS_READS = {"version": OPS_READ_REPS, "api": OPS_READ_REPS,
             "getRules?type=flow": OPS_READ_REPS,
             "cnode?id=res0": OPS_TABLE_READ_REPS,
             "clusterNode": OPS_TABLE_READ_REPS,
             "systemStatus": OPS_READ_REPS,
             "telemetry": OPS_TABLE_READ_REPS,
             "leases": OPS_READ_REPS, "getSwitch": OPS_READ_REPS}
OPS_PUSHES = 5                  # rounds: tighten DS_TIGHT[k] alone to 5/s
OPS_SCRAPES = 20
OPS_RENDERS = 1                 # in-process renders, timed apart from HTTP
OPS_HEARTBEAT_MS = 200
OPS_PARITY_CAPACITY = 8192
# The script's 200 entries: four steps at widths the kernel phase times
# (N = 64 and 8), at 0, 250, 1250 and 1500 ms; exits for the passed.
OPS_SCRIPT_STEPS = ((0, 64), (250, 64), (1250, 64), (1500, 8))
# Values that are host wall times: compared by name, type and label set
# (metrics) or left out (JSON) when the card's answers are held to the
# CPU's.
OPS_TIMING_FAMILIES = (
    "sentinel_tpu_step_ms", "sentinel_tpu_enqueue_ms",
    "sentinel_tpu_step_duration_ms", "sentinel_tpu_pipeline_queue_wait_ms",
    "sentinel_tpu_pipeline_device_wait_ms",
    "sentinel_tpu_waterfall_stage_ms", "sentinel_tpu_waterfall_rtt_ms",
    "sentinel_tpu_wire_rtt_ms", "sentinel_tpu_population_fold_ms")


def ops_untimed(obj):
    """``obj`` (parsed JSON) without its wall-time fields (``stepP50Ms``,
    ``enqueueP95Ms``, ``queueWaitP50Ms``, ``deviceWaitP95Ms``, ...)."""
    import re

    timing = re.compile(r"^(step|enqueue|queueWait|deviceWait|rtt)P\d+Ms$")
    if isinstance(obj, dict):
        return {k: ops_untimed(v) for k, v in obj.items()
                if not timing.match(k)}
    if isinstance(obj, list):
        return [ops_untimed(v) for v in obj]
    return obj


def ops_masked(text: str):
    """An OpenMetrics page's lines, the samples of OPS_TIMING_FAMILIES
    with their values replaced by a placeholder."""
    out, family = [], None
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            family = line.split()[2]
        elif family in OPS_TIMING_FAMILIES and not line.startswith("#"):
            line = line.split(" # ", 1)[0].rpartition(" ")[0] + " <t>"
        out.append(line)
    return out


def ops_http(port, path, body=None, headers=None):
    """(status, body, content type, ms) of one request over loopback."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}",
        data=body.encode() if body is not None else None,
        headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            out = (r.status, r.read().decode(), r.headers["Content-Type"])
    except urllib.error.HTTPError as e:
        out = (e.code, e.read().decode(), e.headers["Content-Type"])
    return out + ((time.perf_counter() - t0) * 1e3,)


def ops_quantiles(ms):
    s = sorted(ms)
    return {"n": len(s), "p50_ms": s[len(s) // 2],
            "p99_ms": s[min(len(s) - 1, int(len(s) * 0.99))], "max_ms": s[-1]}


class _DashboardStub:
    """A loopback dashboard: records every POST to /registry/machine."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer
        import urllib.parse

        received = self.received = []

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n).decode()
                received.append((self.path, urllib.parse.parse_qs(body)))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="ops-dashboard-stub", daemon=True)
        self.thread.start()
        self.address = f"127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


def ops_documents():
    """The headline's 1,000 flow rules as JSON, once per push round with
    ``DS_TIGHT[k]`` alone tightened to ``DS_TIGHT_COUNT`` a second."""
    from sentinel_tpu_torch.datasource import converters as CV

    docs = []
    for k in range(OPS_PUSHES):
        docs.append(CV.flow_rules_to_json([
            F.FlowRule(resource=f"res{i}",
                       count=DS_TIGHT_COUNT if f"res{i}" == DS_TIGHT[k]
                       else 1e9)
            for i in range(0, N_RESOURCES, 10)]))
    return docs


def ops_script_rules():
    """The card = CPU script's rules: every family, as setRules bodies,
    and one gateway route."""
    return {
        "flow": [{"resource": f"s{i}", "count": 2 + i % 4, "grade": 1}
                 for i in range(10)],
        "degrade": [{"resource": f"s{i}", "grade": i % 3, "count": 1,
                     "timeWindow": 1, "minRequestAmount": 2}
                    for i in range(10, 15)],
        "system": [{"qps": 1e6}],
        "authority": [{"resource": "s15", "limitApp": "appA",
                       "strategy": 1}],
        "paramFlow": [{"resource": f"s{i}", "paramIdx": 0, "count": 2}
                      for i in range(16, 20)],
        "gateway": [{"resource": "route-a", "count": 2, "intervalSec": 1}],
    }


OPS_SCRIPT_READS = ("cnode?id=s0", "clusterNode", "getRules?type=flow",
                    "getRules?type=degrade", "getRules?type=system",
                    "getRules?type=authority", "getRules?type=paramFlow",
                    "gateway/getRules", "metrics", "telemetry", "leases")


def ops_read_back(port):
    """The script's read-back: each answer as it is compared (metrics
    masked, JSON without wall times)."""
    out = {}
    for path in OPS_SCRIPT_READS:
        status, body, ctype, _ = ops_http(port, path)
        if path == "metrics":
            body = ops_masked(body)
        elif body[:1] in ("[", "{"):
            body = ops_untimed(json.loads(body))
        out[path] = (status, ctype, body)
    return out


def script_steps(eng, dev, epoch_ms):
    """The entries of ``OPS_SCRIPT_STEPS`` on ``eng`` over the script's
    23 names (20 ruled, a gateway route, two unruled), on the port's
    clock from ``epoch_ms``, each passed entry exited 100 ms later;
    returns each step's verdicts."""
    reg = eng.registry
    ent = reg.entrance_row(CTX)
    names = [f"s{i}" for i in range(20)] + ["route-a", "u0", "u1"]
    rows = [(reg.cluster_row(n), reg.default_row(CTX, n, ent))
            for n in names]
    origin_a = reg.origin_id("appA")
    rng = np.random.default_rng(18)
    verdicts = []
    for offset, per in OPS_SCRIPT_STEPS:
        now = epoch_ms + offset
        time_util.freeze_time(now)
        buf = make_entry_batch_np(per)
        pick = rng.integers(0, len(names), size=per)
        buf["cluster_row"][:] = [rows[i][0] for i in pick]
        buf["dn_row"][:] = [rows[i][1] for i in pick]
        buf["count"][:] = 1
        buf["origin_id"][:] = np.where(rng.random(per) < 0.3, origin_a, -3)
        buf["param_hash"][:, 0] = rng.integers(1, 4, size=per)
        buf["param_present"][:, 0] = True
        reason = eng.harvest_decisions(eng.check_batch(
            to_device(buf, dev), now_ms=now))[0]
        eng.traces.drain()
        ok = np.asarray(reason) == 0
        verdicts.append(np.asarray(reason).tolist())
        ebuf = make_exit_batch_np(per)
        for f in ("cluster_row", "dn_row", "origin_row", "entry_in",
                  "count", "param_hash", "param_present"):
            ebuf[f][:] = buf[f]
        ebuf["cluster_row"][~ok] = -1
        ebuf["success"][:] = ok
        ebuf["rt_ms"][:] = rng.integers(1, 200, size=per)
        ebuf["error"][:] = rng.random(per) < 0.2
        eng.complete_batch(to_device(ebuf, dev), now_ms=now + 100)
    return verdicts


def ops_script(dev, epoch_ms):
    """The card = CPU script on a fresh engine (``OPS_PARITY_CAPACITY``
    rows) with its own ``CommandCenter``, on the port's clock frozen at
    ``epoch_ms``: every family and a gateway route pushed through the
    commands, the entries of ``OPS_SCRIPT_STEPS`` (exits for the passed),
    then the read-back. Returns (the read-back, the engine, its center); the
    caller stops the center and closes the engine."""
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.transport.command_center import CommandCenter

    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    time_util.freeze_time(epoch_ms)
    eng = SentinelEngine(capacity=OPS_PARITY_CAPACITY, device=dev)
    center = CommandCenter(engine=eng, port=0).start()
    port = center.bound_port
    pushed = {}
    for family, rules in ops_script_rules().items():
        path = ("gateway/updateRules" if family == "gateway"
                else f"setRules?type={family}")
        pushed[family] = ops_http(port, path, json.dumps(rules))[:2]
    script_steps(eng, dev, epoch_ms)
    time_util.freeze_time(epoch_ms + 3000)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = ops_read_back(port)
    out["pushed"] = pushed
    return out, eng, center


def merge_counts(counts):
    """The sum of :func:`read_cluster_counts` results (a token server
    process's, read back from JSON, included), shapes as strings."""
    total = {"prefix": 0, "prefix_by_shape": {}, "acquire": 0,
             "acquire_by_width": {}}
    for c in counts:
        total["prefix"] += c["prefix"]
        total["acquire"] += c["acquire"]
        for key, src in (("prefix_by_shape", c["prefix_by_shape"]),
                         ("acquire_by_width", c["acquire_by_width"])):
            for shape, k in src.items():
                shape = ("K={},N={},M={}".format(*shape)
                         if isinstance(shape, tuple) else str(shape))
                total[key][shape] = total[key].get(shape, 0) + k
    return total


def threads_left(before, timeout_s=5.0, ignore=()):
    """Names of the threads started since ``before`` that are still alive
    after up to ``timeout_s`` of waiting."""
    alive = []
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t not in before and t.is_alive()
                 and t.name not in ignore]
        if not alive:
            break
        time.sleep(0.05)
    return alive


def ops_phase(dev):
    """The command center and the OpenMetrics exporter on the card: the
    main path's engine kind as the default engine under
    ``st.init_ops_plane(port=0)`` (metric timer, heartbeat to a loopback
    dashboard stub), read commands, rule pushes that must enforce at the
    next step, scrapes of ``/metrics`` checked against the device
    counters; then a frozen-clock script card = CPU through two
    ``CommandCenter``s and the event-loop twin on the card's. Prints one
    ``{"ops": ...}`` line whatever fails (a failed check raises after it,
    naming the check); returns the card's prefix launches."""
    import shutil
    import socket
    import tempfile

    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.core.config import (DASHBOARD_SERVER,
                                                HEARTBEAT_INTERVAL_MS)
    from sentinel_tpu_torch.telemetry.exporter import (_active_rows,
                                                       render_engine_metrics)
    from sentinel_tpu_torch.telemetry.openmetrics import (
        OPENMETRICS_CONTENT_TYPE, parse_families)
    from sentinel_tpu_torch.transport.aio_command_center import (
        AsyncCommandCenter)

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    before = set(threading.enumerate())
    OPS_DIR.mkdir(parents=True, exist_ok=True)
    cpu = torch.device("cpu")
    parts, out, failed = {}, {}, []
    prefix_total, by_shape = 0, {}

    def check(ok, name):
        if not ok:
            failed.append(name)

    def add_prefix(c):
        nonlocal prefix_total
        prefix_total += c["launches"]
        for s, k in c["by_shape"].items():
            by_shape[s] = by_shape.get(s, 0) + k

    log_dir = tempfile.mkdtemp(prefix="metric-log-", dir=OPS_DIR)
    saved = {k: config._config.get(k) for k in (
        LOG_DIR, DASHBOARD_SERVER, HEARTBEAT_INTERVAL_MS)}
    stub = _DashboardStub()
    config.set(LOG_DIR, log_dir)
    config.set(DASHBOARD_SERVER, stub.address)
    config.set(HEARTBEAT_INTERVAL_MS, str(OPS_HEARTBEAT_MS))
    script_engines, port = [], None
    try:
        # -- setup: the headline engine as the default engine -------------
        t1 = time.perf_counter()
        ctx_mod.replace_context(None)
        ctx_mod.bump_generation()
        time_util.freeze_time(NOW0)
        eng = st.reset(capacity=CAPACITY, device=dev)
        reg = eng.registry
        ent = reg.entrance_row(CTX)
        cluster = np.array([reg.cluster_row(f"res{i}")
                            for i in range(N_RESOURCES)], np.int32)
        dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                       for i in range(N_RESOURCES)], np.int32)
        origin_a = reg.origin_id("appA")
        load_rules(eng, tight=False)
        tight_rows = np.array([int(r[3:]) for r in DS_TIGHT])
        docs = ops_documents()
        plane = st.init_ops_plane(port=0)
        center = plane["command_center"]
        port = center.bound_port
        step = [0]
        admitted = {}  # second -> res0's admitted lanes

        def run_step():
            """One ds_batch step at a fresh second; returns the
            verdicts and the step's ms."""
            time_util.advance_time(1000)
            batch = ds_batch(step[0], cluster, dn, origin_a, tight_rows)
            step[0] += 1
            ts = time.perf_counter()
            reason = np.asarray(eng.harvest_decisions(eng.check_batch(
                to_device(batch, dev),
                now_ms=time_util.current_time_millis()))[0])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - ts) * 1e3
            hit = batch["cluster_row"] == cluster[tight_rows[0]]
            second = time_util.current_time_millis() // 1000 * 1000
            admitted[second] = int((reason[hit] == 0).sum())
            return batch, reason, ms

        run_step()  # the first step: every resource active, rules compiled
        parts["setup_s"] = time.perf_counter() - t1

        # -- timed part: reads, pushes, scrapes, one after the other -------
        zero_prefix_counts()
        t1 = time.perf_counter()
        reads = {}
        for path, reps in OPS_READS.items():
            ms, statuses = [], set()
            for _ in range(reps):
                status, body, _, t = ops_http(port, path)
                ms.append(t)
                statuses.add(status)
            check(statuses == {200}, f"read {path}: statuses {statuses}")
            reads[path] = dict(ops_quantiles(ms), bytes=len(body))
        parts["reads_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        pushes = []
        for k, doc in enumerate(docs):
            tp = time.perf_counter()
            status, body, _, post_ms = ops_http(port, "setRules?type=flow",
                                                doc)
            check((status, body) == (200, "success"),
                  f"push {k}: {status} {body[:80]}")
            batch, reason, step_ms = run_step()
            e2e = (time.perf_counter() - tp) * 1e3
            for i, row in enumerate(tight_rows[:OPS_PUSHES]):
                hit = batch["cluster_row"] == cluster[row]
                got = int((reason[hit] == 0).sum())
                want = DS_TIGHT_COUNT if i == k else int(hit.sum())
                check(got == want, f"push {k}: {DS_TIGHT[i]} admitted "
                                   f"{got}, not {want}")
            pushes.append({"post_ms": post_ms, "step_ms": step_ms,
                           "push_to_enforce_ms": e2e})
        parts["pushes_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        scrape_ms, page = [], None
        for _ in range(OPS_SCRAPES):
            status, page, ctype, t = ops_http(port, "metrics")
            scrape_ms.append(t)
            check(status == 200, f"metrics: status {status}")
            check(ctype == OPENMETRICS_CONTENT_TYPE,
                  f"metrics: content type {ctype}")
        render_ms = []
        for _ in range(OPS_RENDERS):
            tr = time.perf_counter()
            render_engine_metrics(eng)
            render_ms.append((time.perf_counter() - tr) * 1e3)
        parts["scrapes_s"] = time.perf_counter() - t1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        add_prefix(read_prefix_counts())
        out["timed_prefix"] = read_prefix_counts()

        # -- checks on the page, the metric log, the heartbeat -------------
        families = parse_families(page)
        counts = eng.telemetry_counts()
        rows = _active_rows(eng, counts)
        for fam, ev in (("sentinel_tpu_pass", C.MetricEvent.PASS),
                        ("sentinel_tpu_block", C.MetricEvent.BLOCK)):
            got = {lab["resource"]: v for _, lab, v in families.get(fam, ())}
            want = {res: float(counts["totals"][int(ev), row])
                    for res, row in rows.items()}
            check(got == want, f"metrics: {fam} totals != telemetry_counts")
        # the metric timer seals every second before the frozen now
        time_util.advance_time(1000)
        deadline = time.perf_counter() + 5.0
        lines = []
        while time.perf_counter() < deadline:
            _, body, _, _ = ops_http(port, f"metric?startTime=0&identity="
                                           f"{DS_TIGHT[0]}")
            lines = [ln.split("|") for ln in body.splitlines() if ln]
            if len(lines) >= len(admitted):
                break
            time.sleep(0.1)
        sealed = {int(f[0]): int(f[2]) for f in lines}
        check(sealed == admitted,
              f"metric: sealed {sealed} != admitted {admitted}")
        beats = list(stub.received)
        check(len(beats) >= 1, "heartbeat: none received")
        if beats:
            path, form = beats[-1]
            check(path == "/registry/machine", f"heartbeat: path {path}")
            check(form.get("port") == [str(port)],
                  f"heartbeat: port {form.get('port')} != {port}")
            check(form.get("app") == [config.app_name()],
                  f"heartbeat: app {form.get('app')}")
        e2e = sorted(p["push_to_enforce_ms"] for p in pushes)
        out["timed"] = {
            "capacity": CAPACITY, "resources": N_RESOURCES,
            "reads": reads,
            "pushes": pushes,
            "push_to_enforce_ms_p50": e2e[len(e2e) // 2],
            "push_to_enforce_ms_max": e2e[-1],
            "document_bytes": len(docs[0]),
            "metrics": dict(ops_quantiles(scrape_ms), bytes=len(page),
                            scrapes=OPS_SCRAPES,
                            render_ms=sorted(render_ms),
                            active_resources=len(rows)),
            "metric_seconds_sealed": len(sealed),
            "heartbeats": len(beats),
            "heartbeat_interval_ms": OPS_HEARTBEAT_MS}

        # The ops plane stops here, before the scripts: its heartbeat's
        # last success is a probe age the scripts' pages render.
        st.shutdown_ops_plane()

        # -- card = CPU, and the event-loop twin ---------------------------
        t1 = time.perf_counter()
        epoch = (time_util.current_time_millis() // 1000 + 100) * 1000
        zero_prefix_counts()
        card, card_eng, card_center = ops_script(dev, epoch)
        script_engines.append((card_eng, card_center))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        script_prefix = read_prefix_counts()
        add_prefix(script_prefix)
        parts["script_card_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        host, host_eng, host_center = ops_script(cpu, epoch)
        script_engines.append((host_eng, host_center))
        parts["script_cpu_s"] = time.perf_counter() - t1
        for key in card:
            check(card[key] == host[key], f"card = CPU: {key} differs")
        check(all(p == (200, "success") for p in card["pushed"].values()),
              f"script pushes {card['pushed']}")
        blocked = sum(v["blockTotal"] for v in card["telemetry"][2][
            "resources"].values())
        check(blocked > 0, "script: nothing blocked")
        t1 = time.perf_counter()
        aio = AsyncCommandCenter(engine=card_eng, port=0).start()
        try:
            twin = ops_read_back(aio.bound_port)
        finally:
            aio.stop()
        for key in twin:
            check(twin[key] == card[key], f"event-loop center: {key} differs")
        parts["aio_s"] = time.perf_counter() - t1
        out["script"] = {"capacity": OPS_PARITY_CAPACITY,
                         "entries": sum(w for _, w in OPS_SCRIPT_STEPS),
                         "reads": list(OPS_SCRIPT_READS),
                         "blocked": blocked, "prefix": script_prefix,
                         "card_equals_cpu": not any(
                             f.startswith("card = CPU") for f in failed),
                         "aio_equals_threaded": not any(
                             f.startswith("event-loop") for f in failed)}
    finally:
        time_util.unfreeze_time()
        for eng_, center_ in script_engines:
            center_.stop()
            eng_.close()
        st.shutdown_ops_plane()
        stub.stop()
        ctx_mod.replace_context(None)
        default = st._default_engine
        if default is not None:
            default.close()
            if not default._closed:
                failed.append("the default engine is not closed")
        for k, v in saved.items():
            if v is None:
                config._config.pop(k, None)
            else:
                config.set(k, v)
        shutil.rmtree(log_dir, ignore_errors=True)
        if port is not None:
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=2).close()
                failed.append(f"port {port} still accepts after shutdown")
            except OSError:
                pass
        alive = threads_left(before)
        if alive:
            failed.append(f"threads alive after the phase: {alive}")
        out["threads_left"] = len(alive)
        out["default_engine_closed"] = default is None or default._closed
        out["prefix_launches"] = prefix_total
        out["prefix_by_shape"] = dict(sorted(by_shape.items()))
        out["parts_s"] = parts
        out["memory_bytes"] = memory_report(mem0)
        out["failed_checks"] = failed
        out["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"ops": out}), flush=True)
    if failed:
        raise AssertionError(f"ops: {failed[0]} ({len(failed)} failed)")
    if dev.type == "cuda" and prefix_total <= 0:
        raise AssertionError("ops: the path launched the prefix kernel no "
                             "time")
    if out["phase_s"] > OPS_PHASE_LIMIT_S:
        raise AssertionError(f"ops phase took {out['phase_s']:.1f} s, over "
                             f"{OPS_PHASE_LIMIT_S} s")
    return {"prefix": prefix_total, "prefix_by_shape": out["prefix_by_shape"]}



DASH_PHASE_LIMIT_S = 60.0
DASH_DIR = Path(__file__).resolve().parent / "smoke_logs" / "dashboard"
DASH_USER, DASH_PASSWORD = "smoke", "smoke-pass"   # auth on
DASH_HEARTBEAT_TOKEN = "smoke-heartbeat-token"
DASH_FETCH_SECONDS = 2          # sealed width-8192 seconds, one fetch each
DASH_TOP_QUERIES = 20
DASH_SCRAPES = 5
DASH_CLUSTER_FLOW = 8800        # /cluster/assign's GLOBAL flow, 3 a second
DASH_CLUSTER_COUNT = 3
DASH_CLUSTER_ACQUIRES = 5


def dash_login(port, user, password):
    """(status, session token or None) of a ``POST /auth/login``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/auth/login",
                     f"username={user}&password={password}")
        r = conn.getresponse()
        r.read()
        cookie = (r.getheader("Set-Cookie") or "").split(";")[0]
        return r.status, cookie.split("=", 1)[1] if "=" in cookie else None
    finally:
        conn.close()


def dash_script(dev, epoch_ms, log_dir):
    """The card = CPU script of the dashboard phase: a fresh engine
    (``OPS_PARITY_CAPACITY`` rows) with its own ``CommandCenter``, managed
    by a fresh ``DashboardServer`` (auth off) it registered with by one
    heartbeat, on the port's clock frozen at ``epoch_ms``: every family
    and a gateway route pushed through the dashboard, the entries of
    ``OPS_SCRIPT_STEPS``, the seconds sealed into the metric log at
    ``log_dir`` and fetched into the dashboard's repository, then the
    dashboard's read-back. Returns what is compared."""
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.dashboard import DashboardServer
    from sentinel_tpu_torch.metrics.timer import MetricTimerListener
    from sentinel_tpu_torch.metrics.writer import MetricWriter
    from sentinel_tpu_torch.transport.command_center import CommandCenter
    from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    time_util.freeze_time(epoch_ms)
    config.set(LOG_DIR, log_dir)
    eng = SentinelEngine(capacity=OPS_PARITY_CAPACITY, device=dev)
    center = CommandCenter(engine=eng, port=0).start()
    dash = DashboardServer(port=0, heartbeat_token="").start(fetch=False)
    port = dash.bound_port

    def data(path, body=None):
        status, text, _, _ = ops_http(port, path, body)
        return status, json.loads(text)["data"]

    try:
        out = {"beat": HeartbeatSender(
            dashboards=[f"127.0.0.1:{port}"],
            api_port=center.bound_port).send_once()}
        app = config.app_name()
        pushed = {}
        for family, rules in ops_script_rules().items():
            path = (f"gateway/rules?app={app}" if family == "gateway"
                    else f"v1/rules?app={app}&type={family}")
            status, got = data(path, json.dumps(rules))
            pushed[family] = (status, sorted(got.values()))
        out["pushed"] = pushed
        out["verdicts"] = script_steps(eng, dev, epoch_ms)
        time_util.freeze_time(epoch_ms + 3000)
        writer = MetricWriter(app=app, base_dir=log_dir)
        out["sealed"] = MetricTimerListener(eng, writer).tick(epoch_ms + 3000)
        writer.close()
        out["fetched"] = dash.fetcher.fetch_once(now_ms=epoch_ms + 4000)
        span = f"startTime={epoch_ms - 60_000}&endTime={epoch_ms + 4000}"
        reads = {}
        for path in ([f"v1/rules?app={app}&type={t}" for t in
                      ("flow", "degrade", "system", "authority",
                       "paramFlow")]
                     + [f"gateway/rules?app={app}",
                        f"metric/queryTopResourceMetric.json?app={app}"
                        f"&{span}",
                        f"metric/queryByAppAndResource.json?app={app}"
                        f"&identity=s0&{span}",
                        "resource/machineResource.json?ip=127.0.0.1"
                        f"&port={center.bound_port}",
                        f"telemetry/summary.json?app={app}"]):
            status, got = data(path)
            reads[path.split("?")[0]] = (status, ops_untimed(got))
        status, got = data(f"app/machines.json?app={app}")
        reads["app/machines.json"] = (status, [
            {k: v for k, v in m.items() if k not in ("port", "lastHeartbeat")}
            for m in got])
        out["reads"] = reads
        return out
    finally:
        dash.stop()
        center.stop()
        eng.close()


def dashboard_phase(dev):
    """The dashboard on the card's engines: the headline engine as the
    default engine under ``st.init_ops_plane(port=0)`` (heartbeat every
    200 ms with a token) is discovered by an in-process
    ``DashboardServer`` with auth on, which fetches its sealed seconds,
    pushes the 1,000 flow rules through ``/v1/rules`` (each enforced at
    the next width-8192 step), answers the top-resource query and
    ``/metrics``, refuses a request without a session, and assigns the
    engine as a token server that then grants; then a frozen-clock
    script card = CPU through a dashboard over each. Prints one
    ``{"dashboard": ...}`` line whatever fails (a failed check raises
    after it, naming the check); returns the card's launches."""
    import shutil
    import socket
    import tempfile
    import urllib.parse

    from sentinel_tpu_torch.cluster.constants import TokenResultStatus as TS
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.core.config import (DASHBOARD_SERVER,
                                                HEARTBEAT_CLIENT_IP,
                                                HEARTBEAT_INTERVAL_MS,
                                                HEARTBEAT_TOKEN)
    from sentinel_tpu_torch.dashboard import AuthService, DashboardServer
    from sentinel_tpu_torch.native import NativeTokenClient
    from sentinel_tpu_torch.telemetry.exporter import render_dashboard_metrics
    from sentinel_tpu_torch.telemetry.openmetrics import (
        OPENMETRICS_CONTENT_TYPE, parse_families)

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    mem0 = memory_mark()
    before = set(threading.enumerate())
    DASH_DIR.mkdir(parents=True, exist_ok=True)
    cpu = torch.device("cpu")
    parts, out, failed = {}, {}, []
    counts = {}

    def check(ok, name):
        if not ok:
            failed.append(name)

    log_dir = tempfile.mkdtemp(prefix="metric-log-", dir=DASH_DIR)
    keys = (LOG_DIR, DASHBOARD_SERVER, HEARTBEAT_INTERVAL_MS,
            HEARTBEAT_TOKEN, HEARTBEAT_CLIENT_IP)
    saved = {k: config._config.get(k) for k in keys}
    dash = DashboardServer(port=0, auth=AuthService(DASH_USER, DASH_PASSWORD),
                           heartbeat_token=DASH_HEARTBEAT_TOKEN)
    dash.start(fetch=False)
    dport = dash.bound_port
    config.set(LOG_DIR, log_dir)
    config.set(DASHBOARD_SERVER, f"127.0.0.1:{dport}")
    config.set(HEARTBEAT_INTERVAL_MS, str(OPS_HEARTBEAT_MS))
    config.set(HEARTBEAT_TOKEN, DASH_HEARTBEAT_TOKEN)
    config.set(HEARTBEAT_CLIENT_IP, "127.0.0.1")
    session = {}

    def http(path, body=None):
        return ops_http(dport, path, body, headers=session)

    def data(path, body=None):
        status, text, _, ms = http(path, body)
        check(status == 200, f"{path.split('?')[0]}: status {status} "
                             f"{text[:120]}")
        return json.loads(text)["data"] if status == 200 else None, ms

    script_engines, port, eng = [], None, None
    try:
        # -- setup: the headline engine, discovered by the dashboard -------
        t1 = time.perf_counter()
        status, token = dash_login(dport, DASH_USER, DASH_PASSWORD)
        check(status == 200 and token, f"login: {status}")
        session["Authorization"] = f"Bearer {token}"
        status, text, _, _ = ops_http(dport, "app/names.json")
        out["no_session_status"] = status
        check(status == 401, f"a request without a session: {status}")
        status, _ = dash_login(dport, DASH_USER, "wrong")
        check(status == 401, f"a wrong password: {status}")
        ctx_mod.replace_context(None)
        ctx_mod.bump_generation()
        # The port's clock frozen a minute behind the wall clock: the
        # dashboard's /metrics reads the last 120 wall seconds of its
        # repository, which the frozen seconds fetched then fall in.
        time_util.freeze_time((int(time.time()) - 60) * 1000)
        eng = st.reset(capacity=CAPACITY, device=dev)
        reg = eng.registry
        ent = reg.entrance_row(CTX)
        cluster = np.array([reg.cluster_row(f"res{i}")
                            for i in range(N_RESOURCES)], np.int32)
        dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                       for i in range(N_RESOURCES)], np.int32)
        origin_a = reg.origin_id("appA")
        load_rules(eng, tight=False)
        tight_rows = np.array([int(r[3:]) for r in DS_TIGHT])
        docs = ops_documents()
        row_name = {int(r): f"res{i}" for i, r in enumerate(cluster)}
        step = [0]

        def run_step():
            time_util.advance_time(1000)
            batch = ds_batch(step[0], cluster, dn, origin_a, tight_rows)
            step[0] += 1
            ts = time.perf_counter()
            reason = np.asarray(eng.harvest_decisions(eng.check_batch(
                to_device(batch, dev),
                now_ms=time_util.current_time_millis()))[0])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            return batch, reason, (time.perf_counter() - ts) * 1e3

        run_step()  # every resource active, rules compiled
        parts["setup_s"] = time.perf_counter() - t1

        zero_cluster_counts()
        t1 = time.perf_counter()
        td = time.perf_counter()
        plane = st.init_ops_plane(port=0)
        center = plane["command_center"]
        port = center.bound_port
        app, machine = None, None
        deadline = time.perf_counter() + 10.0
        while machine is None and time.perf_counter() < deadline:
            for a in dash.apps.app_names():
                for m in dash.apps.healthy_machines(a):
                    if m.port == port:
                        app, machine = a, m
            if machine is None:
                time.sleep(0.005)
        discovered_ms = (time.perf_counter() - td) * 1e3
        check(machine is not None, "discovery: the engine never registered")
        listed, _ = data(f"app/machines.json?app={app}")
        check(listed and listed[0]["port"] == port and listed[0]["healthy"],
              f"discovery: machines {listed}")
        parts["discovery_s"] = time.perf_counter() - t1

        # -- the metric fetch: one sealed width-8192 second a fetch --------
        t1 = time.perf_counter()
        fetches = []
        # The setup's second falls out of the first fetch's window (a
        # fetch reads at most 6,000 lines: about one second's resources).
        time_util.advance_time(6000)
        for _ in range(DASH_FETCH_SECONDS):
            batch, reason, _ = run_step()
            second = time_util.current_time_millis()
            ok = reason == 0
            rows, k = np.unique(batch["cluster_row"][ok], return_counts=True)
            want = {row_name[int(r)]: int(n) for r, n in zip(rows, k)}
            time_util.advance_time(2000)  # sealed and past the fetch lag
            plane["metric_timer"].tick()
            deadline = time.perf_counter() + 5.0
            while time.perf_counter() < deadline:
                _, body, _, _ = ops_http(port, f"metric?startTime={second}"
                                               f"&endTime={second}"
                                               f"&identity={DS_TIGHT[0]}")
                if body.strip():
                    break
                time.sleep(0.02)
            tf = time.perf_counter()
            saved_n = dash.fetcher.fetch_once(
                now_ms=time_util.current_time_millis())
            fetch_ms = (time.perf_counter() - tf) * 1e3
            got = {}
            for res in dash.repository.resources_of(app):
                for e in dash.repository.query(app, res, second, second):
                    got[res] = e["passQps"]
            got = {r: v for r, v in got.items() if r in want or v}
            check(got == want, f"fetch: second {second}: {len(got)} "
                               f"resources saved, {len(want)} admitted")
            fetches.append({"fetch_ms": fetch_ms, "nodes_saved": saved_n,
                            "resources": len(want),
                            "admitted": int(ok.sum())})
        parts["fetch_s"] = time.perf_counter() - t1

        # -- five pushes through /v1/rules, each enforced at the next step -
        t1 = time.perf_counter()
        pushes = []
        for k, doc in enumerate(docs):
            tp = time.perf_counter()
            got, post_ms = data(f"v1/rules?app={app}&type=flow", doc)
            check(got == {machine.key: True}, f"push {k}: {got}")
            batch, reason, step_ms = run_step()
            e2e = (time.perf_counter() - tp) * 1e3
            for i, row in enumerate(tight_rows[:OPS_PUSHES]):
                hit = batch["cluster_row"] == cluster[row]
                n_ok = int((reason[hit] == 0).sum())
                want = DS_TIGHT_COUNT if i == k else int(hit.sum())
                check(n_ok == want, f"push {k}: {DS_TIGHT[i]} admitted "
                                    f"{n_ok}, not {want}")
            pushes.append({"post_ms": post_ms, "step_ms": step_ms,
                           "push_to_enforce_ms": e2e})
        shown, _ = data(f"v1/rules?app={app}&type=flow")
        check(shown is not None and len(shown) == N_RESOURCES // 10
              and shown[0]["count"] == 1e9 and any(
                  r["resource"] == DS_TIGHT[OPS_PUSHES - 1]
                  and r["count"] == DS_TIGHT_COUNT for r in shown),
              "push: the read-back is not the last document")
        parts["pushes_s"] = time.perf_counter() - t1

        # -- the top-resource query and /metrics ---------------------------
        t1 = time.perf_counter()
        now = time_util.current_time_millis()
        top_ms = []
        for _ in range(DASH_TOP_QUERIES):
            top, ms = data(f"metric/queryTopResourceMetric.json?app={app}"
                           f"&startTime={now - 60_000}&endTime={now}")
            top_ms.append(ms)
        ranked = list(top["resource"]) if top else []
        check(len(ranked) == 30, f"top: {len(ranked)} resources")
        volume = {r: sum(p["passQps"] + p["blockQps"] for p in pts)
                  for r, pts in (top or {"resource": {}})["resource"]
                  .items()}
        check(all(volume[a] >= volume[b] for a, b in
                  zip(ranked, ranked[1:])), "top: not ranked by volume")
        scrape_ms, page = [], ""
        for _ in range(DASH_SCRAPES):
            status, page, ctype, ms = ops_http(dport, "metrics")
            scrape_ms.append(ms)
            check(status == 200 and ctype == OPENMETRICS_CONTENT_TYPE,
                  f"/metrics: {status} {ctype}")
        tr = time.perf_counter()
        render_dashboard_metrics(dash)
        render_ms = (time.perf_counter() - tr) * 1e3
        fams = parse_families(page)
        latest = {lab["resource"]: v for _, lab, v in fams.get(
            "sentinel_tpu_dashboard_resource_pass_qps", ())
            if lab["app"] == app}
        want = {}
        for res in dash.repository.resources_of(app):
            series = dash.repository.query(app, res, 0, 2**62)
            if series:
                want[res] = float(series[-1]["passQps"])
        check(latest == want and len(latest) > 0,
              f"/metrics: {len(latest)} resources, repository {len(want)}")
        machines = {lab["app"]: v for _, lab, v in fams.get(
            "sentinel_tpu_dashboard_machines", ())}
        check(machines.get(app) == 1.0, f"/metrics: machines {machines}")
        parts["queries_s"] = time.perf_counter() - t1

        # -- /cluster/assign, then acquires from the token server ---------
        t1 = time.perf_counter()
        assigned, assign_ms = data(f"cluster/assign?app={app}&ip=127.0.0.1"
                                   f"&port={port}&tokenPort=0", "")
        token_port = (assigned or {}).get("tokenPort") or 0
        check(token_port > 0, f"assign: {assigned}")
        rules = [{"resource": "dashCluster", "count": DASH_CLUSTER_COUNT,
                  "clusterMode": True,
                  "clusterConfig": {"flowId": DASH_CLUSTER_FLOW,
                                    "thresholdType": 1}}]
        status, body, _, _ = ops_http(
            port, "cluster/server/modifyFlowRules?namespace=default",
            "data=" + urllib.parse.quote(json.dumps(rules)))
        check((status, body) == (200, "success"), f"server rules: {body}")
        states, _ = data(f"cluster/state.json?app={app}")
        check(bool(states) and states[0]["mode"] == 1,
              f"cluster state: {states}")
        acquired = []
        if token_port:
            with NativeTokenClient("127.0.0.1", token_port, "default",
                                   timeout_ms=60_000) as client:
                for _ in range(DASH_CLUSTER_ACQUIRES):
                    ta = time.perf_counter()
                    r = client.request_token(DASH_CLUSTER_FLOW, 1)
                    acquired.append((int(r.status),
                                     (time.perf_counter() - ta) * 1e3))
        statuses = [a for a, _ in acquired]
        check(statuses == [TS.OK] * DASH_CLUSTER_COUNT + [TS.BLOCKED] * (
            DASH_CLUSTER_ACQUIRES - DASH_CLUSTER_COUNT),
            f"acquires: {statuses}")
        status, body, _, _ = ops_http(port, "setClusterMode?mode=-1", "")
        check(body == "success", f"cluster mode off: {body}")
        parts["cluster_s"] = time.perf_counter() - t1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts["timed"] = read_cluster_counts()
        e2e = sorted(p["push_to_enforce_ms"] for p in pushes)
        out["timed"] = {
            "capacity": CAPACITY, "resources": N_RESOURCES,
            "discovered_healthy_ms": discovered_ms,
            "heartbeat_interval_ms": OPS_HEARTBEAT_MS,
            "fetches": fetches,
            "pushes": pushes,
            "push_to_enforce_ms_p50": e2e[len(e2e) // 2],
            "push_to_enforce_ms_max": e2e[-1],
            "document_bytes": len(docs[0]),
            "top_query": ops_quantiles(top_ms),
            "metrics": dict(ops_quantiles(scrape_ms), bytes=len(page),
                            render_ms=render_ms, resources=len(latest)),
            "assign_ms": assign_ms,
            "acquires": acquired}

        st.shutdown_ops_plane()
        eng.cluster.stop()

        # -- card = CPU through a dashboard over each ---------------------
        epoch = (time_util.current_time_millis() // 1000 + 100) * 1000
        zero_cluster_counts()
        t1 = time.perf_counter()
        card = dash_script(dev, epoch, tempfile.mkdtemp(dir=log_dir))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts["script"] = read_cluster_counts()
        parts["script_card_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        host = dash_script(cpu, epoch, tempfile.mkdtemp(dir=log_dir))
        parts["script_cpu_s"] = time.perf_counter() - t1
        for key in card:
            check(card[key] == host[key], f"card = CPU: {key} differs")
        check(card["beat"] and card["fetched"] > 0 and card["sealed"] > 0,
              f"script: beat {card['beat']}, sealed {card['sealed']}, "
              f"fetched {card['fetched']}")
        check(all(st_ == 200 and ok == [True] for st_, ok
                  in card["pushed"].values()),
              f"script pushes {card['pushed']}")
        blocked = sum(r != 0 for v in card["verdicts"] for r in v)
        check(blocked > 0, "script: nothing blocked")
        out["script"] = {"capacity": OPS_PARITY_CAPACITY,
                         "entries": sum(w for _, w in OPS_SCRIPT_STEPS),
                         "blocked": blocked, "fetched": card["fetched"],
                         "reads": sorted(card["reads"]),
                         "card_equals_cpu": not any(
                             f.startswith("card = CPU") for f in failed)}
    finally:
        time_util.unfreeze_time()
        st.shutdown_ops_plane()
        if eng is not None:
            eng.cluster.stop()
        dash.stop()
        ctx_mod.replace_context(None)
        default = st._default_engine
        if default is not None:
            default.close()
            if not default._closed:
                failed.append("the default engine is not closed")
        for k, v in saved.items():
            if v is None:
                config._config.pop(k, None)
            else:
                config.set(k, v)
        shutil.rmtree(log_dir, ignore_errors=True)
        for p in (port, dport):
            if p is None:
                continue
            try:
                socket.create_connection(("127.0.0.1", p), timeout=2).close()
                failed.append(f"port {p} still accepts after shutdown")
            except OSError:
                pass
        alive = threads_left(before)
        if alive:
            failed.append(f"threads alive after the phase: {alive}")
        total = out["launches"] = merge_counts(counts.values())
        out["threads_left"] = len(alive)
        out["parts_s"] = parts
        out["memory_bytes"] = memory_report(mem0)
        out["card"] = smi_line()
        out["failed_checks"] = failed
        out["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"dashboard": out}), flush=True)
    if failed:
        raise AssertionError(f"dashboard: {failed[0]} ({len(failed)} "
                             "failed)")
    if dev.type == "cuda" and (total["prefix"] <= 0 or total["acquire"] <= 0):
        raise AssertionError(f"dashboard: the path launched prefix "
                             f"{total['prefix']}, acquire "
                             f"{total['acquire']} times")
    if out["phase_s"] > DASH_PHASE_LIMIT_S:
        raise AssertionError(f"dashboard phase took {out['phase_s']:.1f} s, "
                             f"over {DASH_PHASE_LIMIT_S} s")
    return total



NATIVE_PHASE_LIMIT_S = 45.0
NATIVE_FLOWS = 64               # bench.py:840: GLOBAL flows at 1e9
NATIVE_FLOW0 = 5000
NATIVE_BATCH = 512              # a request_tokens_batch call
NATIVE_WARM = 3
NATIVE_ITERS = 20
NATIVE_SINGLES = 1000           # request_token calls for p50 / p99
NATIVE_CLOCK_TOL_MS = 50
NATIVE_SCRIPT_CAPACITY = 1024


def native_flows():
    """bench.py:840's 64 GLOBAL flows (flowId 5000..5063) at 1e9."""
    return [F.FlowRule(resource=f"lp{i}", count=1e9, cluster_mode=True,
                       cluster_config={"flowId": NATIVE_FLOW0 + i,
                                       "thresholdType": 1})
            for i in range(NATIVE_FLOWS)]


def native_script(dev, epoch_ms):
    """The shim's frozen-clock script against a port ``ClusterTokenServer``
    whose engine and token service are on ``dev``: flow, param and batched
    acquires (GLOBAL flows 4242 at 3 a second and 7100 at 2 a value),
    then ``demos/remote_bridge_demo.py``'s remote entries (a flow rule of
    3 on ``checkout``, a param rule of 2 on ``search``) with their exits.
    Returns what the shim saw and the engine's PASS / BLOCK totals."""
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.native import NativeTokenClient

    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()
    time_util.freeze_time(epoch_ms)
    eng = SentinelEngine(capacity=NATIVE_SCRIPT_CAPACITY, device=dev)
    eng.flow_rules.load_rules([F.FlowRule(resource="checkout", count=3)])
    eng.param_rules.load_rules([P.ParamFlowRule("search", param_idx=0,
                                                count=2)])
    server = ClusterTokenServer(host="127.0.0.1", port=0, engine=eng)
    server.service.rules.load_rules("default", [
        F.FlowRule(resource=f"shim{fid}", count=count, cluster_mode=True,
                   cluster_config={"flowId": fid, "thresholdType": 1})
        for fid, count in ((4242, 3), (7100, 2))])
    server.start()

    def fields(r):
        return [int(r.status), r.remaining, r.wait_ms]

    out = {}
    try:
        with NativeTokenClient("127.0.0.1", server.bound_port,
                               timeout_ms=120_000) as c:
            out["tokens"] = [fields(c.request_token(4242)) for _ in range(5)]
            out["params"] = [int(c.request_param_token(7100, 1, [v]).status)
                             for v in ("hot", "hot", "hot", 42, "42", True,
                                       1.5)]
            out["batch"] = [fields(r) for r in c.request_tokens_batch(
                [(4242, 1, False), (999, 1, False), (7100, 1, True)])]
            checkout = [c.remote_entry("checkout", origin="web-app")
                        for _ in range(5)]
            search = [c.remote_entry("search", params=[q])
                      for q in ("tpu", "tpu", "tpu", "tpu", "gpu")]
            exits = [c.remote_exit(e) for s_, e, _ in checkout + search
                     if s_ == 0]
            out["consumed_exit"] = c.remote_exit(
                next(e for s_, e, _ in checkout if s_ == 0))
        out["checkout"] = [[s_, r] for s_, _, r in checkout]
        out["search"] = [[s_, r] for s_, _, r in search]
        out["exits"] = exits
        out["entry_ids"] = sorted(e for s_, e, _ in checkout + search
                                  if s_ == 0)
        eng._flush_committer()
        totals = eng.telemetry_counts()["totals"]
        out["totals"] = {
            res: [int(totals[int(C.MetricEvent.PASS), row]),
                  int(totals[int(C.MetricEvent.BLOCK), row])]
            for res, row in sorted(eng.registry.resources().items())
            if res in ("checkout", "search")}
        return out
    finally:
        server.stop()
        eng.close()


def native_phase(dev, shim_build_s):
    """The C++ shim's ``NativeTokenClient`` on the card's token servers:
    bench.py:840's loopback (64 GLOBAL flows at 1e9, 512-request batches
    through one handle) and single ``request_token`` latencies against a
    port ``ClusterTokenServer`` on the card in a process of its own, the
    cached-tick clock against the wall clock, and the frozen-clock
    script (acquires, then the remote-entry bridge of
    ``demos/remote_bridge_demo.py``) card = CPU. Prints one
    ``{"native": ...}`` line whatever fails (a failed check raises after
    it, naming the check); returns the card's launches."""
    from sentinel_tpu_torch.cluster.constants import TokenResultStatus as TS
    from sentinel_tpu_torch.native import NativeTokenClient, native_now_ms

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    before = set(threading.enumerate())
    cpu = torch.device("cpu")
    parts, out, failed, counts = {}, {"shim_build_s": shim_build_s}, [], {}

    def check(ok, name):
        if not ok:
            failed.append(name)

    server = TokenServerProcess(dev, "native")
    try:
        # -- card = CPU on the script, in this process (untimed) ----------
        t1 = time.perf_counter()
        zero_cluster_counts()
        card = native_script(dev, NOW0)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts["script"] = read_cluster_counts()
        parts["script_card_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        host = native_script(cpu, NOW0)
        parts["script_cpu_s"] = time.perf_counter() - t1
        for key in card:
            check(card[key] == host[key], f"card = CPU: {key} differs")
        tokens = [s_ for s_, _, _ in card["tokens"]]
        check(tokens == [TS.OK] * 3 + [TS.BLOCKED] * 2,
              f"script tokens {tokens}")
        check(card["checkout"] == [[TS.OK, 0]] * 3 + [[TS.BLOCKED, 1]] * 2,
              f"checkout: {card['checkout']}")
        check(any(s_ == TS.BLOCKED and r == 5 for s_, r in card["search"]),
              f"search: no PARAM_FLOW block in {card['search']}")
        check(all(x == TS.OK for x in card["exits"]),
              f"exits {card['exits']}")
        check(card["consumed_exit"] == TS.BAD_REQUEST,
              f"a consumed exit: {card['consumed_exit']}")
        check(card["totals"].get("checkout") == [3, 2],
              f"checkout totals {card['totals']}")
        out["script"] = {"tokens": tokens, "checkout": card["checkout"],
                         "search": card["search"], "totals": card["totals"],
                         "card_equals_cpu": not any(
                             f.startswith("card = CPU") for f in failed)}

        # -- the clock -----------------------------------------------------
        skew = []
        for _ in range(20):
            skew.append(abs(native_now_ms() - time.time() * 1000))
            time.sleep(0.005)
        out["clock_skew_ms_max"] = max(skew)
        check(max(skew) <= NATIVE_CLOCK_TOL_MS,
              f"native_now_ms {max(skew):.1f} ms off the wall clock")

        # -- timed: the loopback and single acquires ----------------------
        t1 = time.perf_counter()
        server.ready()
        parts["server_ready_s"] = time.perf_counter() - t1
        server.cmd("zero")
        t1 = time.perf_counter()
        reqs = [(NATIVE_FLOW0 + i % NATIVE_FLOWS, 1, False)
                for i in range(NATIVE_BATCH)]
        with NativeTokenClient("127.0.0.1", server.port,
                               timeout_ms=30_000) as client:
            for _ in range(NATIVE_WARM):
                warm = client.request_tokens_batch(reqs)
            tb = time.perf_counter()
            results = []
            for _ in range(NATIVE_ITERS):
                results += client.request_tokens_batch(reqs)
            dt = time.perf_counter() - tb
            singles = []
            for i in range(NATIVE_SINGLES):
                ts = time.perf_counter()
                r = client.request_token(NATIVE_FLOW0 + i % NATIVE_FLOWS)
                singles.append((time.perf_counter() - ts) * 1e3)
                check(r.status == TS.OK, f"request_token: {r.status}")
        bad = [r.status for r in warm + results if r.status != TS.OK]
        check(not bad, f"loopback: {len(bad)} not OK ({bad[:4]})")
        report = server.stop()
        counts["server"] = report["counts"]
        granted = sum(report["ok"].values())
        want = (NATIVE_WARM + NATIVE_ITERS) * NATIVE_BATCH + NATIVE_SINGLES
        check(granted == want, f"server OK verdicts {granted}, not {want}")
        singles.sort()
        out["timed"] = {
            "flows": NATIVE_FLOWS, "batch": NATIVE_BATCH,
            "warm": NATIVE_WARM, "iters": NATIVE_ITERS,
            "acquires_per_s": NATIVE_ITERS * NATIVE_BATCH / dt,
            "request_token_ms": {"n": len(singles),
                                 "p50": pct(singles, 50),
                                 "p99": pct(singles, 99),
                                 "max": singles[-1]},
            "server_host_ms": report["host_ms"]}
        parts["timed_s"] = time.perf_counter() - t1
    finally:
        server.kill()
        time_util.unfreeze_time()
        alive = threads_left(before, ignore=("smoke-token-server-out",))
        if alive:
            failed.append(f"threads alive after the phase: {alive}")
        total = out["launches"] = merge_counts(counts.values())
        out["parts_s"] = parts
        out["card"] = smi_line()
        out["failed_checks"] = failed
        out["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"native": out}), flush=True)
    if failed:
        raise AssertionError(f"native: {failed[0]} ({len(failed)} failed)")
    if dev.type == "cuda" and (total["prefix"] <= 0 or total["acquire"] <= 0):
        raise AssertionError(f"native: the path launched prefix "
                             f"{total['prefix']}, acquire "
                             f"{total['acquire']} times")
    if out["phase_s"] > NATIVE_PHASE_LIMIT_S:
        raise AssertionError(f"native phase took {out['phase_s']:.1f} s, "
                             f"over {NATIVE_PHASE_LIMIT_S} s")
    return total


# ---------------------------------------------------------------------------
# The reference phase: the JAX package's main-path test files on the card
# (tests/test_torch_ref_main.py through tests/test_torch_refsuite.py), and
# the within-batch invariants of tests/test_flow_batch_semantics.py at the
# main path's widths, card = CPU on a numpy batch.
# ---------------------------------------------------------------------------

REF_GROUP = "tests/test_torch_ref_main.py"
REF_PHASE_LIMIT_S = 180.0
REF_CHILD_TIMEOUT_S = 150.0
REF_DIR = Path(__file__).resolve().parent / "smoke_logs" / "reference"
INV_RESOURCES = 1_000
INV_WIDTHS = (2048, 8192)
INV_PERMUTATIONS = 3
INV_CAPACITY = 4096
INV_SEED = 41
INV_T0 = NOW0 + 5_000


def reference_suite(out_path: str) -> int:
    """``chip_smoke.py --reference-suite OUT``: the main-path group of the
    reference suite under pytest in this process, with the engine on the
    device ``SENTINEL_REFSUITE_DEVICE`` names (``--noconftest``: the
    repo's conftest imports JAX). Writes the outcome counts, the failed
    node ids, the seconds and the prefix launches by shape to ``OUT``."""
    import types

    import pytest

    # ``tests`` is the repository's directory (a namespace package): an
    # installed distribution's top-level ``tests`` package must not
    # shadow it.
    tests_pkg = types.ModuleType("tests")
    tests_pkg.__path__ = [str(Path(__file__).resolve().parent / "tests")]
    sys.modules["tests"] = tests_pkg
    prefix_cuda.launches = 0
    prefix_cuda.tile_launches = 0
    prefix_cuda.launches_by_shape.clear()
    counts = {"passed": 0, "failed": 0, "error": 0, "skipped": 0,
              "xfailed": 0, "xpassed": 0}
    failed = []

    class Tally:
        def pytest_runtest_logreport(self, report):
            xfail = hasattr(report, "wasxfail")
            if report.when == "call":
                key = ("xfailed" if report.skipped else "xpassed") if xfail \
                    else report.outcome
            elif report.failed:
                key = "error"
            elif report.skipped:
                key = "xfailed" if xfail else "skipped"
            else:
                return
            counts[key] += 1
            if key in ("failed", "error", "xpassed"):
                failed.append(f"{report.nodeid} ({report.when})")

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "-p", "no:xdist", "-m", "not slow",
                      "-k", "not test_accounting", REF_GROUP],
                     plugins=[Tally()])
    seconds = time.perf_counter() - t0
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps({
        "rc": int(rc), "counts": counts, "failed": failed,
        "seconds": seconds, "launches": prefix_cuda.launches,
        "tile_launches": prefix_cuda.tile_launches,
        "by_shape": {f"K={k},N={n},M={m}": c for (k, n, m), c
                     in sorted(prefix_cuda.launches_by_shape.items())}}))
    return 0


def reference_child(dev) -> dict:
    """Runs :func:`reference_suite` in a process of its own (the reference
    cases rebuild the default engine and set process-wide config); its
    pytest output goes under ``smoke_logs/reference/``."""
    REF_DIR.mkdir(parents=True, exist_ok=True)
    out = REF_DIR / "summary.json"
    log = REF_DIR / "pytest.log"
    out.unlink(missing_ok=True)
    env = dict(os.environ, SENTINEL_REFSUITE_DEVICE=dev.type)
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--reference-suite", str(out)],
            cwd=str(Path(__file__).resolve().parent), env=env,
            stdout=fh, stderr=subprocess.STDOUT)
        try:
            proc.wait(timeout=REF_CHILD_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if not out.exists():
        tail = log.read_text()[-3000:]
        raise AssertionError(f"reference suite: no summary (rc "
                             f"{proc.returncode}); log tail:\n{tail}")
    got = json.loads(out.read_text())
    got["child_rc"] = proc.returncode
    return got


def host_array(x) -> np.ndarray:
    """A copy on the host of a tensor on any device, or of a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def invariant_rules(pkg, n: int):
    """The invariants' rules in package ``pkg`` (the port, or in the
    tier-1 test the JAX package): resource ``inv<i>`` of kind ``i % 5``
    carries a count-0 rule for origin appA ahead of a shared QPS rule (0),
    the same ahead of a shared rate limiter (1), a THREAD-grade rule (2),
    an exception-count breaker (3), or a rule that never binds (4)."""
    flow, degrade = [], []
    for i in range(n):
        r, kind = f"inv{i}", i % 5
        if kind in (0, 1):
            flow.append(pkg.FlowRule(resource=r, count=0, limit_app="appA"))
        if kind == 0:
            flow.append(pkg.FlowRule(resource=r, count=3 + i % 7))
        elif kind == 1:
            flow.append(pkg.FlowRule(
                resource=r, count=10, max_queueing_time_ms=200,
                control_behavior=C.CONTROL_BEHAVIOR_RATE_LIMITER))
        elif kind == 2:
            flow.append(pkg.FlowRule(resource=r, count=4,
                                     grade=C.FLOW_GRADE_THREAD))
        elif kind == 3:
            flow.append(pkg.FlowRule(resource=r, count=1_000))
            degrade.append(pkg.DegradeRule(
                resource=r, count=1, time_window=10, min_request_amount=1,
                grade=C.DEGRADE_GRADE_EXCEPTION_COUNT))
        else:
            flow.append(pkg.FlowRule(resource=r, count=1_000_000))
    return flow, degrade


def invariant_plan(width: int, n: int, seed: int) -> np.ndarray:
    """One lane a row: (resource, origin appA?, count, pre_passed,
    pre_blocked). Zipf(1.2) over the resources, so hot ones take many
    lanes of one batch; THREAD-grade lanes ask 1-5 tokens; pre-passed
    and pre-blocked lanes only on the rule that never binds."""
    rng = np.random.default_rng(seed)
    res = (rng.zipf(1.2, width) - 1) % n
    kind = res % 5
    app_a = (kind <= 1) & (rng.random(width) < 0.4)
    count = np.where(kind == 2, rng.integers(1, 6, width), 1)
    u = rng.random(width)
    pre_passed = (kind == 4) & (u < 0.1)
    pre_blocked = (kind == 4) & (u >= 0.1) & (u < 0.2)
    return np.stack([res, app_a, count, pre_passed, pre_blocked],
                    axis=1).astype(np.int64)


def invariant_buf(reg, plan, width: int):
    """The plan's lanes as a numpy staging dict on ``reg``'s rows (the
    form a reference test hands ``check_batch``), padded to ``width``."""
    buf = make_entry_batch_np(width)
    for j, (i, app_a, count, pre_p, pre_b) in enumerate(plan.tolist()):
        name = f"inv{i}"
        buf["cluster_row"][j] = reg.cluster_row(name)
        buf["dn_row"][j] = -1
        buf["count"][j] = count
        if i % 5 <= 1:
            app = "appA" if app_a else "appB"
            buf["origin_row"][j] = reg.origin_row(name, app)
            buf["origin_id"][j] = reg.origin_id(app)
            buf["origin_named"][j] = bool(app_a)
        buf["pre_passed"][j] = bool(pre_p)
        buf["pre_blocked"][j] = bool(pre_b)
    return buf


def invariant_run(pkg, eng, entry_cls, exit_cls, width: int, n: int,
                  seed: int, order=None):
    """Load the rules, open every breaker (one lane each, exited with
    errors at ``INV_T0``), then one admission batch of the plan (in
    ``order`` when given) 100 ms later: its decisions as numpy, and the
    plan in batch order."""
    flow, degrade = invariant_rules(pkg, n)
    eng.flow_rules.load_rules(flow)
    eng.degrade_rules.load_rules(degrade)
    reg = eng.registry
    for i in range(n):  # intern every row in one order on every engine
        reg.cluster_row(f"inv{i}")
        if i % 5 <= 1:
            reg.origin_row(f"inv{i}", "appA")
            reg.origin_row(f"inv{i}", "appB")
    breakers = np.arange(3, n, 5)[:width]
    # Two tokens a lane: two errors trip an exception count of 1.
    opening = np.stack([breakers, np.zeros_like(breakers),
                        np.full_like(breakers, 2), np.zeros_like(breakers),
                        np.zeros_like(breakers)], axis=1)
    buf = invariant_buf(reg, opening, width)
    dec = eng.check_batch(entry_cls(**buf), now_ms=INV_T0)
    xbuf = make_exit_batch_np(width)
    ok = host_array(dec.reason)[:len(breakers)] == 0
    m = int(ok.sum())
    for f in ("cluster_row", "dn_row", "origin_row", "count"):
        xbuf[f][:m] = buf[f][:len(breakers)][ok]
    xbuf["rt_ms"][:m] = 5
    xbuf["error"][:m] = True
    eng.complete_batch(exit_cls(**xbuf), now_ms=INV_T0 + 5)
    plan = invariant_plan(width, n, seed)
    if order is not None:
        plan = plan[order]
    dec = eng.check_batch(entry_cls(**invariant_buf(reg, plan, width)),
                          now_ms=INV_T0 + 100)
    got = {f: host_array(getattr(dec, f))
           for f in ("reason", "wait_us", "rule_slot")}
    return got, plan


def invariant_checks(got, plan) -> list:
    """What a serial reference admits, whatever the batch order: the
    failed checks by name."""
    reason, wait = got["reason"], got["wait_us"]
    kind = plan[:, 0] % 5
    app_a, pre_p, pre_b = plan[:, 1] == 1, plan[:, 3] == 1, plan[:, 4] == 1
    bad = []
    if not (reason[(kind <= 1) & app_a] == C.BlockReason.FLOW).all():
        bad.append("a count-0 origin rule let an appA lane through")
    if not (reason[kind == 3] == C.BlockReason.DEGRADE).all():
        bad.append("an open breaker let a lane through")
    if not (reason[pre_p] == C.BlockReason.PASS).all():
        bad.append("a pre-passed lane was blocked")
    if not (reason[pre_b] != C.BlockReason.PASS).all():
        bad.append("a pre-blocked lane passed")
    if not (reason[(kind == 4) & ~pre_b] == C.BlockReason.PASS).all():
        bad.append("the rule that never binds blocked a lane")
    res = plan[:, 0]
    for i in np.unique(res[kind == 0]):
        lanes = (res == i) & ~app_a
        want = min(3 + i % 7, int(lanes.sum()))
        if int((reason[lanes] == C.BlockReason.PASS).sum()) != want:
            bad.append(f"inv{i}: blocked appA lanes moved the shared quota")
            break
    for i in np.unique(res[kind == 1]):
        lanes = (res == i) & ~app_a
        passed = lanes & (reason == C.BlockReason.PASS)
        want = min(3, int(lanes.sum()))  # 0, 100, 200 ms under a 200 ms cap
        if int(passed.sum()) != want or \
                sorted(wait[passed].tolist()) != [0, 100_000, 200_000][:want]:
            bad.append(f"inv{i}: the rate limiter's pacing took blocked "
                       "lanes into account")
            break
    for i in np.unique(res[kind == 2]):
        lanes = res == i
        want = min(4, int(lanes.sum()))  # concurrency moves 1 an entry
        if int((reason[lanes] == C.BlockReason.PASS).sum()) != want:
            bad.append(f"inv{i}: THREAD grade counted tokens")
            break
    return bad


def admitted_by_resource(got, plan, n: int) -> np.ndarray:
    passed = got["reason"] == C.BlockReason.PASS
    return np.bincount(plan[passed, 0], minlength=n)


def states_bit_equal(x, y, path="") -> list:
    """Paths where two ``state_to_numpy`` trees differ in any bit."""
    if set(x) != set(y):
        return [f"{path}: fields {sorted(set(x) ^ set(y))}"]
    out = []
    for k in x:
        if isinstance(x[k], dict):
            out += states_bit_equal(x[k], y[k], f"{path}.{k}")
        elif x[k].dtype != y[k].dtype or x[k].shape != y[k].shape or \
                x[k].tobytes() != y[k].tobytes():
            out.append(f"{path}.{k}")
    return out


def invariant_engine(dev):
    from sentinel_tpu_torch.core import context as ctx

    ctx.replace_context(None)
    ctx.bump_generation()
    return SentinelEngine(INV_CAPACITY, device=dev, clock=Clock(INV_T0))


def reference_invariants(dev) -> dict:
    """Card = CPU, bit for bit, on decisions and state at each width, and
    per-resource admitted totals equal under three permutations."""
    cpu = torch.device("cpu")
    out, failed = {}, []
    for width in INV_WIDTHS:
        t1 = time.perf_counter()
        runs = {}
        for d in (dev, cpu):
            eng = invariant_engine(d)
            try:
                got, plan = invariant_run(st, eng, EntryBatch, ExitBatch,
                                          width, INV_RESOURCES, INV_SEED)
                if d.type == "cuda":
                    torch.cuda.synchronize()
                runs[d.type] = (got, plan, convert.state_to_numpy(eng.state))
            finally:
                eng.close()
        card, host = runs[dev.type], runs["cpu"]
        for f in card[0]:
            if not np.array_equal(card[0][f], host[0][f]):
                failed.append(f"width {width}: decisions.{f} card != cpu")
        diff = states_bit_equal(card[2], host[2])
        if diff:
            failed.append(f"width {width}: state differs at {diff[:4]}")
        bad = invariant_checks(card[0], card[1])
        failed += [f"width {width}: {b}" for b in bad]
        totals = admitted_by_resource(card[0], card[1], INV_RESOURCES)
        rng = np.random.default_rng(width)
        for p in range(INV_PERMUTATIONS):
            eng = invariant_engine(dev)
            try:
                got, plan = invariant_run(
                    st, eng, EntryBatch, ExitBatch, width, INV_RESOURCES,
                    INV_SEED, order=rng.permutation(width))
            finally:
                eng.close()
            if not np.array_equal(
                    admitted_by_resource(got, plan, INV_RESOURCES), totals):
                failed.append(f"width {width}: permutation {p} moved a "
                              "resource's admitted total")
            failed += [f"width {width} permutation {p}: {b}"
                       for b in invariant_checks(got, plan)]
        reasons = card[0]["reason"]
        out[str(width)] = {
            "lanes_by_reason": {
                (C.BlockReason(int(r)).name if int(r) >= 0 else str(int(r))):
                int(c) for r, c in zip(*np.unique(reasons,
                                                  return_counts=True))},
            "paced_lanes": int((card[0]["wait_us"] > 0).sum()),
            "admitted": int(totals.sum()),
            "resources_hit": int((np.bincount(card[1][:, 0],
                                              minlength=INV_RESOURCES)
                                  > 0).sum()),
            "seconds": time.perf_counter() - t1}
    return {"widths": out, "failed": failed}


def reference_phase(dev):
    """(i) The main-path files of the JAX package's own suite with the
    engine on the card (every step through the Hopper prefix kernel): no
    case may fail, and the prefix kernel must have launched; (ii) the
    within-batch invariants at 2048 and 8192 lanes. Prints one
    ``{"reference": ...}`` line; returns the launches."""
    t0 = time.perf_counter()
    out, failed = {}, []
    try:
        suite = reference_child(dev)
        out["suite"] = suite
        c = suite["counts"]
        if suite["rc"] != 0 or c["failed"] or c["error"] or c["xpassed"]:
            failed.append(f"reference suite on {dev.type}: rc "
                          f"{suite['rc']}, {suite['failed'][:5]}")
        if c["passed"] <= 0:
            failed.append("reference suite: no case passed")
        if dev.type == "cuda" and suite["launches"] <= 0:
            failed.append("reference suite: the prefix kernel never launched")
        prefix_cuda.launches = 0
        prefix_cuda.tile_launches = 0
        prefix_cuda.launches_by_shape.clear()
        inv = reference_invariants(dev)
        out["invariants"] = inv["widths"]
        failed += inv["failed"]
        out["invariant_launches"] = prefix_cuda.launches
        out["invariant_by_shape"] = {
            f"K={k},N={n},M={m}": v for (k, n, m), v
            in sorted(prefix_cuda.launches_by_shape.items())}
        if dev.type == "cuda" and prefix_cuda.launches <= 0:
            failed.append("invariants: the prefix kernel never launched")
    finally:
        out["card"] = smi_line()
        out["failed_checks"] = failed
        out["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"reference": out}), flush=True)
    if failed:
        raise AssertionError(f"reference: {failed[0]} ({len(failed)} "
                             "failed)")
    if out["phase_s"] > REF_PHASE_LIMIT_S:
        raise AssertionError(f"reference phase took {out['phase_s']:.1f} "
                             f"s, over {REF_PHASE_LIMIT_S} s")
    return {"prefix": suite["launches"] + out["invariant_launches"],
            "suite_by_shape": suite["by_shape"],
            "invariant_by_shape": out["invariant_by_shape"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi_line()
    print(json.dumps({"device": name, "count": count, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "numpy": np.__version__}),
          flush=True)
    print(card, flush=True)

    # Both kernels' libraries, one nvcc for each source, and the client
    # shim (the host C++ compiler), started together.
    from concurrent.futures import ThreadPoolExecutor

    from sentinel_tpu_torch import native
    from sentinel_tpu_torch.ops import cluster_acquire

    def timed_build(build):
        tb = time.perf_counter()
        return build(), time.perf_counter() - tb

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(timed_build, m.build) for m in (prefix_cuda,
                                                              cluster_acquire)]
        shim_build = pool.submit(timed_build, native.build_shim)
        built = [b.result()[0] for b in builds]
        shim_path, shim_build_s = shim_build.result()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "libraries": [p.name for p, _ in built]
                      + [shim_path.name],
                      "shim_build_s": shim_build_s}), flush=True)
    for _, log in built:
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print("ptxas:", line.strip(), flush=True)

    main_shape, max_err = kernel_phase(dev)
    main_results, main_launches, main = main_path_phase(dev)
    profile_phase(dev)
    parity_phase()
    api_phase(dev)
    pipeline_phase(dev)
    _, slot_run = slot_phase(dev)
    boot_phase(dev, main, slot_run)
    main["eng"].close()
    rollout_phase(dev, main_results)
    cluster = cluster_phase(dev)
    pod = pod_phase(dev)
    control_launches = control_phase(dev)
    ha_launches = ha_phase(dev)
    llm_launches = llm_phase(dev)
    ds_launches = datasource_phase(dev)
    edge_launches = edge_phase(dev)
    ops_launches = ops_phase(dev)
    dash_launches = dashboard_phase(dev)
    native_launches = native_phase(dev, shim_build_s)
    ref_launches = reference_phase(dev)

    print(json.dumps({"smoke_wall_s": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "segmented_prefix",
        "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/segmented_prefix.cu",
        "replaces": "sentinel_tpu/ops/pallas_prefix.py:40",
        "replaces_function": "prefix_pallas",
        "design": main_shape["design"],
        "launches": main_launches,
        "bit_equal": True,
        "max_abs_err": max_err,
        "ms": main_shape["kernel_ms"],
        "previous_ms": main_shape["previous_ms"],
        "previous_design": "tile_walk",
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "call_ms": main_shape["call_ms"],
        "library_ms": None,
        "shape": main_shape["shape"],
        "cluster_path_launches": cluster["prefix_launches"],
        "pod_path_launches": pod["full"]["prefix_launches"],
        "pod_path_launches_per_step":
            pod["full"]["prefix_launches_per_pod_step"],
        "control_path_launches": control_launches["prefix"],
        "llm_path_launches": llm_launches["llm"]["launches"],
        "llm_path_launches_by_shape": llm_launches["llm"]["by_shape"],
        "sim_path_launches": llm_launches["sim"]["launches"],
        "sim_path_launches_by_shape": llm_launches["sim"]["by_shape"],
        "datasource_path_launches": ds_launches["prefix"],
        "datasource_path_launches_by_shape": ds_launches["prefix_by_shape"],
        "edge_path_launches": edge_launches["prefix"],
        "edge_path_launches_by_shape": edge_launches["prefix_by_shape"],
        "ops_path_launches": ops_launches["prefix"],
        "ops_path_launches_by_shape": ops_launches["prefix_by_shape"],
        "dashboard_path_launches": dash_launches["prefix"],
        "dashboard_path_launches_by_shape": dash_launches["prefix_by_shape"],
        "native_path_launches": native_launches["prefix"],
        "native_path_launches_by_shape": native_launches["prefix_by_shape"],
        "reference_path_launches": ref_launches["prefix"],
        "reference_suite_launches_by_shape": ref_launches["suite_by_shape"],
        "reference_invariant_launches_by_shape":
            ref_launches["invariant_by_shape"],
    }, dict(acquire_kernel_entry(cluster),
            control_path_launches=control_launches["acquire"],
            control_path_launches_by_width=control_launches[
                "acquire_by_width"],
            ha_path_launches=ha_launches["acquire"],
            ha_path_launches_by_width=ha_launches["acquire_by_width"],
            datasource_path_launches=ds_launches["acquire"],
            datasource_path_launches_by_width=ds_launches[
                "acquire_by_width"],
            edge_path_launches=edge_launches["acquire"],
            edge_path_launches_by_width=edge_launches[
                "acquire_by_width"],
            dashboard_path_launches=dash_launches["acquire"],
            dashboard_path_launches_by_width=dash_launches[
                "acquire_by_width"],
            native_path_launches=native_launches["acquire"],
            native_path_launches_by_width=native_launches[
                "acquire_by_width"])]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--client-token-server"]:
        sys.exit(client_token_server(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--reference-suite"]:
        sys.exit(reference_suite(sys.argv[2]))
    sys.exit(main())
