"""Process wiring: the factory graph + manager.

reference: cmd/controller/main.go:40-77 — flags, scheme, manager, cloud
provider registry, producer/metrics-client/autoscaler factories, controller
registration. KarpenterRuntime is that wiring.

The port's copy of karpenter_tpu/runtime.py. What differs:

  * `Options.device` names where the shared SolverService runs: None
    (or "cuda") is the CUDA card, and construction raises without one;
    "cpu" runs the plain PyTorch and numpy programs on the host.
  * The three shard options (solver_shard_threshold,
    solver_shard_devices, solver_shard_mesh) reach the service as in the
    reference; its mesh spans the process's own devices, so on one card
    it serves exactly as the reference's does (whose mesh needs two).
  * With partitions the runtime is one replica of the replicated
    control plane (replication/), as the reference's is. Its service is
    built, and on the card its kernels too, before the plane writes any
    Lease: without a card the construction raises first.
  * The solver introspection plane's memory source reads the card
    (torch.cuda.memory_stats); a runtime on the CPU reports none, as the
    reference's does on a CPU device.
  * With tenant_config the multi-tenant scheduler holds the card rule
    (tenancy/scheduler.py): on the card a degraded tenant takes its own
    device dispatch, never a numpy mirror.
  * Prewarm (prewarm_compile) raises when a family's warm dispatch
    fails, instead of logging and booting degraded.
  * compile_cache_dir is the directory the CUDA kernels build into
    (utils/backend.configure_compile_cache).
  * With `solver_uri` the card lives in the solver sidecar
    (python -m karpenter_tpu_torch.sidecar): this process builds no
    kernel and needs no card, its service runs its host rungs on the CPU
    and sends the bin-pack and the decide over gRPC. `device` still
    names what the operator asked for. Under None / "cuda" the sidecar
    must answer Health with backend "cuda" before anything else is
    built, and a failed Solve or Decide raises SolverDeviceError (or
    SolverTimeout), never an answer from numpy; under "cpu" the
    reference's numpy ladder stays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from karpenter_tpu_torch.autoscaler import BatchAutoscaler
from karpenter_tpu_torch.cloudprovider import Options as CloudOptions
from karpenter_tpu_torch.cloudprovider import registry as provider_registry
from karpenter_tpu_torch.controllers import (
    HorizontalAutoscalerController,
    Manager,
    MetricsProducerController,
    ScalableNodeGroupController,
)
from karpenter_tpu_torch.metrics.clients import MetricsClientFactory
from karpenter_tpu_torch.metrics.producers import ProducerFactory
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.store import Store


@dataclass
class Options:
    """reference: main.go:40-46 (minus ports, which live in observability)."""

    prometheus_uri: Optional[str] = None  # None = in-process registry client
    cloud_provider: Optional[str] = None  # None = env/default (not-implemented)
    solver_uri: Optional[str] = None  # host:port of a solver sidecar
    # (sidecar/client.py); None = in-process device solve
    data_dir: Optional[str] = None  # WAL+snapshot dir; None = in-memory only
    verbose: bool = False
    # opt-in consolidation engine (karpenter_tpu/consolidation): batched
    # node-drain planning + cordon→verify→drain actuation through the
    # ScalableNodeGroup controller. Off by default: draining nodes is a
    # disruptive posture an operator must choose (--consolidate).
    consolidate: bool = False
    # solver hot-path tuning (docs/solver-service.md "Latency tuning"):
    # the MAX coalescing window (adaptive: an idle queue dispatches
    # immediately) and the in-flight dispatch cap (1 = double-buffered
    # pipeline, 0 = serial)
    solver_window_s: float = 0.002
    solver_pipeline_depth: int = 1
    # sharded dispatch (docs/solver-service.md "Sharded dispatch"):
    # requests whose pods x groups cell count reaches the threshold ride
    # the multi-device mesh; 0 disables. shard_devices caps the mesh
    # device count (None = every visible device); shard_mesh_shape pins
    # explicit (pods, groups) extents instead of the pods-major
    # factorization.
    solver_shard_threshold: int = 1 << 24
    solver_shard_devices: Optional[int] = None
    solver_shard_mesh: Optional[tuple] = None
    # device-resident fleet state (docs/solver-service.md
    # "Device-resident fleet state"): singleton solve dispatches keep
    # their operand stack resident on device and churn applies as
    # batched scatter updates — bit-identical to the re-upload path,
    # so ON by default; False pins the upload-every-dispatch posture
    # (the bench-resident OFF arm and an operator escape hatch).
    solver_resident: bool = True
    # degradation-ladder tuning (docs/resilience.md):
    # engine requeue backoff under retryable failures — first retry in
    # ~[base, 3*base], monotone up to the cap
    backoff_base_s: float = 1.0
    backoff_cap_s: float = 60.0
    # per-node-group actuation circuit breaker: consecutive provider
    # failures before opening, and the open window before a half-open
    # probe reconcile is admitted
    circuit_failure_threshold: int = 5
    circuit_reset_s: float = 120.0
    # solver backend health FSM: consecutive device failures before a
    # wholesale trip to numpy, probe cadence while degraded, and the
    # hung-worker watchdog timeout (0 disables the watchdog)
    solver_health_threshold: int = 3
    solver_probe_interval_s: float = 5.0
    solver_watchdog_timeout_s: float = 30.0
    # predictive scaling (docs/forecasting.md): metric-history ring
    # capacity per series, and how old a history sample may be and still
    # stand in for a FAILED live metric query (the stale-metric bridge;
    # 0 disables reuse). Forecasting itself is opt-in per HA via
    # spec.behavior.forecast — these knobs size the shared machinery.
    forecast_history: int = 64
    stale_metric_max_age_s: float = 60.0
    # opt-in preemption engine (karpenter_tpu/preemption,
    # docs/preemption.md): batched eviction planning for high-priority
    # pending pods + budgeted eviction actuation, coordinated with
    # consolidation. Off by default: evicting workloads is a disruptive
    # posture an operator must choose (--preempt).
    preempt: bool = False
    # default max concurrent evictions charged against one node group
    # per hold window (120s; spec.eviction_budget overrides per group)
    preempt_budget: int = 1
    # fleet default priority for pods naming an unknown PriorityClass
    # (--default-priority): feeds the census encoder AND the engines
    default_pod_priority: int = 0
    # crash-safe controller state (karpenter_tpu/recovery,
    # docs/resilience.md "Crash recovery"): directory for the
    # protective-state journal + checkpoints + fence generation. None =
    # ephemeral (a restart cold-starts FSMs/holds/budgets/backoff/
    # forecast state and actuation is unfenced — the pre-PR-7 posture).
    journal_dir: Optional[str] = None
    # full manager ticks a RECOVERED boot holds the warm-up: no
    # consolidation or preemption planning until this many reconcile
    # passes have confirmed fleet state (first boots skip it)
    recovery_warmup_ticks: int = 1
    # cost model knobs (karpenter_tpu/cost, docs/cost.md): price for
    # catalog-unknown instance types and the spot-tier multiplier. The
    # subsystem itself is opt-in per HA (spec.behavior.slo) and per
    # node group (spec.warmPool) — these size the shared pricing only.
    cost_default_hourly: float = 1.0
    cost_spot_multiplier: float = 0.35
    # pluggable pricing feed (cost/pricing.py, docs/cost.md): a
    # JSON/YAML catalog file reloaded on mtime change, consulted before
    # the built-in catalog. None = built-in catalog only.
    pricing_file: Optional[str] = None
    # simulation seed (--sim-seed, docs/simulator.md): one seed threaded
    # through every SEEDED SimLab scenario's RNG streams. None = each
    # scenario's pinned default, keeping replay digests byte-identical.
    sim_seed: Optional[int] = None
    # multi-tenant control plane (karpenter_tpu/tenancy,
    # docs/multitenancy.md): path to a tenant-config file (--tenant-
    # config). None = single-tenant, byte-identical to the pre-tenancy
    # wiring; set, the runtime builds a TenantRegistry of namespaced
    # per-cluster stacks and a MultiTenantScheduler batching
    # cross-tenant work through the one shared SolverService.
    tenant_config: Optional[str] = None
    # tenant-weighted solve deadlines (docs/multitenancy.md): bounds a
    # deferred tenant's wall-clock wait behind earlier admission
    # rounds — each tenant's budget is this many seconds scaled by
    # weight / mean weight; an exhausted budget serves the tenant
    # immediately from the bit-identical mirror and counts a deferral.
    # None = unbounded wait (fairness still bounds rows per round).
    tenant_deadline_s: Optional[float] = None
    # this control plane's OWN tenant id (--tenant-id): stamped as gRPC
    # metadata on every sidecar RPC so a SHARED solver sidecar can
    # attribute traffic per tenant (the other multi-tenant topology:
    # many control-plane processes, one solver service). None = no
    # metadata, the single-tenant wire.
    tenant_id: Optional[str] = None
    # decision provenance ledger (observability/provenance.py,
    # docs/observability.md "Decision provenance"): record the full
    # input chain behind every HA decision into a bounded columnar ring
    # (/debug/decisions, JSONL next to --trace-export). Default OFF,
    # matching tracing's posture: provenance is telemetry, and the off
    # path must stay mark-free (property-pinned byte-identical).
    provenance: bool = False
    # control-plane self-SLO monitor (observability/selfslo.py): the
    # e2e-latency objective (seconds against the
    # karpenter_reconcile_e2e_seconds histogram — pick a bucket bound)
    # and the SLO target the multi-window burn rates measure against.
    selfslo_objective_s: float = 1.0
    selfslo_target: float = 0.99
    # solver introspection plane (observability/devicetelemetry.py,
    # docs/observability.md "Device telemetry & introspection"):
    # compile ledger + compile-storm trips, device memory telemetry +
    # the self-SLO memory source, XLA cost attribution on dispatch
    # spans, /debug/solver. Default OFF, matching tracing/provenance:
    # the off path is property-pinned byte-identical and mark-free.
    introspect: bool = False
    # compile-cache misses inside ONE tick window (after steady state)
    # that count as a compile storm, and the bytes_in_use/bytes_limit
    # ratio that trips the device-memory high watermark
    introspect_storm_threshold: int = 4
    introspect_memory_watermark: float = 0.9
    # event-driven reconcile (docs/solver-service.md "Event-driven
    # reconcile"): watch events schedule debounced coalesced event
    # passes over the dirty keys, demoting the periodic tick to a
    # resync backstop. Off by default — the tick-paced loop is
    # byte-identical with the flag absent (--event-driven). The
    # debounce window bounds solve amplification under event storms:
    # everything landing inside one window rides ONE pass.
    event_driven: bool = False
    event_debounce_s: float = 0.05
    # INTERNAL (simulate + tests): False runs NO debounce thread — the
    # harness drives Manager.run_event_pass itself on the scripted
    # clock, keeping replays deterministic. The CLI never sets this.
    event_thread: bool = True
    # boot-time compile-cache pre-warm (docs/solver-service.md
    # "Compile pre-warm"): compile the smallest bucket rungs of the
    # always-on kernel families (solve + decide) before the first
    # event arrives, so a cold plane's first event pass doesn't eat a
    # first-touch jit compile (hotpath BASELINE: idle p99 533 ms vs
    # p50 30 ms). Skipped per rung when the compile cache already
    # hits; the persistent cache (KARPENTER_COMPILE_CACHE) turns the
    # remaining cost into a disk read.
    prewarm_compile: bool = False
    # fused steady-state tick (ops/fusedtick.py, docs/solver-service.md
    # "Fused tick"): route the batched autoscaler's forecast -> decide
    # -> cost chain through ONE compiled program per tenant batch
    # (SolverService.fused_tick) instead of 3+ per-stage dispatches
    # with host round-trips between them. Default OFF — the unfused
    # wire stays byte-identical; --fused-tick (or --profile
    # production) turns it on. Outputs are property-pinned bitwise
    # equal to the chained path, so this is latency-only.
    fused_tick: bool = False
    # persistent compile cache directory (--compile-cache-dir): the
    # first-class promotion of the KARPENTER_COMPILE_CACHE env var,
    # matching the sidecar's flag of the same name. Set, jit compiles
    # taking >=1s persist to disk and a restarted process reloads them
    # instead of recompiling (utils/backend.configure_compile_cache).
    # None = env var only (the pre-flag wire).
    compile_cache_dir: Optional[str] = None
    # joint pool-group allocation (karpenter_tpu/poolgroups,
    # docs/poolgroups.md): PoolGroup CRDs name member autoscalers with
    # cross-pool ratio bands and shared budgets; the engine excludes
    # members from the independent cost ladders and refines them in ONE
    # joint dispatch (SolverService.poolgroup). Default OFF — with the
    # flag absent (or no PoolGroup objects) the wire is byte-identical
    # to the uncoordinated plane (--poolgroups).
    poolgroups: bool = False
    # replicated control plane (karpenter_tpu/replication,
    # docs/resilience.md "Replicated control plane"): partition tenants
    # across N leader-elected replicas with fenced handoff. partitions=0
    # (default) builds NOTHING — no lease objects, no lease traffic, no
    # replica metrics: the single-replica wire is byte-identical, per
    # the tracing/provenance/introspection off-path precedent.
    partitions: int = 0
    # this replica's identity on the lease plane (--replica-id); None =
    # a generated karpenter-<hex> identity (fine for a single process,
    # useless for operators correlating /debug/replicas across a fleet)
    replica_id: Optional[str] = None
    # partition/heartbeat lease duration in seconds (--lease-duration):
    # the failover detection horizon — a dead replica's tenants are
    # adoptable one lease duration (plus skew tolerance) after its last
    # renew
    lease_duration_s: float = 15.0
    # where the shared SolverService runs: None (or "cuda") = the CUDA
    # card, raising without one; "cpu" = the host, the counterpart of the
    # reference's JAX_PLATFORMS=cpu
    device: Optional[str] = None


class KarpenterRuntime:
    def __init__(
        self,
        options: Optional[Options] = None,
        store: Optional[Store] = None,
        registry: Optional[GaugeRegistry] = None,
        cloud_provider_factory=None,
        clock=None,
        solver_client=None,
    ):
        import time as _time

        options = options or Options()
        self.options = options
        self.manager = self.solver_service = self.recovery = None
        # a client of options.solver_uri whose Health gate the caller
        # already passed (the binary checks it before its first LIST);
        # the runtime owns and closes it
        self.solver_client = solver_client
        self.clock = clock or _time.time
        self._owns_store = store is None
        self.store = store if store is not None else self._open_store(options)
        self.registry = registry if registry is not None else GaugeRegistry()
        try:
            self._wire(options, cloud_provider_factory)
        except BaseException:
            # a boot that fails (no card, a failed kernel build or
            # pre-warm) stops the threads it started before raising
            self.close()
            raise

    def _wire(self, options: "Options", cloud_provider_factory) -> None:
        # the kernels' build directory, set BEFORE anything can build
        # them (a loaded library stays where it was built): the embedded
        # Options path mirrors __main__'s flag/env resolution so a
        # runtime built in-process (tests, library use) reuses the same
        # builds as the CLI.
        if options.compile_cache_dir:
            from karpenter_tpu_torch.utils.backend import configure_compile_cache

            configure_compile_cache(options.compile_cache_dir)

        self._bind_observability(options)

        # crash-safe state subsystem (karpenter_tpu/recovery): built
        # FIRST — it claims the fence generation durably before anything
        # can actuate, and replays the protective-state journal the
        # subsystems below restore from
        self.recovery = self._build_recovery(options)

        self.cloud_provider = (
            cloud_provider_factory
            if cloud_provider_factory is not None
            else provider_registry.new_factory(
                CloudOptions(store=self.store), provider=options.cloud_provider
            )
        )
        self._seed_fence_validator()
        device_solver, decider = self._build_solver_client(options)
        # ALL bin-pack callers route through the shared solve service
        # (solver/service.py): coalescing, shape buckets, backpressure,
        # the health FSM, and a metrics surface in THIS runtime's
        # registry so /metrics exposes it with no extra wiring. On the
        # card it builds the CUDA kernels here, and a failed build
        # raises; it never answers from numpy there. Split from its
        # card (solver_uri) it runs on the host and fronts the sidecar
        # client, under the card's failure rule when the card was asked
        # for.
        from karpenter_tpu_torch.solver import SolverService

        split = device_solver is not None
        self.solver_service = SolverService(
            registry=self.registry,
            window_s=options.solver_window_s,
            pipeline_depth=options.solver_pipeline_depth,
            health_failure_threshold=options.solver_health_threshold,
            health_probe_interval_s=options.solver_probe_interval_s,
            watchdog_timeout_s=options.solver_watchdog_timeout_s,
            shard_threshold=options.solver_shard_threshold,
            shard_devices=options.solver_shard_devices,
            shard_mesh_shape=options.solver_shard_mesh,
            resident=options.solver_resident,
            device="cpu" if split else options.device,
            card_rule=split and options.device != "cpu",
            device_solver=device_solver,
            decider=decider,
        )
        # the solver introspection plane (observability/devicetelemetry
        # .py): ALWAYS built — a disabled plane is one attribute read
        # per hook — and enabled by --introspect. Attached to the
        # service so dispatch sites note first-time events; evaluated
        # once per manager tick (_on_tick).
        from karpenter_tpu_torch.observability import SolverIntrospection

        self.solver_introspection = SolverIntrospection(
            enabled=options.introspect,
            registry=self.registry,
            clock=self.clock,
            recorder=self.flight_recorder,
            storm_threshold=options.introspect_storm_threshold,
            watermark=options.introspect_memory_watermark,
        ).attach(self.solver_service)
        self._reset_caches_for_recovery()
        self.producer_factory = ProducerFactory(
            self.store, self.cloud_provider, registry=self.registry,
            solver=self.solver_service.solve,
            default_priority=options.default_pod_priority,
        )
        # predictive scaling (forecast/, docs/forecasting.md): history,
        # skill gating, and the batched forecast riding the solve
        # service's queue/compile-cache/FSM; the metrics clients feed
        # the query-keyed warm pool through the observer hook
        from karpenter_tpu_torch.forecast import FleetForecaster

        self.forecaster = FleetForecaster(
            forecast_fn=self.solver_service.forecast,
            registry=self.registry,
            clock=self.clock,
            capacity=options.forecast_history,
            stale_max_age_s=options.stale_metric_max_age_s,
        )
        self._attach_recovery_forecast()
        self.metrics_clients = MetricsClientFactory(
            registry=self.registry, prometheus_uri=options.prometheus_uri,
            observer=self.forecaster.observe_query,
        )
        # cost/SLO subsystem (cost/, docs/cost.md): the multi-objective
        # refinement of the fleet decide through SolverService.cost and
        # the forecast-risk-sized warm pools it signals. Always built —
        # an SLO-free fleet pays one list comprehension per tick and
        # decisions stay bit-identical (the engine's zero-overhead
        # opt-out contract).
        from karpenter_tpu_torch.cost import (
            CostEngine,
            CostModel,
            WarmPoolEngine,
            pricing_source_for,
        )

        self.cost_model = CostModel(
            default_hourly=options.cost_default_hourly,
            spot_multiplier=options.cost_spot_multiplier,
            pricing=pricing_source_for(options.pricing_file),
        )
        self.cost_engine = CostEngine(
            store=self.store,
            cost_fn=self.solver_service.cost,
            model=self.cost_model,
            forecaster=self.forecaster,
            registry=self.registry,
        )
        # joint pool-group allocation (--poolgroups, poolgroups/,
        # docs/poolgroups.md): built only under the flag — the absent
        # engine keeps the autoscaler wire byte-identical
        self.pool_engine = None
        headroom_source = self.cost_engine.headroom
        if options.poolgroups:
            from karpenter_tpu_torch.poolgroups import PoolGroupEngine

            self.pool_engine = PoolGroupEngine(
                store=self.store,
                poolgroup_fn=self.solver_service.poolgroup,
                model=self.cost_model,
                forecaster=self.forecaster,
                registry=self.registry,
            )

            def headroom_source(ns, name, _cost=self.cost_engine.headroom,
                                _pool=self.pool_engine.headroom):
                # warm pools size from the WORST risk either refiner
                # sees for the target group
                return max(_cost(ns, name), _pool(ns, name))

        self.warmpool = WarmPoolEngine(
            headroom_source=headroom_source,
            registry=self.registry,
        )
        self.batch_autoscaler = BatchAutoscaler(
            self.metrics_clients, self.store, clock=self.clock,
            decider=self.solver_service.decide,
            forecaster=self.forecaster,
            cost_engine=self.cost_engine,
            pool_engine=self.pool_engine,
            tenant=options.tenant_id,
            # --fused-tick: the forecast -> decide -> cost chain rides
            # ONE compiled program per batch through the service's
            # fused seam (same FSM/ledger/never-block ladder). None
            # keeps the chained per-stage wire byte-identical.
            fused_tick_fn=(
                self.solver_service.fused_tick
                if options.fused_tick else None
            ),
        )
        self._build_disruption_engines(options)
        # Registration order = in-tick evaluation order. Producers run first
        # so signals are fresh, then node groups observe, then the batched
        # autoscaler decides — one tick moves a signal end to end (the
        # reference's produce→scrape→poll chain costs up to 20s of interval
        # latency; SURVEY.md §6).
        backoff_journal = None
        if self.recovery is not None:
            backoff_journal = self.recovery.handle("backoff")
        # the composed hook: recovery bookkeeping + the self-SLO
        # evaluation, both once per manager tick (_on_tick)
        tick_hook = self._on_tick
        self._sng_controller = ScalableNodeGroupController(
            self.cloud_provider, consolidator=self.consolidation,
            preemptor=self.preemption,
            warmpool=self.warmpool,
            registry=self.registry,
            circuit_failure_threshold=options.circuit_failure_threshold,
            circuit_reset_s=options.circuit_reset_s,
            clock=self.clock,
            recovery=self.recovery,
        )
        self.manager = Manager(
            self.store, clock=self.clock, registry=self.registry,
            solver_service=self.solver_service,
            backoff_base_s=options.backoff_base_s,
            backoff_cap_s=options.backoff_cap_s,
            tick_hook=tick_hook,
            recovery_journal=backoff_journal,
            event_driven=options.event_driven,
            event_debounce_s=options.event_debounce_s,
            event_thread=options.event_thread,
        ).register(
            MetricsProducerController(self.producer_factory),
            self._sng_controller,
            HorizontalAutoscalerController(
                self.batch_autoscaler, solver_service=self.solver_service
            ),
        )
        self._build_tenancy(options)
        self._build_replication(options)
        self._build_selfslo(options)
        self._finish_recovery_boot()
        self._maybe_prewarm(options)

    def _build_disruption_engines(self, options: Options) -> None:
        """The opt-in disruption engines (consolidation + preemption),
        coordinated both ways: preemption skips consolidation's
        in-flight nodes, and consolidation's candidate gate consults
        preemption's holds (node_guard). Their gauges land in THIS
        runtime's registry."""
        self.consolidation = None
        if options.consolidate:
            from karpenter_tpu_torch.consolidation import ConsolidationEngine

            self.consolidation = ConsolidationEngine(
                self.store,
                solver_service=self.solver_service,
                registry=self.registry,
                clock=self.clock,
            )
            self._attach_recovery_engine(
                "consolidation", self.consolidation
            )
        # preemption engine (opt-in): batched eviction planning through
        # SolverService.preempt, actuating budgeted evictions through
        # the store; coordinated BOTH ways with consolidation — it
        # skips consolidation's in-flight nodes, and consolidation's
        # candidate gate consults its holds (node_guard)
        self.preemption = None
        if options.preempt:
            from karpenter_tpu_torch.preemption import (
                PreemptionConfig,
                PreemptionEngine,
            )

            self.preemption = PreemptionEngine(
                self.store,
                solver_service=self.solver_service,
                consolidation=self.consolidation,
                registry=self.registry,
                config=PreemptionConfig(
                    budget_per_group=options.preempt_budget,
                    default_priority=options.default_pod_priority,
                ),
                clock=self.clock,
            )
            self._attach_recovery_engine("preemption", self.preemption)
            if self.consolidation is not None:
                self.consolidation.node_guard = (
                    self.preemption.active_nodes
                )

    def _maybe_prewarm(self, options: Options) -> None:
        """Boot-time pre-warm (docs/solver-service.md "Compile
        pre-warm"), run LAST: the warm-up drives real (tiny) dispatches
        through the fully-wired service, so it must not race recovery
        restore or observe a half-built runtime. A family whose warm
        dispatch failed raises here: the process must not boot onto a
        device path that already failed."""
        if options.prewarm_compile:
            families = ("solve", "decide")
            if options.fused_tick:
                # the fused tick joins the warm list only when the tick
                # will actually dispatch it
                families += ("fused",)
            report = self.solver_service.prewarm(families)
            failed = {
                family: entry["error"]
                for family, entry in report.items() if "error" in entry
            }
            if failed:
                raise RuntimeError(f"pre-warm failed at boot: {failed}")

    @staticmethod
    def _open_store(options: Options):
        from karpenter_tpu_torch.store.persistence import open_store

        return open_store(options.data_dir)

    def _bind_observability(self, options: Options) -> None:
        """Observability wiring (docs/observability.md): the process
        tracer, flight recorder, and decision-provenance ledger publish
        their counters + the karpenter_reconcile_e2e_seconds histogram
        into THIS runtime's registry, and trip-class recorder events
        dump crash-safely into --journal-dir next to the recovery
        journal. The ledger is enabled only under --provenance (and
        never force-disabled here — a test that enabled the process
        default keeps it)."""
        from karpenter_tpu_torch.observability import (
            default_flight_recorder,
            default_ledger,
            default_tracer,
        )

        self.tracer = default_tracer()
        self.tracer.bind_registry(self.registry)
        self.flight_recorder = default_flight_recorder()
        self.flight_recorder.bind_registry(self.registry)
        if options.journal_dir:
            self.flight_recorder.configure(dump_dir=options.journal_dir)
        self.decision_ledger = default_ledger()
        self.decision_ledger.bind_registry(self.registry)
        if options.provenance:
            self.decision_ledger.enabled = True

    def _build_tenancy(self, options: Options) -> None:
        """Multi-tenant control plane (docs/multitenancy.md): with a
        tenant config, the registry namespaces per-cluster stacks and
        the scheduler batches cross-tenant decide/cost/forecast through
        THIS runtime's shared SolverService. Without one, nothing is
        built and every existing path is byte-identical."""
        self.tenancy = None
        self.tenant_scheduler = None
        if not options.tenant_config:
            return
        from karpenter_tpu_torch.tenancy import (
            MultiTenantScheduler,
            TenantRegistry,
            load_tenant_config,
        )

        specs = load_tenant_config(options.tenant_config)
        self.tenancy = TenantRegistry(
            service=self.solver_service,
            registry=self.registry,
            journal_dir=options.journal_dir,
            clock=self.clock,
            specs=specs,
        )
        self.tenant_scheduler = MultiTenantScheduler(
            self.tenancy, self.solver_service,
            deadline_s=options.tenant_deadline_s,
        )

    def _build_replication(self, options: Options) -> None:
        """Replicated control plane (docs/resilience.md "Replicated
        control plane"): with --partitions, this process becomes one
        leader-elected replica — per-partition CAS leases over the
        store, rendezvous-hash tenant assignment, fenced tenant handoff
        on the per-tenant journal dirs, all advanced once per manager
        tick. partitions=0 (the default) builds nothing: no Lease
        objects, no lease traffic, no karpenter_replica_* gauges — the
        single-replica wire stays byte-identical."""
        self.replication = None
        if options.partitions <= 0:
            return
        from karpenter_tpu_torch.replication import ReplicatedControlPlane

        tenants_source = None
        journal_dir_for = None
        if self.tenancy is not None:
            tenants_source = self.tenancy.tenants
            journal_dir_for = self.tenancy.journal_dir_for
        self.replication = ReplicatedControlPlane(
            self.store,
            replica_id=options.replica_id or None,
            partitions=options.partitions,
            lease_duration=options.lease_duration_s,
            tenants_source=tenants_source,
            journal_dir_for=journal_dir_for,
            validator=getattr(
                self.cloud_provider, "fence_validator", None
            ),
            warmup_ticks=options.recovery_warmup_ticks,
            registry=self.registry,
            clock=self.clock,
            recorder=self.flight_recorder,
        )

    def _build_selfslo(self, options: Options) -> None:
        """The control plane's self-SLO monitor (observability/selfslo):
        multi-window burn rates over its OWN e2e-latency histogram plus
        the solver backend FSM, (when multi-tenant) the per-tenant
        breaker board, the card's memory watermark and (when replicated)
        the replica's lease and handoff health; evaluated once per
        manager tick via the tick hook, served at /debug/selfslo.
        Always built — one snapshot tuple per tick."""
        from karpenter_tpu_torch.observability import SelfSLOMonitor

        tenant_source = None
        if self.tenant_scheduler is not None:
            breakers = self.tenant_scheduler.breakers
            registry = self.tenancy

            def tenant_source():
                return {
                    tenant: breakers.is_open(tenant)
                    for tenant in registry.tenants()
                }

        self.selfslo = SelfSLOMonitor(
            registry=self.registry,
            objective_s=options.selfslo_objective_s,
            target=options.selfslo_target,
            clock=self.clock,
            histogram=self.registry.gauge("reconcile", "e2e_seconds"),
            fsm_source=self.solver_service.backend_health,
            tenant_source=tenant_source,
            # the fourth source (observability/devicetelemetry.py): the
            # card's memory high watermark — quiet (None) while the
            # introspection plane is off or the service is on the CPU
            memory_source=self.solver_introspection.memory_source,
            # the fifth source (replication/plane.py): lease renew
            # failures / in-flight handoffs burn budget — quiet (None)
            # in the single-replica deployment
            replica_source=(
                self.replication.slo_source
                if self.replication is not None else None
            ),
            recorder=self.flight_recorder,
        )

    def _on_tick(self) -> None:
        """Composed manager tick hook: recovery bookkeeping (warm-up
        countdown, checkpoint cadence), then the replica's lease round
        and handoffs, then the solver introspection pass (compile-storm
        window close + device memory poll — it must run BEFORE the
        self-SLO evaluation so the memory source reflects THIS tick),
        then the self-SLO evaluation — the monitor must observe the tick
        INCLUDING any degradation the tick just hit."""
        if self.recovery is not None:
            self.recovery.on_tick()
        replication = getattr(self, "replication", None)
        if replication is not None:
            # the lease round + fenced handoffs run BEFORE the self-SLO
            # evaluation so a mid-failover tick burns budget as one
            replication.on_tick()
        introspection = getattr(self, "solver_introspection", None)
        if introspection is not None:
            introspection.on_tick()
        selfslo = getattr(self, "selfslo", None)
        if selfslo is not None:
            selfslo.evaluate()

    def _build_solver_client(self, options: Options):
        """(device_solver, decider) seams for the gRPC process split:
        with a sidecar configured the control-plane process runs NO
        device math — the decision program rides the same split. The
        sidecar's Health answer is held to `options.device` first
        (sidecar/client.require_backend) unless the caller handed in a
        client it already checked; on the card's rule the seams raise the
        card's errors (sidecar/client.card_seams)."""
        if not options.solver_uri:
            return None, None
        from karpenter_tpu_torch.sidecar.client import (
            SolverClient,
            card_seams,
            require_backend,
        )

        if self.solver_client is None:
            self.solver_client = SolverClient(
                options.solver_uri, tenant=options.tenant_id
            )
            require_backend(self.solver_client, options.device)
        if options.device in (None, "cuda"):
            return card_seams(self.solver_client)
        return self.solver_client.solve, self.solver_client.decide

    def _build_recovery(self, options: Options):
        if not options.journal_dir:
            return None
        from karpenter_tpu_torch.recovery import RecoveryManager

        return RecoveryManager(
            options.journal_dir,
            registry=self.registry,
            clock=self.clock,
            warmup_ticks=options.recovery_warmup_ticks,
        )

    def _seed_fence_validator(self) -> None:
        """Raise the provider's fence floor to this incarnation's
        generation at boot: a stale (restarted-over) incarnation is
        rejected even before our first actuation, and a provider
        factory freshly constructed by a restarted process does not
        start with an empty memory of generations."""
        if self.recovery is None:
            return
        validator = getattr(self.cloud_provider, "fence_validator", None)
        if validator is not None:
            validator.observe(self.recovery.fence.generation)

    def _reset_caches_for_recovery(self) -> None:
        """Recovery boot: identity-keyed PROCESS-LEVEL caches must
        rebuild cold — stale pre-crash entries (the encoder delta
        layer's same-object fast path + its resident scatter plans,
        compiled-program keys, device-resident operand stacks) must not
        be silently reused against post-restart state. This runtime's
        OWN SolverService is freshly constructed (already cold); the
        state that actually survives an in-process restart is the
        module-global encoder delta cache (reset_delta_cache also
        clears the scatter plans) and the process-default solver
        service (reset_caches also drops its ResidentFleetState)
        shared by simulate/sidecar embedders across runtime
        incarnations."""
        if self.recovery is None or not self.recovery.recovered:
            return
        from karpenter_tpu_torch.metrics.producers.pendingcapacity import (
            encoder as _encoder,
        )
        from karpenter_tpu_torch.solver.service import (
            reset_default_service_caches,
        )

        _encoder.reset_delta_cache()
        reset_default_service_caches()

    def _attach_recovery_forecast(self) -> None:
        """Forecast state journals (skill EWMAs as sets, history as
        bounded ring appends; the checkpoint stores rings columnar) and
        restores here, so the blend resumes with its earned skill
        instead of a cold start."""
        if self.recovery is None:
            return
        self.forecaster.journal = self.recovery.handle("forecast")
        self.forecaster.history.journal = self.recovery.handle("history")
        self.forecaster.restore_state(
            self.recovery.table("forecast"),
            self.recovery.table("history"),
        )
        self.recovery.register_snapshot(
            "forecast", self.forecaster.snapshot_state
        )
        self.recovery.register_snapshot(
            "history", self.forecaster.history.snapshot_rings
        )

    def _attach_recovery_engine(self, sub: str, engine) -> None:
        """Disruption-engine crash safety: FSM transitions / holds /
        budget charges journal WRITE-AHEAD of the effects they cover, a
        restarted controller restores them (resuming phases instead of
        re-planning disruption), and no planning happens until the
        recovery warm-up confirms fleet state."""
        if self.recovery is None:
            return
        engine.journal = self.recovery.handle(sub)
        engine.disruption_gate = self.recovery.allow_disruption
        engine.restore_state(self.recovery.table(sub))
        self.recovery.register_snapshot(sub, engine.snapshot_state)

    def _finish_recovery_boot(self) -> None:
        """Restore the requeue-backoff ladder (restored due times are
        capped at now + backoff cap) and compact the journal: every
        boot re-bounds it, so a restart storm cannot grow it."""
        if self.recovery is None:
            return
        self.manager.restore_backoff(self.recovery.table("backoff"))
        self.recovery.register_snapshot(
            "backoff", self.manager.snapshot_backoff
        )
        # drop restored breaker/intent state for groups deleted while
        # we were down — no Deleted event will ever fire for them
        self._sng_controller.prune_restored_missing(self.store)
        self.recovery.finish_boot()

    def run(self, duration: float) -> None:
        self.manager.run(duration)

    def close(self) -> None:
        if self.manager is not None:
            self.manager.close()
        if getattr(self, "replication", None) is not None:
            # surrender leases BEFORE the tenancy teardown: successors
            # can start adopting while this process finishes closing
            self.replication.close()
            self.replication = None
        if getattr(self, "tenancy", None) is not None:
            self.tenancy.close()
            self.tenancy = None
        if self.recovery is not None:
            self.recovery.close()
            self.recovery = None
        if self.solver_service is not None:
            self.solver_service.close()
        if self.solver_client is not None:
            self.solver_client.close()
            self.solver_client = None
        if self._owns_store and hasattr(self.store, "close"):
            self.store.close()
