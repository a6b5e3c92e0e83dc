"""The built-in SimLab scenarios (docs/simulator.md).

Every pre-existing `--simulate` world re-registers here: the `run`
callables are the former `__main__._run_simulation` branch bodies
moved verbatim (same simulate.py calls, same argument spellings, same
provenance save/restore and trace-export handoff), so the pinned
deterministic digests are preserved bit-identically. `--sim-seed`
threads through every seeded world via `_resolved_seed` — the default
resolves to the seed each world always hardcoded, so default-seed
digests don't move.

Each scenario also carries a `trails(seed)` generator for the gym
plane: a themed seeded episode (demand trace, next-tick forecast
preview, price-multiplier schedule, fault schedule drawn from the
chaos registry) that `SimEnv`/`BatchedSimEnv` step through the device
seam. Trails keep a fault-free constant-demand tail of ticks//4 so
every episode has a reachable fixed point after faults clear — the
recovery property the seeded fuzz test pins (step_limit 2.0 traverses
32 replicas across a 16-tick tail).

The port's copy of karpenter_tpu/simlab/builtin.py: the same thirteen
registrations in the same order, trails and selection predicates. Each
runner passes --device to its world (the card unless `cpu` is named),
except `failover`'s, whose world is host code.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from karpenter_tpu_torch.simlab.env import SimParams, SimTrails
from karpenter_tpu_torch.simlab.registry import Scenario, register_scenario

_F32 = np.float32

TRAIL_TICKS = 64
TRAIL_ROWS = 8
FAULT_POINT = "simlab.actuate"


def _resolved_seed(args, default: int) -> int:
    """--sim-seed when given, else the seed the world always hardcoded
    (so default digests are byte-identical to the pre-registry CLI)."""
    seed = getattr(args, "sim_seed", None)
    return int(default) if seed is None else int(seed)


# -- trail generators ------------------------------------------------------


def _fault_trail(seed: int, ticks: int, probability: float, tail: int):
    """A fault schedule drawn honestly from the chaos registry: one
    seeded error plan evaluated per tick (the registry's plan-local RNG
    stream makes the trail a pure function of the seed), with the last
    `tail` ticks left clear so the episode can recover."""
    from karpenter_tpu_torch.faults.registry import FaultRegistry

    trail = np.zeros(ticks, _F32)
    if probability <= 0.0:
        return trail
    registry = FaultRegistry(seed=seed)
    registry.plan(
        FAULT_POINT, mode="error", probability=probability, times=ticks
    )
    for t in range(ticks - tail):
        try:
            registry.fire(FAULT_POINT)
        except Exception:  # noqa: BLE001 — FaultInjected IS the signal
            trail[t] = 1.0
    return trail


def make_trails(  # lint: allow-complexity — one guard per trail theme knob
    seed: int,
    *,
    ticks: int = TRAIL_TICKS,
    rows: int = TRAIL_ROWS,
    base: float = 8.0,
    amplitude: float = 24.0,
    diurnal: bool = False,
    spike: float = 0.0,
    price_spike: float = 0.0,
    fault_probability: float = 0.0,
    params: SimParams = None,
) -> SimTrails:
    """One themed seeded episode (module docstring). All shaping runs
    in float64 and is cast to f32 once at the end, so the trails —
    like the kernels they feed — are a pure function of the seed."""
    p = params if params is not None else SimParams()
    rng = np.random.default_rng(seed)
    tail = ticks // 4
    row_scale = 0.5 + rng.random(rows)
    demand = base + rng.random((ticks, rows)) * amplitude * row_scale
    if diurnal:
        wave = np.clip(
            np.sin(2.0 * np.pi * np.arange(ticks) / ticks), 0.0, None
        )
        demand = demand * (0.25 + wave[:, None])
    if spike > 0.0:
        # a seeded burst third of the way in: the restart-storm /
        # preempt shape — demand jumps faster than the rate limit
        start = ticks // 3
        width = max(2, ticks // 8)
        demand[start : start + width] += spike * row_scale
    # constant-demand fault-free tail: the fixed point the fuzz pins
    demand[ticks - tail :] = demand[ticks - tail - 1]
    demand = np.clip(demand, 0.0, 0.85 * p.max_replicas * p.cap)
    # the forecast previews the NEXT tick's demand with seeded noise —
    # skillful but imperfect, which is what makes the blend-floor knob
    # a real decision instead of an oracle
    forecast = np.empty_like(demand)
    forecast[:-1] = demand[1:] + rng.normal(0.0, 1.0, (ticks - 1, rows))
    forecast[-1] = demand[-1]
    forecast = np.clip(forecast, 0.0, None)
    price = np.ones(ticks)
    if price_spike > 0.0:
        # seeded spot-spike ticks (none in the tail): the cost-ladder
        # knob's signal
        hot = rng.integers(0, ticks - tail, size=max(2, ticks // 8))
        price[hot] = 1.0 + price_spike
    fault = _fault_trail(seed, ticks, fault_probability, tail)
    replicas0 = np.clip(
        np.ceil(demand[0] / p.cap), p.min_replicas, p.max_replicas
    )
    return SimTrails(
        demand=demand.astype(_F32),
        forecast=forecast.astype(_F32),
        price=price.astype(_F32),
        fault=fault.astype(_F32),
        replicas0=replicas0.astype(_F32),
    )


def _trails_theme(**kwargs):
    """Bind a theme's knobs into the `trails(seed)` shape the registry
    stores (late-bound so every reset regenerates from the seed)."""

    def trails(seed: int) -> SimTrails:
        return make_trails(seed, **kwargs)

    return trails


# -- CLI runners (the reference's, each passing --device to its world) ------


def _device(args):
    """Where a world runs: --device (the card by default; `cpu` names
    the host)."""
    return getattr(args, "device", None)


def _run_trace(args, store) -> int:
    # the traced end-to-end replay (docs/observability.md): a seeded
    # consolidating world driven tick by tick, exporting a trace in
    # which the coalesced solver dispatch links the candidate
    # request spans and the SNG actuation closes the e2e window
    from karpenter_tpu_torch.simulate import simulate_trace

    if args.provenance:
        # the replay's HA decides record into the ledger, and the
        # decisions JSONL lands next to the trace (the
        # --trace-export help's contract); the process default is
        # restored afterwards — an enabled default leaking out
        # would turn on provenance for a co-resident runtime that
        # never opted in (the simulate replays take the same care)
        from karpenter_tpu_torch.observability import (
            default_ledger,
            reset_default_ledger,
            set_default_ledger,
        )

        saved_ledger = default_ledger()
        ledger = reset_default_ledger(enabled=True)
    try:
        report = simulate_trace(
            export_path=args.trace_export, device=_device(args)
        )
        if args.provenance:
            from karpenter_tpu_torch.observability.provenance import (
                export_next_to_trace,
            )

            path, count = export_next_to_trace(ledger, args.trace_export)
            report["decisions_export"] = path
            report["decision_records"] = count
    finally:
        if args.provenance:
            set_default_ledger(saved_ledger)
    # simulate_trace already exported (the report pins the event
    # count): clear the flag so main's exit-time _export_trace
    # doesn't rewrite the identical file (or the decisions sibling)
    args.trace_export = None
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_constraints(args, store) -> int:
    # self-contained replay (own store, fake provider, scripted
    # clock): the constraint plane through a seeded zonal outage
    # (docs/constraints.md)
    from karpenter_tpu_torch.simulate import simulate_constraints

    report = simulate_constraints(
        seed=_resolved_seed(args, 7), device=_device(args)
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_eventloop(args, store) -> int:
    # self-contained replay (own stores, fake provider, scripted
    # clock): the same seeded pod-arrival trace tick-paced vs
    # event-driven (docs/solver-service.md "Event-driven reconcile")
    from karpenter_tpu_torch.simulate import simulate_eventloop

    report = simulate_eventloop(
        arrivals=args.eventloop_arrivals,
        storm_events=args.eventloop_storm,
        debounce_s=args.event_debounce,
        seed=_resolved_seed(args, 0),
        device=_device(args),
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_multitenant(args, store) -> int:
    # self-contained replay (no store, no provider): N seeded
    # tenant clusters stepped in lockstep through one
    # MultiTenantScheduler (docs/multitenancy.md); combines with
    # --cost implicitly (every lockstep tick runs decide + cost),
    # with --provenance (per-decision "why" records + ledger
    # JSONL), and with --trace-export
    from karpenter_tpu_torch.simulate import simulate_multitenant

    report = simulate_multitenant(
        tenants=args.tenants,
        seed=_resolved_seed(args, 0),
        tenant_config=args.tenant_config,
        provenance=args.provenance,
        trace_export=args.trace_export,
        device=_device(args),
    )
    # simulate_multitenant exported trace + decisions itself
    args.trace_export = None
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_poolgroups(args, store) -> int:
    # self-contained replay (own stores, fake provider): a decode-heavy
    # traffic-mix storm through a prefill/decode PoolGroup, coordinated
    # (--poolgroups joint allocator) vs uncoordinated per-pool loops
    # (docs/poolgroups.md)
    from karpenter_tpu_torch.simulate import simulate_poolgroups

    report = simulate_poolgroups(
        seed=_resolved_seed(args, 0), device=_device(args)
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_cost(args, store) -> int:
    # self-contained replay (own stores, lagged fake provider):
    # warm pool on vs off through the cost-aware pipeline
    from karpenter_tpu_torch.simulate import simulate_cost

    report = simulate_cost(
        horizon_s=args.forecast_horizon,
        default_hourly=args.cost_default_hourly,
        spot_multiplier=args.cost_spot_multiplier,
        provenance=args.provenance,
        seed=_resolved_seed(args, 0),
        device=_device(args),
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_forecast(args, store) -> int:
    # self-contained replay (no store, no provider): proactive vs
    # reactive on a scripted diurnal ramp
    from karpenter_tpu_torch.simulate import simulate_forecast

    report = simulate_forecast(
        horizon_s=args.forecast_horizon,
        model=args.forecast_model,
        seed=_resolved_seed(args, 0),
        device=_device(args),
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_restart_storm(args, store) -> int:
    # self-contained replay (own store/provider/journal dir): a
    # seeded kill-and-restart storm pinning the crash-safety
    # contract — exactly-once actuation, FSM resumption, fencing
    from karpenter_tpu_torch.simulate import simulate_restart_storm

    report = simulate_restart_storm(
        crashes=args.storm_crashes,
        seed=_resolved_seed(args, 0),
        journal_dir=args.journal_dir,
        warmup_ticks=args.recovery_warmup_ticks,
        device=_device(args),
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_failover(args, store) -> int:
    # self-contained replay (own store/planes/journal root): a seeded
    # leader-kill failover pinning the replicated-control-plane
    # contract — fenced handoff, exactly-once actuation across the
    # handoff, reconvergence, stale-write rejection. Host code: the
    # device check ran before the dispatch, as for every world
    from karpenter_tpu_torch.simulate import simulate_failover

    report = simulate_failover(
        replicas=args.replicas,
        seed=_resolved_seed(args, 0),
        journal_dir=args.journal_dir,
        warmup_ticks=args.recovery_warmup_ticks,
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_preempt(args, store) -> int:
    # self-contained replay (no live store, no provider): a seeded
    # spot-reclaim storm over mixed on-demand/spot pools
    from karpenter_tpu_torch.simulate import simulate_preempt

    report = simulate_preempt(
        preempt_budget=args.preempt_budget,
        default_priority=args.default_priority,
        seed=_resolved_seed(args, 0),
        device=_device(args),
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _run_karpenter(args, store) -> int:
    """The default dry-run world over the WAL store — consolidate,
    what-if delta, or the plain solve (one runner for all three so the
    consolidate-over-what-if precedence and the what-if file validation
    keep the reference's order)."""
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.simulate import simulate, simulate_delta

    what_if = None
    if args.what_if:
        from karpenter_tpu_torch.utils.configfile import load_json_or_yaml

        what_if = load_json_or_yaml(args.what_if)
        if not isinstance(what_if, list):
            print(
                f"--what-if {args.what_if}: expected a LIST of group specs",
                file=sys.stderr,
            )
            return 2

    # a runtime only to materialize the store the flags describe (WAL
    # dir or live apiserver) and the optional solver sidecar; no
    # controllers tick, nothing is mutated
    runtime = KarpenterRuntime(
        Options(
            data_dir=args.data_dir,
            solver_uri=args.solver_uri,
            cloud_provider=args.cloud_provider,
            verbose=args.verbose,
            cost_default_hourly=args.cost_default_hourly,
            cost_spot_multiplier=args.cost_spot_multiplier,
            pricing_file=args.pricing_file,
            sim_seed=getattr(args, "sim_seed", None),
            device=_device(args),
        ),
        store=store,
        solver_client=getattr(args, "solver_client", None),
    )
    # route through the runtime's shared solve service: the dry run gets
    # the same queueing, deadlines and failure policy the production
    # tick gets (on the card: the cuda rung, both CUDA kernels)
    solver = runtime.solver_service.solve
    # the scale-from-zero seam the production solve uses: without it,
    # empty groups with a nodeGroupRef would simulate as infeasible
    resolver = runtime.producer_factory.template_resolver()
    try:
        if args.consolidate:
            from karpenter_tpu_torch.simulate import simulate_consolidation

            report = simulate_consolidation(
                runtime.store, service=runtime.solver_service
            )
        elif what_if is not None:
            report = simulate_delta(
                runtime.store, what_if, solver=solver,
                template_resolver=resolver,
                cost_model=runtime.cost_model,
            )
        else:
            report = simulate(
                runtime.store, solver=solver, template_resolver=resolver,
                cost_model=runtime.cost_model,
            )
        print(json.dumps(report, indent=2, sort_keys=True))
    finally:
        runtime.close()
    return 0


# -- registrations ---------------------------------------------------------
# Ascending `order` preserves the old elif chain's precedence exactly;
# the trace world's not-any-other-flag predicate is the same guard the
# chain's first branch carried.


def _select_trace(args) -> bool:
    return bool(args.trace_export) and not (
        args.forecast or args.restart_storm or args.failover
        or args.preempt or args.consolidate or args.what_if
        or args.cost or args.multitenant or args.eventloop
    )


register_scenario(Scenario(
    name="trace",
    description="traced end-to-end consolidating replay exporting "
    "Chrome-trace JSONL",
    flags="--trace-export FILE",
    order=10,
    select=_select_trace,
    run=_run_trace,
    seeded=False,
    trails=_trails_theme(fault_probability=0.05),
))

register_scenario(Scenario(
    name="constraints",
    description="constraint plane through a seeded zonal outage "
    "(spread/affinity/dead-zone report)",
    flags="--constraints",
    order=20,
    select=lambda args: bool(args.constraints),
    run=_run_constraints,
    default_seed=7,
    trails=_trails_theme(spike=40.0, fault_probability=0.1),
))

register_scenario(Scenario(
    name="eventloop",
    description="seeded pod-arrival trace tick-paced vs event-driven "
    "(lead time + storm coalescing)",
    flags="--eventloop",
    order=30,
    select=lambda args: bool(args.eventloop),
    run=_run_eventloop,
    trails=_trails_theme(spike=60.0),
))

register_scenario(Scenario(
    name="multitenant",
    description="N seeded tenant clusters in lockstep through one "
    "scheduler (cross-tenant batched dispatches)",
    flags="--multitenant",
    order=40,
    select=lambda args: bool(args.multitenant),
    run=_run_multitenant,
    trails=_trails_theme(diurnal=True, amplitude=48.0),
))

register_scenario(Scenario(
    name="poolgroups",
    description="decode-heavy traffic-mix storm through a "
    "prefill/decode PoolGroup, joint vs per-pool loops",
    flags="--poolgroups",
    order=45,
    select=lambda args: bool(getattr(args, "poolgroups", False)),
    run=_run_poolgroups,
    trails=_trails_theme(
        diurnal=True, amplitude=64.0, spike=48.0,
        fault_probability=0.05,
    ),
))

register_scenario(Scenario(
    name="cost",
    description="warm pool on vs off through the cost-aware pipeline "
    "(spot spikes + clamps)",
    flags="--cost",
    order=50,
    select=lambda args: bool(args.cost),
    run=_run_cost,
    trails=_trails_theme(
        diurnal=True, amplitude=96.0, price_spike=1.5,
        fault_probability=0.05,
    ),
))

register_scenario(Scenario(
    name="forecast",
    description="proactive vs reactive autoscaling on a scripted "
    "diurnal ramp (provisioning lead)",
    flags="--forecast",
    order=60,
    select=lambda args: bool(args.forecast),
    run=_run_forecast,
    trails=_trails_theme(diurnal=True, amplitude=120.0, base=8.0),
))

register_scenario(Scenario(
    name="restart-storm",
    description="seeded kill-and-restart storm pinning exactly-once "
    "actuation + FSM resumption",
    flags="--restart-storm",
    order=70,
    select=lambda args: bool(args.restart_storm),
    run=_run_restart_storm,
    trails=_trails_theme(spike=50.0, fault_probability=0.25),
))

register_scenario(Scenario(
    name="failover",
    description="seeded leader-kill over replicated solver replicas "
    "(fenced handoff + reconvergence)",
    flags="--failover",
    order=72,
    select=lambda args: bool(args.failover),
    run=_run_failover,
    trails=_trails_theme(spike=50.0, fault_probability=0.3),
))

register_scenario(Scenario(
    name="preempt",
    description="seeded spot-reclaim storm over mixed on-demand/spot "
    "pools (preemption budgets)",
    flags="--preempt",
    order=80,
    select=lambda args: bool(args.preempt),
    run=_run_preempt,
    trails=_trails_theme(
        spike=70.0, price_spike=2.0, fault_probability=0.15
    ),
))

register_scenario(Scenario(
    name="consolidate",
    description="dry-run consolidation plan over the live/WAL store "
    "(drainability + repack)",
    flags="--consolidate",
    order=90,
    select=lambda args: bool(args.consolidate),
    run=_run_karpenter,
    seeded=False,
    trails=_trails_theme(amplitude=12.0, fault_probability=0.05),
))

register_scenario(Scenario(
    name="what-if",
    description="baseline vs what-if delta solve over hypothetical "
    "node groups",
    flags="--what-if FILE",
    order=95,
    select=lambda args: bool(args.what_if),
    run=_run_karpenter,
    seeded=False,
    trails=_trails_theme(amplitude=12.0),
))

register_scenario(Scenario(
    name="karpenter",
    description="default dry-run solve over the live/WAL store "
    "(pendingCapacity producers)",
    flags="(no extra flags)",
    order=100,
    select=lambda args: True,
    run=_run_karpenter,
    seeded=False,
    trails=_trails_theme(),
))
