"""Process entry point: `python -m karpenter_tpu_torch`.

reference: cmd/controller/main.go:40-77 — flag parsing, logging, a
leader-elected manager serving /metrics on :8080, cloud-provider registry,
factory graph, controller registration, run-until-signalled.

The port's copy of karpenter_tpu/__main__.py: the same flags, defaults,
`--profile production` preset and usage errors, plus `--device
{cuda,cpu}` (default cuda). The process runs on the CUDA card: without
one, or when a kernel does not build, it exits non-zero with the reason
and starts no tick — it never degrades to the CPU, which runs only when
`--device cpu` names it. `--profiler-port P` serves torch.profiler
captures as Chrome traces over HTTP (observability/profiler.py), where
the reference serves xprof's gRPC.

`--simulate` runs the operator's dry run or a seeded SimLab world
(simlab/, simulate.py) instead of the control loop, on the same device
check; `--simulate --list` prints the scenario catalog and touches no
device.

`--apiserver URL` runs on a kube-apiserver (store/kube.py: an informer
mirror read by the controllers, statuses, scales and leases written over
REST) instead of the in-process store, and `--webhook-port` serves the
admission webhooks (webhook.py). The device check runs first: without a
card the process exits before any watch stream opens.

`--solver-uri HOST:PORT` puts the card in a solver sidecar (`python -m
karpenter_tpu_torch.sidecar`), the shipped Deployment's shape: this
process then builds no kernel and needs no card. Its device check is the
sidecar's Health answer instead, before any LIST and any tick: under
`--device cuda` (the default) the sidecar must compute on the card, or
the process exits 1 with the reason; under `--device cpu` either answer
is accepted. `--cloud-provider aws|tpu` select the AWS and GKE TPU
providers (cloudprovider/aws.py, cloudprovider/tpu.py); without their
SDKs the pools answer the reference's not-implemented guidance.

`--tenant-config FILE` (a JSON or YAML list of tenant specs) builds the
multi-tenant control plane (tenancy/) over the runtime's one service,
with `--tenant-deadline` its weighted deadlines; `--introspect` turns on
the solver introspection plane behind /debug/solver
(observability/devicetelemetry.py); `--simulate --multitenant --tenants
N` replays N seeded tenant clusters in lockstep through one scheduler.

`--partitions N` (with `--replica-id` and `--lease-duration`) runs the
process as one replica of the replicated control plane (replication/):
per-partition leases in the store replace the `--leader-elect` gate,
and /debug/replicas serves the replica's scoreboard. `--simulate
--failover` replays the seeded leader-kill world (simulate.py).
"""

from __future__ import annotations

import argparse
import sys
import time

from karpenter_tpu_torch.leaderelection import LeaderElector
from karpenter_tpu_torch.observability import MetricsServer
from karpenter_tpu_torch.observability.profiler import (
    capture_threads,
    start_profiler_server,
    stop_profiler_server,
)
from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
from karpenter_tpu_torch.utils.log import setup as log_setup


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="karpenter_tpu_torch",
        description="metrics-driven autoscaling control plane on a CUDA "
        "card (the PyTorch port of karpenter-tpu)",
    )
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the solver service runs: the CUDA card (default; the "
        "process exits when there is none) or the host CPU",
    )
    parser.add_argument(
        "--prometheus-uri",
        default=None,
        help="Prometheus HTTP API base URI; omit to read the in-process "
        "gauge registry directly",
    )
    parser.add_argument("--metrics-port", type=int, default=8080)
    parser.add_argument(
        "--webhook-port",
        type=int,
        default=0,
        help="serve AdmissionReview validate/mutate webhooks on this port "
        "(0 = off; real-cluster mode uses 9443 like the reference)",
    )
    parser.add_argument(
        "--webhook-cert-dir",
        default=None,
        help="directory holding tls.crt/tls.key for the webhook server "
        "(plain HTTP when omitted)",
    )
    parser.add_argument(
        "--cloud-provider",
        default=None,
        help="provider name from the registry (fake, aws, ...); defaults to "
        "KARPENTER_CLOUD_PROVIDER or the not-implemented fake",
    )
    parser.add_argument(
        "--solver-uri",
        default=None,
        help="host:port of a solver sidecar (python -m karpenter_tpu_torch.sidecar);"
        " omit to solve in-process",
    )
    parser.add_argument(
        "--data-dir",
        default=None,
        help="directory for the durable store (WAL + snapshots); omit for "
        "in-memory only",
    )
    parser.add_argument(
        "--journal-dir",
        default=None,
        help="directory for the crash-safe protective-state journal "
        "(FSM phases, holds, budgets, breakers, backoff, forecast "
        "history) + actuation fence generation; omit for ephemeral "
        "state and unfenced actuation (docs/resilience.md 'Crash "
        "recovery')",
    )
    parser.add_argument(
        "--recovery-warmup-ticks",
        type=int,
        default=1,
        help="full reconcile ticks a RECOVERED boot holds the "
        "conservative warm-up (no consolidation or preemption) while "
        "fleet state is confirmed; first boots skip it",
    )
    parser.add_argument(
        "--apiserver",
        default=None,
        help="kube-apiserver base URL for real-cluster mode (e.g. "
        "https://kubernetes.default.svc); in-cluster token/CA are picked "
        "up automatically. Omit to run on the in-process store.",
    )
    parser.add_argument(
        "--kube-token-file",
        default=None,
        help="bearer-token file for --apiserver (default: the in-cluster "
        "serviceaccount token)",
    )
    parser.add_argument(
        "--kube-ca",
        default=None,
        help="CA bundle for --apiserver (default: the in-cluster CA)",
    )
    parser.add_argument(
        "--kube-insecure",
        action="store_true",
        help="skip TLS verification for --apiserver (dev only)",
    )
    parser.add_argument(
        "--leader-elect",
        action=argparse.BooleanOptionalAction,
        default=True,
    )
    parser.add_argument(
        "--partitions",
        type=int,
        default=0,
        metavar="N",
        help="replicated control plane (docs/resilience.md 'Replicated "
        "control plane'): partition tenants across N CAS leases and "
        "run this process as one leader-elected replica — rendezvous-"
        "hash assignment, fenced tenant handoff, /debug/replicas "
        "scoreboard. 0 (default) = single-replica wire, byte-identical "
        "and lease-traffic-free; with N > 0 the global --leader-elect "
        "gate is superseded by the per-partition leases",
    )
    parser.add_argument(
        "--replica-id",
        default=None,
        metavar="ID",
        help="this replica's identity on the lease plane (heartbeat "
        "lease name, rendezvous ranking, /debug/replicas); default: a "
        "generated karpenter-<hex> id — set it in real fleets so "
        "scoreboards correlate across processes",
    )
    parser.add_argument(
        "--lease-duration",
        type=float,
        default=15.0,
        metavar="SECONDS",
        help="partition/heartbeat lease duration: the failover "
        "detection horizon — a dead replica's tenants become adoptable "
        "one lease duration (plus skew tolerance) after its last renew",
    )
    parser.add_argument(
        "--profiler-port",
        type=int,
        default=0,
        help="serve torch.profiler captures on this port (0 = off): GET "
        "/profile?ms=N answers a Chrome trace",
    )
    parser.add_argument(
        "--trace-export",
        default=None,
        metavar="FILE",
        help="export reconcile traces as Chrome-trace/Perfetto JSONL to "
        "FILE at exit (docs/observability.md); with --simulate and no "
        "other scenario flag, replays a seeded end-to-end scenario "
        "(tick -> coalesced solver dispatch -> actuation) and exports "
        "its trace. With --provenance, the decision ledger is dumped "
        "next to it as FILE's .decisions.jsonl sibling",
    )
    parser.add_argument(
        "--provenance",
        action=argparse.BooleanOptionalAction,
        default=False,
        help="record decision provenance (docs/observability.md "
        "'Decision provenance'): every HorizontalAutoscaler decision's "
        "full input chain — observed metrics, forecast blend, cost "
        "ladder + clamps, warm-pool headroom, solver rung, tenant/"
        "admission round, trace id — into a bounded columnar ring "
        "served at /debug/decisions and dumped as JSONL next to "
        "--trace-export. Default off (byte-identical decisions either "
        "way; ~zero cost when off)",
    )
    parser.add_argument(
        "--profile",
        choices=("production",),
        default=None,
        help="opinionated flag preset (docs/OPERATIONS.md 'Profiles'): "
        "'production' turns on --event-driven, --prewarm-compile and "
        "--fused-tick and tightens the --selfslo-objective default to "
        "0.5s (the sub-second posture the event-driven plane is built "
        "to hold); every explicit flag still wins over the preset",
    )
    parser.add_argument(
        "--fused-tick",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="fuse the steady-state forecast -> decide -> cost chain "
        "into ONE compiled program per tenant batch "
        "(docs/solver-service.md 'Fused tick'): no host round-trips "
        "between stages, 3+ dispatches per tick collapse to 1 "
        "(karpenter_solver_dispatches_per_tick). Decisions are "
        "property-pinned bitwise identical to the chained path; off "
        "(the default outside --profile production) keeps the unfused "
        "wire byte-identical",
    )
    parser.add_argument(
        "--poolgroups",
        action="store_true",
        help="enable the joint pool-group allocator "
        "(docs/poolgroups.md): PoolGroup CRDs name member autoscalers "
        "with cross-pool ratio bands and a shared budget; members "
        "leave the independent per-pool cost ladders and ride ONE "
        "batched joint dispatch (SolverService.poolgroup). Off (the "
        "default, or a fleet with no PoolGroup objects) keeps the "
        "uncoordinated wire byte-identical. With --simulate: run the "
        "seeded traffic-mix-shift world instead "
        "(prefill/decode pools through a decode-heavy storm)",
    )
    parser.add_argument(
        "--compile-cache-dir",
        default=None,
        metavar="DIR",
        help="persistent jit compile cache directory (the first-class "
        "form of the KARPENTER_COMPILE_CACHE env var, matching the "
        "sidecar's flag): restarted processes reload compiled solver "
        "programs from disk instead of recompiling — with "
        "--prewarm-compile the boot warm-up becomes a disk read "
        "(docs/solver-service.md 'Compile pre-warm'). The flag wins "
        "over the env var when both are set",
    )
    parser.add_argument(
        "--event-driven",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="watch events schedule debounced coalesced event passes "
        "(sub-second reaction; docs/solver-service.md 'Event-driven "
        "reconcile'), demoting the periodic tick to a resync backstop; "
        "off (the default outside --profile production) keeps the "
        "tick-paced loop byte-identical to previous releases",
    )
    parser.add_argument(
        "--event-debounce",
        type=float,
        default=0.05,
        metavar="SECONDS",
        help="event-pass debounce window: watch events landing within "
        "this window coalesce into ONE partial reconcile pass (bounds "
        "solve amplification under churn storms); only meaningful with "
        "--event-driven",
    )
    parser.add_argument(
        "--prewarm-compile",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="compile the smallest bucket rungs of the always-on kernel "
        "families (solve + decide) at boot, so a cold plane's first "
        "event pass doesn't pay a first-touch jit compile "
        "(docs/solver-service.md 'Compile pre-warm'); rungs the "
        "compile cache already knows are skipped",
    )
    parser.add_argument(
        "--introspect",
        action=argparse.BooleanOptionalAction,
        default=False,
        help="enable the solver introspection plane "
        "(docs/observability.md 'Device telemetry & introspection'): "
        "a compile ledger recording every compile-cache miss with "
        "rung/extents/wall time/trace ids + XLA flops/bytes "
        "attribution (karpenter_solver_compile_seconds, compile_storm "
        "flight-recorder trips), per-tick device memory telemetry "
        "(karpenter_device_*, resident-LRU byte accounting, the "
        "self-SLO memory source), and the /debug/solver posture "
        "document. Default off (decisions byte-identical either way; "
        "~zero cost when off)",
    )
    parser.add_argument(
        "--introspect-storm-threshold",
        type=int,
        default=4,
        help="compile-cache misses inside one tick window (after the "
        "plane reached steady state) that count as a compile storm "
        "and dump the flight-recorder ring; only meaningful with "
        "--introspect",
    )
    parser.add_argument(
        "--selfslo-objective",
        type=float,
        default=None,
        help="the control plane's own e2e-latency objective in seconds "
        "(against karpenter_reconcile_e2e_seconds; pick a histogram "
        "bucket bound) for the self-SLO burn-rate monitor "
        "(docs/observability.md 'Self-SLO monitoring'); defaults to "
        "1.0, or 0.5 under --profile production",
    )
    parser.add_argument(
        "--selfslo-target",
        type=float,
        default=0.99,
        help="the self-SLO success-ratio target the multi-window burn "
        "rates measure against (error budget = 1 - target); must be "
        "strictly between 0 and 1",
    )
    parser.add_argument(
        "--duration",
        type=float,
        default=float("inf"),
        help="seconds to run before exiting (default: forever)",
    )
    parser.add_argument("--tick", type=float, default=0.1)
    parser.add_argument(
        "--simulate",
        action="store_true",
        help="dry-run: solve the pending-pods problem once, print a JSON "
        "report with per-pod-shape assignments, and exit without "
        "mutating anything (docs/OPERATIONS.md 'What-if simulation')",
    )
    parser.add_argument(
        "--what-if",
        default=None,
        metavar="FILE",
        help="with --simulate: JSON/YAML file of hypothetical node groups "
        "([{name, allocatable, labels, taints}]) appended to the solve; "
        "the report then includes baseline vs what-if and the delta",
    )
    parser.add_argument(
        "--sim-seed",
        type=int,
        default=None,
        metavar="N",
        help="with --simulate: one seed threaded through every SEEDED "
        "scenario's RNG streams (docs/simulator.md); omit for each "
        "scenario's pinned default seed, keeping published replay "
        "digests byte-identical",
    )
    parser.add_argument(
        "--list",
        action="store_true",
        help="with --simulate: print the registered scenario catalog "
        "(name, selection flags, seedability, one-line description) "
        "from the simlab registry and exit without running anything",
    )
    parser.add_argument(
        "--backoff-base",
        type=float,
        default=1.0,
        help="engine requeue backoff base seconds under retryable "
        "failures (docs/resilience.md)",
    )
    parser.add_argument(
        "--backoff-cap",
        type=float,
        default=60.0,
        help="engine requeue backoff cap seconds",
    )
    parser.add_argument(
        "--circuit-threshold",
        type=int,
        default=5,
        help="consecutive provider failures before a node group's "
        "actuation circuit opens",
    )
    parser.add_argument(
        "--circuit-reset",
        type=float,
        default=120.0,
        help="seconds an open actuation circuit waits before a "
        "half-open probe reconcile",
    )
    parser.add_argument(
        "--solver-watchdog-timeout",
        type=float,
        default=30.0,
        help="seconds a solver device call may run before the watchdog "
        "restarts the worker and drains to numpy (0 = off)",
    )
    parser.add_argument(
        "--shard-threshold",
        type=int,
        default=1 << 24,
        help="pods x groups cell count at which a solve routes through "
        "the multi-device mesh instead of the single-device program "
        "(docs/solver-service.md 'Sharded dispatch'); 0 disables "
        "sharding",
    )
    parser.add_argument(
        "--shard-devices",
        type=int,
        default=None,
        help="cap the sharded-dispatch mesh at N devices (default: "
        "every visible device; < 2 leaves the mesh unbuilt)",
    )
    parser.add_argument(
        "--shard-mesh",
        default=None,
        metavar="PODSxGROUPS",
        help="explicit mesh extents for the sharded dispatch, e.g. "
        "'8x1' (default: pods-major factorization of the device count)",
    )
    parser.add_argument(
        "--no-resident",
        action="store_true",
        help="disable the device-resident fleet state (docs/"
        "solver-service.md 'Device-resident fleet state'): every solve "
        "dispatch re-uploads its full operand stack instead of serving "
        "resident buffers with scatter updates; outputs are "
        "bit-identical either way",
    )
    parser.add_argument(
        "--consolidate",
        action="store_true",
        help="enable the consolidation engine (batched node-drain "
        "planning + cordon/verify/drain actuation; "
        "docs/consolidation.md). With --simulate: print the dry-run "
        "drain plan instead of the pending-pods report and exit "
        "without mutating anything",
    )
    parser.add_argument(
        "--preempt",
        action="store_true",
        help="enable the preemption engine (batched eviction planning "
        "for high-priority pending pods + budgeted eviction actuation; "
        "docs/preemption.md). With --simulate: replay a seeded "
        "spot-reclaim storm and report evictions vs scale-ups vs "
        "pending-pod recovery, mutating nothing",
    )
    parser.add_argument(
        "--preempt-budget",
        type=int,
        default=1,
        help="default max concurrent evictions charged against one "
        "node group per hold window (120s; spec.eviction_budget "
        "overrides per group)",
    )
    parser.add_argument(
        "--default-priority",
        type=int,
        default=0,
        help="priority assumed for pods naming an unknown "
        "PriorityClass (resolved spec.priority and the system classes "
        "always win; docs/preemption.md)",
    )
    parser.add_argument(
        "--constraints",
        action="store_true",
        help="with --simulate: replay a seeded spread-constrained "
        "serving fleet with a gold reservation through a zonal outage "
        "and report per-group spread skew and reservation fill "
        "before/after (docs/constraints.md)",
    )
    parser.add_argument(
        "--eventloop",
        action="store_true",
        help="with --simulate: replay a seeded pod-arrival trace "
        "tick-paced vs event-driven and report e2e p50/p99 off the "
        "karpenter_reconcile_e2e_seconds histogram, the solve-"
        "amplification factor, and the churn-storm coalescing proof "
        "(docs/solver-service.md 'Event-driven reconcile'); "
        "--event-debounce tunes the replayed window",
    )
    parser.add_argument(
        "--eventloop-arrivals",
        type=int,
        default=60,
        help="with --simulate --eventloop: seeded pod arrivals in the "
        "replayed trace",
    )
    parser.add_argument(
        "--eventloop-storm",
        type=int,
        default=1000,
        help="with --simulate --eventloop: churn-storm events injected "
        "into one debounce window",
    )
    parser.add_argument(
        "--restart-storm",
        action="store_true",
        help="with --simulate: replay a seeded kill-and-restart storm "
        "against a consolidating fleet (crash mid-drain, reboot from "
        "the protective-state journal, repeat) and report exactly-once "
        "actuation, FSM resumption, and the fence rejecting a stale "
        "incarnation's replay (docs/resilience.md 'Crash recovery')",
    )
    parser.add_argument(
        "--storm-crashes",
        type=int,
        default=3,
        help="with --simulate --restart-storm: kill/reboot cycles",
    )
    parser.add_argument(
        "--failover",
        action="store_true",
        help="with --simulate: replay a seeded leader-kill failover "
        "across a replicated control plane (N tenants partitioned over "
        "R replicas, the biggest owner SIGKILLed mid-storm) and report "
        "handoff blackout, exactly-once actuation across the handoff, "
        "the deposed replica's fence-rejected late write, and "
        "reconvergence ticks (docs/resilience.md 'Replicated control "
        "plane')",
    )
    parser.add_argument(
        "--replicas",
        type=int,
        default=3,
        help="with --simulate --failover: simulated replica count",
    )
    parser.add_argument(
        "--cost",
        action="store_true",
        help="with --simulate: replay a seeded diurnal ramp + spot-price "
        "step through two cost-aware worlds (warm pool on vs off) behind "
        "a lagged provider and report the hourly-cost and "
        "provisioning-lead-time deltas (docs/cost.md); cost-aware "
        "scaling in the running control plane is opt-in per HA via "
        "spec.behavior.slo and per group via spec.warmPool, no flag "
        "needed",
    )
    parser.add_argument(
        "--cost-default-hourly",
        type=float,
        default=1.0,
        help="hourly price for a node whose instance type the built-in "
        "cost catalog doesn't know (docs/cost.md); per-group overrides "
        "via the cost.karpenter.sh/hourly-cost annotation win",
    )
    parser.add_argument(
        "--cost-spot-multiplier",
        type=float,
        default=0.35,
        help="spot/preemptible-tier price as a fraction of on-demand "
        "in the cost model (docs/cost.md)",
    )
    parser.add_argument(
        "--pricing-file",
        default=None,
        metavar="FILE",
        help="JSON/YAML instance-type pricing catalog, reloaded on "
        "mtime change and consulted before the built-in catalog "
        "(docs/cost.md 'Pricing feeds'); omit for the built-in "
        "illustrative catalog",
    )
    parser.add_argument(
        "--tenant-config",
        default=None,
        metavar="FILE",
        help="JSON/YAML list of tenant specs ({id, weight, "
        "pricingFile, ...}) enabling the multi-tenant control plane "
        "(docs/multitenancy.md): per-tenant namespaced stacks over one "
        "shared solver service; omit for the single-tenant wiring "
        "(byte-identical to previous releases)",
    )
    parser.add_argument(
        "--tenant-deadline",
        type=float,
        default=None,
        metavar="SECONDS",
        help="tenant-weighted solve deadline (docs/multitenancy.md): "
        "bounds a deferred tenant's wait behind earlier admission "
        "rounds — the budget is SECONDS x weight / mean weight, and an "
        "exhausted budget serves the tenant immediately from the "
        "bit-identical mirror (counted in "
        "karpenter_tenant_deferrals_total); omit for unbounded waits",
    )
    parser.add_argument(
        "--multitenant",
        action="store_true",
        help="with --simulate: step N seeded tenant clusters in "
        "lockstep through one MultiTenantScheduler (cross-tenant "
        "concatenated decide/cost dispatches) and report aggregate "
        "decisions, dispatch counts, and per-tick digests "
        "(docs/multitenancy.md)",
    )
    parser.add_argument(
        "--tenants",
        type=int,
        default=16,
        help="with --simulate --multitenant: simulated tenant count",
    )
    parser.add_argument(
        "--tenant-id",
        default=None,
        help="this control plane's tenant id, stamped as gRPC metadata "
        "on every --solver-uri RPC so a shared solver sidecar can "
        "attribute traffic per tenant (docs/multitenancy.md)",
    )
    parser.add_argument(
        "--forecast",
        action="store_true",
        help="with --simulate: replay a synthetic diurnal ramp through "
        "a forecast-enabled and a reactive-only autoscaler and report "
        "the proactive provisioning lead (docs/forecasting.md); "
        "forecasting in the running control plane is opt-in per HA via "
        "spec.behavior.forecast, no flag needed",
    )
    parser.add_argument(
        "--forecast-horizon",
        type=float,
        default=60.0,
        help="with --simulate --forecast: horizon seconds for the replay",
    )
    parser.add_argument(
        "--forecast-model",
        default="holt-winters",
        choices=("holt-winters", "linear"),
        help="with --simulate --forecast: model for the replay",
    )
    parser.add_argument(
        "--forecast-history",
        type=int,
        default=64,
        help="metric-history ring capacity per series "
        "(docs/forecasting.md)",
    )
    parser.add_argument(
        "--stale-metric-max-age",
        type=float,
        default=60.0,
        help="seconds a history sample may stand in for a FAILED live "
        "metric query before the row errors instead (0 disables reuse)",
    )
    args = parser.parse_args(argv)
    # Resolve the --profile preset: flags parked on a None sentinel take
    # the profile's value; anything the user typed explicitly wins.
    production = args.profile == "production"
    if args.event_driven is None:
        args.event_driven = production
    if args.prewarm_compile is None:
        args.prewarm_compile = production
    if args.fused_tick is None:
        args.fused_tick = production
    if args.selfslo_objective is None:
        args.selfslo_objective = 0.5 if production else 1.0
    if not 0.0 < args.selfslo_target < 1.0:
        # a clean usage error instead of a ValueError traceback from
        # deep inside runtime construction (SelfSLOMonitor's guard)
        parser.error(
            f"--selfslo-target must be in (0, 1), got "
            f"{args.selfslo_target}"
        )
    if args.selfslo_objective <= 0:
        parser.error(
            f"--selfslo-objective must be > 0 seconds, got "
            f"{args.selfslo_objective}"
        )
    if args.introspect_storm_threshold < 1:
        parser.error(
            f"--introspect-storm-threshold must be >= 1, got "
            f"{args.introspect_storm_threshold}"
        )
    if args.event_debounce < 0:
        parser.error(
            f"--event-debounce must be >= 0 seconds (0 = dispatch the "
            f"pass immediately), got {args.event_debounce}"
        )
    return args


def _parse_mesh_shape(spec):
    """'8x1' -> (8, 1): the --shard-mesh override of the service's shard
    route, with the reference's errors."""
    if not spec:
        return None
    try:
        pods, groups = spec.lower().split("x")
        shape = (int(pods), int(groups))
    except ValueError:
        raise SystemExit(
            f"--shard-mesh {spec!r}: expected PODSxGROUPS, e.g. 8x1"
        )
    if shape[0] < 1 or shape[1] < 1:
        raise SystemExit(f"--shard-mesh {spec!r}: extents must be >= 1")
    return shape


def _run_simulation(args, store) -> int:
    """Registry-driven simulation dispatch (docs/simulator.md): the
    SimLab scenario catalog (karpenter_tpu_torch/simlab) owns both the
    selection predicates and the replay runners, so `--simulate --list`
    and this dispatch can never disagree about what a flag runs.
    `--sim-seed` threads through every seeded scenario inside the
    runners; the default reproduces each world's pinned digests."""
    from karpenter_tpu_torch.simlab import catalog_text, select_for

    if args.list:
        print(catalog_text())
        return 0
    return int(select_for(args).run(args, store) or 0)


def _export_trace(args) -> None:
    """Flush the reconcile-span ring as Chrome-trace JSONL when
    --trace-export names a file (docs/observability.md), and the
    decision-provenance ledger as its .decisions.jsonl sibling when
    --provenance recorded any."""
    if not args.trace_export:
        return
    from karpenter_tpu_torch.observability import default_ledger, default_tracer

    events = default_tracer().export_jsonl(args.trace_export)
    print(
        f"exported {events} trace event(s) to {args.trace_export}",
        file=sys.stderr,
    )
    ledger = default_ledger()
    if ledger.enabled:
        from karpenter_tpu_torch.observability.provenance import (
            export_next_to_trace,
        )

        path, records = export_next_to_trace(ledger, args.trace_export)
        print(
            f"exported {records} decision record(s) to {path}",
            file=sys.stderr,
        )


def _readiness(runtime):
    """/readyz wired to REAL state (docs/observability.md): NOT ready
    during the recovery warm-up (fleet state unconfirmed — disruption is
    gated too) and while the solver backend-health FSM is tripped
    (decisions are numpy-degraded). /healthz stays liveness-only."""
    from karpenter_tpu_torch.solver.service import HEALTHY

    def check():
        recovery = runtime.recovery
        if recovery is not None and recovery.warmup_remaining > 0:
            return False, (
                f"recovery warm-up: {recovery.warmup_remaining} "
                "tick(s) remaining"
            )
        health = runtime.solver_service.backend_health()
        if health != HEALTHY:
            return False, f"solver backend {health}"
        return True, "ok"

    return check


def _make_store(args):
    """KubeStore when --apiserver names a real cluster, else None (the
    runtime then builds its in-process store). Its constructor relists
    every watched kind and starts the watch threads."""
    if not args.apiserver:
        return None
    from karpenter_tpu_torch.store.kube import KubeClient, KubeStore

    return KubeStore(
        KubeClient(
            base_url=args.apiserver,
            token_file=args.kube_token_file,
            ca_file=args.kube_ca,
            insecure=args.kube_insecure,
        )
    )


def _start_webhook_server(args):
    if not args.webhook_port:
        return None
    import os.path

    from karpenter_tpu_torch.webhook import WebhookServer

    cert = key = None
    if args.webhook_cert_dir:
        cert = os.path.join(args.webhook_cert_dir, "tls.crt")
        key = os.path.join(args.webhook_cert_dir, "tls.key")
    server = WebhookServer(
        port=args.webhook_port, cert_file=cert, key_file=key
    )
    wport = server.start()
    print(f"serving admission webhooks on :{wport}", file=sys.stderr)
    return server


def _run_loop(args, runtime, elector) -> None:
    """Tick until the duration elapses, SIGTERM arrives, or ^C.

    Clean shutdown on SIGTERM (what kubernetes sends on pod termination):
    finish the current tick, then run the same teardown as normal exit —
    the reference's manager stops on SIGTERM/SIGINT via controller-
    runtime's signal handler (main.go run-until-signalled)."""
    import signal

    stopping = {"flag": False}

    def _stop(signum, frame):
        stopping["flag"] = True

    previous_handler = None
    try:
        previous_handler = signal.signal(signal.SIGTERM, _stop)
    except ValueError:
        pass  # non-main thread (tests): rely on duration/interrupt

    deadline = runtime.clock() + args.duration
    try:
        while runtime.clock() < deadline and not stopping["flag"]:
            if elector is None or elector.try_acquire():
                runtime.manager.reconcile_all()
            time.sleep(args.tick)
    except KeyboardInterrupt:
        pass
    finally:
        if previous_handler is not None:
            # restore: after main() returns, SIGTERM must regain its
            # previous disposition (a stale handler flipping a dead flag
            # would make the process unkillable by TERM)
            signal.signal(signal.SIGTERM, previous_handler)


def _setup_backend(args) -> str:
    """Kernel build directory + device, before the runtime is built.

    --compile-cache-dir (or KARPENTER_COMPILE_CACHE) names the directory
    the CUDA kernels build into, so a restarted process loads them
    instead of running nvcc again. Then the device is resolved and, on
    the card, every kernel is built and loaded. Unlike the reference,
    an unusable card is not answered by a CPU fallback: this raises
    with the reason (utils/backend.py). With --solver-uri the card is
    the sidecar's: its Health answer is checked instead, and nothing
    is built here; the checked client rides on `args.solver_client` to
    the runtime, which then skips its own check."""
    import os as _os

    from karpenter_tpu_torch.utils.backend import (
        configure_compile_cache,
        ensure_usable_backend,
    )

    configure_compile_cache(
        args.compile_cache_dir
        or _os.environ.get("KARPENTER_COMPILE_CACHE", "")
    )
    if args.solver_uri:
        return _check_sidecar(args)
    return ensure_usable_backend(args.device)


def _check_sidecar(args) -> str:
    """The sidecar's Health answer held to --device (sidecar/client.
    require_backend): raises when the card was asked for and the sidecar
    does not compute on it, or does not answer. The client that passed
    is kept on `args.solver_client` for the runtime."""
    from karpenter_tpu_torch.sidecar.client import SolverClient, require_backend

    client = SolverClient(args.solver_uri, tenant=args.tenant_id)
    try:
        meta = require_backend(client, args.device)
    except BaseException:
        client.close()
        raise
    args.solver_client = client
    return (
        f"solver sidecar at {args.solver_uri} (backend "
        f"{meta.get('backend', 'not answered')}, device_count "
        f"{meta.get('device_count', 'not answered')}); this process "
        "builds no kernel"
    )


def _close_sidecar_client(args) -> None:
    """Closes the client _check_sidecar kept (a runtime that took it may
    have closed it already; a second close does nothing)."""
    client = getattr(args, "solver_client", None)
    if client is not None:
        client.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    log_setup(verbose=args.verbose)
    if args.simulate:
        return _simulate_main(args)
    store = None
    try:
        note = _setup_backend(args)
        # after the device check: no card, no watch stream
        store = _make_store(args)
        runtime = _build_runtime(args, store)
    except Exception as error:  # noqa: BLE001 — reported, exit non-zero
        _close_sidecar_client(args)
        if store is not None:
            store.close()
        return _cannot_start(error)
    print(f"solver device: {note}", file=sys.stderr)
    metrics_server = MetricsServer(
        runtime.registry,
        port=args.metrics_port,
        readiness=_readiness(runtime),
        ledger=runtime.decision_ledger,
        selfslo=runtime.selfslo,
        introspection=runtime.solver_introspection,
        # /debug/profile captures land next to the flight-recorder
        # dumps (and the recovery journal) — one incident directory
        profile_dir=args.journal_dir,
        replication=runtime.replication,
    )
    port = metrics_server.start()
    print(f"serving /metrics and /healthz on :{port}", file=sys.stderr)
    webhook_server = None
    try:
        webhook_server = _start_webhook_server(args)
        if args.profiler_port and start_profiler_server(args.profiler_port):
            print(
                f"torch profiler listening on :{args.profiler_port} "
                f"(captures hold the ranges of {capture_threads()})",
                file=sys.stderr,
            )
        # with --partitions the per-partition lease plane IS the
        # election: every replica must tick (each serves its owned
        # partitions), so the global whole-process gate is superseded
        elector = (
            LeaderElector(runtime.store, clock=runtime.clock)
            if args.leader_elect and not args.partitions
            else None
        )
        _run_loop(args, runtime, elector)
    finally:
        _export_trace(args)
        metrics_server.stop()
        stop_profiler_server()
        if webhook_server is not None:
            webhook_server.stop()
        runtime.close()
        if store is not None:
            store.close()  # CLI-owned KubeStore: stop the watch threads
    return 0


def _cannot_start(error: Exception) -> int:
    print(
        f"karpenter_tpu_torch: cannot start: {type(error).__name__}: "
        f"{error}",
        file=sys.stderr,
    )
    return 1


def _simulate_main(args) -> int:
    """`--simulate`: the device check of the control loop (exit 1 with
    the reason when the card is missing or a kernel does not build),
    then the selected world, then the exit-time trace export. `--list`
    runs no device program and skips the check. With --apiserver the
    dry run reads the live mirror; the watch streams open after the
    device check (and not for --list)."""
    store = None
    if not args.list:
        try:
            note = _setup_backend(args)
            store = _make_store(args)
        except Exception as error:  # noqa: BLE001 — reported, exit non-zero
            _close_sidecar_client(args)
            return _cannot_start(error)
        print(f"solver device: {note}", file=sys.stderr)
    try:
        return _run_simulation(args, store)
    finally:
        _export_trace(args)
        _close_sidecar_client(args)
        if store is not None:
            store.close()


def _build_runtime(args, store=None) -> KarpenterRuntime:
    return KarpenterRuntime(
        Options(
            prometheus_uri=args.prometheus_uri,
            cloud_provider=args.cloud_provider,
            solver_uri=args.solver_uri,
            data_dir=args.data_dir,
            verbose=args.verbose,
            consolidate=args.consolidate,
            preempt=args.preempt,
            preempt_budget=args.preempt_budget,
            default_pod_priority=args.default_priority,
            journal_dir=args.journal_dir,
            recovery_warmup_ticks=args.recovery_warmup_ticks,
            backoff_base_s=args.backoff_base,
            backoff_cap_s=args.backoff_cap,
            circuit_failure_threshold=args.circuit_threshold,
            circuit_reset_s=args.circuit_reset,
            solver_watchdog_timeout_s=args.solver_watchdog_timeout,
            solver_shard_threshold=args.shard_threshold,
            solver_shard_devices=args.shard_devices,
            solver_shard_mesh=_parse_mesh_shape(args.shard_mesh),
            solver_resident=not args.no_resident,
            forecast_history=args.forecast_history,
            stale_metric_max_age_s=args.stale_metric_max_age,
            cost_default_hourly=args.cost_default_hourly,
            cost_spot_multiplier=args.cost_spot_multiplier,
            pricing_file=args.pricing_file,
            tenant_config=args.tenant_config,
            tenant_deadline_s=args.tenant_deadline,
            tenant_id=args.tenant_id,
            provenance=args.provenance,
            introspect=args.introspect,
            introspect_storm_threshold=args.introspect_storm_threshold,
            selfslo_objective_s=args.selfslo_objective,
            selfslo_target=args.selfslo_target,
            event_driven=args.event_driven,
            event_debounce_s=args.event_debounce,
            prewarm_compile=args.prewarm_compile,
            fused_tick=args.fused_tick,
            poolgroups=args.poolgroups,
            # already applied above (before the first compile); carried
            # on Options so embedded runtimes resolve identically
            compile_cache_dir=args.compile_cache_dir,
            partitions=args.partitions,
            replica_id=args.replica_id,
            lease_duration_s=args.lease_duration,
            device=args.device,
        ),
        store=store,
        solver_client=getattr(args, "solver_client", None),
    )


if __name__ == "__main__":
    sys.exit(main())
