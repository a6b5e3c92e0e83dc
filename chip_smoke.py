#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (karpenter_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (set-up, with ptxas's register,
shared-memory and stack report), then runs nineteen phases and fails (exit 1,
no result line) if any of them fails:

1. fused kernel vs its plain version on the card: fused_assign against
   fused_assign_reference on a small ragged problem, on P=512/T=24 with
   weights in [1000, 5000) and each of the score, forbidden and exclusive
   operands, on wide fleets (T = 4,096 at K = L = 64, T = 2,000 at
   K = L = 512: both past 1,447 groups, where a per-block [T, B] shared
   histogram would no longer fit) and on the main path's own inputs;
   assigned, hist and unschedulable exact, demand within rtol 1e-5 and
   bitwise equal across two launches;
2. shelf kernel vs its plain version on the card, on random histograms at
   B = 1, 8, 16, 32, 33, 64 and the main path's histogram: nodes and
   assigned_count exact;
3. main path: solve(backend="cuda") on the bench's 100k pods x 300 types x
   64 taints x 64 labels problem (workloads.build_inputs, seed 0), once
   with the launch counts set to 0 just before and read just after (both
   kernels must have launched); held exactly against
   solve(backend="torch") on the card, and its totals against the
   reference bench's (nodes 20262); p50/p95 over 20 more solves;
4. wide fleet: solve(backend="cuda") == solve(backend="torch") at T = 2,000;
5. small card vs CPU: binpack_fused on the card == binpack on the CPU;
6. decision at fleet scale: decide on the card == decide on the CPU,
   bitwise on every output leaf, at N = 4,096 autoscalers x M = 3
   metrics, without and with forecast operands, the edge rows of
   workloads.with_edge_rows included (a zero target, a recommendation
   past 2**31 - 128, a Percent policy at spec 0, min > max);
7. fleet step: fleet_step on the card (decide + solve) with the launch
   counts set to 0 just before and read just after (both kernels must
   have launched); its decision equals phase 6's, its bin-pack equals
   solve(backend="torch") (nodes 20262); p50/p95 over 20 steps;
8. fused tick at N = 4,096, M = 3, S = 2,048 series x T = 64 samples,
   G = 64 pool groups x P = 4 pools, every stage present: the card's
   eager fused_tick == the CPU's, bitwise on every leaf; the captured
   CUDA graph (FusedTickProgram) == eager on two operand sets, the second
   replayed after the first; the eager ticks and the replays run under
   torch.cuda.set_sync_debug_mode("error"); eager and replay p50/p95,
   device kernels and busy us per tick (torch.profiler), the forecast
   stage's share of them, and the peak of allocated device memory; the
   forecast kernel launches once an eager tick and not at all a replay,
   and at the fleet cell's 6,144 x 64 series its outputs equal the plain
   version's bit for bit, with its ms a launch beside its bound and the
   plain version's ms (the kernel's record);
9. reconcile tick: bench.py::run_e2e's cluster at 100k pods x 300 groups
   (workloads.build_reconcile_cluster, seed 0) in the port's Store, solved
   by the port's solve_pending through its PendingFeed with the default
   solver (the card): the first tick's totals equal the reference's
   (RECONCILE_TOTALS), with each kernel launched once; 20 steady ticks
   launch nothing; 20 churned ticks (1,000 pods replaced per tick) launch
   each kernel once per tick; the last churned tick's inputs solved by
   the plain program on the CPU equal the card's five outputs; then the
   host split of churned ticks, a torch.profiler window of 5 churned
   ticks (device kernels, busy us, copies and host->device bytes per
   tick, the generic fused instance's device time per launch), and the
   mixed draw (20k x 50, affinity 0.3, anti 0.05, spread 0.1): its
   statuses and gauges on the card equal a CPU-solver run on the same
   store state, with no reroute;
10. the solve service on the card (karpenter_tpu_torch/solver), as
   production reaches the kernels: (a) SolverService() (the cuda rung,
   which does not pad) on the main path's problem handed over as host
   arrays: its five outputs equal a direct solve(backend="cuda"), each
   kernel launched once per request (counts set to 0 just before, read
   just after); service and direct p50/p95 over 20 calls, the service's
   stage percentiles, the fused instance that ran (the narrow one) with
   its device ms per launch and the host->device bytes of a repeated
   request (profiler); (b) phase 9's cluster with its pods restored to
   the first tick's, reconciled by solve_pending(...,
   solver=service.solve): the first tick's totals equal
   RECONCILE_TOTALS, and on it and on 20 churned ticks the statuses and
   gauges equal the direct-solve path's; then 12 pairs of churned ticks
   timed in turns (service, direct, direct, service, ...), each on its
   own fresh churn: medians and spread of both arms and of the pairs'
   differences, and the service's share of the tick;
   (c) 8 threads submitting reconcile-size problems in one window, on the
   cuda and the torch rungs: answers equal their direct solves, requests,
   dispatches and coalesce factor printed; (d) the torch rung over 5
   churned ticks with the device-resident state and without it: equal to
   each other and to the cuda rung, host->device bytes per tick for both
   (the resident arm ships only the changed rows), the batched program
   under set_sync_debug_mode("error"); (e) solve(backend="numpy") at the
   main path with its C helper loaded == the card, its p50; then a
   solver.dispatch error plan: each failed request raises the injected
   error (the card's service never answers from numpy), the health FSM
   trips to degraded and the next request raises SolverDeviceError with
   no device attempt; with the plan cleared the probe (on an injected
   clock) heals it. The phase ends with every service at fallback_total
   0, the main one healthy, and its shard route idle (one card: no mesh,
   no shard request, the shard gauge 0);
11. the HorizontalAutoscaler reconcile tick through SolverService() on the
   card (workloads.build_ha_fleet at BASELINE.json's 1000 tenants x 4
   autoscalers, 3 metrics, about half forecasting one metric over 64
   observed samples, an SLO on about 60%, 64 pool groups x 4 pools,
   --fused-tick): (a) the first tick captures the fused program's CUDA
   graph while the service's worker answers bin-pack solves (each equal);
   10 timed ticks: p50/p95 on the host clock, the host split (snapshot and
   metric queries, plans and operands, service.fused_tick with its
   upload / replay / fetch, commits, scale writes, status writes), the
   device rows, kernels and busy us per tick (profiler) and the forecast
   stage's share; fused_dispatches == ticks, no chained or numpy serve,
   one dispatch per tick, one graph capture, the FSM healthy; (b) the
   same world for 6 ticks through the card's chained wire (forecast,
   decide, cost, poolgroup families) and through a CPU service (numpy,
   in a child process beside (a)): the same replica trail, HA statuses, error maps and registry
   exposition as the fused tick's; (c) phase 8's batch through
   service.fused_tick == the direct FusedTickProgram replay, bitwise on
   every leaf, the two timed in turns; (d) under a fused.tick error plan
   every row reports the error, no scale is written, nothing answers
   from numpy or the chained rung, the FSM degrades to SolverDeviceError
   and the probe (on an injected clock) heals it.
12. the disruption path (`--consolidate --preempt`, runtime.py:409-501)
   through SolverService() on the card: (a) workloads.
   build_disruption_world(2000 nodes, 30000 bound pods, 64 pending
   critical pods, seed 0; bench.py's fragmented consolidation cluster in
   four node groups, the last preemptible) with the engines at their
   defaults, driven for 9 rounds of 60 s by the ScalableNodeGroup
   controller over a fake clock (launch counts set to 0 just before, read
   just after): drains cordoned, verified, actuated through spec.replicas
   and finished by on_scale_down, evictions planned and made; per round
   the host time, the engines' eval gauges, candidates, drains planned /
   vetoed / actuated, evictions, unplaceable, dispatches and the host
   split; every consolidation plan launches each CUDA kernel once per
   candidate with pods; a profiler window of the largest plan's
   candidates (device kernels, launches, the fused instance, device ms
   per launch at T = 2,000 with the forbidden operand, busy us); (b) the
   same world on a CPU numpy service (in a child process beside (a)):
   equal error maps, store state,
   node groups, provider replicas, engine tables and exposition every
   round, and equal verdicts and plans; (c) service.preempt on bench.py's
   eviction fleet at the victim ceiling (64 x 2,000 x 16,384) ==
   preempt_numpy on every output, its p50 and the program's alone, device
   kernels and busy us per call; (d) under solver.dispatch and
   preempt.plan error plans the engines see FaultInjected, then
   SolverDeviceError, nothing is cordoned or evicted, nothing answers
   from numpy, and the probe (on an injected clock) heals the FSM.
13. the controller binary (karpenter_tpu_torch.runtime and __main__):
   (a) workloads.build_runtime_world (phase 9's 100k-pod x 300-group
   cluster and phase 11's 4,000-autoscaler fleet with 64 pool groups,
   the fleet reading karpenter_queue_length from ~7,900 queue
   MetricsProducers over fake queues) written into a Store, then
   KarpenterRuntime(Options(fused_tick, event_driven, prewarm_compile,
   poolgroups)) over it on the card: the three controllers in the
   reference's order; the first manager tick launches each kernel once
   (the MetricsProducer controller's batched solve; counts set to 0 just
   before, read just after) with RECONCILE_TOTALS and every object
   Active; 1 tick of 5 s with 1,000 pods churned (the churn lands
   under the pass lock; the event thread's pass follows it): tick
   p50/p95, the split by controller / note_tick + publish_gauges / tick
   hook, the event thread's passes, launches and dispatches per tick,
   fused_dispatches == HA ticks, fallback_total 0, the FSM healthy, full
   gc collections; a profiler window of 1 tick (device kernels, busy
   us, each kernel's launches and ms per launch; skipped past
   RUNTIME_LATE_S of smoke); (b) the same world, options and first tick
   on a CPU runtime: equal objects (every status), provider replicas and
   exposition (less timings and the service's and manager's own
   counters); (b) and (c)-(d) each run in a child process beside (a)
   (_Child); (c) the binary `python -m
   karpenter_tpu_torch --profile production --cloud-provider fake
   --data-dir D --journal-dir J` over a 10,000-pod x 300-group, 400-HA
   world written with open_store: /readyz "ok", /metrics with solver
   requests, no fallback and every producer's pending_capacity series,
   exit 0 on SIGTERM, every producer with a status when D is reopened;
   restarted on D and J it answers the recovery warm-up, then "ok", with
   a higher fence generation; both runs with --profiler-port P: the
   first takes GET :P/profile?ms=PROFILE_MS, the restart
   /debug/profile?ms=PROFILE_MS into J, each spanning the first tick
   (the one that solves): each trace parses and holds both kernels
   (KERNEL_NAMES), and the count of solver.* ranges is reported;
   (d) with CUDA_VISIBLE_DEVICES="" the same
   command exits non-zero with the reason, serves nothing and writes
   nothing.
14. the --simulate entry point and SimLab (simulate.py, simlab/): (a)
   phase 9's 100k-pod x 300-group cluster written into a data dir
   (workloads.write_reconcile_dir), then `python -m karpenter_tpu_torch
   --simulate --data-dir D` on the card and with --device cpu, and the
   same with --what-if (workloads.what_if_specs, two hypothetical
   groups), each process over its own copy of the dir: card report ==
   CPU report; the dry run's totals (nodes, LP bound, pending,
   unschedulable) and both reports' crc32 equal the reference's
   (SIMULATE_PINS); in process on a card runtime over the dir,
   simulate() launches each kernel once and simulate_delta() twice
   (counts set to 0 just before, read just after), with the host split
   (store open, encode, service.solve, report assembly) and the kernels'
   device ms per launch; (b) phase 12's 2,000-node x 30,000-pod world in
   a data dir, `--simulate --consolidate` with --device cpu as a process
   and on the card through main() in this process, beside the four (a)
   processes: the reports equal, each kernel launched once per candidate
   with pods (counts set to 0 just before the report's evaluate, read
   just after), device ms per launch over 64 candidates; every wall time
   printed; (c) SolverService().sim_rollout on bench.py's
   256 clusters x 64 ticks x 8 rows (cost theme): == sim_rollout_numpy
   bitwise on every field, clusters 0, 128, 255 unbatched == their rows,
   no mirror serve, batched and sequential p50/p95 timed in turns; (d)
   4,096 clusters x 1,440 ticks x 8 rows (workloads.
   build_sim_rollout_inputs): three clusters == the numpy mirror, p50
   through the service and of the program alone, device ops, kernels and
   busy us per rollout (profiler), peak allocated memory; (e)
   search_tuned_policy on the cost scenario at seed 0: every reward and
   the winner == a CPU service's and the reference's (SEARCH_PIN); a
   64-tick BatchedSimEnv.step loop over 256 clusters, card == CPU every
   tick; (f) under a simlab.step error plan sim_step and sim_rollout
   raise the injected error, no mirror serve, the FSM degrades to
   SolverDeviceError and the probe (on an injected clock) heals it.

15. real-cluster mode (store/kube.py, webhook.py): (a) phase 9's
   100k-pod x 300-group cluster plus 4 node groups, each scaled by an
   autoscaler on its producer's additional-nodes gauge, seeded into two
   fake kube-apiservers (tests/fake_apiserver.py); KarpenterRuntime over
   KubeStore(KubeClient(url)) on the card with --profile production's
   options, and a CPU runtime over the second fake: the initial sync time
   (a chunked relist of 100,000 pods); the first tick launches each
   kernel once with RECONCILE_TOTALS; then 3 churned ticks (1,000 pods
   replaced through the fake's delete_object / put_object, a wait until
   the mirror holds exactly the server's pods at the churn's last
   resourceVersion, reconcile_all) and one more under the profiler, each
   launching each kernel exactly once (counts set to 0 just before the
   churn, read once the event thread settles); after every tick the
   producers', node groups' and autoscalers' documents on the card's fake
   equal those the CPU runtime wrote (less resourceVersion, uid,
   creationTimestamp and transition times); tick p50/p95 and its split
   (churn writes, watch lag to quiescence, watch decode, mirror apply,
   encode, service.solve, status patches over HTTP, the controllers'
   slices), REST requests per tick, the profiled tick's device busy time
   and kernels, device ms per launch (the profiler over 5 cuda solves of
   the last tick's operands); (c)
   `--simulate --apiserver URL` (main() in process, before the churn):
   totals and groups equal the --data-dir dry run's (phase 14), each
   kernel launched once; (b) two `python -m
   karpenter_tpu_torch --apiserver URL --kube-insecure --leader-elect
   --webhook-port P` over a 10,000-pod fake: one leader writes every
   producer's status while the standby solves nothing; both webhooks
   answer valid and invalid HorizontalAutoscaler and MetricsProducer
   reviews as the CPU's review_validate / review_mutate; SIGTERM to the
   leader exits 0, the standby takes the lease within the lease duration
   plus its skew tolerance and ticks on its card; with
   CUDA_VISIBLE_DEVICES="" the command exits 1 before any LIST or watch;
   (b) runs in a child process beside (a) and (c).
16. the shipped Deployment (config/manager/manager.yaml: the controller
   with --cloud-provider tpu --solver-uri beside `python -m
   karpenter_tpu_torch.sidecar`, which owns the card): it prints the
   transport leg (`sidecar transport: grpc <version>`) and fails where
   grpc is not installed; (a) phase 15's draws in a Store
   plus the four GKE TPU pools of workloads.TPU_POOLS (one with no live
   node, profiled from the pool's template: ct5lp-hightpu-4t, 2x4) behind
   a fake GKE cluster manager through cloudprovider/gke_sdk.py, each
   scaled by an autoscaler on its producer's additional-nodes gauge
   (docs/examples/pending-capacity-binpack.yaml); a SolverServer on the
   card in this process, a KarpenterRuntime(Options(solver_uri,
   device="cuda")) split from it (its service on the host under the
   card's failure rule) and a CPU twin without a sidecar: the first tick
   and 3 churned ticks of 1,000 pods, each launching each kernel exactly
   once, all from the sidecar's service (counts set to 0 just before the
   churn, read after the tick); after every tick the producers', node
   groups' and autoscalers' documents, the exposition and the fake API's
   resizes equal the twin's; tick p50/p95, the split into RPC round
   trips, the sidecar's service.solve and the kernels' device ms per
   launch, Solve and Decide RPCs and request bytes per tick; (b) at
   10,000 pods, the port's shipped Deployment (config/torch, rendered by
   hack/render_overlay.py) as processes: the kernels prebuilt as the
   image's build step builds them (`python -m
   karpenter_tpu_torch.prebuild`; each library's NEEDED entries printed
   and held to the runtime stage's), then the solver container's own
   command and args on the card (endpoints substituted) and the
   controller container's flags with CUDA_VISIBLE_DEVICES="": the
   sidecar starts without running nvcc (every library's path and mtime
   unchanged, no .tmp), the controller ticks through the sidecar, its
   producers' statuses equal an in-process card runtime's, its pools
   answer the no-SDK guidance, both exit 0 on SIGTERM, and the sidecar's
   closing line counts each kernel launched once per Solve it answered;
   the sidecar with the card hidden exits 1 before it binds, and a
   --device cuda controller beside a --device cpu sidecar exits 1 before
   its first tick.
17. the multi-tenant control plane (tenancy/, --tenant-config) and the
   solver introspection plane (--introspect) on SolverService() on the
   card: (a) simulate_multitenant at BASELINE.json's 1000 tenants x 4
   autoscalers x 2 metrics (bench.py --multitenant's defaults), 12
   lockstep ticks: its aggregate_replicas digests equal the reference's
   (MT_DIGESTS, pinned) and a CPU twin's, no mirror or floor serve;
   shared dispatches per tick, amortization, tick p50/p95 (the tick's
   tracer span); the same tenants' decide + cost matrices through one
   scheduler vs a sequential per-tenant loop through the same service
   (bench.py's two arms): equal answers, both p50s and their ratio;
   (b) solve_all over 64 tenants' seeded reconcile-size problems (256
   rows x 304 groups, R = 4), 3 rounds with the launch counts set to 0
   just before each and read just after: each kernel once per tenant per
   round; every tenant's five outputs equal its direct
   solve(backend="cuda") and the plain program on the CPU; device ms per
   launch (profiler); (c) fused_tick_all, decide_all, cost_all and
   forecast_all over 64 tenants: each tenant's answer equals its own
   numpy mirror's bitwise, the fused round one CUDA-graph dispatch;
   (d) one solver.dispatch failure, then one tenant under a
   tenancy.gather.<id> plan: the failed dispatch's tenants and then the
   faulted one (its breaker open) are served by their own device
   dispatches, every answer equals the no-fault run's, nothing is served
   from numpy, and with the plan cleared the probe (on a running injected
   clock) closes the breaker; (e) KarpenterRuntime with a
   tenant config (4 tenants, weights 1-3, JSON) and the introspection
   plane over phase 13 (c)'s 10,000-pod world for 3 ticks behind the
   HTTP server: /debug/solver enabled with the kernels' build and the
   first-shape dispatches in its ledger and the card's memory,
   /metrics with karpenter_device_*, karpenter_tenant_active 4 and the
   compile family, /debug/selfslo with the tenants' board. Past
   MT_LATE_S of smoke (a)'s CPU twin is skipped and its sequential arm
   runs one round.
18. the replicated control plane (replication/, --partitions): (a) three
   card KarpenterRuntime replicas (partitions 16, lease 5 s, a 16-tenant
   config, one journal root) over phase 13 (c)'s 10,000-pod world in one
   Store (workloads.ReplicaFleet), on a step clock of 5 s ticks: 4 ticks,
   the replica owning the most partitions killed by its crash plan on
   the next, 4 more ticks (2 past REPLICA_LATE_S of smoke), the first
   already lease + skew past the victim's last renew; each live
   replica's tick launches both kernels (counts set to 0 just before
   each replica's tick, read just after); the survivors hold all 16
   partitions, every victim tenant goes warmup -> serving at a fence
   generation of 2 or more, and the victim's stale token is rejected by
   each adopter's provider; every tick (ownership, handoffs, fence
   generations, the replica and handoff series, the store's objects,
   the cloud's replicas, each replica's exposition) equals a CPU twin's
   run in a child process (every journal of both fleets compacts on its
   record count alone, not on the host's clock); device ms per launch at the last tick's
   operands; (b) `--simulate --failover` through main() on the card ==
   the reference's report (pinned), and simulate_failover at
   bench-failover's 256 tenants x 4 replicas x 16 partitions x 40
   ticks: the reference's writes digest (BASELINE.json); (c) two
   `python -m karpenter_tpu_torch --apiserver URL --partitions 8
   --lease-duration 3 --replica-id r0|r1` over one fake kube-apiserver
   at 1,000 pods: the bigger owner SIGKILLed, the survivor's
   /debug/replicas lists all 8 partitions within lease + skew + 3 of its
   ticks, and it exits 0 on SIGTERM; (b) and (c) run in a child beside
   (a); (d) the C quantity parser (native/quantity.c) builds and loads,
   Quantity.parse through it equals the regex oracle on (a)'s world's
   quantities, both rates printed.
19. multi-device (parallel/mesh.py, parallel/multihost.py, the solve
   service's shard route) over 8 virtual shards of the card
   (utils/device.force_virtual_devices): (a) sharded_binpack on 4x2,
   2x2x2 (slices=2) and 8x1 meshes at the main path == solve(backend=
   "cuda") bitwise on all five outputs (nodes 20262), each launching
   what launch_plan states (a scan per non-empty row slab, one
   demand_reduce, a shelf per non-empty group slab: 8 + 1 + 8) and one
   pack (counts set to 0 just before, read just after); p50/p95 of 10 sharded beside
   10 single-device solves in turns; device ms per launch at the slab
   shape (profiler); dryrun_fleet_step(8) on the card; (b) SolverService()
   over the shards: the main path's host arrays at the default
   threshold take the shard route (shard_requests 1, shard_dispatches 1,
   shard_fallbacks 0, fallback_total 0, the shard gauge 8) == single-
   device bitwise; at shard_threshold=1, decide on phase 6's fleet,
   forecast on phase 8's series, preempt on phase 12's eviction fleet, a
   constrained solve and phase 12's profiled consolidation batch equal
   the single-device service's answers bitwise; (c) in a child beside
   (a) and (b): two ranks on the card join over gloo (4 shards each),
   each runs dryrun_fleet_step(8) on its global meshes and a card-route
   solve on a global 2x2x2 mesh equal to the single-process solve, and
   beside them two `python -m karpenter_tpu_torch.sidecar --multihost`
   processes:
   Health device_count 2 and backend cuda, a Solve RPC at phase 16's
   operands == an in-process solve.

Then it profiles 20 main-path solves (torch.profiler: device time by
kernel) and prints, before the last line, one JSON line of kernel records
(`ms` is device time per launch from the profiler, and the smoke fails
without it; `call_ms` is the wrapper's time by CUDA events around 50
calls; the pack kernel's record is taken at the main path's four masks,
its words held to the plain pack_bits' bit for bit, and the forecast
kernel's in phase 8), and the script's
wall time, and as the last line
{"ok": true, "device": {...}}. Every line with a measured number ends
with the card's name and power limit. Without a CUDA device, or without
the rest of the repo beside it, it exits non-zero and prints no result.
Imports neither jax nor karpenter_tpu.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and the
# non-tensor-core f32 rate, used here for the scalar integer/float steps
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

MAIN_SHAPE = dict(pods=100_000, types=300, taints=64, labels=64, seed=0)
# the main path's node total, as the reference's bench printed it for seed 0
MAIN_NODES = 20262
BUCKETS = 32
ITERS = 20
# device kernels of each wrapper, by the names the profiler shows
# the wrappers a single-device solve launches (a sharded one adds the
# demand reduction as its own launch, LAUNCHES["demand_reduce"])
SINGLE_KERNELS = ("fused_assign", "shelf_bfd")
KERNEL_NAMES = {
    "fused_assign": ("assign_kernel", "demand_reduce_kernel"),
    "shelf_bfd": ("shelf_bfd_warp_kernel", "shelf_bfd_wide_kernel"),
}
# phases 6-8 at the repo's published sizes (BASELINE.json): 1000 tenants
# x 4 autoscalers padded to pad_to's 64-row bucket, 3 metrics; 2,048
# series x 64 samples; 64 pool groups x 4 pools
FLEET_N, FLEET_M = 4096, 3
TICK_SHAPE = dict(n=FLEET_N, m=FLEET_M, s=2048, t=64, groups=64, pools=4)
# phase 9: bench.py::run_e2e's cluster at its defaults, its churn per tick
# (max(1, pods // 100)), and its mixed draw
RECONCILE_SHAPE = dict(pods=100_000, types=300, seed=0)
RECONCILE_CHURN = 1000
SERVICE_PAIRS = 12  # churned ticks timed in turns, service vs direct
MIXED_SHAPE = dict(pods=20_000, types=50, seed=0, affinity=0.3, anti=0.05,
                   spread=0.1)
# the first tick's totals on RECONCILE_SHAPE: the reference's solve_pending
# (karpenter_tpu, backend="numpy", on a CPU) over the same draw gives these
# summed over the 300 producers, with every pod on mp0
RECONCILE_TOTALS = dict(nodes=9263, lp_bound=8197, unschedulable=0,
                        mp0_pending=100_000)
# where phase 9 writes its profiler trace (listed in .gitignore)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
# the card's `nvidia-smi --query-gpu=name,power.limit` line, set in main()
CARD = {"line": "not read"}


def need(ok, what: str) -> None:
    """A check that holds under python -O too."""
    if not ok:
        raise AssertionError(what)


def report(line: str) -> None:
    """Print a line of measured numbers with the card it was measured on."""
    print(f"{line} [card: {CARD['line']}]", flush=True)


def host_ms(torch, fn, iters=ITERS):
    """(p50, p95) ms of `iters` calls on the host clock, each ending in
    synchronize(), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times, 50)), float(np.percentile(times, 95))


def _leaves(tree, prefix=""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        elif value is not None:
            yield f"{prefix}{name}", value


def same_bits(got: dict, want: dict, what: str) -> int:
    """Two output trees (Operands.to_numpy() dicts) hold the same leaves
    with the same dtype, shape and bytes; returns the number of leaves."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    need(got.keys() == want.keys(),
         f"{what}: leaves {sorted(got)} vs {sorted(want)}")
    for path, x in got.items():
        y = want[path]
        need(x.dtype == y.dtype and x.shape == y.shape
             and x.tobytes() == y.tobytes(), f"{what}: {path} differs bitwise")
    return len(got)


def random_fields(rng, pods, types, taints=8, labels=8, n_resources=3):
    """A ragged random problem with a few empty groups (the reference's
    tests/test_pallas_binpack.py::random_inputs, as numpy fields)."""
    alloc = rng.uniform(1.0, 64.0, (types, n_resources)).astype(np.float32)
    alloc[rng.random(types) < 0.1] = 0.0
    return {
        "pod_requests": rng.uniform(0.05, 8.0, (pods, n_resources)).astype(
            np.float32
        ),
        "pod_valid": rng.random(pods) > 0.05,
        "pod_intolerant": rng.random((pods, taints)) < 0.1,
        "pod_required": rng.random((pods, labels)) < 0.05,
        "group_allocatable": alloc,
        "group_taints": rng.random((types, taints)) < 0.15,
        "group_labels": rng.random((types, labels)) < 0.8,
    }


def fused_cases():
    """(name, numpy fields) for phase 2's small problems."""
    cases = []
    rng = np.random.default_rng(1)
    f = random_fields(rng, 203, 37)
    f["pod_weight"] = rng.integers(1, 2000, 203).astype(np.int32)
    cases.append(("ragged 203x37", f))
    for i, extra in enumerate(("score", "forbidden", "exclusive")):
        rng = np.random.default_rng(10 + i)
        f = random_fields(rng, 512, 24)
        f["pod_weight"] = rng.integers(1000, 5000, 512).astype(np.int32)
        if extra == "score":
            f["pod_group_score"] = rng.integers(0, 100, (512, 24)).astype(
                np.float32
            )
        elif extra == "forbidden":
            f["pod_group_forbidden"] = rng.random((512, 24)) < 0.3
        else:
            f["pod_exclusive"] = rng.random(512) < 0.3
        cases.append((f"512x24 weighted + {extra}", f))
    rng = np.random.default_rng(20)
    f = random_fields(rng, 777, 53, taints=70, labels=130)
    f["pod_group_score"] = rng.integers(0, 5, (777, 53)).astype(np.float32)
    f["pod_group_forbidden"] = rng.random((777, 53)) < 0.2
    f["pod_exclusive"] = rng.random(777) < 0.2
    cases.append(("777x53 multi-word K/L + all operands", f))
    return cases


def wide_cases(workloads):
    """(name, numpy fields) past 1,447 groups, where the generic
    instance reads the group side from global memory (T = 4,096 at
    K = L = 64; T = 2,000 at K = L = 512)."""
    cases = []
    for pods, types, tl, seed in ((20_000, 4096, 64, 4), (5_000, 2000, 512, 5)):
        f = workloads.build_inputs(pods, types, tl, tl, seed=seed)
        f["pod_weight"] = np.random.default_rng(seed).integers(
            1, 5000, f["pod_valid"].shape[0]
        ).astype(np.int32)
        cases.append((f"{pods}x{types} K=L={tl} weighted", f))
    return cases


def queued_ms(torch, fn, iters=50):
    """Device ms of one call, by CUDA events around `iters` calls queued
    behind a device sleep of ~50 ms, so that the card runs them back to
    back whatever the host's enqueue rate (launch gaps included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # cycles: ~50 ms at the card's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters):
    """Mean device time of one call, by CUDA events around `iters` calls
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_fused(torch, TB, TF, main_inputs, workloads):
    cases = fused_cases() + wide_cases(workloads)
    for name, fields in cases + [(f"main path {MAIN_SHAPE}", None)]:
        inputs = (
            main_inputs if fields is None
            else TB.inputs_from_numpy(fields, "cuda")
        )
        a, h, d, u = TF.fused_assign(inputs, BUCKETS)
        ra, rh, rd, ru = TF.fused_assign_reference(inputs, BUCKETS)
        again = TF.fused_assign(inputs, BUCKETS)[2]
        torch.cuda.synchronize()
        need(torch.equal(a, ra), f"{name}: assigned differs")
        need(torch.equal(h, rh), f"{name}: hist differs")
        need(torch.equal(u, ru), f"{name}: unschedulable differs")
        torch.testing.assert_close(d, rd, rtol=1e-5, atol=0.0)
        need(torch.equal(d.view(torch.int32), again.view(torch.int32)),
             f"{name}: demand differs between two launches")
        err = float((d.double() - rd.double()).abs().max()) if d.numel() else 0.0
        print(f"fused_assign vs plain [{name}]: assigned/hist/unschedulable "
              f"exact, demand max |diff| {err}, bitwise stable")


def phase_shelf(torch, TF, main_hist):
    rng = np.random.default_rng(3)
    cases = [
        (f"random B={b} seed={s}",
         torch.from_numpy(
             rng.integers(0, hi, (300, b)).astype(np.int32)
         ).cuda(), b)
        for s, (b, hi) in enumerate((
            (8, 40), (16, 400), (32, 40), (32, 4000), (1, 400), (33, 400),
            (64, 400),
        ))
    ] + [("main path histogram", main_hist, BUCKETS)]
    for name, hist, b in cases:
        nodes, count = TF.shelf_bfd(hist, b)
        want_nodes, want_count = TF.shelf_bfd_reference(hist, b)
        torch.cuda.synchronize()
        need(torch.equal(nodes, want_nodes), f"shelf_bfd [{name}]: nodes differ")
        need(torch.equal(count, want_count), f"shelf_bfd [{name}]: count differs")
        print(f"shelf_bfd vs plain [{name}]: nodes and count exact "
              f"({int(nodes.sum())} nodes)")


def outputs_equal(a, b, what):
    for field in ("assigned", "assigned_count", "nodes_needed", "unschedulable"):
        x, y = getattr(a, field), getattr(b, field)
        need(torch_equal(x, y), f"{what}: {field} differs")


def torch_equal(x, y):
    import torch

    return torch.equal(x.cpu(), y.cpu())


def check_lp(cuda_out, plain_out, inputs):
    """lp_bound exact; any mismatch printed with its demand, and allowed
    only where demand/alloc lies within 1e-5 relative of an integer."""
    import torch

    from karpenter_tpu_torch.ops.fused_assign import fused_assign_reference

    diff = (cuda_out.lp_bound != plain_out.lp_bound).nonzero().flatten()
    if diff.numel() == 0:
        return 0
    demand = fused_assign_reference(inputs, BUCKETS)[2]
    alloc = inputs.group_allocatable
    for t in diff.tolist():
        ratio = (demand[t].double() / alloc[t].double()).tolist()
        print(f"lp_bound mismatch group {t}: cuda {int(cuda_out.lp_bound[t])} "
              f"plain {int(plain_out.lp_bound[t])} demand {demand[t].tolist()} "
              f"demand/alloc {ratio}")
        near = any(abs(x - round(x)) <= 1e-5 * max(1.0, abs(x)) for x in ratio)
        need(near, f"lp_bound mismatch at group {t} away from an integer")
    return int(diff.numel())


def phase_main(torch, TB, TF, inputs):
    TF.reset_launch_counts()
    t0 = time.perf_counter()
    out = TB.solve(inputs, buckets=BUCKETS, backend="cuda")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(TF.LAUNCHES)
    for name in SINGLE_KERNELS:
        need(launches[name] > 0,
             f"kernel {name} was not launched on the main path")
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        again = TB.solve(inputs, buckets=BUCKETS, backend="cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    outputs_equal(again, out, "solve cuda, first vs later call")

    plain_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        plain = TB.solve(inputs, buckets=BUCKETS, backend="torch")
        torch.cuda.synchronize()
        plain_times.append((time.perf_counter() - t0) * 1e3)
    outputs_equal(out, plain, "solve cuda vs torch (main path)")
    n_lp = check_lp(out, plain, inputs)

    pods = inputs.pod_requests.shape[0]
    assigned = out.assigned
    need(assigned.shape == (pods,) and assigned.dtype == torch.int32,
         "assigned is not i32[P]")
    need(int(assigned.min()) >= -1, "assigned below -1")
    need(int(assigned.max()) < inputs.group_allocatable.shape[0],
         "assigned past the last group")
    need(int(out.assigned_count.sum()) + int(out.unschedulable) == pods,
         "scheduled + unschedulable != pods")
    need(bool((out.nodes_needed >= out.lp_bound).all()), "sandwich broken")
    need(int(out.nodes_needed.sum()) == MAIN_NODES,
         f"main path nodes {int(out.nodes_needed.sum())} != {MAIN_NODES}")
    p50, p95 = np.percentile(times, 50), np.percentile(times, 95)
    scheduled = int((assigned >= 0).sum())
    report(f"main path first call {first_ms} ms")
    report(f"main path solve(backend='cuda') p50={p50}ms p95={p95}ms "
          f"scheduled={scheduled}/{pods} unschedulable={int(out.unschedulable)} "
           f"nodes={int(out.nodes_needed.sum())} decisions/sec={1000.0 / p50}")
    report(f"main path solve(backend='torch') p50={np.percentile(plain_times, 50)}ms "
           f"(plain program on the card); lp_bound mismatches: {n_lp}")
    print(f"main path launches (one solve): {launches}")
    return out, launches


def phase_wide_solve(torch, TB, workloads):
    """solve(backend="cuda") == solve(backend="torch") at T = 2,000."""
    fields = workloads.build_inputs(20_000, 2000, 64, 64, seed=6)
    inputs = TB.inputs_from_numpy(fields, "cuda")
    fused = TB.solve(inputs, buckets=BUCKETS, backend="cuda")
    plain = TB.solve(inputs, buckets=BUCKETS, backend="torch")
    torch.cuda.synchronize()
    outputs_equal(fused, plain, "solve cuda vs torch at T=2000")
    n_lp = check_lp(fused, plain, inputs)
    print(f"wide fleet 20000x2000: solve cuda == torch on all outputs "
          f"(lp_bound mismatches {n_lp}), nodes {int(fused.nodes_needed.sum())}")


def phase_small_vs_cpu(torch, TB, TF):
    rng = np.random.default_rng(5)
    fields = random_fields(rng, 300, 31)
    fields["pod_weight"] = rng.integers(1, 50, 300).astype(np.int32)
    fields["pod_group_score"] = rng.integers(0, 3, (300, 31)).astype(np.float32)
    gpu = TF.binpack_fused(TB.inputs_from_numpy(fields, "cuda"), 16)
    cpu = TB.binpack(TB.inputs_from_numpy(fields, "cpu"), 16)
    outputs_equal(gpu, cpu, "binpack_fused on the card vs binpack on the CPU")
    need(torch_equal(gpu.lp_bound, cpu.lp_bound), "small lp_bound differs")
    print("binpack_fused (card) == binpack (CPU) on 300x31: all five outputs")


def phase_decision(torch, D, workloads):
    """decide on the card == on the CPU, bitwise, without and with the
    forecast operands. Returns {forecast: (numpy fields, CPU outputs)}."""
    out = {}
    for forecast in (False, True):
        fields = workloads.build_decision_inputs(
            0, FLEET_N, FLEET_M, forecast=forecast
        )
        cpu = D.decide(D.DecisionInputs.from_numpy(fields, "cpu")).to_numpy()
        card_in = D.DecisionInputs.from_numpy(fields, "cuda")
        card = D.decide(card_in).to_numpy()
        what = f"decide N={FLEET_N} M={FLEET_M} forecast={forecast}"
        n_leaves = same_bits(card, cpu, f"{what}: card vs CPU")
        # the edge rows of workloads.with_edge_rows
        need(card["recommendation"][0] >= 0, "zero target: bad recommendation")
        need(card["recommendation"][1] == 2**31 - 128
             and card["desired"][1] == 2**31 - 128,
             "a recommendation past 2**31 - 128 did not saturate")
        need(card["desired"][2] in (1, 2) and card["able_to_scale"][2],
             "Percent policy at spec 0: not floored at one replica")
        need(card["desired"][3] == 5, "min > max: the clamp did not give max")
        p50, p95 = host_ms(torch, lambda: D.decide(card_in))
        counts = profile_per_call(torch, lambda: D.decide(card_in))
        kernels = "not measured" if counts is None else (
            f"{counts[1]} kernels and {counts[2]} us device busy per call")
        report(f"{what}: card == CPU bitwise on {n_leaves} leaves (edge rows "
               f"included); decide p50={p50}ms p95={p95}ms (host clock, "
               f"{ITERS} calls); {kernels}")
        out[forecast] = (fields, cpu)
    return out


def phase_fleet_step(torch, TB, TF, D, MESH, inputs, decision):
    """fleet_step on the card: both kernels launch, the decision is phase
    6's, the bin-pack is the plain program's."""
    fields, cpu_decision = decision[False]
    dec = D.DecisionInputs.from_numpy(fields, "cuda")
    TF.reset_launch_counts()
    dout, bout = MESH.fleet_step(dec, inputs, buckets=BUCKETS)
    torch.cuda.synchronize()
    launches = dict(TF.LAUNCHES)
    for name in SINGLE_KERNELS:
        need(launches[name] > 0,
             f"kernel {name} was not launched by fleet_step")
    same_bits(dout.to_numpy(), cpu_decision, "fleet_step decision vs phase 6")
    plain = TB.solve(inputs, buckets=BUCKETS, backend="torch")
    outputs_equal(bout, plain, "fleet_step bin-pack vs solve(backend='torch')")
    n_lp = check_lp(bout, plain, inputs)
    nodes = int(bout.nodes_needed.sum())
    need(nodes == MAIN_NODES, f"fleet_step nodes {nodes} != {MAIN_NODES}")
    p50, p95 = host_ms(
        torch, lambda: MESH.fleet_step(dec, inputs, buckets=BUCKETS)
    )
    report(f"fleet_step (decide N={FLEET_N} x M={FLEET_M} + solve "
           f"{MAIN_SHAPE}): p50={p50}ms p95={p95}ms (host clock, {ITERS} "
           f"steps); nodes={nodes}, lp_bound mismatches {n_lp}; launches "
           f"(one step): {launches}")
    return launches


def phase_fused_tick(torch, FT, M, workloads):
    """The fused tick on the card == on the CPU; the CUDA graph == eager;
    no host sync in either; times, kernels and memory per tick."""
    torch.cuda.reset_peak_memory_stats()
    ticks = []
    for seed in (0, 1):
        fields = workloads.build_fused_tick_inputs(seed, **TICK_SHAPE)
        cpu = FT.fused_tick(FT.FusedTickInputs.from_numpy(fields, "cpu"))
        ticks.append((FT.FusedTickInputs.from_numpy(fields, "cuda"),
                      cpu.to_numpy()))
    (a, cpu_a), (b, cpu_b) = ticks
    FT.fused_tick(a)  # first launches and allocations, outside the checks
    program = FT.FusedTickProgram()
    t0 = time.perf_counter()
    program(a)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager_a = FT.fused_tick(a)
        replay_a = program(a)
        replay_b = program(b)
        eager_b = FT.fused_tick(b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    need(program.captures == 1, f"{program.captures} captures, expected 1")
    eager_a, eager_b = eager_a.to_numpy(), eager_b.to_numpy()
    n_leaves = same_bits(eager_a, cpu_a, "eager tick (seed 0): card vs CPU")
    same_bits(eager_b, cpu_b, "eager tick (seed 1): card vs CPU")
    same_bits(replay_a.to_numpy(), eager_a, "graph replay (seed 0) vs eager")
    same_bits(replay_b.to_numpy(), eager_b, "graph replay (seed 1) vs eager")
    for stage in ("forecast", "cost", "poolgroup"):
        need(eager_a[stage] is not None, f"stage {stage} missing")
    repaired = int(eager_a["poolgroup"]["joint_repair"].sum())
    print(f"fused tick {TICK_SHAPE}: card == CPU bitwise on {n_leaves} "
          f"leaves (two operand sets); graph replay == eager on both, the "
          f"second replayed after the first; no host sync under "
          f"set_sync_debug_mode('error'); pool groups repaired: {repaired}")

    eager = lambda: FT.fused_tick(a)  # noqa: E731
    replay = lambda: program(a)  # noqa: E731
    e50, e95 = host_ms(torch, eager)
    r50, r95 = host_ms(torch, replay)
    report(f"fused tick eager p50={e50}ms p95={e95}ms; graph replay "
           f"p50={r50}ms p95={r95}ms (host clock, {ITERS} ticks each); "
           f"first call of the program (capture) {capture_s} s")
    counts = {
        "eager tick": profile_per_call(torch, eager),
        "graph replay": profile_per_call(torch, replay),
        "forecast stage alone": profile_per_call(
            torch, lambda: M.forecast(a.forecast)
        ),
    }
    for name, got in counts.items():
        if got is None:
            print(f"profiler, {name}: no device rows (not measured)")
            continue
        ops, kernels, busy = got
        report(f"profiler, {name}: {kernels} kernels, {ops} device ops "
               f"(kernels + memcpy/memset), {busy} us device busy per call")
    tick, fc = counts["eager tick"], counts["forecast stage alone"]
    if tick and fc:
        report(f"forecast stage's share of the eager tick: "
               f"{100.0 * fc[1] / tick[1]}% of the kernels, "
               f"{100.0 * fc[2] / tick[2]}% of the device busy time")
    # the forecast stage is one launch of csrc/forecast.cu and the row
    # stages one of each of csrc/tick_rows.cu's kernels: one an eager
    # tick, none a graph replay
    M.reset_launch_counts()
    FT.reset_launch_counts()
    FT.fused_tick(a)
    eager_launches = {**M.LAUNCHES, **FT.LAUNCHES}
    program(a)
    torch.cuda.synchronize()
    want = {"forecast": 1, "tick_scatter": 1, "tick_rows": 1}
    need(eager_launches == want and {**M.LAUNCHES, **FT.LAUNCHES} == want,
         f"launches: {eager_launches} an eager tick, then "
         f"{ {**M.LAUNCHES, **FT.LAUNCHES} } after a replay (want {want})")
    report(f"fused tick phase: peak allocated device memory "
           f"{torch.cuda.max_memory_allocated()} bytes")
    return [forecast_record(torch, M, workloads),
            tick_rows_record(torch, FT, M, workloads)]


def forecast_record(torch, M, workloads):
    """The forecast kernel's record (csrc/forecast.cu's forecast_kernel) at
    the HA fleet cell's forecast group (5,000 series of 64 samples, padded
    to 6,144 as the service's door pads them): `ms` its device time per
    launch (`ms_by`: the profiler over ITERS launches, or queued_ms where
    it lost the rows), `call_ms` forecast() by CUDA events around 50
    calls, `plain_ms` the plain version forecast_reference on the card,
    `bound_ms` the operand and output bytes at PEAK_BYTES_PER_S, and
    `max_abs_err` 0 when the kernel's outputs equal the plain version's
    bit for bit (1 otherwise; required 0)."""
    fields = workloads.build_fused_tick_inputs(0, 10000, 3, 5000, 64,
                                               groups=64, pools=4)
    host = M.concat_forecast_inputs(
        [M.ForecastInputs.from_arrays(fields["forecast"])], 6144)
    inputs = M.ForecastInputs.from_numpy(host, "cuda")
    kernel = lambda: M.forecast(inputs)  # noqa: E731
    plain = lambda: M.forecast_reference(inputs)  # noqa: E731
    got, want = kernel().to_numpy(), plain().to_numpy()
    err = 0.0 if all(got[k].tobytes() == want[k].tobytes()
                     for k in got) else 1.0
    need(err == 0.0, "the forecast kernel's outputs != the plain version's")

    def ranged():
        # key_averages() keeps a kernel only under a host range or op
        with torch.profiler.record_function("forecast"):
            return kernel()

    M.reset_launch_counts()
    prof, _ = profile_window(torch, ranged, ITERS)
    need(M.LAUNCHES["forecast"] == ITERS + 2,
         f"{ITERS + 2} forecast calls launched {M.LAUNCHES}")
    hits = [(us, c) for us, c, key in device_rows(torch, prof)
            if "forecast_kernel" in key]
    kept = sum(c for _, c in hits)
    if kept == ITERS:
        ms, ms_by = sum(us for us, _ in hits) / ITERS / 1e3, "profiler"
    else:
        # the profiler does not keep every row of a ctypes launch
        ms, ms_by = queued_ms(torch, kernel), (
            f"CUDA events around 50 launches queued behind a device sleep "
            f"(the profiler kept {kept} of {ITERS} forecast_kernel rows)")
    nbytes = sum(t.numel() * t.element_size() for t in (
        *(getattr(inputs, f) for f in M.ForecastInputs.KINDS),
        *(torch.as_tensor(v) for v in got.values())))
    record = {
        "name": "forecast",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/forecast.cu",
        "replaces": ("karpenter_tpu_torch/forecast/models.py::"
                     "forecast_reference (a PyTorch program; the reference "
                     "leaves its forecast to XLA, karpenter_tpu/forecast/"
                     "models.py::forecast)"),
        "shape": [6144, 64],
        "plan": list(M.forecast_plan(64)),
        "bytes": nbytes,
        "max_abs_err": err,
        "ms": ms,
        "ms_by": ms_by,
        "call_ms": time_ms(kernel, 50),
        "plain_ms": time_ms(plain, 3),
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }
    report(f"forecast_kernel at the fleet cell's 6,144 x 64 series: {ms} ms "
           f"a launch ({ms_by}; bound {record['bound_ms']} ms, {nbytes} "
           f"bytes), call {record['call_ms']} ms, plain version "
           f"{record['plain_ms']} ms, outputs == plain bit for bit")
    return record


def tick_rows_record(torch, FT, M, workloads):
    """The row-stage kernels' record (csrc/tick_rows.cu's memset,
    tick_scatter_kernel and tick_rows_kernel, one `tick_rows` call) at the
    HA fleet cell's shape: 10,000 HAs x 3 metrics, K = 2 policy slots,
    5,000 series padded to 6,144. `ms` the three device ops' time per call
    (`ms_by`: the profiler over ITERS calls, or queued_ms where it lost
    rows), `kernel_us` each op's, `call_ms` tick_rows() by CUDA events
    around 50 calls, `plain_ms` the plain version tick_rows_reference on
    the card, `bound_ms` the operand and output bytes at
    PEAK_BYTES_PER_S, and `max_abs_err` 0 when every output equals the
    plain version's bit for bit (1 otherwise; required 0)."""
    fields = workloads.build_fused_tick_inputs(0, 10000, 3, 5000, 64)
    host = FT.pad_series(FT.FusedTickInputs.from_arrays(fields), 6144)
    inputs = FT.FusedTickInputs.from_numpy(host, "cuda")
    fout = M.forecast(inputs.forecast)
    kernel = lambda: FT.tick_rows(inputs, fout)  # noqa: E731
    plain = lambda: FT.tick_rows_reference(inputs, fout)  # noqa: E731

    def leaves(out):
        dout, cout, dist = out
        return [*dout.to_numpy().values(), *cout.to_numpy().values(),
                *(x.cpu().numpy() for x in dist)]

    got, want = leaves(kernel()), leaves(plain())
    err = 0.0 if all(x.tobytes() == y.tobytes()
                     for x, y in zip(got, want)) else 1.0
    need(err == 0.0, "the tick_rows kernels' outputs != the plain version's")

    def ranged():
        # key_averages() keeps a kernel only under a host range or op
        with torch.profiler.record_function("tick_rows"):
            return kernel()

    FT.reset_launch_counts()
    prof, _ = profile_window(torch, ranged, ITERS)
    need(FT.LAUNCHES == {"tick_scatter": ITERS + 2, "tick_rows": ITERS + 2},
         f"{ITERS + 2} tick_rows calls launched {FT.LAUNCHES}")
    ops = {"memset": "Memset", "tick_scatter_kernel": "tick_scatter_kernel",
           "tick_rows_kernel": "tick_rows_kernel"}
    rows = device_rows(torch, prof)
    kernel_us = {name: [(us, c) for us, c, key in rows if match in key]
                 for name, match in ops.items()}
    if all(sum(c for _, c in hits) == ITERS for hits in kernel_us.values()):
        kernel_us = {name: sum(us for us, _ in hits) / ITERS
                     for name, hits in kernel_us.items()}
        ms, ms_by = sum(kernel_us.values()) / 1e3, "profiler"
    else:
        # the profiler does not keep every row of a ctypes launch
        kept = {name: sum(c for _, c in hits)
                for name, hits in kernel_us.items()}
        kernel_us = None
        ms, ms_by = queued_ms(torch, kernel), (
            f"CUDA events around 50 calls queued behind a device sleep "
            f"(the profiler kept {kept} of {ITERS} rows each)")
    operands = [t for path, t in FT._leaves(inputs)
                if not path.startswith(("forecast.", "poolgroup."))]
    nbytes = sum(t.numel() * t.element_size() for t in (
        *operands, fout.point, fout.sigma2, fout.n_valid,
        *(torch.as_tensor(v) for v in got)))
    record = {
        "name": "tick_rows",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/tick_rows.cu",
        "replaces": ("karpenter_tpu_torch/ops/fusedtick.py::"
                     "tick_rows_reference (PyTorch programs: the scatter, "
                     "ops/decision.py::decide, the cost seam and "
                     "ops/cost.py::cost_decide; the reference leaves them "
                     "to XLA)"),
        "shape": [10000, 3, 2, 6144],
        "bytes": nbytes,
        "max_abs_err": err,
        "ms": ms,
        "ms_by": ms_by,
        "kernel_us": kernel_us,
        "call_ms": time_ms(kernel, 50),
        "plain_ms": time_ms(plain, 3),
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }
    report(f"tick_rows at the fleet cell's 10,000 x 3, 6,144 series: {ms} "
           f"ms a call ({ms_by}; {kernel_us} us by op; bound "
           f"{record['bound_ms']} ms, {nbytes} bytes), call "
           f"{record['call_ms']} ms, plain version {record['plain_ms']} ms, "
           f"outputs == plain bit for bit")
    return record


def _totals(producers) -> dict:
    """RECONCILE_TOTALS' keys from the producers' statuses."""
    sts = [mp.status.pending_capacity for mp in producers]
    return dict(
        nodes=sum(st.additional_nodes_needed for st in sts),
        lp_bound=sum(st.lp_lower_bound for st in sts),
        unschedulable=sts[0].unschedulable_pods,
        mp0_pending=sts[0].pending_pods,
    )


def _status_and_gauges(PC, cluster) -> dict:
    """(status fields, the four gauges) per producer."""
    out = {}
    for mp in cluster.producers:
        ns, name = mp.metadata.namespace, mp.metadata.name
        st = mp.status.pending_capacity
        out[(ns, name)] = (
            None if st is None else (
                st.pending_pods, st.additional_nodes_needed,
                st.lp_lower_bound, st.unschedulable_pods,
            ),
            tuple(
                cluster.registry.gauge(PC.SUBSYSTEM, g).get(name, ns)
                for g in (PC.PENDING_PODS, PC.ADDITIONAL_NODES_NEEDED,
                          PC.LP_LOWER_BOUND, PC.UNSCHEDULABLE_PODS)
            ),
        )
    return out


def _host_split(TB, PC, workloads, cluster, n=10) -> dict:
    """Median ms of each host stage of n churned ticks: the store mutation
    (with its watch fan-out into the feed), the feed (targets, profiles,
    snapshot, fingerprint: the tick's time outside the stages below), the
    encode, the solve call (the launches return before the kernels end),
    the fetch (one device->host copy, which waits for the kernels), and
    the status and gauge writes. Timed by wrapping the module's
    encode_snapshot and _pack_outputs seams and the solver."""
    marks = {}
    encode, pack = PC.encode_snapshot, PC._pack_outputs

    def timed_encode(*args, **kwargs):
        t0 = time.perf_counter()
        out = encode(*args, **kwargs)
        marks["encode"] = time.perf_counter() - t0
        return out

    def timed_solver(inputs, **kwargs):
        t0 = time.perf_counter()
        out = TB.solve(inputs, **kwargs)
        marks["solve"] = time.perf_counter() - t0
        return out

    def timed_pack(*args):
        t0 = time.perf_counter()
        out = pack(*args).cpu()  # the tick's own .cpu() is then a no-op
        marks["fetched_at"] = time.perf_counter()
        marks["fetch"] = marks["fetched_at"] - t0
        return out

    rows = []
    PC.encode_snapshot, PC._pack_outputs = timed_encode, timed_pack
    try:
        for _ in range(n):
            apply = workloads.churn_reconcile(cluster, RECONCILE_CHURN)
            marks.clear()
            t0 = time.perf_counter()
            apply()
            t1 = time.perf_counter()
            cluster.tick(timed_solver)
            t2 = time.perf_counter()
            row = {
                "mutation": t1 - t0,
                "encode": marks["encode"],
                "solve": marks["solve"],
                "fetch": marks["fetch"],
                "status_gauges": t2 - marks["fetched_at"],
            }
            row["feed"] = (t2 - t1) - sum(
                row[k] for k in ("encode", "solve", "fetch", "status_gauges")
            )
            row["tick"] = t2 - t0
            rows.append(row)
    finally:
        PC.encode_snapshot, PC._pack_outputs = encode, pack
    return {k: float(np.median([r[k] for r in rows])) * 1e3 for k in rows[0]}


def _trace_copy_bytes(prof, name) -> dict:
    """{"HtoD": bytes, "DtoH": bytes} of the memcpy events in a profile,
    read from its exported Chrome trace (written to OUT_DIR/name), or
    None when the trace carries no byte counts."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    out = {"HtoD": 0, "DtoH": 0}
    seen = False
    for ev in events:
        if ev.get("cat") != "gpu_memcpy" or "bytes" not in ev.get("args", {}):
            continue
        seen = True
        for kind in out:
            if kind in ev.get("name", ""):
                out[kind] += int(ev["args"]["bytes"])
    return out if seen else None


def _profile_reconcile(torch, workloads, cluster, n=5) -> dict:
    """A torch.profiler window of n churned ticks (after two warm-up
    ticks): device kernels, busy us, copies and host->device bytes per
    tick, and the device time per launch of the fused kernel's generic
    instance and of the shelf kernel."""
    mutations = iter([
        workloads.churn_reconcile(cluster, RECONCILE_CHURN)
        for _ in range(n + 2)
    ])

    def churned_tick():
        next(mutations)()
        cluster.tick()

    prof, wall_us = profile_window(torch, churned_tick, n)
    rows = device_rows(torch, prof)
    need(rows, "profiler: no device rows in the reconcile ticks")

    def per_tick(pred):
        hits = [(us, count) for us, count, key in rows if pred(key)]
        return sum(c for _, c in hits) / n, sum(u for u, _ in hits) / n

    kernels, _ = per_tick(lambda k: not k.startswith(("Memcpy", "Memset")))
    d2h, _ = per_tick(lambda k: k.startswith("Memcpy DtoH"))
    h2d, _ = per_tick(lambda k: k.startswith("Memcpy HtoD"))
    busy = sum(us for us, _, _ in rows) / n
    generic = [(us, c) for us, c, key in rows if "assign_kernel<8, 8, false>" in key]
    narrow = [key for _, _, key in rows if "assign_kernel<3, 1, true>" in key]
    need(generic and not narrow,
         "the reconcile path did not run the fused kernel's generic instance")
    fused_launches = sum(c for _, c in generic)
    reduce_us = sum(us for us, _, key in rows if "demand_reduce_kernel" in key)
    fused_ms = (sum(us for us, _ in generic) + reduce_us) / fused_launches / 1e3
    shelf = [(us, c) for us, c, key in rows if "shelf_bfd_warp_kernel" in key]
    need(shelf, "the reconcile path did not run the shelf kernel")
    shelf_ms = sum(us for us, _ in shelf) / sum(c for _, c in shelf) / 1e3
    copy_bytes = _trace_copy_bytes(prof, "reconcile_ticks_trace.json")
    h2d_bytes = ("not measured" if copy_bytes is None
                 else copy_bytes["HtoD"] / n)
    report(f"reconcile profiler, {n} churned ticks: {kernels} kernels, "
           f"{busy} us device busy per tick ({100.0 * busy * n / wall_us}% "
           f"of the window); {h2d} host->device copies and {h2d_bytes} bytes "
           f"per tick; {d2h} device->host copies per tick")
    report(f"reconcile: fused generic instance assign_kernel<8, 8, false> + "
           f"demand_reduce_kernel {fused_ms} ms per launch "
           f"({fused_launches / n} launches per tick); shelf_bfd_warp_kernel "
           f"{shelf_ms} ms per launch")
    for dev_us, count, key in rows[:12]:
        report(f"  device {dev_us / n} us/tick  x{count / n}/tick  {key[:90]}")
    need(d2h == 1.0, f"{d2h} device->host copies per churned tick, not 1")
    return {"fused_ms": fused_ms, "shelf_ms": shelf_ms}


def phase_reconcile(torch, TB, TF, workloads):
    """The port's solve_pending on run_e2e's cluster, on the card."""
    from karpenter_tpu_torch.metrics.producers import pendingcapacity as PC

    cpu_solve = functools.partial(TB.solve, device="cpu")
    t0 = time.perf_counter()
    cluster = workloads.build_reconcile_cluster(**RECONCILE_SHAPE)
    report(f"reconcile cluster {RECONCILE_SHAPE}: store populated in "
           f"{time.perf_counter() - t0} s (host)")
    # the first tick's pods, for phase 10: stored instances are replaced,
    # never mutated, so references keep the state
    initial_pods = _stored_pods(cluster.store)

    TF.reset_launch_counts()
    t0 = time.perf_counter()
    errors = cluster.tick()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(TF.LAUNCHES)
    need(all(e is None for e in errors.values()), f"tick errors {errors}")
    need(launches == {"fused_assign": 1, "shelf_bfd": 1, "demand_reduce": 0,
                      "pack_bits": 1},
         f"first reconcile tick launches {launches}")
    totals = _totals(cluster.producers)
    need(totals == RECONCILE_TOTALS,
         f"reconcile totals {totals} != reference {RECONCILE_TOTALS}")
    inputs = cluster.feed.encode_memo[1]
    shape = {f: tuple(getattr(inputs, f).shape) for f in
             ("pod_requests", "pod_intolerant", "pod_required",
              "group_allocatable")}
    report(f"reconcile first tick {first_ms} ms: totals {totals} (the "
           f"reference's); launches {launches}; operands {shape}")

    TF.reset_launch_counts()
    steady = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        cluster.tick()
        steady.append((time.perf_counter() - t0) * 1e3)
    need(all(n == 0 for n in TF.LAUNCHES.values()),
         f"steady ticks launched kernels: {TF.LAUNCHES}")
    need(cluster.feed.encode_memo[1] is inputs, "steady ticks re-encoded")

    TF.reset_launch_counts()
    churned = []
    for _ in range(ITERS):
        apply = workloads.churn_reconcile(cluster, RECONCILE_CHURN)
        t0 = time.perf_counter()
        apply()
        cluster.tick()
        churned.append((time.perf_counter() - t0) * 1e3)
    need(TF.LAUNCHES == {"fused_assign": ITERS, "shelf_bfd": ITERS,
                         "demand_reduce": 0, "pack_bits": ITERS},
         f"{ITERS} churned ticks launched {TF.LAUNCHES}")
    last, host = cluster.feed.encode_memo[1], cluster.feed.encode_memo[2]
    card = TB.solve(last)
    plain = cpu_solve(last)
    for field in ("assigned", "assigned_count", "nodes_needed", "lp_bound",
                  "unschedulable"):
        need(torch_equal(getattr(card, field), getattr(plain, field)),
             f"last churned tick: card {field} != CPU plain program")
    for got, field in zip(host, ("assigned_count", "nodes_needed",
                                 "lp_bound", "unschedulable")):
        need(np.array_equal(np.asarray(got),
                            getattr(plain, field).cpu().numpy()),
             f"last churned tick: the tick's {field} != CPU plain program")
    report(f"reconcile steady tick p50={np.percentile(steady, 50)}ms "
           f"p95={np.percentile(steady, 95)}ms, no launch; churned tick "
           f"({RECONCILE_CHURN} pods replaced) p50={np.percentile(churned, 50)}"
           f"ms p95={np.percentile(churned, 95)}ms, each kernel launched once "
           f"per tick (host clock, {ITERS} ticks each); the last churned "
           f"tick's five outputs on the card == the CPU plain program's")

    split = _host_split(TB, PC, workloads, cluster)
    report("reconcile churned tick host split, median ms of 10: "
           + ", ".join(f"{k} {v}" for k, v in split.items())
           + f"; solve + fetch {split['solve'] + split['fetch']}")
    device = _profile_reconcile(torch, workloads, cluster)

    # the mixed draw: the forbidden, score and exclusive operands on the
    # fused path, card == CPU solver on the same store state
    for key in TB.REROUTES:
        TB.REROUTES[key] = 0
    mixed = workloads.build_reconcile_cluster(**MIXED_SHAPE)
    TF.reset_launch_counts()
    errors = mixed.tick()
    need(all(e is None for e in errors.values()), f"mixed errors {errors}")
    mixed_launches = dict(TF.LAUNCHES)
    need(mixed_launches == {"fused_assign": 1, "shelf_bfd": 1,
                            "demand_reduce": 0, "pack_bits": 1},
         f"mixed draw launches {mixed_launches}")
    m_inputs = mixed.feed.encode_memo[1]
    need(all(getattr(m_inputs, f) is not None for f in
             ("pod_group_forbidden", "pod_group_score", "pod_exclusive")),
         "the mixed draw lacks an optional operand")
    on_card = _status_and_gauges(PC, mixed)
    mixed.registry = type(mixed.registry)()
    PC.register_gauges(mixed.registry)
    mixed.feed.encode_memo = None  # solve the same state again
    mixed.tick(cpu_solve)
    need(_status_and_gauges(PC, mixed) == on_card,
         "mixed draw: statuses or gauges on the card != CPU solver")
    m_totals = _totals(mixed.producers)
    used = sum(1 for st, _ in on_card.values() if st and st[0] > 0)
    report(f"reconcile mixed draw {MIXED_SHAPE}: operands "
           f"{tuple(m_inputs.pod_requests.shape)} x "
           f"{tuple(m_inputs.group_allocatable.shape)} with forbidden, score "
           f"and exclusive; card == CPU solver on {len(on_card)} statuses and "
           f"{4 * len(on_card)} gauges; nodes {m_totals['nodes']}, "
           f"unschedulable {m_totals['unschedulable']}, {used} groups used; "
           f"launches {mixed_launches}; REROUTES {dict(TB.REROUTES)}")
    need(not any(TB.REROUTES.values()), f"mixed draw rerouted {TB.REROUTES}")
    return {"launches": launches, **device, "cluster": cluster,
            "initial_pods": initial_pods}


def _stored_pods(store) -> dict:
    """{key: stored Pod instance} of a port Store."""
    return {key: store._objects[key]
            for key in store._by_kind.get("Pod", {})}


def _restore_pods(store, pods: dict) -> None:
    """Bring the store's pods back to `pods` (a _stored_pods snapshot):
    delete the pods created since, re-create the ones deleted since, in
    their original order, through the store (its watch events update the
    feed like any churn)."""
    from karpenter_tpu_torch.utils.clone import fast_clone

    current = _stored_pods(store)
    for key in current:
        if key not in pods:
            store.delete("Pod", key[1], key[2])
    for key, pod in pods.items():
        if key not in current:
            store.create(fast_clone(pod))


def _service_outputs_equal(got, want, inputs, what):
    """A service answer (host numpy) == a direct solve (tensors): the
    four integer outputs exactly; lp_bound exactly, or with `inputs`, per
    check_lp at the documented f32 boundary. Returns the lp mismatches."""
    import torch

    for field in ("assigned", "assigned_count", "nodes_needed",
                  "unschedulable"):
        need(np.array_equal(np.asarray(getattr(got, field)),
                            getattr(want, field).cpu().numpy()),
             f"{what}: {field} differs")
    lp = torch.from_numpy(np.asarray(got.lp_bound)).to(want.lp_bound.device)
    if inputs is None:
        need(torch.equal(lp, want.lp_bound), f"{what}: lp_bound differs")
        return 0
    return check_lp(type("Out", (), {"lp_bound": lp}), want, inputs)


def _fused_instance_ms(rows, n):
    """(instance, fused ms per launch, shelf ms per launch) from profiler
    rows of n calls of one launch each."""
    generic = [(us, c) for us, c, key in rows
               if "assign_kernel<8, 8, false>" in key]
    narrow = [(us, c) for us, c, key in rows
              if "assign_kernel<3, 1, true>" in key]
    need(bool(generic) != bool(narrow),
         f"service solves ran {len(generic)} generic and {len(narrow)} "
         f"narrow fused instances")
    hits = generic or narrow
    fused_launches = sum(c for _, c in hits)
    need(fused_launches == n, f"{fused_launches} fused launches in {n} calls")
    reduce_us = sum(us for us, _, key in rows if "demand_reduce_kernel" in key)
    fused_ms = (sum(us for us, _ in hits) + reduce_us) / fused_launches / 1e3
    shelf = [(us, c) for us, c, key in rows if "shelf_bfd_warp_kernel" in key]
    need(shelf, "service solves ran no shelf kernel")
    shelf_ms = sum(us for us, _ in shelf) / sum(c for _, c in shelf) / 1e3
    return ("generic" if generic else "narrow"), fused_ms, shelf_ms


def _service_main_path(torch, TB, TF, svc, inputs, host_inputs):
    """Sub-phase 1: the bench problem through SolverService() on the card
    (the cuda rung: the request's own 100k x 300 x 3 operands uploaded,
    then solve(backend="cuda") on them, both kernels, one fetch), against
    a direct solve(backend="cuda")."""
    direct = TB.solve(inputs, buckets=BUCKETS, backend="cuda")
    torch.cuda.synchronize()
    TF.reset_launch_counts()
    out = svc.solve(host_inputs, buckets=BUCKETS)
    launches = dict(TF.LAUNCHES)
    need(launches == {"fused_assign": 1, "shelf_bfd": 1, "demand_reduce": 0,
                      "pack_bits": 1},
         f"service main path launches {launches}")
    n_lp = _service_outputs_equal(out, direct, inputs,
                                  "service main path vs direct cuda")
    nodes = int(np.asarray(out.nodes_needed).sum())
    need(nodes == MAIN_NODES, f"service main path nodes {nodes}")

    def service_call():
        svc.solve(host_inputs, buckets=BUCKETS)

    def direct_call():
        TB.solve(inputs, buckets=BUCKETS, backend="cuda")
        torch.cuda.synchronize()

    TF.reset_launch_counts()
    s50, s95 = host_ms(torch, service_call, ITERS)
    # every request uploads and packs its operands
    need(TF.LAUNCHES == {"fused_assign": ITERS + 1, "shelf_bfd": ITERS + 1,
                         "demand_reduce": 0, "pack_bits": ITERS + 1},
         f"{ITERS + 1} service solves launched {TF.LAUNCHES}")
    d50, d95 = host_ms(torch, direct_call, ITERS)
    report(f"service main path: SolverService().solve == direct "
           f"solve(backend='cuda') on all five outputs (lp_bound mismatches "
           f"{n_lp}, nodes {nodes}); launches per request {launches}")
    report(f"service main path p50={s50}ms p95={s95}ms vs direct solve "
           f"p50={d50}ms p95={d95}ms (host clock, {ITERS} calls each)")
    stages = svc.stage_percentiles()
    report("service stage percentiles (ms): " + "; ".join(
        f"{k} p50={v['p50_ms']} p99={v['p99_ms']} n={v['n']}"
        for k, v in sorted(stages.items())))
    prof, _ = profile_window(torch, service_call, 5)
    rows = device_rows(torch, prof)
    need(rows, "profiler: no device rows in the service solves")
    instance, fused_ms, shelf_ms = _fused_instance_ms(rows, 5)
    need(instance == "narrow",
         "the service's unpadded R = 3 request missed the narrow instance")
    copies = _trace_copy_bytes(prof, "service_main_trace.json")
    h2d = "not measured" if copies is None else copies["HtoD"] / 5
    busy = sum(us for us, _, _ in rows) / 5
    report(f"service main path: fused instance {instance} + "
           f"demand_reduce_kernel {fused_ms} ms per launch; "
           f"shelf_bfd_warp_kernel {shelf_ms} ms per launch; device busy "
           f"{busy} us per request; host->device {h2d} bytes per repeated "
           f"request (profiler, 5 requests)")
    for dev_us, count, key in rows[:8]:
        report(f"  device {dev_us / 5} us/request  x{count / 5}/request  "
               f"{key[:90]}")
    return {"launches": launches, "fused_ms": fused_ms, "shelf_ms": shelf_ms,
            "instance": instance}


def _service_reconcile(torch, TB, TF, PC, workloads, svc, reconcile):
    """Sub-phase 2: phase 9's cluster, its pods restored to the first
    tick's, reconciled by solve_pending(..., solver=service.solve) as
    production wires it; each tick's statuses and gauges against the
    direct-solve path's on the same store state. Then the service's cost
    on the tick: pairs of churned ticks timed in turns, each tick on its
    own fresh churn, with no check between them."""
    cluster = reconcile["cluster"]
    t0 = time.perf_counter()
    _restore_pods(cluster.store, reconcile["initial_pods"])
    report(f"reconcile via service: phase 9's store restored to the first "
           f"tick's pods in {time.perf_counter() - t0} s (host)")
    in_service = {"s": 0.0}

    def service_solver(inputs, **kwargs):
        t = time.perf_counter()
        out = svc.solve(inputs, **kwargs)
        in_service["s"] += time.perf_counter() - t
        return out

    def same_as_direct(what):
        """Solve the tick's state again by the direct path; statuses and
        gauges must not move."""
        got = _status_and_gauges(PC, cluster)
        cluster.feed.encode_memo = None
        cluster.tick(TB.solve)
        need(_status_and_gauges(PC, cluster) == got,
             f"{what}: statuses or gauges != the direct-solve path's")

    cluster.feed.encode_memo = None
    TF.reset_launch_counts()
    errors = cluster.tick(service_solver)
    launches = dict(TF.LAUNCHES)
    need(all(e is None for e in errors.values()), f"errors {errors}")
    need(launches == {"fused_assign": 1, "shelf_bfd": 1, "demand_reduce": 0,
                      "pack_bits": 1},
         f"first service tick launches {launches}")
    totals = _totals(cluster.producers)
    need(totals == RECONCILE_TOTALS,
         f"service first tick totals {totals} != {RECONCILE_TOTALS}")
    same_as_direct("first service tick")
    for _ in range(ITERS):
        workloads.churn_reconcile(cluster, RECONCILE_CHURN)()
        TF.reset_launch_counts()
        errors = cluster.tick(service_solver)
        need(all(e is None for e in errors.values()), f"errors {errors}")
        need(TF.LAUNCHES == {"fused_assign": 1, "shelf_bfd": 1,
                             "demand_reduce": 0, "pack_bits": 1},
             f"churned service tick launched {TF.LAUNCHES}")
        same_as_direct("churned service tick")
    report(f"reconcile via service: first tick totals {totals} (the "
           f"reference's), statuses and gauges == the direct path's on it "
           f"and on {ITERS} churned ticks ({RECONCILE_CHURN} pods each), "
           f"each kernel launched once per tick")

    # in turns: S D D S S D ..., every tick after its own churn, so both
    # arms meet the same kind of state (a delta encode of 1,000 replaced
    # pods) and drift in the host's speed falls on both alike
    arms = {"service": service_solver, "direct": TB.solve}
    ticks = {"service": [], "direct": []}
    churned = {"service": [], "direct": []}
    shares = []
    for i in range(2 * SERVICE_PAIRS):
        arm = ("service", "direct")[(i + i // 2) % 2]
        apply = workloads.churn_reconcile(cluster, RECONCILE_CHURN)
        in_service["s"] = 0.0
        t0 = time.perf_counter()
        apply()
        t1 = time.perf_counter()
        errors = cluster.tick(arms[arm])
        t2 = time.perf_counter()
        need(all(e is None for e in errors.values()), f"errors {errors}")
        ticks[arm].append((t2 - t1) * 1e3)
        churned[arm].append((t2 - t0) * 1e3)
        if arm == "service":
            shares.append(in_service["s"] / (t2 - t0))
    diffs = [s - d for s, d in zip(ticks["service"], ticks["direct"])]

    def spread(xs):
        return (f"median {float(np.median(xs))} [min {min(xs)}, max "
                f"{max(xs)}]")

    report(f"reconcile via service vs direct, {SERVICE_PAIRS} pairs in turns "
           f"(host clock, ms): tick after the store mutation: service "
           f"{spread(ticks['service'])}, direct {spread(ticks['direct'])}; "
           f"service - direct per pair {spread(diffs)}")
    report(f"reconcile via service: churned tick (mutation + tick) "
           f"p50={np.percentile(churned['service'], 50)}ms "
           f"p95={np.percentile(churned['service'], 95)}ms vs direct "
           f"p50={np.percentile(churned['direct'], 50)}ms "
           f"p95={np.percentile(churned['direct'], 95)}ms; service.solve "
           f"{100.0 * float(np.median(shares))}% of the churned tick "
           f"(median)")
    return cluster


def _service_coalescing(torch, TB, S, GaugeRegistry, cluster):
    """Sub-phase 3: 8 threads submit reconcile-size problems in one
    window, on the cuda rung and on the torch rung."""
    import dataclasses
    import threading

    base = cluster.feed.encode_memo[1]
    rng = np.random.default_rng(10)
    rows = base.pod_requests.shape[0]
    problems = [
        dataclasses.replace(base, pod_weight=(
            np.asarray(base.pod_weight) * rng.integers(1, 4, rows)
        ).astype(np.int32))
        for _ in range(8)
    ]
    wants = [TB.solve(p, buckets=BUCKETS, backend="cuda") for p in problems]
    for rung in ("cuda", "torch"):
        csvc = S.SolverService(registry=GaugeRegistry(), backend=rung,
                               window_s=0.05, adaptive_window=False)
        try:
            csvc.solve(problems[0], buckets=BUCKETS)
            results = [None] * 8
            barrier = threading.Barrier(8)

            def submit(i):
                barrier.wait(10.0)
                results[i] = csvc.solve(problems[i], buckets=BUCKETS)

            before = (csvc.stats.requests, csvc.stats.dispatches)
            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
                need(not t.is_alive(), "a coalescing submitter hung")
            for i, (got, want) in enumerate(zip(results, wants)):
                _service_outputs_equal(got, want, None,
                                       f"coalesced {rung} request {i}")
            requests = csvc.stats.requests - before[0]
            dispatches = csvc.stats.dispatches - before[1]
            need(csvc.stats.fallbacks == 0
                 and csvc.stats.device_failures == 0, f"{rung}: fallbacks")
            report(f"coalescing ({rung} rung), 8 threads x "
                   f"{tuple(base.pod_requests.shape)} x "
                   f"{tuple(base.group_allocatable.shape)}: requests "
                   f"{requests}, dispatches {dispatches}, coalesce_factor "
                   f"{csvc.stats.last_coalesce_factor}, coalesced batches "
                   f"{csvc.stats.coalesced_batches}, pipeline splits "
                   f"{csvc.stats.pipeline_splits}, overlaps "
                   f"{csvc.stats.pipeline_overlaps}; every answer == its "
                   f"direct solve(backend='cuda')")
        finally:
            csvc.close()


def _service_torch_rung(torch, S, GaugeRegistry, workloads, cluster, svc):
    """Sub-phase 4: the torch rung on the card, with the device-resident
    state and without it, over 5 churned ticks through the feed; both
    equal the cuda rung; host->device bytes per tick."""
    rsvc = S.SolverService(registry=GaugeRegistry(), backend="torch")
    csvc = S.SolverService(registry=GaugeRegistry(), backend="torch",
                           resident=False)
    fields = ("assigned", "assigned_count", "nodes_needed", "lp_bound",
              "unschedulable")
    try:
        workloads.churn_reconcile(cluster, RECONCILE_CHURN)()
        cluster.tick(rsvc.solve)  # establishes residency (a rebuild)
        need(rsvc.stats.resident_rebuilds == 1, "no resident rebuild")
        res_bytes, cold_bytes, changed = [], [], []
        for _ in range(5):
            workloads.churn_reconcile(cluster, RECONCILE_CHURN)()
            b0 = rsvc.stats.upload_bytes
            cluster.tick(rsvc.solve)
            res_bytes.append(rsvc.stats.upload_bytes - b0)
            changed.append(rsvc._resident.last_scatter_rows)
            need(res_bytes[-1] == rsvc._resident.last_scatter_bytes,
                 "the resident arm copied more than its scatter")
            inputs = cluster.feed.encode_memo[1]
            resident = rsvc.solve(inputs, buckets=BUCKETS)  # identity hit
            b0 = csvc.stats.upload_bytes
            cold = csvc.solve(inputs, buckets=BUCKETS)
            cold_bytes.append(csvc.stats.upload_bytes - b0)
            card = svc.solve(inputs, buckets=BUCKETS)
            for field in fields:
                a = np.asarray(getattr(resident, field))
                need(np.array_equal(a, np.asarray(getattr(cold, field))),
                     f"torch rung resident vs not: {field} differs")
                need(np.array_equal(a, np.asarray(getattr(card, field))),
                     f"torch rung vs cuda rung: {field} differs")
        need(rsvc.stats.resident_scatters == 5,
             f"{rsvc.stats.resident_scatters} scatters in 5 churned ticks")
        for arm in (rsvc, csvc):
            need(arm.stats.fallbacks == 0 and arm.stats.device_failures == 0,
                 "the torch rung fell back to numpy")
        need(max(res_bytes) * 10 < min(cold_bytes),
             f"resident arm bytes {res_bytes} vs full upload {cold_bytes}")
        entry = next(iter(rsvc._resident._entries.values()))
        n_rows = int(inputs.pod_requests.shape[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = S.run_batched(entry.stacked, BUCKETS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        need(np.array_equal(out.assigned[0].cpu().numpy()[:n_rows],
                            np.asarray(card.assigned)),
             "run_batched under sync debug mode differs")
        report(f"torch rung on the card, 5 churned ticks: resident == not "
               f"resident == cuda rung on all five outputs; host->device "
               f"bytes per tick resident {res_bytes} (scatters of "
               f"{changed} changed rows) vs full upload {cold_bytes}; the "
               f"batched program ran under set_sync_debug_mode('error')")
    finally:
        rsvc.close()
        csvc.close()


def _service_numpy_and_ladder(torch, TB, TF, S, GaugeRegistry, inputs,
                              host_inputs):
    """Sub-phase 5: the numpy rung with its C helper at the main path, and
    the FSM under a solver.dispatch error plan: each failure raises to
    the caller (never a numpy answer on the card), the FSM trips and
    short-circuits with SolverDeviceError, and the probe heals it."""
    from karpenter_tpu_torch import faults, native

    lib = native.load_kbinpack()
    need(lib is not None, "the numpy rung's C helper did not build or load")
    print(f"numpy rung C helper loaded: {lib._name}")
    direct = TB.solve(inputs, buckets=BUCKETS, backend="cuda")
    out = TB.solve(host_inputs, buckets=BUCKETS, backend="numpy")
    n_lp = _service_outputs_equal(out, direct, inputs, "numpy rung vs cuda")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        TB.solve(host_inputs, buckets=BUCKETS, backend="numpy")
        times.append((time.perf_counter() - t0) * 1e3)
    report(f"numpy rung (C helper) at {MAIN_SHAPE}: == cuda rung (lp_bound "
           f"mismatches {n_lp}); p50={np.percentile(times, 50)}ms (host "
           f"clock, 5 solves)")
    now = [1000.0]
    fsvc = S.SolverService(registry=GaugeRegistry(), clock=lambda: now[0],
                           health_failure_threshold=3,
                           health_probe_interval_s=30.0)
    raised = []
    try:
        with faults.injected_faults(seed=5) as reg:
            reg.plan("solver.dispatch", mode="error")
            for i in range(4):
                try:
                    fsvc.solve(host_inputs, buckets=BUCKETS)
                except (faults.FaultInjected, S.SolverDeviceError) as exc:
                    raised.append(type(exc).__name__)
                else:
                    need(False, f"request {i} under the error plan answered")
            need(raised == ["FaultInjected"] * 3 + ["SolverDeviceError"],
                 f"under the error plan the requests raised {raised}")
            need(fsvc.backend_health() == "degraded", "the FSM did not trip")
            need(fsvc.stats.fsm_short_circuits == 1, "no short circuit")
            need(fsvc.stats.fallbacks == 0, "a numpy answer on the card")
        now[0] += 31.0
        TF.reset_launch_counts()
        got = fsvc.solve(host_inputs, buckets=BUCKETS)
        need(fsvc.backend_health() == "healthy", "the probe did not heal")
        need(TF.LAUNCHES == {"fused_assign": 1, "shelf_bfd": 1,
                             "demand_reduce": 0, "pack_bits": 1},
             f"the probe launched {TF.LAUNCHES}")
        _service_outputs_equal(got, direct, inputs, "probe answer")
        need(fsvc.stats.fallbacks == 0, "a numpy answer on the card")
        print(f"ladder: solver.dispatch error plan -> the requests raised "
              f"{raised} ({fsvc.stats.device_failures} device failures, FSM "
              f"degraded after {fsvc.health_failure_threshold}, "
              f"{fsvc.stats.fsm_short_circuits} short-circuited, "
              f"{fsvc.stats.fallbacks} numpy answers); plan cleared, probe "
              f"clock +31 s -> healthy ({fsvc.stats.fsm_recoveries} "
              f"recovery), the probe ran both kernels and == the direct "
              f"solve")
    finally:
        fsvc.close()


def phase_service(torch, TB, TF, workloads, inputs, host_inputs, reconcile):
    """Phase 10: the shared solve service on the card."""
    from karpenter_tpu_torch.metrics.producers import pendingcapacity as PC
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import service as S

    svc = S.SolverService(registry=GaugeRegistry())
    try:
        need(svc.device.type == "cuda", f"default service on {svc.device}")
        main = _service_main_path(torch, TB, TF, svc, inputs, host_inputs)
        cluster = _service_reconcile(torch, TB, TF, PC, workloads, svc,
                                     reconcile)
        _service_coalescing(torch, TB, S, GaugeRegistry, cluster)
        _service_torch_rung(torch, S, GaugeRegistry, workloads, cluster, svc)
        _service_numpy_and_ladder(torch, TB, TF, S, GaugeRegistry, inputs,
                                  host_inputs)
        svc.publish_gauges()
        fallback = svc.registry.gauge("solver", "fallback_total").get("-", "-")
        need(svc.stats.fallbacks == 0 and not fallback,
             f"service fallbacks {svc.stats.fallbacks} / {fallback}")
        need(svc.backend_health() == "healthy", "service not healthy")
        need(svc.stats.device_failures == 0, "service device failures")
        st = svc.stats
        need(svc._shard_mesh() is None
             and (st.shard_requests, st.shard_dispatches,
                  st.shard_fallbacks) == (0, 0, 0),
             f"one card took the shard route: {st}")
        need(svc._g_shard.get("-", "-") == 0.0,
             "the shard gauge is not 0 on one card")
        print(f"service: {svc.stats.requests} requests, "
              f"{svc.stats.dispatches} dispatches, fallback_total 0, health "
              f"{svc.backend_health()}, the shard route idle (one card)")
        return main
    finally:
        svc.close()


# -- phase 11: the HorizontalAutoscaler reconcile tick through the service ----

# BASELINE.json's 1000 tenants x 4 autoscalers (pad_to: 4,032 rows), 3
# metrics; about half the HAs forecast one metric (S = 2,031, bucket
# 2,048) over 64 observed samples; an SLO on about 60%; 64 pool groups x
# 4 pools; --fused-tick. The queue series are spread over 125 gauge
# vectors (32 HAs each), a layout no source has: the reference registers
# one `karpenter_queue_length` vector. (a) also runs one tick at the
# reference's layout and holds it to the spread layout's decisions.
HA_SHAPE = dict(n_has=4000, metrics=3, seed=0, forecast_share=0.5,
                slo_share=0.6, groups=64, pools=4, history=64,
                queue_vectors=125)
HA_WARMUP = 2  # ticks before the first recorded one (the graph capture)
# cut from 12 and 20 to make room for phase 13 in the time limit
HA_PARITY_TICKS = 6  # ticks the card, its chained wire and the CPU share
HA_TIMED_TICKS = 10
HA_PAIRS = 10  # phase 8's batch through the service vs direct, in turns
# the small world of the failure-policy check (d)
HA_FAULT_SHAPE = dict(n_has=256, metrics=3, seed=1, groups=4, pools=4,
                      history=16)


class _Clock:
    """An injected clock for the service's health FSM."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class _Timers:
    """Host-clock seconds spent in named methods, summed per tick: each
    (object, method name, bucket) is wrapped on the instance."""

    def __init__(self, hooks):
        self.spent = {}
        self._undo = []
        for obj, name, bucket in hooks:
            self._wrap(obj, name, bucket)

    def _wrap(self, obj, name, bucket):
        inner = getattr(obj, name)
        # an attribute of the instance itself is restored, a method unwrapped
        self._undo.append((obj, name, vars(obj).get(name, _Timers)))

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                self.spent[bucket] = (
                    self.spent.get(bucket, 0.0) + time.perf_counter() - t0
                )

        setattr(obj, name, timed)

    def take(self) -> dict:
        spent, self.spent = self.spent, {}
        return spent

    def remove(self):
        for obj, name, before in reversed(self._undo):
            if before is _Timers:
                delattr(obj, name)
            else:
                setattr(obj, name, before)


def _ha_record(fleet):
    """(trail, statuses) of a fleet after a tick."""
    return fleet.trail(), fleet.statuses()


def _ha_run_parity(workloads, svc, fused, ticks):
    """The phase's world on `svc` for `ticks` ticks: [(trail, statuses,
    errors)] per tick and the registry exposition at the end."""
    fleet = workloads.build_ha_fleet(service=svc, fused=fused, **HA_SHAPE)
    out = []
    for _ in range(ticks):
        errors = fleet.tick()
        svc.note_tick()
        out.append((*_ha_record(fleet), _errors(errors)))
    return out, fleet.registry.expose_text()


def _errors(errors: dict) -> dict:
    return {k: None if e is None else (type(e).__name__, str(e))
            for k, e in errors.items()}


def _ha_concurrent_solves(svc, workloads, stop, result):
    """Bin-pack traffic on the service's worker while the main thread's
    first fused tick captures its graph: each answer must equal the
    first."""
    from karpenter_tpu_torch.ops import binpack as TB

    fields = workloads.build_inputs(2000, 50, 8, 8, seed=1)
    host = TB.BinPackInputs(**fields)
    want = None
    n = 0
    try:
        while not stop.is_set():
            got = svc.solve(host)
            if want is None:
                want = got
            for name in ("assigned", "assigned_count", "nodes_needed",
                         "unschedulable"):
                need(np.array_equal(getattr(got, name), getattr(want, name)),
                     f"concurrent solve {n}: {name} differs")
            n += 1
    except Exception as exc:  # noqa: BLE001 — reported by the phase
        result["error"] = exc
    result["solves"] = n


def _ha_production(torch, workloads, S, M, GaugeRegistry):
    """(a) The production tick at full width through SolverService()."""
    import threading

    svc = S.SolverService(registry=GaugeRegistry())
    try:
        need(svc.device.type == "cuda", f"default service on {svc.device}")
        t0 = time.perf_counter()
        fleet = workloads.build_ha_fleet(service=svc, fused=True, **HA_SHAPE)
        build_s = time.perf_counter() - t0
        rows = len(fleet.has)
        n_series = sum(1 for h in fleet.has if h.spec.behavior.forecast)
        print(f"HA world {HA_SHAPE}: built in {build_s} s; {rows} HAs, "
              f"{n_series} forecast series, "
              f"{sum(1 for h in fleet.has if h.spec.behavior.slo)} with an "
              f"SLO, {len(fleet.store.list('PoolGroup'))} pool groups")
        # the first tick captures the graph while the worker solves
        stop, solves = threading.Event(), {}
        worker = threading.Thread(
            target=_ha_concurrent_solves,
            args=(svc, workloads, stop, solves),
        )
        worker.start()
        try:
            while svc.stats.dispatches == 0 and worker.is_alive():
                time.sleep(0.01)
            records, errors_seen = [], []
            t0 = time.perf_counter()
            errors_seen.append(_errors(fleet.tick()))
            first_tick_s = time.perf_counter() - t0
        finally:
            stop.set()
            worker.join(120)
        need(not worker.is_alive(), "concurrent solves did not stop")
        need("error" not in solves, f"concurrent solve: {solves.get('error')!r}")
        need(solves.get("solves", 0) >= 1, "no concurrent solve ran")
        svc.note_tick()
        records.append(_ha_record(fleet))
        program = svc.fused_program()
        need(program.captures == 1, f"{program.captures} graph captures")
        report(f"first HA tick (graph capture, {solves['solves']} bin-pack "
               f"solves on the worker meanwhile, each equal): "
               f"{first_tick_s} s")
        for _ in range(HA_PARITY_TICKS - 1):
            errors_seen.append(_errors(fleet.tick()))
            svc.note_tick()
            records.append(_ha_record(fleet))
        text = fleet.registry.expose_text()
        need(all(e is None for errs in errors_seen for e in errs.values()),
             "an HA row errored")
        need(records[0][0] != records[-1][0], "the replica trail never moved")

        # timed ticks with the host split
        hooks = [
            (fleet.autoscaler, "_snapshot_row", "snapshot + metric queries"),
            (fleet.pool_engine, "plan", "plans + operands"),
            (fleet.forecaster, "fused_plan", "plans + operands"),
            (fleet.autoscaler, "_decision_inputs", "plans + operands"),
            (fleet.cost_engine, "fused_operands", "plans + operands"),
            (fleet.pool_engine, "fused_operands", "plans + operands"),
            (fleet.forecaster, "fused_commit", "commits"),
            (fleet.cost_engine, "fused_commit", "commits"),
            (fleet.pool_engine, "fused_commit", "commits"),
            (fleet.autoscaler, "_apply", "scale writes + conditions"),
            (fleet.controller, "reconcile_batch", "reconcile_batch"),
        ]
        ticks, splits = [], []
        last_inputs = {}
        inner_fn = fleet.autoscaler.fused_tick_fn

        def keep(inputs):
            last_inputs["tick"] = inputs
            return inner_fn(inputs)

        fleet.autoscaler.fused_tick_fn = keep
        timers = _Timers(hooks + [
            (fleet.autoscaler, "fused_tick_fn", "service.fused_tick"),
        ])
        # the interpreter's cyclic garbage collector, timed per tick
        gc_spent, gc_t0 = {"s": 0.0, "full": 0}, {}

        def on_gc(phase, info):
            if phase == "start":
                gc_t0["t"] = time.perf_counter()
            elif "t" in gc_t0:
                gc_spent["s"] += time.perf_counter() - gc_t0.pop("t")
                gc_spent["full"] += info.get("generation") == 2

        gc.callbacks.append(on_gc)
        gc_ticks = []
        try:
            for _ in range(HA_TIMED_TICKS):
                fleet.step_world()
                t0 = time.perf_counter()
                errors = fleet.reconcile()
                ticks.append((time.perf_counter() - t0) * 1e3)
                svc.note_tick()
                need(all(e is None for e in errors.values()), "a row errored")
                spent = timers.take()
                spent["status writes"] = ticks[-1] / 1e3 - spent.pop(
                    "reconcile_batch")
                splits.append(spent)
                gc_ticks.append((ticks[-1], gc_spent["s"] * 1e3,
                                 gc_spent["full"]))
                gc_spent["s"], gc_spent["full"] = 0.0, 0
        finally:
            gc.callbacks.remove(on_gc)
            timers.remove()
            fleet.autoscaler.fused_tick_fn = inner_fn
        p50, p95 = np.percentile(ticks, 50), np.percentile(ticks, 95)
        report(f"HA tick (fused, {rows} HAs): p50={p50}ms p95={p95}ms over "
               f"{HA_TIMED_TICKS} ticks (host clock; reconcile + HA status "
               f"writes, the world's step excluded)")
        total = {}
        for spent in splits:
            for k, v in spent.items():
                total.setdefault(k, []).append(v * 1e3)
        inside = sum(np.median(v) for k, v in total.items())
        for k, v in sorted(total.items(), key=lambda kv: -np.median(kv[1])):
            report(f"  host split, median ms per tick: {k} {np.median(v)} "
                   f"({100.0 * np.median(v) / p50}% of the tick p50)")
        report(f"  host split: the named spans sum to {inside} ms of the "
               f"{p50} ms p50 (the rest is the batch loop's own work)")
        stages = svc.stage_percentiles()
        for k in ("fused_upload", "fused_replay", "fused_fetch",
                  "fused_device"):
            report(f"  inside service.fused_tick, stage {k}: "
                   f"{stages.get(k)}")
        slow = sorted(gc_ticks, reverse=True)[:3]
        report(f"  garbage collector: median {np.median([g for _, g, _ in gc_ticks])}"
               f" ms per tick, {sum(f for _, _, f in gc_ticks)} full "
               f"collections in {HA_TIMED_TICKS} ticks; the 3 slowest ticks "
               f"(tick ms, gc ms, full collections): {slow}")
        report(f"  service stages: fused {stages.get('fused')}, door "
               f"(arrays + padding) {stages.get('fused_pad')}")

        # device view: kernels and busy us per tick, and the forecast's share
        prof, _ = profile_window(torch, fleet.tick, 3)
        rows = device_rows(torch, prof)
        need(rows, "profiler: no device rows for the HA tick")
        ops = sum(c for _, c, _ in rows) / 3
        kernels = sum(c for _, c, k in rows
                      if not k.startswith(("Memcpy", "Memset"))) / 3
        busy = sum(us for us, _, _ in rows) / 3
        for dev_us, count, key in rows[:8]:
            report(f"  HA tick device row: {dev_us / 3} us/tick "
                   f"x{count / 3}/tick {key[:80]}")
        staged = last_inputs.get("tick")
        need(staged is not None and staged.forecast is not None,
             "no forecast operands in the last tick")
        from karpenter_tpu_torch.solver.bucketing import bucket_up

        t = staged.forecast.values.shape[1]
        s = staged.forecast.values.shape[0]
        fin = M.pad_forecast_inputs(
            M.ForecastInputs.from_numpy(staged.forecast, "cuda"),
            bucket_up(t, 16))
        fin = M.concat_forecast_inputs([fin], bucket_up(s, 8))
        report(f"  forecast operands of the last tick: S = {s} series "
               f"(bucket {fin.values.shape[0]}) x T = {t}")
        fc = profile_per_call(torch, lambda: M.forecast(fin), n=3)
        report(f"profiler, HA tick: {kernels} kernels, {ops} device ops "
               f"(kernels + memcpy/memset), {busy} us device busy per "
               f"tick ({100.0 * busy / 1e3 / p50}% of the tick p50)")
        if fc is None or fc[1] < 1:
            # the profiler does not keep every row of a ctypes launch
            # (csrc/forecast.cu): the stage's one kernel by CUDA events
            us = 1e3 * queued_ms(torch, lambda: M.forecast(fin))
            fc = (1.0, 1.0, us)
            report("  the profiler lost rows of the forecast stage "
                   "alone; its busy us by CUDA events")
        report(f"  forecast stage alone on the tick's operands: "
               f"{fc[1]} kernels, {fc[2]} us busy = "
               f"{100.0 * fc[1] / kernels}% of the tick's kernels, "
               f"{100.0 * fc[2] / busy}% of its device busy time")
        ticks_run = fleet.ticks
        st = svc.stats
        need(st.fused_dispatches == ticks_run,
             f"fused_dispatches {st.fused_dispatches} != ticks {ticks_run}")
        need(st.fused_chained_serves == 0 and st.fused_mirror_serves == 0,
             f"chained {st.fused_chained_serves} / mirror "
             f"{st.fused_mirror_serves} serves")
        need(st.fallbacks == 0, f"{st.fallbacks} numpy fallbacks")
        need(st.last_dispatches_per_tick == 1,
             f"{st.last_dispatches_per_tick} dispatches in the last tick")
        need(program.captures == 1, f"{program.captures} graph captures")
        need(svc.backend_health() == "healthy", "FSM not healthy")
        print(f"HA tick on the card: {ticks_run} ticks, fused_dispatches "
              f"{st.fused_dispatches}, chained 0, mirror 0, fallbacks 0, "
              f"1 dispatch per tick, 1 graph capture for the shape class, "
              f"{program.replays} replays, FSM healthy")
        snapshot = np.median(total["snapshot + metric queries"])
        _ha_one_vector(workloads, svc, records[0][0], snapshot)
        return records, errors_seen, text
    finally:
        svc.close()


def _ha_one_vector(workloads, svc, first_trail, spread_snapshot_ms):
    """The first tick of (a)'s world at the reference's layout, one queue
    vector for every series, on the same service: the same shape class
    (no capture) and the same decisions; the snapshot's host time beside
    the spread layout's."""
    shape = dict(HA_SHAPE, queue_vectors=1)
    fleet = workloads.build_ha_fleet(service=svc, fused=True, **shape)
    queries = sum(len(h.spec.metrics) for h in fleet.has)
    series = sum(len(names) for _, names in fleet.gauge_of)
    captures = svc.fused_program().captures
    timers = _Timers([
        (fleet.autoscaler, "_snapshot_row", "snapshot + metric queries"),
    ])
    try:
        t0 = time.perf_counter()
        errors = fleet.tick()
        tick_ms = (time.perf_counter() - t0) * 1e3
        snapshot = timers.take()["snapshot + metric queries"] * 1e3
    finally:
        timers.remove()
    svc.note_tick()
    need(all(e is None for e in errors.values()), "one vector: a row errored")
    need(fleet.trail() == first_trail, "one vector: the trail differs")
    need(svc.fused_program().captures == captures, "one vector: recaptured")
    report(f"HA tick at one queue vector ({series} series, {queries} "
           f"queries): first tick {tick_ms} ms (step and status writes "
           f"included), snapshot + metric queries {snapshot} ms = "
           f"{snapshot / queries} ms per query; at {HA_SHAPE['queue_vectors']} "
           f"vectors the median snapshot is {spread_snapshot_ms} ms = "
           f"{spread_snapshot_ms / queries} ms per query; the same trail")


def _ha_cpu_child(workloads, out_dir: str) -> None:
    """(b)'s CPU service (numpy) over the phase's world, in a child beside
    (a): its records, exposition, seconds and family calls, pickled."""
    import pickle

    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import service as S

    svc = S.SolverService(registry=GaugeRegistry(), device="cpu",
                          backend="numpy")
    try:
        t0 = time.perf_counter()
        got, text = _ha_run_parity(workloads, svc, False, HA_PARITY_TICKS)
        st = svc.stats
        out = {"got": got, "text": text, "s": time.perf_counter() - t0,
               "stats": (st.forecast_calls, st.decide_calls, st.cost_calls,
                         st.poolgroup_calls, st.last_dispatches_per_tick)}
    finally:
        svc.close()
    with open(os.path.join(out_dir, "ha_cpu.pickle"), "wb") as f:
        pickle.dump(out, f)


def _ha_same(name, got, got_text, fused_run):
    records, errors, text = fused_run
    for k, (trail, statuses, errs) in enumerate(got):
        need(trail == records[k][0], f"{name}: trail differs, tick {k}")
        need(statuses == records[k][1], f"{name}: statuses differ, tick {k}")
        need(errs == errors[k], f"{name}: errors differ, tick {k}")
    need(got_text == text, f"{name}: registry exposition differs")


def _ha_parity_report(name, records, text, elapsed, stats):
    forecast, decide, cost, poolgroup, per_tick = stats
    report(f"HA parity, {name}: {HA_PARITY_TICKS} ticks equal to the "
           f"card's fused tick (trail of {len(records[0][0])} node "
           f"groups, statuses, error maps, {len(text)} bytes of "
           f"exposition); {elapsed} s; families: forecast {forecast}, "
           f"decide {decide}, cost {cost}, poolgroup {poolgroup}, "
           f"dispatches per tick {per_tick}")


def _ha_parity(workloads, S, GaugeRegistry, fused_run, twin):
    """(b) The card's chained wire, and a CPU service (numpy) over the same
    world in the child `twin`: the same trail, statuses, error maps and
    exposition as (a)."""
    import pickle

    records, _, text = fused_run
    name = "card, chained wire"
    svc = S.SolverService(registry=GaugeRegistry())
    try:
        t0 = time.perf_counter()
        got, got_text = _ha_run_parity(workloads, svc, False,
                                       HA_PARITY_TICKS)
        elapsed = time.perf_counter() - t0
        _ha_same(name, got, got_text, fused_run)
        st = svc.stats
        need(st.fallbacks == 0 and st.poolgroup_independent_serves == 0,
             f"{name}: numpy answered")
        need(st.forecast_dispatches == HA_PARITY_TICKS,
             f"{name}: {st.forecast_dispatches} forecast dispatches")
        need(st.last_dispatches_per_tick >= 2,
             f"{name}: {st.last_dispatches_per_tick} dispatches")
        _ha_parity_report(name, records, text, elapsed, (
            st.forecast_calls, st.decide_calls, st.cost_calls,
            st.poolgroup_calls, st.last_dispatches_per_tick))
    finally:
        svc.close()
    twin.join()
    with open(twin.path("ha_cpu.pickle"), "rb") as f:
        cpu = pickle.load(f)
    name = "CPU, numpy (a child process beside (a))"
    _ha_same(name, cpu["got"], cpu["text"], fused_run)
    _ha_parity_report(name, records, text, cpu["s"], cpu["stats"])


def _ha_fused_vs_direct(torch, workloads, S, FT, GaugeRegistry):
    """(c) Phase 8's batch through service.fused_tick == the direct
    FusedTickProgram replay, bitwise; the two timed in turns."""
    fields = workloads.build_fused_tick_inputs(0, **TICK_SHAPE)
    host = FT.FusedTickInputs.from_arrays(fields)
    card = FT.FusedTickInputs.from_numpy(fields, "cuda")
    direct = FT.FusedTickProgram()
    svc = S.SolverService(registry=GaugeRegistry())
    try:
        got = svc.fused_tick(host)
        want = direct(card).to_numpy()
        n_leaves = same_bits(got.to_numpy(), want,
                             "service.fused_tick vs direct replay")
        times = {"service": [], "direct": []}
        for k in range(2 * HA_PAIRS):
            arm = ("service", "direct", "direct", "service")[k % 4]
            t0 = time.perf_counter()
            if arm == "service":
                svc.fused_tick(host)
            else:
                direct(card)
                torch.cuda.synchronize()
            times[arm].append((time.perf_counter() - t0) * 1e3)
        need(svc.fused_program().captures == 1, "service recaptured")
        report(f"phase 8's batch {TICK_SHAPE}: service.fused_tick == direct "
               f"replay bitwise on {n_leaves} leaves; in turns, service "
               f"(host in, one fetch out) median "
               f"{np.median(times['service'])} ms, direct replay (card "
               f"operands, synchronize) median {np.median(times['direct'])} "
               f"ms over {HA_PAIRS} each")
    finally:
        svc.close()


def _ha_failure_policy(workloads, S, GaugeRegistry):
    """(d) On the card a fused-tick failure raises to the tick (every row
    reports it, no scale is written, numpy never answers); the FSM
    degrades to SolverDeviceError and the probe heals it."""
    from karpenter_tpu_torch import faults

    clock = _Clock()
    svc = S.SolverService(registry=GaugeRegistry(), clock=clock,
                          health_failure_threshold=2,
                          health_probe_interval_s=30.0)
    try:
        fleet = workloads.build_ha_fleet(service=svc, fused=True,
                                         **HA_FAULT_SHAPE)
        fleet.tick()
        before = fleet.trail()
        seen = []
        with faults.injected_faults(seed=11) as reg:
            reg.plan("fused.tick", mode="error")
            for _ in range(3):
                fleet.step_world()
                errors = fleet.reconcile()
                kinds = {type(e).__name__ for e in errors.values()}
                need(len(kinds) == 1 and None not in errors.values(),
                     f"not every row errored: {kinds}")
                seen.append(kinds.pop())
                need(fleet.trail() == before, "a scale was written")
            attempts = reg.attempts["fused.tick"]
        need(seen == ["FaultInjected", "FaultInjected", "SolverDeviceError"],
             f"errors per tick {seen}")
        need(attempts == 2, f"{attempts} device attempts while degraded")
        need(svc.backend_health() == "degraded", "FSM not degraded")
        st = svc.stats
        need(st.fallbacks == st.fused_chained_serves == st.fused_mirror_serves
             == 0, "numpy or chained answered on the card")
        clock.now += 31.0
        errors = fleet.tick()
        need(all(e is None for e in errors.values()), "probe tick errored")
        need(svc.backend_health() == "healthy", "the probe did not heal")
        print(f"HA failure policy: under a fused.tick error plan 3 ticks "
              f"reported {seen} for every row, no scale written, no numpy or "
              f"chained answer; the probe healed the FSM "
              f"(trips {st.fsm_trips}, recoveries {st.fsm_recoveries})")
    finally:
        svc.close()


def phase_ha_tick(torch, FT, M, workloads):
    """Phase 11: the HorizontalAutoscaler reconcile tick through the
    service on the card; (b)'s CPU service runs in a child beside it."""
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import service as S

    twin = _Child("_ha_cpu_child")
    try:
        fused_run = _ha_production(torch, workloads, S, M, GaugeRegistry)
        _ha_parity(workloads, S, GaugeRegistry, fused_run, twin)
    finally:
        twin.close()
    _ha_fused_vs_direct(torch, workloads, S, FT, GaugeRegistry)
    _ha_failure_policy(workloads, S, GaugeRegistry)


# -- phase 12: the disruption path (runtime.py:409-501) -----------------------

# bench.py:3834's fragmented cluster at phase 9's node scale (2,000 nodes of
# 16 CPU, 30,000 bound pods on the u**2 spread) with bench.py:4069's
# priorities and 64 pending critical pods; the engines and node groups at
# their defaults (max_candidates 64, max_victims 4,096, an eviction budget
# of 1 per group, which defers every plan that needs more)
DISRUPTION_SHAPE = dict(nodes=2000, pods=30000, pending_critical=64, seed=0)
# rounds of 60 s: the cooldown (300 s) passes at round 6, the verify soak
# (60 s) at round 7, and the drains finish in rounds 7-8
DISRUPTION_ROUNDS = 9
# (c): bench.py:4069's eviction fleet at the program's victim ceiling
PREEMPT_SEAM = dict(candidates=64, nodes=2000, victims=16384, seed=0)
# (d): a smaller world for the failure policy
DISRUPTION_FAULT_SHAPE = dict(nodes=200, pods=3000, pending_critical=8,
                              seed=1)


def _disruption_rounds(world, svc, TF, rounds, timers, snaps):
    """Run `rounds` rounds of `world`: per round (host ms, errors, host
    split, engine gauges, service stats), and the world's snapshot after
    it (in `snaps`, outside the timed region); per consolidation plan
    (round, launches of each kernel, candidates solved, candidates
    evaluated)."""
    from karpenter_tpu_torch.consolidation import engine as CE
    from karpenter_tpu_torch.preemption import engine as PE

    plans = []
    inner = world.consolidation.plan

    def plan(now=None):
        before = dict(TF.LAUNCHES)
        c0 = svc.stats.consolidate_candidates
        out = inner(now)
        plans.append((world.rounds, {
            k: TF.LAUNCHES[k] - before.get(k, 0) for k in TF.LAUNCHES
        }, svc.stats.consolidate_candidates - c0, len(out)))
        return out

    world.consolidation.plan = plan
    gauge = world.registry.gauge
    out = []
    try:
        for _ in range(rounds):
            t0 = time.perf_counter()
            errors = world.round()
            ms = (time.perf_counter() - t0) * 1e3
            split = timers.take()
            out.append({
                "ms": ms,
                "errors": _errors(errors),
                "split": split,
                "preempt_eval_ms": gauge(PE.SUBSYSTEM, PE.BATCH_EVAL_MS).get(
                    "-", "-"),
                "consolidate_eval_ms": gauge(
                    CE.SUBSYSTEM, CE.BATCH_EVAL_MS).get("-", "-"),
                "candidates": gauge(CE.SUBSYSTEM, CE.BATCH_CANDIDATES).get(
                    "-", "-"),
                "planned": gauge(CE.SUBSYSTEM, CE.DRAINS_PLANNED).get("-", "-"),
                "vetoed": gauge(CE.SUBSYSTEM, CE.DRAINS_VETOED).get("-", "-"),
                "actuated": gauge(CE.SUBSYSTEM, CE.DRAINS_ACTUATED).get(
                    "-", "-"),
                "preempt_plans": gauge(PE.SUBSYSTEM, PE.PLANS).get("-", "-"),
                "deferred": gauge(PE.SUBSYSTEM, PE.DEFERRED).get("-", "-"),
                "evictions": gauge(PE.SUBSYSTEM, PE.EVICTIONS).get("-", "-"),
                "unplaceable": gauge(PE.SUBSYSTEM, PE.UNPLACEABLE).get(
                    "-", "-"),
                "dispatches": svc.stats.dispatches,
                "in_flight": dict(world.consolidation.in_flight()),
            })
            snaps.append(world.snapshot())
    finally:
        world.consolidation.plan = inner
    return out, plans


def _disruption_timers(world, svc):
    """Host-split hooks for a disruption round: the two engines' cluster
    views, operand builds, service calls and actuation, and the
    controller's provider writes."""
    from karpenter_tpu_torch.consolidation import planner as CP
    from karpenter_tpu_torch.preemption import engine as PE
    from karpenter_tpu_torch.preemption import planner as PP

    return _Timers([
        (CP, "cluster_view", "cluster views"),
        (PE, "cluster_view", "cluster views"),
        (CP, "build_problems", "consolidation operands"),
        (PP, "build_problem", "preemption operands"),
        (svc, "consolidate", "service.consolidate"),
        (svc, "preempt", "service.preempt"),
        (world.preemption, "_resolve_and_actuate", "evictions + holds"),
        (world.consolidation, "_advance_cordoned", "cordon/verify/actuate"),
        (world.consolidation, "_cordon_drainable", "cordon/verify/actuate"),
        (world.controller, "_set_replicas", "provider writes + finalize"),
        (world.controller, "_finish_scale_down", "provider writes + finalize"),
    ])


def _plan_profile(torch, TF, CP, world, svc, verdicts):
    """Device view of one consolidation plan: the largest plan's
    candidates (those still in the store) rebuilt as operands and
    answered by svc.consolidate under a profiler window of 3 plans:
    device kernels, each CUDA kernel's launches and the fused instance,
    device us per launch, busy us per plan."""
    view = CP.cluster_view(world.store)
    live = view.by_name()
    names = [n for n in verdicts if n in live]
    solved, inputs, _ = CP.build_problems(view, names)
    need(inputs, "no candidate with pods to profile")
    t = inputs[0].group_allocatable.shape[0]
    pods = [x.pod_requests.shape[0] for x in inputs]
    n = 3
    TF.reset_launch_counts()
    prof, _ = profile_window(torch, lambda: svc.consolidate(inputs), n,
                             warmup=1)
    launches = {k: v / (n + 1) for k, v in TF.LAUNCHES.items()}
    need(launches == {"fused_assign": len(inputs), "shelf_bfd": len(inputs),
                      "demand_reduce": 0, "pack_bits": len(inputs)},
         f"a plan of {len(inputs)} candidates launched {launches}")
    rows = device_rows(torch, prof)
    need(rows, "profiler: no device rows for the consolidation plans")
    instances = sorted({key[key.index("assign_kernel<"):].split(">")[0] + ">"
                        for _, _, key in rows if "assign_kernel<" in key})
    fused_rows = [(us, c) for us, c, key in rows
                  if any(k in key for k in KERNEL_NAMES["fused_assign"])]
    shelf_rows = [(us, c) for us, c, key in rows
                  if any(k in key for k in KERNEL_NAMES["shelf_bfd"])]
    need(fused_rows and shelf_rows, "profiler: a kernel of the plan is missing")
    assign = [(us, c) for us, c, key in rows if "assign_kernel<" in key]
    fused_ms = sum(us for us, _ in fused_rows) / sum(c for _, c in assign) / 1e3
    shelf_ms = (sum(us for us, _ in shelf_rows)
                / sum(c for _, c in shelf_rows) / 1e3)
    kernels = sum(c for _, c, k in rows
                  if not k.startswith(("Memcpy", "Memset"))) / n
    busy = sum(us for us, _, _ in rows) / n
    report(f"consolidation plan on the card (profiler, {n} plans of "
           f"{len(inputs)} candidates with pods, T = {t} node columns, "
           f"P = {min(pods)}-{max(pods)} pods, the forbidden operand): "
           f"{kernels} device kernels and {busy} us busy per plan; launches "
           f"per plan {launches}; fused instance {instances}; fused "
           f"{fused_ms} ms per launch (assign + demand_reduce), shelf "
           f"{shelf_ms} ms per launch")
    for dev_us, count, key in rows[:8]:
        report(f"  plan device row: {dev_us / n} us/plan x{count / n}/plan "
               f"{key[:80]}")
    return {"launches_per_plan": launches, "fused_ms": fused_ms,
            "shelf_ms": shelf_ms, "instances": instances,
            "candidates": len(inputs), "t": t, "batch": inputs}


def _disruption_production(torch, TF, workloads, S, GaugeRegistry):
    """(a) The production rounds through SolverService() on the card."""
    from karpenter_tpu_torch.consolidation import planner as CP

    svc = S.SolverService(registry=GaugeRegistry())
    try:
        need(svc.device.type == "cuda", f"default service on {svc.device}")
        t0 = time.perf_counter()
        world = workloads.build_disruption_world(service=svc,
                                                 **DISRUPTION_SHAPE)
        report(f"disruption world {DISRUPTION_SHAPE}: built in "
               f"{time.perf_counter() - t0} s; "
               f"{len(world.store.keys('ScalableNodeGroup'))} node groups "
               f"(the last preemptible), engine defaults max_candidates "
               f"{world.consolidation.config.max_candidates}, max_victims "
               f"{world.preemption.config.max_victims}")
        timers = _disruption_timers(world, svc)
        snaps = []
        torch.cuda.synchronize()
        TF.reset_launch_counts()
        try:
            rounds, plans = _disruption_rounds(
                world, svc, TF, DISRUPTION_ROUNDS, timers, snaps)
        finally:
            timers.remove()
        launches = dict(TF.LAUNCHES)
        need(all(launches[name] > 0 for name in SINGLE_KERNELS),
             f"the disruption rounds launched {launches}")
        for r, row in enumerate(rounds, 1):
            need(all(e is None for e in row["errors"].values()),
                 f"round {r} errored: {row['errors']}")
            report(f"disruption round {r}: {row['ms']} ms (host clock, "
                   f"snapshot excluded); consolidate eval "
                   f"{row['consolidate_eval_ms']} ms, candidates "
                   f"{row['candidates']}, drains planned / vetoed / actuated "
                   f"{row['planned']} / {row['vetoed']} / {row['actuated']}, "
                   f"in flight {row['in_flight']}; preempt eval "
                   f"{row['preempt_eval_ms']} ms, plans / deferred / "
                   f"evictions {row['preempt_plans']} / {row['deferred']} / "
                   f"{row['evictions']} (totals), unplaceable "
                   f"{row['unplaceable']}; "
                   f"service dispatches {row['dispatches']}")
        for r, per_kernel, solved, evaluated in plans:
            need(per_kernel["fused_assign"] == per_kernel["shelf_bfd"]
                 == solved,
                 f"round {r}: {solved} candidates with pods launched "
                 f"{per_kernel}")
            if evaluated:
                print(f"  consolidation plan, round {r}: {evaluated} "
                      f"candidates evaluated, {solved} solved on the card, "
                      f"launches {per_kernel}")
        last = rounds[-1]
        need(last["actuated"] and last["actuated"] > 0,
             "no drain was actuated and finished")
        need(last["evictions"] and last["evictions"] > 0, "nothing evicted")
        final = snaps[-1]
        need(sum(r for _, r in final["provider"])
             == DISRUPTION_SHAPE["nodes"] - int(last["actuated"]),
             f"provider replicas {final['provider']} after "
             f"{last['actuated']} drains")
        need(len(final["nodes"])
             == DISRUPTION_SHAPE["nodes"] - int(last["actuated"]),
             "the drained nodes are still in the store")
        for label, key in (("preempt", "preempt_eval_ms"),
                           ("consolidate", "consolidate_eval_ms")):
            vals = [row[key] for row in rounds if row[key] is not None]
            report(f"{label} eval (the engine's gauge, host clock): p50="
                   f"{np.percentile(vals, 50)} ms p95="
                   f"{np.percentile(vals, 95)} ms over {len(vals)} rounds")
        ms = [row["ms"] for row in rounds]
        report(f"disruption round: p50={np.percentile(ms, 50)} ms "
               f"p95={np.percentile(ms, 95)} ms over {len(ms)} rounds")
        total = {}
        for row in rounds:
            for k, v in row["split"].items():
                total.setdefault(k, []).append(v * 1e3)
        for k, v in sorted(total.items(), key=lambda kv: -sum(kv[1])):
            report(f"  host split, ms per round (median / max): {k} "
                   f"{np.median(v)} / {max(v)} ({100.0 * sum(v) / sum(ms)}% "
                   f"of all rounds)")
        stages = svc.stage_percentiles()
        report("  service stages (ms): " + "; ".join(
            f"{k} p50={v['p50_ms']} p99={v['p99_ms']} n={v['n']}"
            for k, v in sorted(stages.items())))
        st = svc.stats
        need(st.fallbacks == 0, f"{st.fallbacks} numpy answers on the card")
        need(st.preempt_dispatches == DISRUPTION_ROUNDS,
             f"{st.preempt_dispatches} preempt dispatches in "
             f"{DISRUPTION_ROUNDS} rounds")
        need(svc.backend_health() == "healthy", "FSM not healthy")
        biggest = max((v for _, v in world.verdicts), key=len)
        profile = _plan_profile(torch, TF, CP, world, svc, biggest)
        print(f"disruption on the card: {DISRUPTION_ROUNDS} rounds, "
              f"{st.consolidate_calls} consolidate calls "
              f"({st.consolidate_candidates} candidates), "
              f"{st.preempt_dispatches} preempt dispatches, launches "
              f"{launches}, fallbacks 0, FSM healthy")
        return {"snaps": snaps, "errors": [row["errors"] for row in rounds],
                "verdicts": world.verdicts, "plans": world.plans,
                "launches": launches, "profile": profile}
    finally:
        svc.close()


def _disruption_cpu_rounds(workloads) -> dict:
    """(b)'s world: the same world and rounds on a CPU numpy service;
    each round's error map and snapshot, the verdicts and plans."""
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import service as S

    svc = S.SolverService(registry=GaugeRegistry(), device="cpu",
                          backend="numpy")
    try:
        world = workloads.build_disruption_world(service=svc,
                                                 **DISRUPTION_SHAPE)
        t0 = time.perf_counter()
        errors, snaps = [], []
        for _ in range(DISRUPTION_ROUNDS):
            errors.append(_errors(world.round()))
            snaps.append(world.snapshot())
        return {"errors": errors, "snaps": snaps, "verdicts": world.verdicts,
                "plans": world.plans, "s": time.perf_counter() - t0}
    finally:
        svc.close()


def _disruption_cpu_child(workloads, out_dir: str) -> None:
    """(b)'s world in a child, beside (a): its rounds, pickled."""
    import pickle

    with open(os.path.join(out_dir, "disruption_cpu.pickle"), "wb") as f:
        pickle.dump(_disruption_cpu_rounds(workloads), f)


def _disruption_parity(cpu, card):
    """(b) The CPU numpy service's rounds equal the card's: verdicts,
    plans, evictions, cordons, deleted nodes and pods, node groups,
    provider replicas, engine tables and exposition."""
    for r in range(DISRUPTION_ROUNDS):
        need(cpu["errors"][r] == card["errors"][r],
             f"round {r + 1}: error maps")
        for key, value in cpu["snaps"][r].items():
            need(value == card["snaps"][r][key],
                 f"round {r + 1}: {key} differs from the card's")
    need(cpu["verdicts"] == card["verdicts"], "consolidation verdicts")
    need(cpu["plans"] == card["plans"], "preemption plans")
    evictions = sum(len(p["evictions"]) for _, plans in cpu["plans"]
                    for p in plans.values() if p)
    print(f"disruption parity: the CPU numpy service equals the card on "
          f"{DISRUPTION_ROUNDS} rounds ({len(cpu['verdicts'])} "
          f"consolidation plans, {len(cpu['plans'])} preemption plans, "
          f"{evictions} evictions, every store object, node group, "
          f"provider replica, engine table and "
          f"{len(cpu['snaps'][-1]['exposition'])} bytes of exposition) in "
          f"{cpu['s']} s, in a child process beside the card's rounds")


def _preempt_seam(torch, workloads, S, GaugeRegistry):
    """(c) The preempt seam at the victim ceiling: service.preempt on the
    card == preempt_numpy on every output; its p50 and device view."""
    from karpenter_tpu_torch.ops import preempt as P

    inputs = workloads.build_preempt_inputs(**PREEMPT_SEAM)
    svc = S.SolverService(registry=GaugeRegistry())
    try:
        got = svc.preempt(inputs)
        want = P.preempt_numpy(inputs)
        for field in ("chosen_node", "evict_count", "evict_mask",
                      "unplaceable"):
            a, b = np.asarray(getattr(got, field)), np.asarray(
                getattr(want, field))
            need(a.shape == b.shape and np.array_equal(a, b),
                 f"preempt seam: {field} differs from preempt_numpy")
        need(np.asarray(got.chosen_node).dtype == np.int32, "chosen_node dtype")
        placed = int((np.asarray(got.chosen_node) >= 0).sum())
        p50, p95 = host_ms(torch, lambda: svc.preempt(inputs), ITERS)
        dev = P.PreemptInputs.from_numpy(inputs, "cuda")
        d50, d95 = host_ms(torch, lambda: P.preempt_plan(dev), ITERS)
        per_call = profile_per_call(torch, lambda: svc.preempt(inputs), n=5)
        need(per_call is not None, "profiler: no device rows for preempt")
        report(f"preempt seam {PREEMPT_SEAM}: service.preempt == "
               f"preempt_numpy on every output ({placed} of "
               f"{PREEMPT_SEAM['candidates']} placed, max evictions "
               f"{int(np.asarray(got.evict_count).max())}); service p50="
               f"{p50} ms p95={p95} ms, the program alone on resident "
               f"operands p50={d50} ms p95={d95} ms ({ITERS} calls each); "
               f"{per_call[1]} device kernels, {per_call[0]} device ops and "
               f"{per_call[2]} us busy per call (profiler)")
        return {"p50": p50, "program_p50": d50, "kernels": per_call[1],
                "busy_us": per_call[2]}
    finally:
        svc.close()


class _RunningClock:
    """The monotonic clock plus an offset the phase moves forward: an
    injected clock for the service's health FSM that still runs, since a
    consolidation batch widens the service's gather window, which waits
    on the service's clock."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self):
        return time.monotonic() + self.offset


def _disruption_failure_policy(workloads, S, GaugeRegistry):
    """(d) Under error plans on solver.dispatch and preempt.plan the
    engines see the errors (FaultInjected, then SolverDeviceError once the
    FSM degrades), nothing is cordoned or evicted, nothing answers from
    numpy; with the plans cleared the probe heals the FSM."""
    from karpenter_tpu_torch import faults

    clock = _RunningClock()
    svc = S.SolverService(registry=GaugeRegistry(), clock=clock,
                          health_failure_threshold=2,
                          health_probe_interval_s=30.0)
    try:
        world = workloads.build_disruption_world(service=svc,
                                                 **DISRUPTION_FAULT_SHAPE)
        for _ in range(6):  # past the cooldown: consolidation has candidates
            world.round()
        seen = {"PreemptionEngine": [], "ConsolidationEngine": []}
        for engine in (world.preemption, world.consolidation):
            inner = engine.plan

            def caught(now=None, inner=inner, log=seen[type(engine).__name__]):
                try:
                    return inner(now)
                except Exception as exc:
                    log.append(type(exc).__name__)
                    raise

            engine.plan = caught
        before = world.snapshot()
        with faults.injected_faults(seed=12) as reg:
            reg.plan("solver.dispatch", mode="error")
            reg.plan("preempt.plan", mode="error")
            for _ in range(2):
                world.round()
        after = world.snapshot()
        need(set(n for n, cordoned, _ in after["nodes"] if cordoned)
             <= set(n for n, cordoned, _ in before["nodes"] if cordoned),
             "a node was cordoned under the fault plans")
        need(after["pods"] == before["pods"], "a pod was evicted")
        need(seen["PreemptionEngine"] == ["FaultInjected", "SolverDeviceError"],
             f"preemption saw {seen['PreemptionEngine']}")
        need(seen["ConsolidationEngine"]
             and set(seen["ConsolidationEngine"])
             <= {"FaultInjected", "SolverDeviceError"},
             f"consolidation saw {seen['ConsolidationEngine']}")
        need(svc.backend_health() == "degraded", "FSM not degraded")
        need(svc.stats.fallbacks == 0, "numpy answered on the card")
        clock.offset += 31.0
        n_before = {k: len(v) for k, v in seen.items()}
        world.round()
        need({k: len(v) for k, v in seen.items()} == n_before,
             "the probe round errored")
        need(svc.backend_health() == "healthy", "the probe did not heal")
        print(f"disruption failure policy: under solver.dispatch and "
              f"preempt.plan error plans preemption saw "
              f"{seen['PreemptionEngine']}, consolidation saw "
              f"{seen['ConsolidationEngine']}; nothing cordoned or evicted, "
              f"no numpy answer; the probe healed the FSM (trips "
              f"{svc.stats.fsm_trips}, recoveries {svc.stats.fsm_recoveries})")
    finally:
        svc.close()


def phase_disruption(torch, TF, workloads):
    """Phase 12: the disruption engines behind SolverService() on the
    card, driven by the ScalableNodeGroup controller. (b)'s CPU world
    runs in a child process beside (a)."""
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import service as S

    import pickle

    twin = _Child("_disruption_cpu_child")
    try:
        card = _disruption_production(torch, TF, workloads, S, GaugeRegistry)
        twin.join()
        with open(twin.path("disruption_cpu.pickle"), "rb") as f:
            _disruption_parity(pickle.load(f), card)
    finally:
        twin.close()
    seam = _preempt_seam(torch, workloads, S, GaugeRegistry)
    _disruption_failure_policy(workloads, S, GaugeRegistry)
    return {"launches": card["launches"], "profile": card["profile"],
            "seam": seam}


# -- phase 13: the controller binary ------------------------------------------

# the runtime world at full width: phase 9's cluster and phase 11's fleet
# (BASELINE.json's 1000 tenants x 4 autoscalers, 3 metrics, 64 pool groups
# x 4 pools), the fleet read through queue MetricsProducers
RUNTIME_SHAPE = dict(pods=100_000, types=300, n_has=4000, metrics=3, seed=0,
                     groups=64, pools=4)
# what `--profile production --poolgroups` sets
RUNTIME_OPTIONS = dict(fused_tick=True, event_driven=True,
                       prewarm_compile=True, poolgroups=True)
RUNTIME_DEVICE = None  # Options.device of the card runtime: the card
# a manager tick of this world takes ~30 s on the host (PERF.md section
# 5): the tick counts are what the script's time limit holds
RUNTIME_TICKS = 1  # timed ticks after the first (4 until phase 14, 2 until 15)
RUNTIME_PARITY_TICKS = 2  # ticks the CPU runtime repeats (the first included)
RUNTIME_TICK_S = 5.0  # the MetricsProducer interval
RUNTIME_PROFILED_TICKS = 1
# smoke seconds past which (a) skips its profiled tick: a slow host reached
# phase 13 at 246 s and, with the tick profiled (~90 s), ran 1,163 s
RUNTIME_LATE_S = 200.0
# the binary's world, written into a data dir
BINARY_SHAPE = dict(pods=10_000, types=300, n_has=400, metrics=3, seed=0,
                    groups=16, pools=4)
BINARY_DURATION_S = 30
BINARY_ARGS = ()  # extra flags of the binary (none: it runs on the card)
# each run's profiler capture, opened as the server serves (its warm-up
# done, the first tick starting): long enough to span that tick
PROFILE_MS = 6000


class _StepClock:
    """The runtime's injected clock, advanced between ticks."""

    def __init__(self, now=1_000_000.0):
        self.now = now

    def __call__(self):
        return self.now


class _TickTimers:
    """Host time of a manager tick's parts, on the tick's thread: each
    controller's slice (its due sweep, batch reconcile and status writes;
    its tracer span `reconcile.<Kind>`), the solver's note_tick +
    publish_gauges, and the tick hook (recovery bookkeeping and the
    self-SLO evaluation). The same slices run by the event thread's
    passes are summed apart, with the passes' count."""

    def __init__(self, runtime):
        import threading

        self.tick_thread = threading.current_thread()
        self.parts = {}
        self.event = {}
        manager, svc = runtime.manager, runtime.solver_service
        self._undo = []

        def wrap(owner, attr, label_of):
            real = getattr(owner, attr)
            self._undo.append((owner, attr, vars(owner).get(attr)))

            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    dt = time.perf_counter() - t0
                    into = (self.parts if threading.current_thread()
                            is self.tick_thread else self.event)
                    label = label_of(*args)
                    into[label] = into.get(label, 0.0) + dt

            setattr(owner, attr, timed)

        wrap(manager, "_reconcile_controller",
             lambda controller, *a: f"reconcile.{controller.kind()}")
        wrap(svc, "note_tick", lambda *a: "note_tick + publish_gauges")
        wrap(svc, "publish_gauges", lambda *a: "note_tick + publish_gauges")
        wrap(manager, "_tick_hook", lambda *a: "tick hook")
        self.ha_batches = 0
        ha = next(c for c in manager._controllers
                  if c.kind() == "HorizontalAutoscaler")
        real_batch = ha.reconcile_batch

        def counted(objs):
            self.ha_batches += 1
            return real_batch(objs)

        self._undo.append((ha, "reconcile_batch", None))
        ha.reconcile_batch = counted

    def take(self):
        parts, event = self.parts, self.event
        self.parts, self.event = {}, {}
        return parts, event

    def remove(self):
        """Put back what was wrapped: an instance attribute (the tick
        hook) as it was, a method by dropping the wrapper."""
        for owner, attr, own in reversed(self._undo):
            if own is not None:
                setattr(owner, attr, own)
            else:
                delattr(owner, attr)


def _runtime_boot(workloads, device):
    """(runtime, world, clock, provider, build s, boot s): the runtime
    world written into a fresh Store first, then KarpenterRuntime over it
    (so the world's creation is no watch event), on `device`."""
    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.store import Store

    store, provider, clock = Store(), FakeFactory(), _StepClock()
    t0 = time.perf_counter()
    world = workloads.build_runtime_world(store, provider, **RUNTIME_SHAPE)
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    runtime = KarpenterRuntime(
        Options(device=device, **RUNTIME_OPTIONS), store=store,
        cloud_provider_factory=provider, clock=clock,
    )
    return runtime, world, clock, provider, built, time.perf_counter() - t0


def _runtime_step(workloads, runtime, world, clock):
    """The world between two ticks: the clock moves one MetricsProducer
    interval, the queues step, and RECONCILE_CHURN pods are replaced. The
    churn lands under the manager's pass lock, as one watch burst between
    passes: the event thread's pass over it starts after the burst."""
    clock.now += RUNTIME_TICK_S
    world.step_queues()
    apply = workloads.churn_reconcile(world.cluster, RECONCILE_CHURN)
    with runtime.manager._pass_lock:
        apply()


def _settled(manager, quiet_s=0.15, timeout=120.0):
    """Wait until the event thread has run every pass the last tick
    caused (no dirty key for `quiet_s`, three debounce windows), then
    hold the pass lock: nothing reconciles while the caller reads."""
    deadline = time.perf_counter() + timeout
    while True:
        quiet_since = time.perf_counter()
        while time.perf_counter() - quiet_since < quiet_s:
            if manager.dirty_count():
                quiet_since = time.perf_counter()
            need(time.perf_counter() < deadline,
                 "the event thread did not settle")
            time.sleep(0.005)
        manager._pass_lock.acquire()
        if not manager.dirty_count():
            return manager._pass_lock
        manager._pass_lock.release()


def _runtime_snapshot(workloads, runtime, provider):
    from karpenter_tpu_torch.api.serialization import to_dict

    # the event thread's pass counters and the solve service's own
    # counters depend on how the work split between the threads and on
    # the rung: left out
    skip = workloads.RUNG_SKIP + ("karpenter_runtime_",)
    lock = _settled(runtime.manager)
    try:
        return workloads.runtime_snapshot(
            runtime.store, runtime.registry, provider, to_dict, skip=skip,
            pods="fields")
    finally:
        lock.release()


def _inactive(runtime) -> dict:
    """{kind: objects whose Active condition is False}."""
    out = {}
    for kind in ("MetricsProducer", "ScalableNodeGroup",
                 "HorizontalAutoscaler"):
        bad = 0
        for obj in runtime.store.list(kind):
            active = obj.status_conditions().get("Active")
            bad += int(active is not None and active.status == "False")
        out[kind] = bad
    return out


def _runtime_production(torch, TF, workloads):
    """(a) The runtime on the card: first tick, RUNTIME_TICKS timed
    ticks, the split, the service's accounting, a profiler window."""
    from karpenter_tpu_torch.solver.service import HEALTHY

    runtime, world, clock, provider, built, boot = _runtime_boot(
        workloads, RUNTIME_DEVICE)
    try:
        svc = runtime.solver_service
        need(svc.device.type == "cuda", f"the runtime's service on {svc.device}")
        kinds = [c.kind() for c in runtime.manager._controllers]
        need(kinds == ["MetricsProducer", "ScalableNodeGroup",
                       "HorizontalAutoscaler"], f"controllers {kinds}")
        n_queue = sum(1 for mp in runtime.store.list("MetricsProducer")
                      if mp.spec.queue is not None)
        report(f"runtime world {RUNTIME_SHAPE}: written in {built} s "
               f"({n_queue} queue producers); KarpenterRuntime(Options("
               f"{RUNTIME_OPTIONS})) built in {boot} s (prewarm included)")
        timers = _TickTimers(runtime)
        snaps = []
        try:
            torch.cuda.synchronize()
            TF.reset_launch_counts()
            t0 = time.perf_counter()
            runtime.manager.reconcile_all()
            first_ms = (time.perf_counter() - t0) * 1e3
            first_launches = dict(TF.LAUNCHES)
            need(first_launches == {"fused_assign": 1, "shelf_bfd": 1,
                                    "demand_reduce": 0, "pack_bits": 1},
                 f"the first tick launched {first_launches}")
            pending = [runtime.store.get("MetricsProducer", "default",
                                         f"mp{g}")
                       for g in range(RUNTIME_SHAPE["types"])]
            totals = _totals(pending)
            need(totals == RECONCILE_TOTALS,
                 f"runtime first tick totals {totals} != {RECONCILE_TOTALS}")
            inactive = _inactive(runtime)
            need(not any(inactive.values()),
                 f"objects not Active after the first tick: {inactive}")
            parts, event = timers.take()
            report(f"runtime first tick: {first_ms} ms; launches "
                   f"{first_launches} (the MetricsProducer controller's "
                   f"batched solve); totals {totals}; split "
                   + ", ".join(f"{k} {v * 1e3} ms" for k, v in parts.items()))
            snaps.append(_runtime_snapshot(workloads, runtime, provider))
            rows = []
            gc_full = gc.get_stats()[2]["collections"]
            ha_before = timers.ha_batches
            fused_before = svc.stats.fused_dispatches
            dispatches_before = svc.stats.dispatches
            passes = runtime.registry.gauge("runtime", "event_passes_total")
            for t in range(RUNTIME_TICKS):
                passes_before = passes.get("manager", "-") or 0.0
                TF.reset_launch_counts()
                d0 = svc.stats.dispatches + svc.stats.fused_dispatches
                _runtime_step(workloads, runtime, world, clock)
                t0 = time.perf_counter()
                runtime.manager.reconcile_all()
                ms = (time.perf_counter() - t0) * 1e3
                parts, event = timers.take()
                rows.append(dict(
                    ms=ms, launches=dict(TF.LAUNCHES), parts=parts,
                    event=event,
                    passes=(passes.get("manager", "-") or 0.0)
                    - passes_before,
                    dispatches=svc.stats.dispatches
                    + svc.stats.fused_dispatches - d0,
                ))
                if len(snaps) < RUNTIME_PARITY_TICKS:
                    snaps.append(_runtime_snapshot(workloads, runtime,
                                                   provider))
            gc_full = gc.get_stats()[2]["collections"] - gc_full
            ha_ticks = timers.ha_batches - ha_before
            fused = svc.stats.fused_dispatches - fused_before
        finally:
            timers.remove()
        ms = [r["ms"] for r in rows]
        report(f"runtime tick (manager.reconcile_all, host clock) over "
               f"{RUNTIME_TICKS} ticks of {RUNTIME_TICK_S} s with "
               f"{RECONCILE_CHURN} pods churned each: p50="
               f"{np.percentile(ms, 50)} ms p95={np.percentile(ms, 95)} ms")
        total = {}
        for r in rows:
            for k, v in r["parts"].items():
                total.setdefault(k, []).append(v * 1e3)
        for k, v in sorted(total.items(), key=lambda kv: -sum(kv[1])):
            report(f"  tick split, ms per tick (median / max): {k} "
                   f"{np.median(v)} / {max(v)} ({100.0 * sum(v) / sum(ms)}% "
                   f"of all ticks)")
        event_ms = {}
        for r in rows:
            for k, v in r["event"].items():
                event_ms[k] = event_ms.get(k, 0.0) + v * 1e3
        report(f"  event thread: {sum(r['passes'] for r in rows)} passes "
               f"over the {RUNTIME_TICKS} ticks; their slices (ms, total): "
               + (", ".join(f"{k} {v}" for k, v in event_ms.items())
                  or "none"))
        per_tick = {name: [r["launches"][name] for r in rows]
                    for name in TF.LAUNCHES}
        report(f"  launches per tick (churn -> event pass -> tick): "
               + ", ".join(f"{k} {v}" for k, v in per_tick.items())
               + f"; solver dispatches per tick "
               f"{[r['dispatches'] for r in rows]}")
        need(all(v >= 1 for v in per_tick["fused_assign"]),
             f"a churned tick launched no fused_assign: {per_tick}")
        need(per_tick["fused_assign"] == per_tick["shelf_bfd"],
             f"launches per tick differ: {per_tick}")
        need(fused == ha_ticks and ha_ticks > 0,
             f"fused_dispatches {fused} != HA ticks {ha_ticks}")
        st = svc.stats
        need(st.fallbacks == 0, f"{st.fallbacks} numpy answers on the card")
        need(svc.backend_health() == HEALTHY,
             f"FSM {svc.backend_health()}")
        report(f"  HA ticks {ha_ticks}, fused_dispatches {fused}, "
               f"fallback_total 0, FSM healthy, full gc collections "
               f"{gc_full} over {RUNTIME_TICKS} ticks, service requests "
               f"{st.requests} dispatches {st.dispatches - dispatches_before}"
               f" since the first tick")
        profile = (_runtime_profile(torch, TF, workloads, runtime, world,
                                    clock)
                   if RUNTIME_PROFILED_TICKS else None)
        return {"snaps": snaps, "first_launches": first_launches,
                "launches_per_tick": per_tick, "profile": profile,
                "p50_ms": float(np.percentile(ms, 50))}
    finally:
        runtime.close()


def _runtime_profile(torch, TF, workloads, runtime, world, clock):
    """A torch.profiler window of RUNTIME_PROFILED_TICKS ticks (each with
    its step and churn): device kernels, busy us, each CUDA kernel's
    launches and device ms per launch."""

    def one_tick():
        _runtime_step(workloads, runtime, world, clock)
        runtime.manager.reconcile_all()

    try:
        # no warm-up tick (one until phase 15 came): a tick takes ~30 s
        prof, wall_us = profile_window(torch, one_tick,
                                       RUNTIME_PROFILED_TICKS, warmup=0)
    except RuntimeError as exc:
        print(f"profiler: not available ({exc})")
        return None
    rows = device_rows(torch, prof)
    need(rows, "the profiler shows no device rows for the runtime's ticks")
    n = RUNTIME_PROFILED_TICKS
    busy_us = sum(r[0] for r in rows)
    kernels = sum(count for _, count, key in rows
                  if not key.startswith(("Memcpy", "Memset")))
    report(f"runtime profiler, {n} ticks: window {wall_us} us, device busy "
           f"{busy_us} us ({100.0 * busy_us / wall_us}% of the window), "
           f"{kernels / n} device kernels per tick")
    out = {}
    for name, names in KERNEL_NAMES.items():
        hits = [(us, count, key) for us, count, key in rows
                if any(k in key for k in names)]
        need(hits, f"the runtime's profile shows no {name} kernel")
        kernels_seen = sum(c for _, c, _ in hits)
        # each of the wrapper's kernels runs once per wrapper launch
        launches = max(c for _, c, _ in hits)
        us = sum(u for u, _, _ in hits)
        out[name] = {"launches": launches / n, "ms": us / launches / 1e3}
        report(f"  {name}: {launches / n} launches per tick "
               f"({kernels_seen / n} device kernels), {us / launches / 1e3} "
               f"ms per launch")
    for dev_us, count, key in rows[:10]:
        report(f"  device {dev_us / n} us/tick  x{count / n}/tick  {key[:90]}")
    return out


def _runtime_cpu_snaps(workloads):
    """(b) The same world, options and ticks on a CPU runtime: its
    snapshot after each of RUNTIME_PARITY_TICKS ticks."""
    runtime, world, clock, provider, _, _ = _runtime_boot(workloads, "cpu")
    try:
        snaps = []
        for t in range(RUNTIME_PARITY_TICKS):
            if t:
                _runtime_step(workloads, runtime, world, clock)
            runtime.manager.reconcile_all()
            snaps.append(_runtime_snapshot(workloads, runtime, provider))
        return snaps
    finally:
        runtime.close()


def _runtime_parity(card_snaps, cpu_snaps):
    """(b) The card runtime's snapshots == the CPU runtime's, tick by
    tick: every object, the provider replicas and the exposition."""
    need(len(cpu_snaps) == RUNTIME_PARITY_TICKS,
         f"the CPU runtime ran {len(cpu_snaps)} ticks")
    for t, (got, want) in enumerate(zip(cpu_snaps, card_snaps)):
        need(got["objects"].keys() == want["objects"].keys(),
             f"tick {t}: the stores hold different objects")
        diff = [k for k, v in want["objects"].items()
                if got["objects"][k] != v]
        need(not diff, f"tick {t}: {len(diff)} objects differ, e.g. "
             f"{diff[:3]}")
        need(got["replicas"] == want["replicas"],
             f"tick {t}: provider replicas differ")
        need(got["exposition"] == want["exposition"],
             f"tick {t}: exposition differs")
    print(f"runtime card == CPU runtime: {RUNTIME_PARITY_TICKS} ticks, "
          f"{len(want['objects'])} objects, statuses, store, provider "
          f"replicas and exposition equal")


class _Child:
    """`chip_smoke.<function>(workloads, out_dir)` in a child process,
    started now and joined later, so host-bound work (a CPU twin,
    processes that the smoke drives) runs beside the card's work in this
    process. `out_dir` is a fresh directory the child may write results
    into (`path(name)`), removed by close(); the child's output goes to
    a file there, printed when it is joined; the card's line comes from
    this process."""

    def __init__(self, function: str, env=None):
        import subprocess
        import tempfile

        self.what = function
        self.root = tempfile.mkdtemp(prefix="karpenter-smoke-child-")
        self.log_path = os.path.join(self.root, "child.log")
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
                 f"chip_smoke._child_main({function!r}, {self.root!r}))"],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, KARPENTER_SMOKE_CARD=CARD["line"],
                         **(env or {})),
            )

    def path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def join(self, timeout=1200) -> None:
        """Wait for it, print its output, fail with it; a child still
        running (an error in this process, a timeout) is killed."""
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            with open(self.log_path) as log:
                text = log.read()
            print(text, end="", flush=True)
        # a child's traceback ends with its exception's line
        last = [x for x in text.splitlines() if x.strip()][-1:]
        need(rc == 0, f"{self.what} failed in its child process (exit "
             f"{rc}; its output above, ending {last})")

    def close(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.root, ignore_errors=True)


def _child_main(function: str, out_dir: str) -> int:
    """A _Child's body: `function(workloads, out_dir)` of this module."""
    from karpenter_tpu_torch import workloads

    CARD["line"] = os.environ.get("KARPENTER_SMOKE_CARD", CARD["line"])
    globals()[function](workloads, out_dir)
    return 0


def _runtime_cpu_child(workloads, out_dir: str) -> None:
    """(b) in a child: the CPU runtime's snapshots, pickled."""
    import pickle

    t0 = time.perf_counter()
    snaps = _runtime_cpu_snaps(workloads)
    with open(os.path.join(out_dir, "cpu_snaps.pickle"), "wb") as f:
        pickle.dump(snaps, f)
    report(f"phase 13 (b), beside (a): the CPU runtime's {len(snaps)} "
           f"ticks in {time.perf_counter() - t0} s")


def _runtime_binary_child(workloads, out_dir: str) -> None:
    """(c), (d) in a child."""
    t0 = time.perf_counter()
    _runtime_binary(workloads)
    report(f"phase 13 (c), (d), beside (a): {time.perf_counter() - t0} s")


class _Binary:
    """`python -m karpenter_tpu_torch` as a subprocess, its stderr read by
    a thread: `port` once it serves."""

    def __init__(self, args, env=None):
        import subprocess
        import threading

        self.lines = []
        self.port = None
        self.serving = threading.Event()
        self.profiling = threading.Event()  # --profiler-port serves
        self.seen_at = {}  # marker -> perf_counter when its line came
        self.started = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        marker = "serving /metrics and /healthz on :"
        for line in self.proc.stderr:
            self.lines.append(line.rstrip())
            if marker in line and self.port is None:
                self.seen_at["serving"] = time.perf_counter()
                self.port = int(line.rsplit(":", 1)[1])
                self.serving.set()
            if "torch profiler listening on :" in line:
                self.seen_at["profiling"] = time.perf_counter()
                self.profiling.set()

    def get(self, path, port=None, timeout=30):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port or self.port}{path}",
                timeout=timeout,
            ) as response:
                return response.status, response.read().decode()
        except urllib.error.HTTPError as error:
            return error.code, error.read().decode()

    def wait_serving(self, timeout):
        if not self.serving.wait(timeout):
            need(False, f"the binary did not serve within {timeout} s: "
                 f"{self.lines[-5:]}")

    def stop(self, timeout=60):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        self.reader.join(timeout=10)
        return rc


def _binary_run(args, recovered, capture):
    """Start the binary, poll /readyz until "ok" (noting any not-ready
    answers), read /metrics, SIGTERM it: (readyz answers, metrics text,
    seconds to ready, exit code, seconds from SIGTERM to exit, stderr
    lines, what `capture(binary)` returned). `capture` runs on a thread
    beside the polling, from the start; it is joined before SIGTERM."""
    import threading

    binary = _Binary(args)
    captured = {}

    def run_capture():
        try:
            captured["value"] = capture(binary)
        except BaseException as error:  # noqa: BLE001 — raised below
            captured["error"] = error

    capturing = threading.Thread(target=run_capture, daemon=True)
    capturing.start()
    try:
        binary.wait_serving(300)
        answers = []
        deadline = time.perf_counter() + 120
        while time.perf_counter() < deadline:
            status, body = binary.get("/readyz")
            if not answers or answers[-1] != (status, body):
                answers.append((status, body))
            if status == 200:
                break
            time.sleep(0.02)
        ready_s = time.perf_counter() - binary.started
        need(answers and answers[-1] == (200, "ok"),
             f"/readyz never answered ok: {answers}")
        if recovered:
            need(any(s == 503 and "recovery warm-up" in b for s, b in answers),
                 f"the recovered boot answered no warm-up: {answers}")
        # ready is not ticked: a first boot is ready before its first
        # tick ends; /metrics is read once a tick has published the
        # manager's tick time
        while True:
            status, metrics = binary.get("/metrics")
            need(status == 200, f"/metrics answered {status}")
            if (_metric(metrics, "karpenter_runtime_tick_seconds", "manager")
                    or time.perf_counter() > deadline):
                break
            time.sleep(0.1)
        capturing.join(timeout=300)
        need(not capturing.is_alive(), "the profiler capture hung")
        if "error" in captured:
            raise captured["error"]
        t0 = time.perf_counter()
        rc = binary.stop()
        stop_s = time.perf_counter() - t0
        need(rc == 0, f"the binary exited {rc} on SIGTERM: "
             f"{binary.lines[-5:]}")
        need(stop_s < BINARY_DURATION_S and ready_s + stop_s
             < BINARY_DURATION_S + 300,
             f"the binary took {stop_s} s to stop")
        return (answers, metrics, ready_s, rc, stop_s, binary.lines,
                captured["value"])
    finally:
        binary.stop()


def _trace_kernels(text: str, what: str) -> dict:
    """A Chrome trace's device kernels of each wrapper (KERNEL_NAMES) and
    its solver.* ranges; fails unless it parses and holds both wrappers'
    kernels."""
    events = json.loads(text)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {wrapper: sum(any(n in k for n in names) for k in kernels)
             for wrapper, names in KERNEL_NAMES.items()}
    need(all(found.values()), f"{what}: the capture holds kernels {found} "
         f"of {len(kernels)} device kernels (both wrappers' needed)")
    ranges = [e for e in events if str(e.get("name", "")).startswith("solver.")]
    # where in the window the wrappers' first kernel ran
    start = min(e["ts"] for e in events if "ts" in e)
    first = min(e["ts"] for e in events if e.get("cat") == "kernel" and any(
        n in e["name"] for names in KERNEL_NAMES.values() for n in names))
    return {"kernels": found, "device_kernels": len(kernels),
            "first_kernel_at_ms": (first - start) / 1e3,
            "solver_ranges": len(ranges),
            "solver_range_cats": sorted({str(e.get("cat")) for e in ranges})}


def _check_solver_ranges(profile, lines, what):
    """A capture taken on the profiler server's thread over a tick holds
    the solver.* ranges that the binary's other threads open where this
    torch takes profile_all_threads, and none where it does not; the
    binary's profiler line names which."""
    from karpenter_tpu_torch.observability import profiler as P

    threads = P.capture_threads()
    listening = [line for line in lines
                 if "torch profiler listening on :" in line]
    need(listening and threads in listening[0],
         f"the profiler line does not name {threads!r}: {listening}")
    need((profile["solver_ranges"] > 0) == P._all_threads(),
         f"{what}: {profile['solver_ranges']} solver.* ranges with "
         f"captures holding the ranges of {threads}")
    profile["threads"] = threads


def _server_start_s(binary) -> float:
    """Seconds from the metrics server's line to the profiler server's:
    the webhook start (none here) and the profiler's warm-up window."""
    return binary.seen_at["profiling"] - binary.seen_at["serving"]


def _profile_route(port):
    """The first run's capture: GET :port/profile as soon as the profiler
    server serves."""

    def capture(binary):
        if not binary.profiling.wait(300):
            need(False, f"--profiler-port never served: {binary.lines[-5:]}")
        t0 = time.perf_counter()
        status, body = binary.get(f"/profile?ms={PROFILE_MS}", port=port,
                                  timeout=300)
        need(status == 200, f"GET /profile answered {status}: {body[:200]}")
        return dict(_trace_kernels(body, "GET /profile"),
                    seconds=time.perf_counter() - t0, bytes=len(body),
                    server_start_s=_server_start_s(binary))

    return capture


def _debug_profile(journal):
    """The restart's capture: /debug/profile into the journal dir as soon
    as the profiler server serves (the same single-flight capture)."""

    def capture(binary):
        if not binary.profiling.wait(300):
            need(False, f"--profiler-port never served: {binary.lines[-5:]}")
        t0 = time.perf_counter()
        status, body = binary.get(f"/debug/profile?ms={PROFILE_MS}",
                                  timeout=300)
        need(status == 200, f"/debug/profile answered {status}: {body[:200]}")
        path = json.loads(body)["path"]
        need(os.path.dirname(path) == journal,
             f"the capture is not in the journal dir: {path}")
        with open(os.path.join(path, "trace.json")) as fh:
            text = fh.read()
        return dict(_trace_kernels(text, "/debug/profile"),
                    seconds=time.perf_counter() - t0, bytes=len(text),
                    server_start_s=_server_start_s(binary))

    return capture


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


def _metric(text, family, name="-", namespace="-"):
    line = f'{family}{{name="{name}",namespace="{namespace}"}} '
    for row in text.splitlines():
        if row.startswith(line):
            return float(row[len(line):])
    return None


def _runtime_binary(workloads):
    """(c) The binary over a data dir and a journal dir, twice; (d) with
    the card hidden. The dirs live in a temporary directory, removed
    after."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="karpenter-binary-")
    try:
        _runtime_binary_in(workloads, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _runtime_binary_in(workloads, root):
    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
    from karpenter_tpu_torch.recovery.fence import read_generation
    from karpenter_tpu_torch.store.persistence import open_store

    data, journal = os.path.join(root, "data"), os.path.join(root, "journal")
    store = open_store(data)
    t0 = time.perf_counter()
    workloads.build_runtime_world(store, FakeFactory(), **BINARY_SHAPE)
    store.close()
    report(f"binary world {BINARY_SHAPE} written into the data dir in "
           f"{time.perf_counter() - t0} s")
    command = ["--profile", "production", "--cloud-provider", "fake",
               "--data-dir", data, "--journal-dir", journal,
               "--metrics-port", "0", "--no-leader-elect", "--tick", "0.1",
               "--duration", str(BINARY_DURATION_S)]
    port = _free_port()
    args = command + list(BINARY_ARGS) + ["--profiler-port", str(port)]
    answers, metrics, ready_s, rc, stop_s, lines, profile = _binary_run(
        args, False, _profile_route(port))
    requests = _metric(metrics, "karpenter_solver_requests_total")
    fallbacks = _metric(metrics, "karpenter_solver_fallback_total") or 0.0
    need(requests and requests > 0, "/metrics shows no solver request")
    need(fallbacks == 0, f"/metrics shows {fallbacks} fallbacks")
    device_line = [line for line in lines if line.startswith("solver device:")]
    need(device_line and ("cuda" in device_line[0] or BINARY_ARGS),
         f"the binary's device: {device_line}")
    missing = [g for g in range(BINARY_SHAPE["types"])
               if _metric(metrics, "karpenter_pending_capacity_pending_pods",
                          f"mp{g}", "default") is None]
    need(not missing, f"no pending_capacity series for {len(missing)} "
         f"producers, e.g. mp{missing[:3]}")
    generation = read_generation(journal)
    report(f"binary: ready in {ready_s} s ({answers}), "
           f"{device_line[0]}; solver requests {requests}, fallbacks 0, "
           f"karpenter_pending_capacity_* for all {BINARY_SHAPE['types']} "
           f"producers; SIGTERM -> exit {rc} in {stop_s} s; fence "
           f"generation {generation}")
    _check_solver_ranges(profile, lines, "GET /profile")
    report(f"binary GET :P/profile?ms={PROFILE_MS} over the first tick: "
           f"{profile}; manager tick "
           f"{_metric(metrics, 'karpenter_runtime_tick_seconds', 'manager')} s")
    store = open_store(data)
    try:
        mps = store.list("MetricsProducer")
        bare = [mp.metadata.name for mp in mps
                if mp.status.pending_capacity is None
                and mp.status.queue is None]
        need(mps and not bare, f"{len(bare)} of {len(mps)} producers have "
             f"no status in the data dir, e.g. {bare[:3]}")
    finally:
        store.close()
    answers, metrics, ready_s, rc, stop_s, lines, profile = _binary_run(
        args, True, _debug_profile(journal))
    _check_solver_ranges(profile, lines, "/debug/profile")
    regenerated = read_generation(journal)
    need(regenerated > generation,
         f"fence generation {generation} -> {regenerated}")
    report(f"binary restart on the same dirs: /readyz {answers} in "
           f"{ready_s} s; SIGTERM -> exit {rc} in {stop_s} s; fence "
           f"generation {generation} -> {regenerated}; all "
           f"{len(mps)} producers had a status on reopen")
    report(f"binary restart /debug/profile?ms={PROFILE_MS} into J over the "
           f"first tick: {profile}; manager tick "
           f"{_metric(metrics, 'karpenter_runtime_tick_seconds', 'manager')} s")
    wal = os.path.join(data, "wal.jsonl")
    wal_size = os.path.getsize(wal)
    hidden = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    binary = _Binary(command, env=hidden)
    rc = binary.proc.wait(timeout=300)
    binary.reader.join(timeout=10)
    text = "\n".join(binary.lines)
    need(rc != 0, "the binary ran with the card hidden")
    need("CUDA device requested" in text,
         f"no reason given with the card hidden: {binary.lines[-3:]}")
    need(binary.port is None, "the binary served with the card hidden")
    need(os.path.getsize(wal) == wal_size,
         "the data dir changed with the card hidden")
    print(f"binary with CUDA_VISIBLE_DEVICES=\"\": exit {rc}, no tick, "
          f"{[line for line in binary.lines if 'cannot start' in line]}",
          flush=True)


def phase_runtime(torch, TF, workloads, started):
    """Phase 13. (b) and (c)-(d) run in two child processes beside (a):
    the CPU runtime's ticks and the binary's processes need the host, (a)
    the card and one core. Past RUNTIME_LATE_S of smoke (a)'s profiled
    tick is skipped (the kernels' device ms per launch at the same
    operands are measured in phases 9, 15 and 16)."""
    import pickle

    global RUNTIME_PROFILED_TICKS
    if time.perf_counter() - started > RUNTIME_LATE_S:
        RUNTIME_PROFILED_TICKS = 0
        print(f"phase 13: the smoke is past {RUNTIME_LATE_S} s; (a) runs no "
              f"profiled tick", flush=True)
    t0 = time.perf_counter()
    twin = binary = None
    try:
        twin = _Child("_runtime_cpu_child")
        binary = _Child("_runtime_binary_child")
        card = _runtime_production(torch, TF, workloads)
        report(f"phase 13 (a): {time.perf_counter() - t0} s")
        twin.join()
        with open(twin.path("cpu_snaps.pickle"), "rb") as f:
            _runtime_parity(card.pop("snaps"), pickle.load(f))
        binary.join()
    finally:
        for child in (twin, binary):
            if child is not None:
                child.close()
    report(f"phase 13: {time.perf_counter() - t0} s")
    return card


# -- phase 14: the --simulate entry point and SimLab ---------------------------

# (a) the dry run over phase 9's cluster written into a data dir, and (b)
# the consolidation report over phase 12's world written into another
SIM_DRY_SHAPE = RECONCILE_SHAPE
SIM_CONSOLIDATE_SHAPE = DISRUPTION_SHAPE
# the reference's `python -m karpenter_tpu --simulate` on SIM_DRY_SHAPE's
# data dir (written by its DurableStore; JAX on a CPU): crc32 of each JSON
# report (json.dumps(sort_keys=True, separators=(",", ":"))), and the
# plain report's totals over the 300 groups
SIMULATE_PINS = dict(report_crc=1421211271, what_if_crc=3253814251, nodes=9263,
                     lp_bound=8197, pending=100_000, unschedulable=0)
# (c) bench.py:2237-2246's published SimLab size on the cost theme, timed
# in turns; (d) a size SimLab's users would call real: one day at 60 s
SIM_BATCH = dict(clusters=256, ticks=64, rows=8)
SIM_TURNS = 2  # 3 until phase 15 came
SIM_REAL = dict(clusters=4096, ticks=1440, rows=8, seed=0)
SIM_REAL_ITERS = 3
SIM_SAMPLED = (0, 128, 255)
# (e) the reference's search_tuned_policy on the cost scenario's trails at
# its default seed (karpenter_tpu, JAX on a CPU): the winner, its reward,
# the reactive baseline's, and _report_crc of sorted((list(knobs), reward)
# for every candidate)
SEARCH_PIN = dict(knobs=(1.0, 0.0, 3.0), reward=-1187.3,
                  baseline=-2296.5499999999997, candidates=64,
                  rewards_crc=2075835504)
SIM_GYM = dict(clusters=256, ticks=64)
SIM_DEVICE = None  # Options.device / SolverService device of the card runs
SIM_CARD_ARGS = ()  # extra flags of the card's --simulate processes (none)


def _report_crc(report) -> int:
    import zlib

    return zlib.crc32(json.dumps(
        report, sort_keys=True, separators=(",", ":")).encode())


class _SimulateProcesses:
    """`python -m karpenter_tpu_torch --simulate ARGS` for every {label:
    ARGS}, started at once; `wait()` gives {label: (exit code, stdout,
    stderr, wall s)} and `stop()` kills any still running."""

    def __init__(self, runs):
        import subprocess
        import tempfile
        import threading

        self.started, self.ended = {}, {}
        try:
            for label, argv in runs.items():
                out = tempfile.TemporaryFile("w+")
                err = tempfile.TemporaryFile("w+")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "karpenter_tpu_torch",
                     "--simulate", *argv],
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    stdout=out, stderr=err, text=True,
                )
                self.started[label] = (proc, out, err, time.perf_counter())
                # the exit time, taken when the process ends (not when
                # wait() looks)
                threading.Thread(target=self._watch, args=(label, proc),
                                 daemon=True).start()
        except BaseException:
            self.stop()
            raise

    def _watch(self, label, proc):
        proc.wait()
        self.ended[label] = time.perf_counter()

    def wait(self, timeout=900):
        results = {}
        deadline = time.perf_counter() + timeout
        while len(results) < len(self.started):
            for label, (proc, out, err, t0) in self.started.items():
                if label not in results and label in self.ended:
                    out.seek(0)
                    err.seek(0)
                    results[label] = (proc.returncode, out.read(), err.read(),
                                      self.ended[label] - t0)
            need(time.perf_counter() < deadline,
                 f"--simulate processes still running after {timeout} s: "
                 f"{sorted(set(self.started) - set(results))}")
            time.sleep(0.05)
        return results

    def stop(self):
        for proc, out, err, _ in self.started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


def _dry_run_totals(report) -> dict:
    groups = report["groups"].values()
    return dict(
        nodes=sum(g["additional_nodes_needed"] for g in groups),
        lp_bound=sum(g["lp_lower_bound"] for g in groups),
        pending=sum(g["pending_pods"] for g in groups),
        unschedulable=report["unschedulable_pods"],
    )


def _copy_dir(root, src, label):
    """A copy of a data dir for one process (a data dir takes one
    process's lock)."""
    import shutil

    copy = os.path.join(root, label)
    shutil.copytree(os.path.join(root, src), copy)
    return copy


def _consolidate_on_card(torch, TF, copy):
    """`--simulate --consolidate` on the card through the binary's main()
    in this process, so its launches can be counted: the consolidation's
    evaluate() is wrapped to profile 64 candidates' masked solves first
    (device ms per launch), then the counts are set to 0 just before the
    report's own evaluate and read just after it. Returns (report,
    launches, candidates with pods, ms per launch, wall s)."""
    import contextlib
    import io

    from karpenter_tpu_torch import __main__ as main_module
    from karpenter_tpu_torch import consolidation as CONS

    real_evaluate = CONS.evaluate
    seen = {}

    def evaluate(view, candidates, service, **kwargs):
        with_pods = [nv.name for nv in view.nodes
                     if nv.name in set(candidates) and nv.pods]
        seen["with_pods"] = len(with_pods)
        sample = with_pods[:64]
        seen["ms"] = _kernel_ms(
            torch, lambda: real_evaluate(view, sample, service, **kwargs),
            n=1, warmup=1)
        TF.reset_launch_counts()
        out = real_evaluate(view, candidates, service, **kwargs)
        seen["launches"] = dict(TF.LAUNCHES)
        return out

    out = io.StringIO()
    CONS.evaluate = evaluate
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main_module.main(["--simulate", "--consolidate",
                                   "--data-dir", copy, "--no-leader-elect",
                                   *SIM_CARD_ARGS])
        wall = time.perf_counter() - t0
    finally:
        CONS.evaluate = real_evaluate
    need(rc == 0, f"--simulate --consolidate on the card exited {rc}")
    return (json.loads(out.getvalue()), seen["launches"], seen["with_pods"],
            seen["ms"], wall)


def _simulate_cli(torch, TF, workloads, root):
    """(a), (b) through the binary: the dry-run data dir written, then
    the card and CPU dry runs and what-if runs as four `--simulate`
    processes; meanwhile the consolidation data dir written, the CPU's
    `--simulate --consolidate` as a fifth process and the card's through
    main() in this process (its launches counted). Returns the reports."""
    t0 = time.perf_counter()
    written = workloads.write_reconcile_dir(os.path.join(root, "dry"),
                                            **SIM_DRY_SHAPE)
    dry_s = time.perf_counter() - t0
    what_if = os.path.join(root, "what-if.json")
    with open(what_if, "w") as f:
        json.dump(workloads.what_if_specs(), f)
    runs = {}
    for device in ("card", "cpu"):
        extra = ["--device", "cpu"] if device == "cpu" else list(SIM_CARD_ARGS)
        for kind, flags in (("plain", []), ("what-if", ["--what-if", what_if])):
            copy = _copy_dir(root, "dry", f"{kind}-{device}")
            runs[(kind, device)] = ["--data-dir", copy, "--no-leader-elect",
                                    *flags, *extra]
    dry_procs = _SimulateProcesses(runs)
    cons_procs = None
    try:
        t1 = time.perf_counter()
        written_cons = workloads.write_disruption_dir(
            os.path.join(root, "cons"), **SIM_CONSOLIDATE_SHAPE)
        cons_s = time.perf_counter() - t1
        cons_procs = _SimulateProcesses({("consolidate", "cpu"): [
            "--data-dir", _copy_dir(root, "cons", "consolidate-cpu"),
            "--no-leader-elect", "--consolidate", "--device", "cpu"]})
        card_cons = _consolidate_on_card(
            torch, TF, _copy_dir(root, "cons", "consolidate-card"))
        results = dry_procs.wait()
        results.update(cons_procs.wait())
    finally:
        dry_procs.stop()
        if cons_procs is not None:
            cons_procs.stop()
    report(f"simulate data dirs: {SIM_DRY_SHAPE} ({written} objects) in "
           f"{dry_s} s, {SIM_CONSOLIDATE_SHAPE} ({written_cons} objects) in "
           f"{cons_s} s (beside the four dry-run processes)")
    reports = {}
    for key, (rc, out, err, wall) in sorted(results.items()):
        need(rc == 0, f"--simulate {key} exited {rc}: {err[-2000:]}")
        device_line = [line for line in err.splitlines()
                       if line.startswith("solver device:")]
        on_card = device_line and "cuda" in device_line[0]
        need(device_line and (on_card == (key[1] == "card")
                              or (SIM_CARD_ARGS and key[1] == "card")),
             f"--simulate {key} ran on {device_line}")
        reports[key] = json.loads(out)
        report(f"--simulate {' '.join(key)}: {wall} s wall (five processes "
               f"and the card's consolidation at once), {len(out)} bytes of "
               f"report, {device_line[0]}")
    cons_report, launches, with_pods, cons_ms, cons_wall = card_cons
    reports[("consolidate", "card")] = cons_report
    for kind in ("plain", "what-if", "consolidate"):
        need(reports[(kind, "card")] == reports[(kind, "cpu")],
             f"--simulate {kind}: the card's report differs from the CPU's")
    need(launches == {"fused_assign": with_pods, "shelf_bfd": with_pods,
                      "demand_reduce": 0, "pack_bits": with_pods},
         f"consolidation launched {launches} for {with_pods} candidates "
         f"with pods")
    report(f"--simulate --consolidate on the card (main() in process, "
           f"{cons_wall} s wall beside the processes): "
           f"{cons_report['candidates_evaluated']} candidates, {with_pods} "
           f"with pods, {len(cons_report['drainable'])} drainable; launches "
           f"{launches} (once per candidate with pods); device ms per launch "
           f"over 64 candidates' masked solves: {cons_ms}")
    plain, delta = reports[("plain", "card")], reports[("what-if", "card")]
    totals = _dry_run_totals(plain)
    want = {k: SIMULATE_PINS[k] for k in totals}
    need(totals == want, f"dry run totals {totals}, the reference's {want}")
    need(delta["baseline"] == plain, "the what-if baseline != the dry run")
    need(_report_crc(plain) == SIMULATE_PINS["report_crc"],
         f"dry run report crc {_report_crc(plain)}, the reference's "
         f"{SIMULATE_PINS['report_crc']}")
    need(_report_crc(delta) == SIMULATE_PINS["what_if_crc"],
         f"what-if report crc {_report_crc(delta)}, the reference's "
         f"{SIMULATE_PINS['what_if_crc']}")
    print(f"--simulate card == --device cpu on all three reports; dry run "
          f"totals {totals} == the reference's, its report and the what-if "
          f"report equal the reference's (crc32 {_report_crc(plain)}, "
          f"{_report_crc(delta)}); what-if delta unschedulable "
          f"{delta['delta']['unschedulable_pods']}, changed groups "
          f"{ {k: v for k, v in delta['delta']['groups'].items() if any(v.values())} }",
          flush=True)
    consolidate = {"launches": launches, "candidates": with_pods,
                   "ms": cons_ms}
    return plain, delta, consolidate


def _kernel_ms(torch, fn, n=5, warmup=2):
    """{wrapper: device ms per launch} of the CUDA kernels `fn` launches,
    from a torch.profiler window of n calls (None without device rows)."""
    from karpenter_tpu_torch.ops import fused_assign as TF

    TF.reset_launch_counts()
    prof, _ = profile_window(torch, fn, n, warmup=warmup)
    launches = dict(TF.LAUNCHES)
    rows = device_rows(torch, prof)
    out = {}
    for name, kernels in KERNEL_NAMES.items():
        us = sum(r[0] for r in rows if any(k in r[2] for k in kernels))
        per = launches[name] * n / (n + warmup)
        out[name] = us / 1e3 / per if us and per else None
    return out


def _simulate_in_process(torch, TF, workloads, root, plain, delta):
    """(a) in process on a card runtime over a copy of the data dir: the
    launches of one dry run and one what-if delta, the host split, the
    kernels' device ms per launch at the dry run's shapes."""
    from karpenter_tpu_torch import simulate as SIM
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options

    copy = _copy_dir(root, "dry", "in-process")
    t0 = time.perf_counter()
    runtime = KarpenterRuntime(Options(data_dir=copy, device=SIM_DEVICE))
    store_open = time.perf_counter() - t0
    real_encode = SIM.encode_snapshot
    marks, captured = {}, []
    svc = runtime.solver_service

    def encode(*args, **kwargs):
        out = real_encode(*args, **kwargs)
        marks["encoded"] = time.perf_counter()
        return out

    def solver(inputs):
        t = time.perf_counter()
        out = svc.solve(inputs)
        marks["solved"] = time.perf_counter()
        marks["solve"] = marks["solved"] - t
        captured.append(inputs)
        return out

    try:
        resolver = runtime.producer_factory.template_resolver()
        SIM.encode_snapshot = encode
        try:
            TF.reset_launch_counts()
            t = time.perf_counter()
            got = SIM.simulate(runtime.store, solver=solver,
                               template_resolver=resolver,
                               cost_model=runtime.cost_model)
            end = time.perf_counter()
            launches = dict(TF.LAUNCHES)
        finally:
            SIM.encode_snapshot = real_encode
        need(launches == {"fused_assign": 1, "shelf_bfd": 1,
                          "demand_reduce": 0, "pack_bits": 1},
             f"the dry run launched {launches}")
        need(got == plain, "the in-process dry run != the binary's report")
        split = {
            "store open": store_open,
            "encode (pods, snapshot, census, operands)": marks["encoded"] - t,
            "service.solve": marks["solve"],
            "report assembly": end - marks["solved"],
        }
        report(f"dry run in process on the card: launches {launches}; "
               f"host split (s) {split}, simulate() {end - t} s")
        TF.reset_launch_counts()
        got_delta = SIM.simulate_delta(
            runtime.store, workloads.what_if_specs(), solver=svc.solve,
            template_resolver=resolver, cost_model=runtime.cost_model)
        what_if_launches = dict(TF.LAUNCHES)
        need(what_if_launches == {"fused_assign": 2, "shelf_bfd": 2,
                                  "demand_reduce": 0, "pack_bits": 2},
             f"the what-if delta launched {what_if_launches}")
        need(got_delta == delta, "the in-process delta != the binary's")
        inputs = captured[0]
        ms = _kernel_ms(torch, lambda: svc.solve(inputs))
        report(f"what-if delta in process: launches {what_if_launches}; "
               f"device ms per launch at the dry run's shapes "
               f"({inputs.pod_requests.shape[0]} rows x "
               f"{inputs.group_allocatable.shape[0]} groups): {ms}")
        return {"launches": launches, "what_if_launches": what_if_launches,
                "ms": ms, "split": split}
    finally:
        runtime.close()


def _rollout_equal(got, want, what, index=None) -> None:
    for name in ("replicas", "streak", "violation", "cost", "backlog",
                 "target"):
        a = np.asarray(getattr(got, name))
        b = np.asarray(getattr(want, name))
        if index is not None:
            a = a[index]
        need(a.shape == b.shape and a.tobytes() == b.tobytes(),
             f"{what}: field {name} differs")


def _sim_batch(torch, SK, svc, workloads):
    """(c) bench.py's 256 x 64 x 8 cost-theme rollout through
    SolverService().sim_rollout: == the numpy mirror, sampled clusters
    unbatched == their rows, no mirror serve; batched and sequential
    timed in turns."""
    from karpenter_tpu_torch.simlab import BatchedSimEnv
    from karpenter_tpu_torch.simlab.policy import FROZEN_KNOBS

    c, t, r = SIM_BATCH["clusters"], SIM_BATCH["ticks"], SIM_BATCH["rows"]
    env = BatchedSimEnv(workloads.simlab_trails(t, r), clusters=c, seed=0,
                        service=svc)
    p = env.params
    inputs = SK.SimRolloutInputs(
        replicas0=np.asarray(env.trails.replicas0, np.float32),
        streak0=np.zeros((c, r), np.float32),
        demand=env.trails.demand, forecast=env.trails.forecast,
        price=env.trails.price, fault=env.trails.fault,
        knobs=np.broadcast_to(FROZEN_KNOBS, (c, 3)).copy(),
        cap=np.float32(p.cap), hourly=np.float32(p.hourly),
        step_limit=np.float32(p.step_limit),
        min_replicas=np.float32(p.min_replicas),
        max_replicas=np.float32(p.max_replicas),
    )
    batched = svc.sim_rollout(inputs)
    _rollout_equal(batched, SK.sim_rollout_numpy(inputs),
                   "batched rollout vs the numpy mirror")
    slices = [SK._cluster_slice(inputs, b) for b in range(c)]
    for b in SIM_SAMPLED:
        _rollout_equal(batched, svc.sim_rollout(slices[b]),
                       f"cluster {b} unbatched vs its batch row", index=b)
    need(svc.stats.sim_mirror_serves == 0, "the mirror served on the card")
    batched_ms, seq_ms = [], []
    for _ in range(SIM_TURNS):
        t0 = time.perf_counter()
        svc.sim_rollout(inputs)
        batched_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for one in slices:
            svc.sim_rollout(one)
        seq_ms.append((time.perf_counter() - t0) * 1e3)
    need(svc.stats.sim_mirror_serves == 0, "the mirror served on the card")
    b50, s50 = np.percentile(batched_ms, 50), np.percentile(seq_ms, 50)
    days = c * t * 10.0 / 86_400.0
    report(f"SimLab {c} clusters x {t} ticks x {r} rows (cost theme): "
           f"batched == numpy mirror bitwise on every field, clusters "
           f"{SIM_SAMPLED} unbatched == their rows, no mirror serve; "
           f"batched p50 {b50} ms p95 {np.percentile(batched_ms, 95)} ms, "
           f"sequential p50 {s50} ms p95 {np.percentile(seq_ms, 95)} ms "
           f"({SIM_TURNS} turns), {s50 / b50}x; "
           f"{days / (b50 / 1e3) * 60.0} cluster-days per minute at a 10 s "
           f"tick")
    return {"batched_p50_ms": float(b50), "sequential_p50_ms": float(s50)}


def _sim_real(torch, SK, svc, workloads):
    """(d) 4,096 clusters x 1,440 ticks x 8 rows: sampled clusters ==
    the numpy mirror, p50 through the service and of the program alone,
    device kernels and busy time per rollout, peak device memory."""
    t0 = time.perf_counter()
    fields = workloads.build_sim_rollout_inputs(**SIM_REAL)
    host = SK.SimRolloutInputs(**fields)
    made = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = svc.sim_rollout(host)
    peak = torch.cuda.max_memory_allocated()
    b = SIM_REAL["clusters"]
    for i in (0, b // 2, b - 1):
        _rollout_equal(out, SK.sim_rollout_numpy(SK._cluster_slice(host, i)),
                       f"cluster {i} of {b} vs the numpy mirror", index=i)
    times = []
    for _ in range(SIM_REAL_ITERS):
        t1 = time.perf_counter()
        svc.sim_rollout(host)
        times.append((time.perf_counter() - t1) * 1e3)
    dev = SK.SimRolloutInputs.from_numpy(fields, SIM_DEVICE)
    alone = host_ms(torch, lambda: SK.sim_rollout(dev), SIM_REAL_ITERS)
    per_call = profile_per_call(torch, lambda: SK.sim_rollout(dev), n=1)
    need(svc.stats.sim_mirror_serves == 0, "the mirror served on the card")
    nbytes = sum(np.asarray(v).nbytes for v in fields.values()) + sum(
        np.asarray(getattr(out, f)).nbytes
        for f in ("replicas", "streak", "violation", "cost", "backlog",
                  "target"))
    report(f"SimLab {SIM_REAL}: drawn in {made} s; clusters 0, {b // 2}, "
           f"{b - 1} == the numpy mirror bitwise; through the service p50 "
           f"{np.percentile(times, 50)} ms ({SIM_REAL_ITERS} calls, upload "
           f"and fetch of {nbytes / 1e9} GB included); the program alone "
           f"p50/p95 {alone} ms; device ops, kernels, busy us per rollout "
           f"{per_call}; peak allocated {peak / 2**30} GiB; "
           f"{b * SIM_REAL['ticks'] * 60.0 / 86_400.0 / (np.percentile(times, 50) / 6e4)} "
           f"cluster-days per minute at a 60 s tick")
    return {"p50_ms": float(np.percentile(times, 50)), "alone": alone,
            "per_call": per_call, "peak_gib": peak / 2**30}


def _sim_search_and_gym(torch, svc, S, GaugeRegistry):
    """(e) search_tuned_policy on the cost scenario's trails at the
    default seed, card == CPU == the pinned reference; a 64-tick batched
    gym loop over 256 clusters, card == CPU every tick."""
    from karpenter_tpu_torch.simlab import BatchedSimEnv, get_scenario
    from karpenter_tpu_torch.simlab.policy import search_tuned_policy

    trails = get_scenario("cost").trails
    cpu = S.SolverService(registry=GaugeRegistry(), device="cpu")
    try:
        t0 = time.perf_counter()
        card_result = search_tuned_policy(trails, seed=0, service=svc)
        card_s = time.perf_counter() - t0
        cpu_result = search_tuned_policy(trails, seed=0, service=cpu,
                                         backend="torch")
        need(card_result.rewards == cpu_result.rewards,
             "search rewards: the card's differ from the CPU's")
        got = dict(
            knobs=tuple(float(k) for k in card_result.knobs),
            reward=card_result.reward, baseline=card_result.baseline_reward,
            candidates=card_result.candidates,
            rewards_crc=_report_crc(sorted(
                (list(k), v) for k, v in card_result.rewards.items())),
        )
        need(got == SEARCH_PIN, f"search {got}, the reference's {SEARCH_PIN}")
        envs = [BatchedSimEnv(trails, clusters=SIM_GYM["clusters"], seed=0,
                              service=service, backend=backend)
                for service, backend in ((svc, None), (cpu, "torch"))]
        cap = np.float32(envs[0].params.cap)
        t1 = time.perf_counter()
        for t in range(SIM_GYM["ticks"]):
            obs = envs[0]._obs()
            # the reactive target on even ticks, one replica over it on odd
            action = None if t % 2 == 0 else (
                np.ceil(obs["demand"] / cap) + np.float32(1.0))
            steps = [env.step(action) for env in envs]
            (card_obs, card_r, _, _), (cpu_obs, cpu_r, _, _) = steps
            need(card_r.tobytes() == cpu_r.tobytes()
                 and card_obs["replicas"].tobytes()
                 == cpu_obs["replicas"].tobytes(),
                 f"gym tick {t}: the card's step differs from the CPU's")
        gym_s = time.perf_counter() - t1
        need(svc.stats.sim_mirror_serves == 0, "the mirror served on the card")
        report(f"search_tuned_policy (cost scenario, seed 0) on the card "
               f"in {card_s} s: winner {got['knobs']} reward {got['reward']} "
               f"over the reactive {got['baseline']}, {got['candidates']} "
               f"candidates in 2 dispatches, every reward == the CPU's and "
               f"the reference's; {SIM_GYM['ticks']}-tick gym loop over "
               f"{SIM_GYM['clusters']} clusters card == CPU every tick "
               f"({gym_s} s for both)")
    finally:
        cpu.close()


def _sim_failure_policy(SK, S, GaugeRegistry, workloads):
    """(f) Under a simlab.step error plan the card's sim_step and
    sim_rollout raise the injected error with no mirror serve; the FSM
    degrades and the next call raises SolverDeviceError; with the plan
    cleared the probe (on an injected clock) heals it."""
    from karpenter_tpu_torch import faults

    fields = workloads.build_sim_rollout_inputs(4, 16, 8, 1)
    rollout = SK.SimRolloutInputs(**fields)
    scalars = {k: fields[k] for k in ("cap", "hourly", "step_limit",
                                      "min_replicas", "max_replicas")}
    step = SK.SimStepInputs(
        replicas=fields["replicas0"], target=fields["demand"][:, 0],
        demand=fields["demand"][:, 0], price=fields["price"][:, 0],
        fault=fields["fault"][:, 0], **scalars,
    )
    clock = _RunningClock()
    svc = S.SolverService(registry=GaugeRegistry(), clock=clock,
                          health_failure_threshold=2,
                          health_probe_interval_s=30.0, device=SIM_DEVICE)
    try:
        raised = []
        with faults.injected_faults(seed=14) as reg:
            reg.plan("simlab.step", mode="error")
            for call in (lambda: svc.sim_step(step),
                         lambda: svc.sim_rollout(rollout),
                         lambda: svc.sim_rollout(rollout)):
                try:
                    call()
                    raised.append(None)
                except Exception as exc:  # noqa: BLE001 — the policy under test
                    raised.append(type(exc).__name__)
        need(raised == ["FaultInjected", "FaultInjected", "SolverDeviceError"],
             f"under the plan the sim family raised {raised}")
        need(svc.stats.sim_mirror_serves == 0, "the mirror served on the card")
        need(svc.backend_health() == "degraded", "FSM not degraded")
        clock.offset += 31.0
        healed = svc.sim_rollout(rollout)
        need(svc.backend_health() == "healthy", "the probe did not heal")
        _rollout_equal(healed, SK.sim_rollout_numpy(rollout),
                       "the probe's rollout vs the numpy mirror")
        print(f"sim failure policy: under a simlab.step error plan the card "
              f"raised {raised}, no mirror serve; the probe healed the FSM "
              f"(trips {svc.stats.fsm_trips}, recoveries "
              f"{svc.stats.fsm_recoveries})", flush=True)
    finally:
        svc.close()


def phase_simulate(torch, TF, workloads):
    """Phase 14: the --simulate entry point (the binary's dry run, what-if
    and consolidation reports) and SimLab's sim families on the card."""
    import shutil
    import tempfile

    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.ops import simstep as SK
    from karpenter_tpu_torch.solver import service as S

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="karpenter-simulate-")
    try:
        plain, delta, consolidate = _simulate_cli(torch, TF, workloads, root)
        t1 = time.perf_counter()
        dry_run = _simulate_in_process(torch, TF, workloads, root, plain,
                                       delta)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t2 = time.perf_counter()
    report(f"phase 14 (a), (b): {t2 - t0} s ({t1 - t0} s of it the data "
           f"dirs, the five --simulate processes and the card's "
           f"consolidation)")
    svc = S.SolverService(registry=GaugeRegistry(), device=SIM_DEVICE)
    try:
        batch = _sim_batch(torch, SK, svc, workloads)
        real = _sim_real(torch, SK, svc, workloads)
        _sim_search_and_gym(torch, svc, S, GaugeRegistry)
        need(svc.stats.sim_mirror_serves == 0 and svc.stats.fallbacks == 0,
             "the card's service answered from numpy")
    finally:
        svc.close()
    _sim_failure_policy(SK, S, GaugeRegistry, workloads)
    report(f"phase 14 (c)-(f): {time.perf_counter() - t2} s")
    return {"dry_run": dry_run, "consolidate": consolidate, "batch": batch,
            "real": real, "groups": plain["groups"]}


# -- phase 15: real-cluster mode (store/kube.py, webhook.py) -------------------

# (a) phase 9's cluster served by a fake kube-apiserver, plus node groups
# an autoscaler scales (they select no pod and no node: the totals stay
# phase 9's)
KUBE_SHAPE = dict(pods=100_000, types=300, seed=0, node_groups=4)
KUBE_TICKS = 3  # timed churned ticks; one more runs under the profiler
# what `--profile production` sets
KUBE_OPTIONS = dict(fused_tick=True, event_driven=True, prewarm_compile=True)
KUBE_DEVICE = None  # Options.device of the card runtime: the card
KUBE_TIMEOUT_S = 60.0  # the client's socket timeout (a 5,000-pod page)
# (b) the binaries' world, and their extra flags (none: they run on the card)
KUBE_BINARY_SHAPE = dict(pods=10_000, types=300, seed=0)
KUBE_BINARY_ARGS = ()
KUBE_LEASE_S = 15.0  # LeaderElector's default lease duration
KUBE_SKEW_S = 1.0  # and its skew tolerance


class _KubeTimers:
    """Host time of a card runtime's real-cluster work while `on`: the
    watch events' decode on its store's informer threads, their mirror
    apply (with the PendingFeed's and the Manager's watch callbacks), the
    encode, service.solve, the status patches over HTTP and every REST
    request its client sends (counted)."""

    def __init__(self, runtime, store):
        import threading

        from karpenter_tpu_torch.metrics.producers import pendingcapacity as PC
        from karpenter_tpu_torch.store import kube as K

        self.on = False
        self.parts = {}
        self.requests = 0
        self._undo = []
        informers = store._threads

        def add(label, dt):
            if self.on:
                self.parts[label] = self.parts.get(label, 0.0) + dt

        def timed(real, label, when=lambda: True):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    if when():
                        add(label, time.perf_counter() - t0)
            return wrapper

        def patch(owner, attr, wrapper):
            self._undo.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, wrapper)

        patch(K, "decode_from_read", timed(
            K.decode_from_read, "watch decode",
            lambda: threading.current_thread() in informers))
        patch(store, "_apply", timed(store._apply, "mirror apply"))
        patch(PC, "encode_snapshot", timed(PC.encode_snapshot, "encode"))
        factory = runtime.producer_factory
        timed_solver = timed(factory.solver, "service.solve")
        self.inputs = None

        def solver(inputs, *args, **kwargs):
            self.inputs = inputs  # the last solve's operands
            return timed_solver(inputs, *args, **kwargs)

        patch(factory, "solver", solver)
        client = store.client
        patch(client, "patch_status", timed(client.patch_status,
                                            "status patches (HTTP)"))
        real_request = client._request

        def counted(*args, **kwargs):
            if self.on:
                self.requests += 1
            return real_request(*args, **kwargs)

        patch(client, "_request", counted)

    def take(self):
        parts, requests = self.parts, self.requests
        self.parts, self.requests = {}, 0
        return parts, requests

    def remove(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)


def _fake_apiserver():
    """tests/fake_apiserver.py's FakeApiServer, loaded from its file (a
    `tests` package installed elsewhere may shadow the repo's)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fake_apiserver.py")
    spec = importlib.util.spec_from_file_location("fake_apiserver", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FakeApiServer


def _free_port() -> int:
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _kube_runtime(server, device, clock, node_replicas):
    """(runtime, store, sync s, boot s): a KubeStore over `server` (its
    constructor relists every watched kind), then KarpenterRuntime over
    it on `device` with --profile production's options."""
    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.store.kube import KubeClient, KubeStore

    t0 = time.perf_counter()
    store = KubeStore(KubeClient(server.url, timeout=KUBE_TIMEOUT_S))
    synced = time.perf_counter() - t0
    provider = FakeFactory()
    provider.node_replicas.update(node_replicas)
    try:
        t0 = time.perf_counter()
        runtime = KarpenterRuntime(
            Options(device=device, **KUBE_OPTIONS), store=store,
            cloud_provider_factory=provider, clock=clock,
        )
        return runtime, store, synced, time.perf_counter() - t0
    except BaseException:
        store.close()
        raise


def _kube_settle(workloads, server, store, rv) -> float:
    """Seconds until the mirror holds exactly the server's pods at the
    churn's last resourceVersion and every producer, node group and
    autoscaler at the server's version (the autoscalers' scale writes of
    the last tick reach the mirror only through the watch)."""
    return workloads.wait_mirrored(server, store, rv) + sum(
        workloads.wait_mirrored(server, store, kind=kind)
        for kind in ("MetricsProducer", "ScalableNodeGroup",
                     "HorizontalAutoscaler"))


def _kube_documents(workloads, server) -> dict:
    return {plural: workloads.server_documents(server, plural)
            for plural in ("metricsproducers", "scalablenodegroups",
                           "horizontalautoscalers")}


def _kube_same(workloads, card_server, cpu_server, tick) -> int:
    """The documents both fakes hold are equal; returns their count."""
    card, cpu = (_kube_documents(workloads, s)
                 for s in (card_server, cpu_server))
    for plural, want in card.items():
        got = cpu[plural]
        need(got.keys() == want.keys(), f"tick {tick}: the fakes hold "
             f"different {plural}")
        diff = [k for k, v in want.items() if got[k] != v]
        need(not diff, f"tick {tick}: {len(diff)} {plural} differ between "
             f"the card's and the CPU's runtime, e.g. {diff[:3]}")
    return sum(len(v) for v in card.values())


def _kube_dry_run(torch, TF, url, pins):
    """(c) `--simulate --apiserver URL` through the binary's main() in
    this process: (report, launches, wall s)."""
    import contextlib
    import io

    from karpenter_tpu_torch import __main__ as CLI

    argv = ["--simulate", "--apiserver", url, "--kube-insecure"]
    if KUBE_DEVICE == "cpu":
        argv += ["--device", "cpu"]
    out = io.StringIO()
    torch.cuda.synchronize()
    TF.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = CLI.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(TF.LAUNCHES)
    need(rc == 0, f"--simulate --apiserver exited {rc}")
    got = json.loads(out.getvalue())
    need(launches == {"fused_assign": 1, "shelf_bfd": 1, "demand_reduce": 0,
                      "pack_bits": 1},
         f"--simulate --apiserver launched {launches}")
    totals = _dry_run_totals(got)
    want = {k: pins[k] for k in totals}
    need(totals == want, f"--simulate --apiserver totals {totals}, the "
         f"--data-dir dry run's {want}")
    return got, launches, wall


def _kube_production(torch, TF, workloads, dry_groups):
    """(a) the card runtime and a CPU runtime over two fakes seeded
    alike, ticked in lockstep; (c) the dry run over the card's fake."""
    from karpenter_tpu_torch.solver.service import HEALTHY

    FakeApiServer = _fake_apiserver()
    servers = [FakeApiServer(), FakeApiServer()]
    runtimes, stores, timers = [], [], None
    for server in servers:
        server.start()
    try:
        t0 = time.perf_counter()
        cluster = workloads.build_kube_world(servers, **KUBE_SHAPE)
        report(f"kube world {KUBE_SHAPE}: drawn and seeded into two fakes "
               f"in {time.perf_counter() - t0} s (host)")
        clock = _StepClock()
        synced = []
        for device in (KUBE_DEVICE, "cpu"):
            runtime, store, sync_s, boot_s = _kube_runtime(
                servers[len(runtimes)], device, clock, cluster.node_replicas)
            runtimes.append(runtime)
            stores.append(store)
            pods = len(store.keys("Pod"))
            need(pods == KUBE_SHAPE["pods"], f"the mirror holds {pods} pods")
            synced.append(sync_s)
            report(f"KubeStore initial sync ({'card' if device != 'cpu' else 'CPU'}"
                   f" runtime's): {pods} pods + {KUBE_SHAPE['types']} nodes "
                   f"and producers mirrored in {sync_s} s (chunked LIST of "
                   f"{stores[-1].client.list_chunk_size}, decode, mirror "
                   f"apply); KarpenterRuntime(Options({KUBE_OPTIONS})) built "
                   f"in {boot_s} s (prewarm included)")
        card, cpu = runtimes
        svc = card.solver_service
        need(svc.device.type == "cuda" or KUBE_DEVICE == "cpu",
             f"the card runtime's service on {svc.device}")
        timers = _KubeTimers(card, stores[0])
        slices = _TickTimers(card)

        # the first tick, on each runtime alone
        torch.cuda.synchronize()
        TF.reset_launch_counts()
        timers.on = True
        t0 = time.perf_counter()
        card.manager.reconcile_all()
        first_ms = (time.perf_counter() - t0) * 1e3
        locks = [_settled(card.manager)]
        timers.on = False
        first_parts, first_requests = timers.take()
        first_slices = slices.take()
        first_launches = dict(TF.LAUNCHES)
        need(first_launches == {"fused_assign": 1, "shelf_bfd": 1,
                                "demand_reduce": 0, "pack_bits": 1},
             f"the first tick launched {first_launches}")
        producers = [stores[0].get("MetricsProducer", "default", f"mp{g}")
                     for g in range(KUBE_SHAPE["types"])]
        totals = _totals(producers)
        need(totals == RECONCILE_TOTALS,
             f"first tick totals {totals} != {RECONCILE_TOTALS}")
        cpu.manager.reconcile_all()
        locks.append(_settled(cpu.manager))
        n_docs = _kube_same(workloads, *servers, 0)
        report(f"kube first tick on the card: {first_ms} ms; launches "
               f"{first_launches}; totals {totals} (the reference's); "
               f"{n_docs} documents on the fakes == the CPU runtime's; "
               f"split (ms) " + ", ".join(
                   f"{k} {v * 1e3}" for k, v in first_parts.items())
               + f"; {first_requests} REST requests; controller slices "
               f"(ms; tick thread, event thread) "
               + ", ".join(f"{k} {v * 1e3}" for part in first_slices
                           for k, v in part.items()))

        # (c) while both runtimes hold their pass locks: the dry run over
        # the card's fake, still the unchurned cluster
        dry, dry_launches, dry_wall = _kube_dry_run(
            torch, TF, servers[0].url, SIMULATE_PINS)
        need(dry["groups"] == dry_groups
             and dry["unschedulable_pods"] == SIMULATE_PINS["unschedulable"],
             "--simulate --apiserver groups != the --data-dir dry run's")
        report(f"--simulate --apiserver over the 100k-pod fake (main() in "
               f"process, its own KubeStore): {dry_wall} s wall; totals "
               f"{_dry_run_totals(dry)} and every group == the --data-dir "
               f"dry run's; launches {dry_launches}")

        rows = []
        profile = None
        for t in range(1, KUBE_TICKS + 2):
            profiled = t == KUBE_TICKS + 1
            clock.now += RUNTIME_TICK_S
            pairs = workloads.churn_pods(cluster, RECONCILE_CHURN)
            torch.cuda.synchronize()
            TF.reset_launch_counts()
            timers.take()
            timers.on = True
            t0 = time.perf_counter()
            rv = workloads.apply_churn(servers[0], pairs)
            t1 = time.perf_counter()
            lag = _kube_settle(workloads, servers[0], stores[0], rv)
            if profiled:
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as torch_profile

                # started while the pass lock is held: the event thread's
                # pass cannot solve before the profiler records
                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
                    t2 = time.perf_counter()
                    locks[0].release()
                    card.manager.reconcile_all()
                    t3 = time.perf_counter()
                    locks[0] = _settled(card.manager)
                    torch.cuda.synchronize()
            else:
                t2 = time.perf_counter()
                locks[0].release()
                card.manager.reconcile_all()
                t3 = time.perf_counter()
                locks[0] = _settled(card.manager)
            t4 = time.perf_counter()
            timers.on = False
            launches = dict(TF.LAUNCHES)
            parts, requests = timers.take()
            for part in slices.take():
                for k, v in part.items():
                    parts[k] = parts.get(k, 0.0) + v
            need(launches == {"fused_assign": 1, "shelf_bfd": 1,
                              "demand_reduce": 0, "pack_bits": 1},
                 f"churned tick {t} launched {launches}")
            rv = workloads.apply_churn(servers[1], pairs)
            _kube_settle(workloads, servers[1], stores[1], rv)
            locks[1].release()
            cpu.manager.reconcile_all()
            locks[1] = _settled(cpu.manager)
            n_docs = _kube_same(workloads, *servers, t)
            row = dict(tick=(t1 - t0 + lag + t3 - t2) * 1e3,
                       write=(t1 - t0) * 1e3, lag=lag * 1e3,
                       reconcile=(t3 - t2) * 1e3, settled=(t4 - t2) * 1e3,
                       parts=parts, requests=requests, launches=launches)
            print(f"kube churned tick {t}: " + ", ".join(
                f"{k} {v}" for k, v in row.items()), flush=True)
            if profiled:
                profile = _kube_profile(torch, prof, (t4 - t2) * 1e3)
                report(f"kube profiled churned tick: {row['tick']} ms "
                       f"(profiler on; not in the percentiles), launches "
                       f"{launches}, card == CPU on {n_docs} documents")
            else:
                rows.append(row)
        ticks = [r["tick"] for r in rows]
        report(f"kube churned tick (churn_apiserver of {RECONCILE_CHURN} "
               f"pods -> the mirror settles -> reconcile_all, host clock) "
               f"over {KUBE_TICKS} ticks: p50={np.percentile(ticks, 50)} ms "
               f"p95={np.percentile(ticks, 95)} ms; launches per tick "
               f"{[r['launches'] for r in rows]}; the card's documents == "
               f"the CPU runtime's after every tick ({n_docs} documents)")
        for key, label in (("write", "churn writes to the fake"),
                           ("lag", "watch lag to quiescence"),
                           ("reconcile", "reconcile_all"),
                           ("settled", "reconcile_all to settled")):
            v = [r[key] for r in rows]
            report(f"  {label}: ms per tick (median / max) "
                   f"{np.median(v)} / {max(v)}")
        labels = sorted({k for r in rows for k in r["parts"]})
        for label in labels:
            v = [r["parts"].get(label, 0.0) * 1e3 for r in rows]
            report(f"  {label}: ms per tick (median / max) "
                   f"{np.median(v)} / {max(v)}")
        report(f"  HTTP requests per tick (the card runtime's client, "
               f"watch streams aside): {[r['requests'] for r in rows]}")
        # the cuda rung's own call on the last tick's operands, launched
        # from this thread: in the full smoke the profiler dropped some
        # kernels launched by the service's worker thread
        from karpenter_tpu_torch.ops import binpack as TB

        inputs = timers.inputs
        ms = _kernel_ms(torch, lambda: TB.solve(inputs, backend="cuda"))
        need(all(ms.values()), f"no device time per launch: {ms}")
        report(f"  device ms per launch at the churned tick's operands "
               f"({inputs.pod_requests.shape[0]} rows x "
               f"{inputs.group_allocatable.shape[0]} groups, "
               f"solve(backend='cuda') as the service's cuda rung calls "
               f"it): {ms}")
        st = svc.stats
        need(st.fallbacks == 0, f"{st.fallbacks} numpy answers on the card")
        need(svc.backend_health() == HEALTHY, f"FSM {svc.backend_health()}")
        return {"first_launches": first_launches, "ms": ms,
                "launches_per_tick": {name: [r["launches"][name]
                                             for r in rows]
                                      for name in TF.LAUNCHES},
                "p50_ms": float(np.percentile(ticks, 50)),
                "sync_s": synced[0], "profile": profile,
                "dry_launches": dry_launches}
    finally:
        if timers is not None:
            timers.remove()
            slices.remove()
        for runtime in runtimes:
            runtime.close()
        for store in stores:
            store.close()
        for server in servers:
            server.stop()


def _kube_profile(torch, prof, wall_ms):
    """The device rows of a profiled churned tick: busy us and kernels,
    the largest rows printed."""
    rows = device_rows(torch, prof)
    need(rows, "the profiler shows no device rows for the kube tick")
    busy_us = sum(r[0] for r in rows)
    kernels = sum(c for _, c, k in rows
                  if not k.startswith(("Memcpy", "Memset")))
    # a lower bound: in the full smoke the profiler dropped some kernels
    # the service's worker thread launched
    report(f"kube profiled tick: device busy at least {busy_us} us "
           f"({100.0 * busy_us / (wall_ms * 1e3)}% of the tick's "
           f"{wall_ms} ms), {kernels} device kernels seen")
    for dev_us, count, key in rows[:6]:
        report(f"  device {dev_us} us  x{count}  {key[:90]}")
    return {"busy_us": busy_us, "kernels": kernels}


def _admission_reviews():
    """Valid and invalid HorizontalAutoscaler and MetricsProducer
    AdmissionReviews."""
    def review(uid, obj):
        return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                "request": {"uid": uid, "operation": "CREATE",
                            "object": obj}}

    def ha(lo, hi):
        return {"apiVersion": "autoscaling.karpenter.sh/v1alpha1",
                "kind": "HorizontalAutoscaler",
                "metadata": {"name": "web", "namespace": "default"},
                "spec": {"scaleTargetRef": {
                    "apiVersion": "autoscaling.karpenter.sh/v1alpha1",
                    "kind": "ScalableNodeGroup", "name": "ng0"},
                    "minReplicas": lo, "maxReplicas": hi}}

    def mp(weekday):
        return {"apiVersion": "autoscaling.karpenter.sh/v1alpha1",
                "kind": "MetricsProducer",
                "metadata": {"name": "mp", "namespace": "default"},
                "spec": {"scheduleSpec": {
                    "timezone": "America/Los_Angeles", "defaultReplicas": 1,
                    "behaviors": [{"replicas": 5,
                                   "start": {"weekdays": weekday,
                                             "hours": "9"},
                                   "end": {"weekdays": weekday,
                                           "hours": "17"}}]}}}

    return {"ha valid": (review("u1", ha(1, 10)), True),
            "ha min > max": (review("u2", ha(9, 2)), False),
            "mp valid": (review("u3", mp("Mon,Tue")), True),
            "mp bad cron": (review("u4", mp("Blursday")), False)}


def _post_json(port, path, body):
    import urllib.request

    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=30) as response:
        return json.loads(response.read())


def _kube_binaries(workloads):
    """(b) two `python -m karpenter_tpu_torch --apiserver URL --leader-elect
    --webhook-port P` against one fake: one leader writes, SIGTERM hands
    over within the lease, the webhooks answer as the CPU's handlers do,
    and with the card hidden the command exits before any watch."""
    from karpenter_tpu_torch import webhook

    server = _fake_apiserver()()
    server.start()
    binaries = []
    try:
        t0 = time.perf_counter()
        workloads.build_kube_world([server], **KUBE_BINARY_SHAPE)
        report(f"binary kube world {KUBE_BINARY_SHAPE} seeded in "
               f"{time.perf_counter() - t0} s")
        base = ["--apiserver", server.url, "--kube-insecure",
                "--leader-elect", "--cloud-provider", "fake",
                "--metrics-port", "0", "--tick", "0.1"]
        common = base + list(KUBE_BINARY_ARGS)
        hooks = [_free_port(), _free_port()]
        for port in hooks:
            binaries.append(_Binary(common + ["--webhook-port", str(port)]))
        for binary in binaries:
            binary.wait_serving(300)
        ready = [b.started for b in binaries]

        def ticked(binary):
            status, text = binary.get("/metrics")
            return status == 200 and _metric(
                text, "karpenter_runtime_tick_seconds", "manager") is not None

        def all_statuses():
            return all(d.get("status", {}).get("pendingCapacity")
                       for d in server.objects("metricsproducers"))

        deadline = time.perf_counter() + 180
        while not (any(ticked(b) for b in binaries) and all_statuses()):
            need(time.perf_counter() < deadline,
                 "no binary wrote every producer's status")
            time.sleep(0.2)
        leaders = [b for b in binaries if ticked(b)]
        need(len(leaders) == 1, f"{len(leaders)} binaries tick")
        leader = leaders[0]
        standby = binaries[1 - binaries.index(leader)]
        (lease,) = server.objects("leases")
        holder = lease["spec"]["holderIdentity"]
        status, text = standby.get("/metrics")
        idle = _metric(text, "karpenter_solver_requests_total") or 0.0
        need(idle == 0, f"the standby sent {idle} solves")
        lead_line = [x for x in leader.lines if "solver device:" in x]
        report(f"binaries: both serving after {[time.perf_counter() - s for s in ready]}"
               f" s; one leader ({holder}, {lead_line}) wrote all "
               f"{KUBE_BINARY_SHAPE['types']} producers' statuses, the "
               f"standby ticked nothing")
        answers = {}
        for label, (body, allowed) in _admission_reviews().items():
            want = (webhook.review_validate(body), webhook.review_mutate(body))
            for port in hooks:
                got = (_post_json(port, "/validate", body),
                       _post_json(port, "/mutate", body))
                need(got == want, f"webhook :{port} {label}: {got} != {want}")
            need(want[0]["response"]["allowed"] is allowed,
                 f"{label}: allowed {want[0]['response']['allowed']}")
            answers[label] = want[0]["response"]["allowed"]
        print(f"webhooks on both binaries == review_validate / review_mutate "
              f"on the CPU: {answers}", flush=True)
        rvs = {d["metadata"]["name"]: int(d["metadata"]["resourceVersion"])
               for d in server.objects("metricsproducers")}
        t0 = time.perf_counter()
        rc = leader.stop()
        stop_s = time.perf_counter() - t0
        need(rc == 0, f"the leader exited {rc} on SIGTERM")
        deadline = t0 + KUBE_LEASE_S + KUBE_SKEW_S + 30
        while True:
            (lease,) = server.objects("leases")
            if lease["spec"]["holderIdentity"] not in ("", holder):
                break
            need(time.perf_counter() < deadline, "the standby never took "
                 "the lease")
            time.sleep(0.05)
        takeover_s = time.perf_counter() - t0
        need(takeover_s <= KUBE_LEASE_S + KUBE_SKEW_S + 1.0,
             f"the standby took the lease {takeover_s} s after SIGTERM")
        deadline = time.perf_counter() + 120
        while True:
            status, text = standby.get("/metrics")
            solves = _metric(text, "karpenter_solver_requests_total") or 0.0
            rewritten = all(
                int(d["metadata"]["resourceVersion"]) > rvs[d["metadata"]["name"]]
                for d in server.objects("metricsproducers"))
            if ticked(standby) and solves > 0 and rewritten:
                break
            need(time.perf_counter() < deadline, "the new leader did not "
                 "tick")
            time.sleep(0.1)
        fallbacks = _metric(text, "karpenter_solver_fallback_total") or 0.0
        need(fallbacks == 0, f"the new leader answered {fallbacks} from numpy")
        report(f"leader SIGTERM -> exit 0 in {stop_s} s; the standby took "
               f"the lease {takeover_s} s after SIGTERM (lease "
               f"{KUBE_LEASE_S} s + skew {KUBE_SKEW_S} s) and ticked: "
               f"{solves} solves through its card service, every producer "
               f"rewritten, no fallback")
        rc = standby.stop()
        need(rc == 0, f"the new leader exited {rc} on SIGTERM")
        pages, watchers = server.list_pages_served, len(server._watchers)
        hidden = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        binary = _Binary(base + ["--webhook-port", str(_free_port())],
                         env=hidden)
        rc = binary.proc.wait(timeout=300)
        binary.reader.join(timeout=10)
        need(rc == 1, f"with the card hidden the binary exited {rc}")
        need(any("CUDA device requested" in x for x in binary.lines),
             f"no reason given with the card hidden: {binary.lines[-3:]}")
        need(server.list_pages_served == pages
             and len(server._watchers) == watchers,
             "the binary listed or watched with the card hidden")
        print(f"binary --apiserver with CUDA_VISIBLE_DEVICES=\"\": exit 1 "
              f"before any LIST or watch", flush=True)
    finally:
        for binary in binaries:
            binary.stop()
        server.stop()


def _kube_binaries_child(workloads, out_dir: str) -> None:
    """(b) in a child."""
    t0 = time.perf_counter()
    _kube_binaries(workloads)
    report(f"phase 15 (b), beside (a): {time.perf_counter() - t0} s")


def phase_kube(torch, TF, workloads, simulate):
    """Phase 15: real-cluster mode on the card. (b), two binaries over a
    fake of their own, runs in a child process beside (a) and (c)."""
    t0 = time.perf_counter()
    binaries = _Child("_kube_binaries_child")
    try:
        out = _kube_production(torch, TF, workloads, simulate["groups"])
        report(f"phase 15 (a), (c): {time.perf_counter() - t0} s")
        binaries.join()
    finally:
        binaries.close()
    report(f"phase 15: {time.perf_counter() - t0} s")
    return out


# -- phase 16: the shipped Deployment (solver sidecar + GKE TPU provider) -----

# (a) phase 15's draws in an in-process Store, plus workloads.TPU_POOLS
DEPLOY_SHAPE = dict(pods=100_000, types=300, seed=0)
DEPLOY_TPU_PODS = 24  # pending TPU pods per pool, times (pool index + 1)
DEPLOY_TICKS = 3  # churned ticks after the first
DEPLOY_TWIN_TICKS = 3  # the CPU twin's churned ticks
DEPLOY_LATE_S = 800.0  # smoke seconds past which the twin is cut to 1
DEPLOY_SIDECAR = None  # the sidecar's device: the card
DEPLOY_CONTROLLER = "cuda"  # the controller's --device
# (b) the processes' world, and the sidecar process's extra flags (after
# the overlay's own)
DEPLOY_BINARY_SHAPE = dict(pods=10_000, types=300, seed=0)
DEPLOY_SIDECAR_ARGS = ()
# the port's kustomize overlay, whose Deployment (b) runs
DEPLOY_OVERLAY = os.path.join("config", "torch")
# the controller container's flags that name an endpoint: (b) gives the
# process its own (--solver-uri to its sidecar, --data-dir for
# --apiserver, --metrics-port 0, no webhook) and keeps the rest
DEPLOY_ENDPOINT_FLAGS = ("--apiserver", "--solver-uri", "--webhook-port",
                         "--webhook-cert-dir", "--metrics-port",
                         "--data-dir", "--profiler-port")
# the shared libraries the image's runtime stage (Dockerfile.torch: Ubuntu
# 24.04 with Python 3.12, no toolkit) holds for the prebuilt kernels'
# NEEDED entries: glibc's and the GCC runtime's
RUNTIME_STAGE_LIBS = ("libc.so.6", "ld-linux-x86-64.so.2", "libm.so.6",
                      "libpthread.so.0", "libdl.so.2", "librt.so.1",
                      "libgcc_s.so.1", "libstdc++.so.6")
DEPLOY_BINARY_S = 30  # the controller process's --duration
DEPLOY_KINDS = ("MetricsProducer", "ScalableNodeGroup", "HorizontalAutoscaler")
# the controller process's environment: no card, and no GCE metadata lookup
# should a google-cloud SDK be importable there
DEPLOY_CONTROLLER_ENV = {"CUDA_VISIBLE_DEVICES": "", "NO_GCE_CHECK": "true"}


def _grpc_version():
    """grpc's version, or None when it is not installed."""
    try:
        import grpc
    except ImportError:
        return None
    return grpc.__version__


def _deploy_documents(workloads, runtime, store, manager, to_dict):
    """What a Deployment tick leaves behind: the producers', node groups'
    and autoscalers' documents (less uid and transition times), the
    registry's exposition (less timings and the service's own counters)
    and the resizes the fake GKE API received since the last call."""
    docs = {}
    for kind in DEPLOY_KINDS:
        for obj in store.list(kind):
            doc = to_dict(obj)
            doc.get("metadata", {}).pop("uid", None)
            for c in (doc.get("status") or {}).get("conditions") or []:
                c.pop("lastTransitionTime", None)
            docs[(kind, obj.metadata.name)] = doc
    return {"docs": docs,
            "exposition": workloads.exposition_lines(runtime.registry,
                                                     workloads.RUNG_SKIP),
            "resizes": manager.take_resizes()}


class _DeployRun:
    """One runtime over its own copy of the Deployment world, ticked by
    hand on a stepped clock."""

    def __init__(self, workloads, uri, device):
        from karpenter_tpu_torch.api.serialization import to_dict
        from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
        from karpenter_tpu_torch.store import Store

        self.workloads = workloads
        self.to_dict = to_dict
        self.store = Store()
        self.manager = workloads.FakeClusterManager()
        t0 = time.perf_counter()
        self.cluster = workloads.build_deployment_world(
            self.store, tpu_pods=DEPLOY_TPU_PODS, **DEPLOY_SHAPE)
        self.world_s = time.perf_counter() - t0
        self.now = 1000.0
        t0 = time.perf_counter()
        self.runtime = KarpenterRuntime(
            Options(solver_uri=uri, device=device), store=self.store,
            cloud_provider_factory=workloads.tpu_factory(
                workloads.deployment_api(), self.manager, self.store),
            clock=lambda: self.now,
        )
        self.boot_s = time.perf_counter() - t0

    def churn(self):
        """Draw a churn (outside any timing), then return its mutation."""
        self.now += 5.0
        return self.workloads.churn_reconcile(self.cluster, RECONCILE_CHURN)

    def documents(self):
        return _deploy_documents(self.workloads, self.runtime, self.store,
                                 self.manager, self.to_dict)

    def close(self):
        self.runtime.close()


def _deploy_same(card, twin, tick):
    need(card["docs"].keys() == twin["docs"].keys(),
         f"tick {tick}: the runtimes hold different objects")
    diff = [k for k, v in card["docs"].items() if twin["docs"][k] != v]
    need(not diff, f"tick {tick}: {len(diff)} documents differ between the "
         f"card's split runtime and the CPU twin, e.g. {diff[:3]}")
    need(card["exposition"] == twin["exposition"],
         f"tick {tick}: the expositions differ")
    need(card["resizes"] == twin["resizes"],
         f"tick {tick}: resizes {card['resizes']} != {twin['resizes']}")


def _deploy_in_process(torch, TF, TB, workloads):
    """(a) the card's sidecar in this process, a controller runtime split
    from it, and a CPU twin, ticked in lockstep."""
    from karpenter_tpu_torch.sidecar import SolverServer
    from karpenter_tpu_torch.sidecar import client as SC
    from karpenter_tpu_torch.solver import default_service, reset_default_service

    reset_default_service()
    server = SolverServer(port=0, host="127.0.0.1", device=DEPLOY_SIDECAR)
    uri = f"127.0.0.1:{server.start()}"
    runs = []
    try:
        card = _DeployRun(workloads, uri, DEPLOY_CONTROLLER)
        runs.append(card)
        twin = _DeployRun(workloads, None, "cpu")
        runs.append(twin)
        report(f"deployment worlds {DEPLOY_SHAPE} + {len(workloads.TPU_POOLS)}"
               f" TPU pools written in {card.world_s} / {twin.world_s} s; "
               f"runtimes built in {card.boot_s} / {twin.boot_s} s")
        svc = server.service or default_service()
        need(svc.device.type == ("cuda" if DEPLOY_SIDECAR is None else "cpu"),
             f"the sidecar's service runs on {svc.device}")
        ctl = card.runtime.solver_service
        need(ctl.device.type == "cpu" and ctl.device_solver is not None
             and ctl._numpy_ladder == (DEPLOY_CONTROLLER == "cpu"),
             "the controller's service is not split under its device's "
             "rule")
        parts = {}

        def timed(owner, attr, label):
            real = getattr(owner, attr)

            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    parts[label] = parts.get(label, 0.0) + (
                        time.perf_counter() - t0)
            setattr(owner, attr, wrapper)
            return real

        last = {}
        real_solve = svc.solve

        def sidecar_solve(inputs, *args, **kwargs):
            last["inputs"] = inputs
            return real_solve(inputs, *args, **kwargs)

        svc.solve = sidecar_solve
        timed(svc, "solve", "sidecar service.solve")
        timed(card.runtime.solver_client, "_call", "RPC round trips")
        server.reset_rpcs()
        ticks, rows, zero = [], [], None
        try:
            for tick in range(DEPLOY_TICKS + 1):
                mutations = [run.churn() if tick else None for run in runs]
                parts.clear()
                requests = svc.stats.requests
                torch.cuda.synchronize()
                TF.reset_launch_counts()
                t0 = time.perf_counter()
                if mutations[0] is not None:
                    mutations[0]()
                t1 = time.perf_counter()
                card.runtime.manager.reconcile_all()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                launches = dict(TF.LAUNCHES)
                rpcs = server.reset_rpcs()
                need(launches == {"fused_assign": 1, "shelf_bfd": 1,
                                  "demand_reduce": 0, "pack_bits": 1},
                     f"tick {tick}: the kernels launched {launches}")
                need(svc.stats.requests - requests == launches[
                    "fused_assign"], f"tick {tick}: the sidecar's service "
                     f"took {svc.stats.requests - requests} requests")
                need(rpcs["Solve"][0] == 1, f"tick {tick}: RPCs {rpcs}")
                got = card.documents()
                if tick <= DEPLOY_TWIN_TICKS:
                    if mutations[1] is not None:
                        mutations[1]()
                    twin.runtime.manager.reconcile_all()
                    _deploy_same(got, twin.documents(), tick)
                if tick:
                    ticks.append((t2 - t1) * 1e3)
                rows.append((tick, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                             {k: v * 1e3 for k, v in parts.items()},
                             rpcs, launches))
                zero = got["docs"][("MetricsProducer", "tpu-tpu-train-pool")]
        finally:
            for owner in (svc, card.runtime.solver_client):
                owner.__dict__.pop("solve", None)
                owner.__dict__.pop("_call", None)
        need(ctl.stats.fallbacks == 0 and svc.stats.fallbacks == 0,
             "a service answered from numpy")
        pending = (zero.get("status") or {}).get("pendingCapacity") or {}
        need(pending.get("additionalNodesNeeded", 0) > 0,
             f"the scale-from-zero pool's producer: {pending}")
        for tick, churn_ms, tick_ms, split, rpcs, launches in rows:
            report(f"deployment tick {tick}: churn {churn_ms} ms, "
                   f"reconcile_all {tick_ms} ms, split {split}; RPCs "
                   f"(calls, request bytes) {rpcs}; launches {launches}")
        p50, p95 = (float(np.percentile(ticks, q)) for q in (50, 95))
        kernel, kernel_by = _deploy_kernel_ms(torch, TB, TF, last["inputs"])
        request_bytes = rows[-1][4]["Solve"][1]
        report(f"deployment churned ticks: p50 {p50} ms, p95 {p95} ms over "
               f"{len(ticks)}; each kernel once per tick, all in the "
               f"sidecar's service; the controller's service on "
               f"{ctl.device}; card == CPU twin after {DEPLOY_TWIN_TICKS + 1}"
               f" ticks; the scale-from-zero pool: {pending} from the GKE "
               f"template; the kernels' ms per launch at the last tick's "
               f"operands {kernel} ({kernel_by}); Solve request "
               f"{request_bytes} bytes")
        return {"launches_per_tick": rows[-1][5], "ms": kernel,
                "ms_by": kernel_by, "solve_inputs": last["inputs"],
                "request_bytes": request_bytes, "tick_p50_ms": p50,
                "tick_p95_ms": p95, "decides": [r[4]["Decide"][0]
                                                for r in rows]}
    finally:
        for run in runs:
            run.close()
        server.stop()
        reset_default_service()


def _deploy_kernel_ms(torch, TB, TF, inputs):
    """({wrapper: ms per launch}, how it was timed) at a tick's operands:
    device time per launch from the profiler over 5 cuda solves, as
    phase 15 does; where the profiler shows no device rows for a kernel
    (it loses events late in a long process), each wrapper's time by
    CUDA events around 50 calls on the operands uploaded once (an upper
    bound on the device time: short kernels are enqueue-bound)."""
    import dataclasses

    kernel = _kernel_ms(torch, lambda: TB.solve(inputs, backend="cuda"))
    if None not in kernel.values():
        return kernel, "device time, profiler"
    dev = TB.inputs_from_numpy(
        {f.name: getattr(inputs, f.name) for f in dataclasses.fields(inputs)
         if getattr(inputs, f.name) is not None}, "cuda")
    hist = TF.fused_assign(dev, BUCKETS)[1]
    return {
        "fused_assign": time_ms(lambda: TF.fused_assign(dev, BUCKETS), 50),
        "shelf_bfd": time_ms(lambda: TF.shelf_bfd(hist, BUCKETS), 50),
    }, "CUDA events around 50 wrapper calls (the profiler showed no rows)"


# a sidecar of the phase's own: an ephemeral port on the loopback
_LOCAL_SIDECAR = ("--port", "0", "--host", "127.0.0.1")


class _Sidecar:
    """`python -m <module> <args>` (the solver sidecar) as a subprocess:
    `port` once it prints its serving line, `summary` its closing line
    (RPCs answered, kernel launches) once stopped."""

    def __init__(self, args, env=None, module="karpenter_tpu_torch.sidecar"):
        import subprocess
        import threading

        self.lines = []
        self.port = None
        self.summary = None
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        self.reader = threading.Thread(target=self._read_err, daemon=True)
        self.reader.start()

    def _read_err(self):
        for line in self.proc.stderr:
            self.lines.append(line.rstrip())

    def wait_serving(self, timeout=300):
        import select

        ready, _, _ = select.select([self.proc.stdout], [], [], timeout)
        line = self.proc.stdout.readline() if ready else ""
        need(line.startswith("{"), f"the sidecar did not serve: {line!r} "
             f"{self.lines[-5:]}")
        self.port = int(json.loads(line)["serving"].rsplit(":", 1)[1])
        return self.port

    def stop(self, timeout=60):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        self.reader.join(timeout=10)
        closing = [line for line in self.proc.stdout.read().splitlines()
                   if line.startswith('{"stopped"')]
        if closing:
            self.summary = json.loads(closing[-1])
        return rc


def _overlay_containers() -> dict:
    """{name: container} of the karpenter-tpu Deployment that the port's
    overlay (DEPLOY_OVERLAY) renders to, through hack/render_overlay.py
    (the repo's kustomize reader: no kubectl needed)."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "render_overlay", os.path.join(here, "hack", "render_overlay.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    docs = module.render(os.path.join(here, DEPLOY_OVERLAY))
    (deployment,) = [d for d in docs if d.get("kind") == "Deployment"
                     and d["metadata"]["name"] == "karpenter-tpu"]
    return {c["name"]: c
            for c in deployment["spec"]["template"]["spec"]["containers"]}


def _flags(args) -> list:
    """A container's args as [flag, value or None] pairs (`--f=v`, `--f v`
    or a bare `--f`)."""
    pairs, rest = [], list(args)
    while rest:
        arg = rest.pop(0)
        need(arg.startswith("--"), f"a container arg that is no flag: {arg}")
        flag, eq, value = arg.partition("=")
        if not eq and rest and not rest[0].startswith("--"):
            value, eq = rest.pop(0), "="
        pairs.append([flag, value if eq else None])
    return pairs


def _unflag(pairs) -> list:
    return [flag if value is None else f"{flag}={value}"
            for flag, value in pairs]


def _overlay_sidecar(solver, cache_dir):
    """(module, args): the solver container's command module and every one
    of its args, with the endpoints substituted: --port -> 0, --host ->
    127.0.0.1 (added: the container binds every interface), and
    --compile-cache-dir -> `cache_dir` where the overlay names one."""
    command = solver.get("command") or []
    need(len(command) == 3 and command[:2] == ["python", "-m"],
         f"the solver container's command: {command}")
    local = {"--port": "0", "--host": "127.0.0.1",
             "--compile-cache-dir": cache_dir}
    pairs = _flags(solver.get("args") or [])
    for pair in pairs:
        if pair[0] in local:
            pair[1] = local[pair[0]]
    named = {flag for flag, _ in pairs}
    pairs += [[f, local[f]] for f in ("--port", "--host") if f not in named]
    return command[2], _unflag(pairs), "--compile-cache-dir" in named


def _overlay_controller_flags(controller) -> list:
    """The controller container's flags that name no endpoint."""
    need(not controller.get("command"), "the controller container "
         f"overrides the image's entry point: {controller.get('command')}")
    return _unflag([pair for pair in _flags(controller.get("args") or [])
                    if pair[0] not in DEPLOY_ENDPOINT_FLAGS])


def _deploy_prebuild(build_dir):
    """The image's build step, `python -m karpenter_tpu_torch.prebuild`,
    in a process of its own (into `build_dir` when one is named): its
    {"build", "libraries"} line, and each library's NEEDED entries
    (readelf -d), which must all be the runtime stage's
    (RUNTIME_STAGE_LIBS)."""
    import re
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.prebuild",
         *([build_dir] if build_dir else [])],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    need(proc.returncode == 0, f"the prebuild exited {proc.returncode}: "
         f"{proc.stderr[-2000:]}")
    built = json.loads(proc.stdout.splitlines()[-1])
    needed = {}
    for name, path in built["libraries"].items():
        elf = subprocess.run(["readelf", "-d", path], capture_output=True,
                             text=True, timeout=60)
        need(elf.returncode == 0, f"readelf -d {path}: {elf.stderr}")
        needed[name] = re.findall(r"\(NEEDED\)\s+Shared library: \[([^]]+)\]",
                                  elf.stdout)
    foreign = {name: [x for x in libs if x not in RUNTIME_STAGE_LIBS]
               for name, libs in needed.items()}
    need(not any(foreign.values()), "NEEDED entries the image's runtime "
         f"stage does not hold: {foreign}")
    report(f"prebuild (the image's build step) in "
           f"{time.perf_counter() - t0} s into {built['build']}: "
           f"{sorted(built['libraries'])}; NEEDED {needed}")
    return built


def _build_snapshot(directory) -> dict:
    """{file: mtime_ns} of a build directory."""
    return {name: os.stat(os.path.join(directory, name)).st_mtime_ns
            for name in sorted(os.listdir(directory))}


def _deploy_statuses(store) -> dict:
    from karpenter_tpu_torch.api.serialization import to_dict

    return {mp.metadata.name: to_dict(mp).get("status", {}).get(
        "pendingCapacity") for mp in store.list("MetricsProducer")}


def _deploy_processes(workloads, root):
    """(b) the port's shipped Deployment as processes, and the two
    device-rule refusals. The Deployment is the one config/torch renders
    to (DEPLOY_OVERLAY, through hack/render_overlay.py). What the phase
    substitutes, and nothing else:

      * the solver: the container's command module and every one of its
        args, with --port -> 0 and --host -> 127.0.0.1 (the phase's own
        endpoint) and --compile-cache-dir -> a scratch directory where
        the overlay names one (config/torch names none), then
        DEPLOY_SIDECAR_ARGS (none on the card);
      * the controller: the container's flags less those that name an
        endpoint (DEPLOY_ENDPOINT_FLAGS: --apiserver, --solver-uri,
        --webhook-port and --webhook-cert-dir there), which keeps
        --cloud-provider; then the phase's own endpoints, --solver-uri
        127.0.0.1:<the sidecar's port>, --data-dir D in place of
        --apiserver, --metrics-port 0 and no webhook, and its run
        controls --no-leader-elect, --tick 0.1 and --duration
        DEPLOY_BINARY_S; CUDA_VISIBLE_DEVICES="", as the container has
        no card.

    Before the sidecar starts, the kernels are built as the image's build
    step builds them, into the directory the sidecar loads from, and
    starting the sidecar must run no nvcc there: every file's mtime
    unchanged and no .tmp. The three sidecars start together, before the
    worlds are written, so their start-up overlaps."""
    from karpenter_tpu_torch.cloudprovider import Options as CloudOptions
    from karpenter_tpu_torch.cloudprovider.tpu import TPUFactory
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.store import Store
    from karpenter_tpu_torch.store.persistence import open_store

    controller_env = dict(os.environ, **DEPLOY_CONTROLLER_ENV)
    t0 = time.perf_counter()
    containers = _overlay_containers()
    solver, controller = containers["solver"], containers["controller"]
    need(solver["image"] == controller["image"]
         and solver["image"].startswith("karpenter-tpu-torch:"),
         f"the overlay's images: {solver['image']}, {controller['image']}")
    module, sidecar_args, names_cache = _overlay_sidecar(
        solver, os.path.join(root, "kernels"))
    flags = _overlay_controller_flags(controller)
    render_s = time.perf_counter() - t0
    built = _deploy_prebuild(os.path.join(root, "kernels")
                             if names_cache else None)
    before = _build_snapshot(built["build"])
    sidecar_args += list(DEPLOY_SIDECAR_ARGS)
    print(f"the overlay's solver: python -m {module} {sidecar_args}; its "
          f"controller flags: {flags} (rendered in {render_s} s)",
          flush=True)
    sidecar = _Sidecar(sidecar_args, module=module)
    hidden = _Sidecar(list(_LOCAL_SIDECAR),
                      env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    cpu_sidecar = _Sidecar([*_LOCAL_SIDECAR, "--device", "cpu"])
    binaries = []
    try:
        data = os.path.join(root, "data")
        t1 = time.perf_counter()
        store = open_store(data)
        workloads.build_deployment_world(store, tpu_pods=DEPLOY_TPU_PODS,
                                         **DEPLOY_BINARY_SHAPE)
        store.close()
        report(f"deployment world {DEPLOY_BINARY_SHAPE} written into the "
               f"data dir in {time.perf_counter() - t1} s")
        # the in-process card runtime's statuses over the same world, with
        # the TPU provider bound to no SDK (as the process's)
        mirror = Store()
        workloads.build_deployment_world(mirror, tpu_pods=DEPLOY_TPU_PODS,
                                         **DEPLOY_BINARY_SHAPE)
        factory = TPUFactory(CloudOptions(store=mirror))
        runtime = KarpenterRuntime(
            Options(device=DEPLOY_SIDECAR), store=mirror,
            cloud_provider_factory=factory)
        try:
            runtime.manager.reconcile_all()
            want = _deploy_statuses(mirror)
        finally:
            runtime.close()
        pool = factory.node_group_for(
            mirror.list("ScalableNodeGroup")[0].spec)
        try:
            pool.set_replicas(1)
            guidance = None
        except Exception as error:  # noqa: BLE001 — the answer is checked
            guidance = str(error)
        need(guidance and "no container API client bound" in guidance,
             f"a pool with no SDK answered {guidance!r}")
        port = sidecar.wait_serving()
        serve_s = time.perf_counter() - t0
        loaded = _sidecar_device_line(sidecar)
        need(DEPLOY_SIDECAR == "cpu"
             or f"loaded from {built['build']}" in loaded,
             f"the sidecar's kernels: {loaded!r}")
        changed = sorted(set(before.items()) ^ set(
            _build_snapshot(built["build"]).items()))
        need(not changed, "starting the sidecar changed its build "
             f"directory (nvcc ran?): {changed}")
        binary = _Binary(
            flags + ["--solver-uri", f"127.0.0.1:{port}", "--data-dir", data,
                     "--metrics-port", "0", "--no-leader-elect", "--tick",
                     "0.1", "--duration", str(DEPLOY_BINARY_S)]
            + (["--device", "cpu"] if DEPLOY_CONTROLLER == "cpu" else []),
            env=controller_env)
        binaries.append(binary)
        # a --device cuda controller beside a --device cpu sidecar, over a
        # data dir of its own (the process must not start, so it is empty)
        refused = _Binary(
            ["--solver-uri", f"127.0.0.1:{cpu_sidecar.wait_serving()}",
             "--cloud-provider", "tpu", "--data-dir",
             os.path.join(root, "refused"), "--metrics-port", "0",
             "--duration", "5"], env=controller_env)
        binaries.append(refused)
        binary.wait_serving(300)
        deadline = time.perf_counter() + 120
        while True:
            status, text = binary.get("/metrics")
            requests = _metric(text, "karpenter_solver_requests_total")
            if (_metric(text, "karpenter_runtime_tick_seconds", "manager")
                    and requests):
                break
            need(time.perf_counter() < deadline,
                 f"the controller did not tick: {binary.lines[-5:]}")
            time.sleep(0.1)
        fallbacks = _metric(text, "karpenter_solver_fallback_total") or 0.0
        need(fallbacks == 0, f"the controller answered {fallbacks} "
             "from numpy")
        rc = binary.stop()
        need(rc == 0, f"the controller exited {rc} on SIGTERM")
        device_line = [x for x in binary.lines if "solver device:" in x]
        need(device_line and "backend cuda" in device_line[0]
             or DEPLOY_SIDECAR == "cpu",
             f"the controller's device line: {device_line}")
        store = open_store(data)
        try:
            got = _deploy_statuses(store)
            # a pool bound to no container API refuses to resize with
            # the reference's guidance, which the controller records as
            # AbleToScale=False, ResizeFailed
            refusing = [g.metadata.name
                        for g in store.list("ScalableNodeGroup")
                        for c in _sng_conditions(g)
                        if c.get("type") == "AbleToScale"
                        and c.get("status") == "False"
                        and c.get("message") == "ResizeFailed"]
        finally:
            store.close()
        need(got == want, "the controller process's statuses differ from "
             "the in-process card runtime's: "
             f"{[k for k in want if got.get(k) != want[k]][:3]}")
        need(refusing, "no pool answered the no-SDK guidance")
        logged = any("no container API client bound" in x
                     for x in binary.lines)
        report(f"processes: the overlay's sidecar served {serve_s} s after "
               f"its start on its card ({loaded}), no nvcc run (the "
               f"{len(before)} files of its build directory unchanged); the "
               f"controller ({device_line[0]}) ticked "
               f"with CUDA_VISIBLE_DEVICES=\"\", {requests} solves through "
               f"the sidecar, no fallback, exit 0 on SIGTERM; all "
               f"{len(got)} producers' statuses == the in-process card "
               f"runtime's; pools {refusing} answered the no-SDK guidance "
               f"(AbleToScale=False, ResizeFailed: {guidance!r}; the text "
               f"in the log: {logged})")
        rc = refused.proc.wait(timeout=300)
        refused.reader.join(timeout=10)
        need(rc == 1 and refused.port is None,
             f"a --device cuda controller beside a CPU sidecar exited {rc}")
        need(any("computes on 'cpu'" in x for x in refused.lines),
             f"no reason given: {refused.lines[-3:]}")
        rc = hidden.proc.wait(timeout=300)
        out = hidden.proc.stdout.read()
        hidden.reader.join(timeout=10)
        need(rc == 1 and not out.strip(), f"with the card hidden the "
             f"sidecar exited {rc} and printed {out!r}")
        need(any("CUDA device requested" in x for x in hidden.lines),
             f"no reason given: {hidden.lines[-3:]}")
        print("sidecar with CUDA_VISIBLE_DEVICES=\"\": exit 1 before "
              "binding; a --device cuda controller beside a --device cpu "
              "sidecar: exit 1 before its first tick", flush=True)
    finally:
        for binary in binaries:
            binary.stop()
        cpu_sidecar.stop()
        hidden.stop()
        rc = sidecar.stop()
    need(rc == 0, f"the sidecar exited {rc} on SIGTERM")
    summary = sidecar.summary
    need(summary, "the sidecar printed no closing line")
    solves, launches = summary["rpcs"]["Solve"][0], summary["launches"]
    need(DEPLOY_SIDECAR == "cpu" or solves >= 1 and launches == {
        "fused_assign": solves, "shelf_bfd": solves, "demand_reduce": 0,
        "pack_bits": solves},
        f"the sidecar answered {solves} Solves with launches {launches}")
    report(f"the overlay's sidecar on SIGTERM: {summary} (the overlay "
           f"requests {solver['resources']['requests']['memory']}); each "
           f"kernel launched once per Solve, in the sidecar; phase 16 (b) "
           f"{time.perf_counter() - t0} s, of it the render {render_s} s")


def _sidecar_device_line(sidecar, timeout=30) -> str:
    """The sidecar's `sidecar device:` line on stderr (it comes before the
    serving line on stdout; the reader thread may lag)."""
    deadline = time.perf_counter() + timeout
    while True:
        lines = [x for x in sidecar.lines if x.startswith("sidecar device:")]
        if lines or time.perf_counter() > deadline:
            need(lines, f"no sidecar device line: {sidecar.lines[-5:]}")
            return lines[0]
        time.sleep(0.05)


def _sng_conditions(group):
    from karpenter_tpu_torch.api.serialization import to_dict

    return (to_dict(group).get("status") or {}).get("conditions") or []


def phase_deployment(torch, TF, TB, workloads, started):
    """Phase 16: the shipped Deployment's shape on the card. Past
    DEPLOY_LATE_S of smoke the CPU twin is cut to the first tick and one
    churned tick (the card's ticks are never cut)."""
    import shutil
    import tempfile

    global DEPLOY_TWIN_TICKS
    if time.perf_counter() - started > DEPLOY_LATE_S:
        DEPLOY_TWIN_TICKS = 1
        print(f"phase 16: the smoke is past {DEPLOY_LATE_S} s; the CPU twin "
              f"runs the first tick and 1 churned tick", flush=True)

    version = _grpc_version()
    need(version, "grpc is not installed: the sidecar's transport cannot run")
    print(f"sidecar transport: grpc {version}", flush=True)
    t0 = time.perf_counter()
    out = _deploy_in_process(torch, TF, TB, workloads)
    t1 = time.perf_counter()
    report(f"phase 16 (a): {t1 - t0} s")
    root = tempfile.mkdtemp(prefix="karpenter-deployment-")
    try:
        _deploy_processes(workloads, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report(f"phase 16 (b): {time.perf_counter() - t1} s")
    out["transport"] = f"grpc {version}"
    return out


# -- phase 17: the multi-tenant control plane (tenancy/, --introspect) ---------

# (a) BASELINE.json's "1000 tenants x 4 autoscalers multitenant" entry:
# bench.py --multitenant's defaults (bench.py:905-925), stepped 12 ticks
MT_REPLAY = dict(tenants=1000, ticks=12, rows=4, metrics=2, seed=0)
# the reference's aggregate_replicas digests at MT_REPLAY: karpenter_tpu's
# simulate_multitenant on the CPU (tests/test_torch_simulate_multitenant.py
# pins the same numbers)
MT_DIGESTS = {"tick_0": 44106, "tick_6": 44058, "tick_11": 44109}
MT_BATCHED_ITERS = 10  # decide + cost rounds of the batched arm
MT_SEQUENTIAL_ITERS = 3  # rounds of the per-tenant loop (2,000 calls each)
# (b) cross-tenant bin-packs: one reconcile-size problem per tenant
MT_TENANTS = 64
MT_ROUNDS = 3
# (c) the fleet-tick families: tenant i's fleet is MT_FLEET_ROWS[i % 5]
# autoscalers x 3 metrics, as many forecast series of 64 samples
MT_FLEET_ROWS = (16, 24, 32, 40, 48)
MT_LATE_S = 1000.0  # smoke seconds past which (a) cuts its CPU twin and
# its sequential arm to one round
MT_DEVICE = None  # the shared services' device: the card
MT_TENANT_WEIGHTS = (1.0, 2.0, 3.0, 1.0)  # (e)'s tenant config


def _mt_world(tenants, **kw):
    """(service, registry, scheduler): `tenants` tenants t0000.. of weight
    1 + i % 3 over one SolverService on MT_DEVICE."""
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import SolverService
    from karpenter_tpu_torch.tenancy import (
        MultiTenantScheduler,
        TenantRegistry,
        TenantSpec,
    )

    svc = SolverService(registry=GaugeRegistry(), device=MT_DEVICE)
    registry = TenantRegistry(
        service=svc, registry=GaugeRegistry(),
        specs=[TenantSpec(id=f"t{i:04d}", weight=1.0 + i % 3)
               for i in range(tenants)],
    )
    return svc, registry, MultiTenantScheduler(registry, svc, **kw)


def _mt_replay(torch, late):
    """(a) simulate_multitenant at MT_REPLAY on SolverService() on the
    card: digests == the reference's and the CPU twin's, no mirror or
    floor serve; shared dispatches per tick, amortization and the tick's
    p50/p95 (its tracer span); then the same tenants' decide + cost
    matrices batched through one scheduler vs a sequential per-tenant
    loop through the same service (bench.py --multitenant's arms), the
    per-tenant answers equal, both arms' p50 and their ratio."""
    from karpenter_tpu_torch.observability import reset_default_tracer
    from karpenter_tpu_torch.simulate import (
        multitenant_cost_inputs,
        multitenant_fleet_inputs,
        simulate_multitenant,
    )

    tracer = reset_default_tracer()
    t0 = time.perf_counter()
    card = simulate_multitenant(**MT_REPLAY, device=MT_DEVICE)
    wall = time.perf_counter() - t0
    need(card["aggregate_replicas"] == MT_DIGESTS,
         f"(a) digests {card['aggregate_replicas']} != the reference's "
         f"{MT_DIGESTS}")
    need(card["mirror_served"] == 0 and card["fallback_served"] == 0,
         f"(a) mirror {card['mirror_served']} / floor "
         f"{card['fallback_served']} serves on the card")
    ticks = [span["dur_us"] / 1e3 for span in tracer.snapshot()
             if span["name"] == "simulate.multitenant.tick"]
    need(len(ticks) == MT_REPLAY["ticks"], f"(a) {len(ticks)} tick spans")
    shared = card["decide_dispatches"] + card["cost_dispatches"]
    report(f"phase 17 (a): {MT_REPLAY} on the card in {wall} s: digests "
           f"{card['aggregate_replicas']} == the reference's; "
           f"{shared / MT_REPLAY['ticks']} shared dispatches per tick, "
           f"{card['isolated_dispatches']} isolated, amortization "
           f"{card['dispatch_amortization']}x over "
           f"{card['sequential_equivalent_dispatches']} sequential; tick "
           f"p50 {np.percentile(ticks[1:], 50)} / p95 "
           f"{np.percentile(ticks[1:], 95)} ms (first tick {ticks[0]} ms); "
           f"solver requests {card['solver']}")
    sequential_iters = MT_SEQUENTIAL_ITERS
    if late:
        sequential_iters = 1
        print(f"phase 17 (a): the smoke is past {MT_LATE_S} s; the CPU twin "
              f"of the replay is skipped (the card is still held to the "
              f"reference's pinned digests) and the sequential arm runs "
              f"one round", flush=True)
    else:
        t0 = time.perf_counter()
        cpu = simulate_multitenant(**MT_REPLAY, device="cpu")
        need(cpu["aggregate_replicas"] == card["aggregate_replicas"],
             "(a) card digests != the CPU twin's")
        report(f"phase 17 (a): the CPU twin's digests equal "
               f"({time.perf_counter() - t0} s)")

    n, rows, metrics = (MT_REPLAY[k] for k in ("tenants", "rows", "metrics"))
    svc, _, sched = _mt_world(n, max_rows_per_round=n * rows)
    try:
        spec = np.full(rows, 2, np.int32)
        decide = {f"t{i:04d}": multitenant_fleet_inputs(
            i, rows, metrics, 0, 0, spec, 1_000_000.0) for i in range(n)}
        decided = sched.decide_all(decide)
        cost = {t: multitenant_cost_inputs(decide[t], decided[t].desired)
                for t in decide}
        refined = sched.cost_all(cost)
        batched = []
        for _ in range(MT_BATCHED_ITERS):
            t0 = time.perf_counter()
            sched.decide_all(decide)
            sched.cost_all(cost)
            batched.append((time.perf_counter() - t0) * 1e3)
        sequential = []
        for it in range(sequential_iters):
            t0 = time.perf_counter()
            answers = {t: (svc.decide(decide[t]), svc.cost(cost[t]))
                       for t in decide}
            sequential.append((time.perf_counter() - t0) * 1e3)
            if it == 0:
                for t, (d, c) in answers.items():
                    same_bits(d.to_numpy(), decided[t].to_numpy(),
                              f"(a) {t} decide, sequential vs batched")
                    same_bits(c.to_numpy(), refined[t].to_numpy(),
                              f"(a) {t} cost, sequential vs batched")
        need(svc.stats.fallbacks == 0, "(a) the service fell back")
    finally:
        svc.close()
    b50, s50 = np.percentile(batched, 50), np.percentile(sequential, 50)
    report(f"phase 17 (a): decide + cost of {n} tenants x {rows} rows: "
           f"batched p50 {b50} / p95 {np.percentile(batched, 95)} ms "
           f"({MT_BATCHED_ITERS} rounds), sequential per-tenant loop p50 "
           f"{s50} ms ({sequential_iters} rounds, {2 * n} calls each): "
           f"{s50 / b50}x; per-tenant answers equal")
    return {"tick_ms": ticks, "batched_ms": batched,
            "sequential_ms": sequential}


def _mt_solve_all(torch, TB, TF, workloads):
    """(b) solve_all over MT_TENANTS tenants' reconcile-size problems,
    MT_ROUNDS rounds, launch counts set to 0 just before each and read
    just after: each kernel once per tenant per round; every tenant's
    five outputs == its own direct solve(backend="cuda") and the plain
    program on the CPU; the kernels' device ms per launch."""
    problems = workloads.build_tenant_problems(MT_TENANTS)
    batch = {f"t{i:04d}": TB.BinPackInputs(**fields)
             for i, fields in enumerate(problems)}
    svc, _, sched = _mt_world(MT_TENANTS)
    launches, round_ms = [], []
    try:
        for _ in range(MT_ROUNDS):
            TF.reset_launch_counts()
            t0 = time.perf_counter()
            out = sched.solve_all(batch)
            round_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(TF.LAUNCHES))
            need(launches[-1] == {"fused_assign": MT_TENANTS,
                                  "shelf_bfd": MT_TENANTS, "demand_reduce": 0,
                                  "pack_bits": MT_TENANTS},
                 f"(b) launches {launches[-1]} in a round of {MT_TENANTS} "
                 f"tenants")
        need(sched.stats.mirror_served == 0 and not sched.errors,
             "(b) a tenant was not served by the card")
        need(svc.stats.fallbacks == 0, "(b) the service fell back")
    finally:
        svc.close()
    for i, (tenant, inputs) in enumerate(sorted(batch.items())):
        direct = TB.solve(inputs, backend="cuda")
        _service_outputs_equal(out[tenant], direct, None,
                               f"(b) {tenant} vs its direct cuda solve")
        plain = TB.solve(TB.inputs_from_numpy(problems[i], "cpu"),
                         backend="torch", device="cpu")
        _service_outputs_equal(out[tenant], plain, None,
                               f"(b) {tenant} vs the plain program on the CPU")
    first = [batch[t] for t in sorted(batch)[:8]]
    ms, ms_by = None, "profiler"
    try:
        ms = _kernel_ms(torch, lambda: [TB.solve(p, backend="cuda")
                                        for p in first], n=3)
    except RuntimeError as exc:
        print(f"phase 17 (b): profiler not available ({exc})")
    if not ms or None in ms.values():
        ms_by = "CUDA events around the wrapper"
        device = TB.inputs_from_numpy(problems[0], "cuda")
        hist = TF.fused_assign(device, BUCKETS)[1]
        ms = {"fused_assign": time_ms(
                  lambda: TF.fused_assign(device, BUCKETS), 20),
              "shelf_bfd": time_ms(lambda: TF.shelf_bfd(hist, BUCKETS), 20)}
    report(f"phase 17 (b): solve_all of {MT_TENANTS} tenants (256 rows x 304 "
           f"groups, R = 4) x {MT_ROUNDS} rounds: launches per round "
           f"{launches}; round ms {round_ms}; every tenant == its direct "
           f"cuda solve and the CPU plain program; device ms per launch "
           f"{ms} ({ms_by})")
    return {"launches_per_round": launches[-1], "ms": ms, "ms_by": ms_by,
            "round_ms": round_ms, "outputs": out, "batch": batch}


def _mt_fleet_batches(workloads):
    """(c)'s per-tenant FusedTickInputs, DecisionInputs, CostInputs and
    ForecastInputs (host arrays): tenant i's fleet from
    build_fused_tick_inputs(900 + i, ...), its cost matrix the replay's
    (multitenant_cost_inputs over its numpy-mirror decision)."""
    from karpenter_tpu_torch.forecast import models as M
    from karpenter_tpu_torch.ops import decision as D
    from karpenter_tpu_torch.ops import fusedtick as FT
    from karpenter_tpu_torch.simulate import multitenant_cost_inputs

    fused, decide, cost, forecast = {}, {}, {}, {}
    for i in range(MT_TENANTS):
        n = MT_FLEET_ROWS[i % len(MT_FLEET_ROWS)]
        fields = workloads.build_fused_tick_inputs(900 + i, n, 3, n, 64)
        tenant = f"t{i:04d}"
        fused[tenant] = FT.FusedTickInputs.from_arrays(fields)
        decide[tenant] = D.DecisionInputs.from_arrays(fields["decision"])
        forecast[tenant] = M.ForecastInputs.from_arrays(fields["forecast"])
        cost[tenant] = multitenant_cost_inputs(
            decide[tenant], D.decide_numpy(decide[tenant]).desired)
    return fused, decide, cost, forecast


def _mt_families(torch, workloads):
    """(c) fused_tick_all, decide_all, cost_all and forecast_all over
    MT_TENANTS tenants on the card: each tenant's answer == its own
    numpy-mirror answer on the CPU, bitwise; the fused family one
    CUDA-graph dispatch for the round."""
    from karpenter_tpu_torch.forecast import models as M
    from karpenter_tpu_torch.ops import cost as CK
    from karpenter_tpu_torch.ops import decision as D
    from karpenter_tpu_torch.ops import fusedtick as FT

    fused, decide, cost, forecast = _mt_fleet_batches(workloads)
    svc, _, sched = _mt_world(MT_TENANTS)
    timings, leaves = {}, 0
    try:
        for family, call, batch, mirror in (
            ("fused", sched.fused_tick_all, fused, FT.fused_tick_numpy),
            ("decide", sched.decide_all, decide, D.decide_numpy),
            ("cost", sched.cost_all, cost, CK.cost_numpy),
            ("forecast", sched.forecast_all, forecast, M.forecast_numpy),
        ):
            before = (svc.stats.fused_dispatches,
                      svc.fused_program().replays)
            t0 = time.perf_counter()
            out = call(batch)
            timings[family] = (time.perf_counter() - t0) * 1e3
            for tenant, inputs in batch.items():
                leaves += same_bits(out[tenant].to_numpy(),
                                    mirror(inputs).to_numpy(),
                                    f"(c) {family} {tenant} vs its mirror")
            if family == "fused":
                program = svc.fused_program()
                need(sched.stats.fused_dispatches == 1
                     and svc.stats.fused_dispatches - before[0] == 1
                     and program.replays - before[1] == 1,
                     f"(c) the fused round took {sched.stats.fused_dispatches}"
                     f" scheduler / {svc.stats.fused_dispatches - before[0]} "
                     f"service dispatches, {program.replays - before[1]} "
                     f"replays")
        stats = sched.stats
        need(stats.mirror_served == 0 and stats.fallback_served == 0,
             "(c) a tenant was served off the card")
        need(svc.stats.fused_chained_serves == 0
             and svc.stats.fused_mirror_serves == 0,
             "(c) the service served the fused tick off the graph")
    finally:
        svc.close()
    report(f"phase 17 (c): {MT_TENANTS} tenants' fused tick, decide, cost "
           f"and forecast on the card == their own numpy mirrors on the "
           f"CPU ({leaves} leaves bitwise); one graph dispatch for the fused "
           f"round; ms {timings}; shared dispatches decide "
           f"{stats.decide_dispatches} cost {stats.cost_dispatches} forecast "
           f"{stats.forecast_dispatches} fused {stats.fused_dispatches}")
    return {"ms": timings}


def _mt_card_rule(torch, workloads, solved):
    """(d) one solver.dispatch failure, then tenant t0003 under a
    tenancy.gather.t0003 plan for 3 rounds: the failed dispatch's tenants
    and then t0003 (its breaker open) are served by their own device
    dispatches; every tenant's answers equal the no-fault run's; nothing
    is served from numpy. With the plan cleared the probe (on an injected
    clock that runs) closes the breaker."""
    from karpenter_tpu_torch import faults
    from karpenter_tpu_torch.ops import cost as CK

    tenants = sorted(solved["batch"])[:8]
    batch = {t: solved["batch"][t] for t in tenants}
    _, _, cost, _ = _mt_fleet_batches(workloads)
    cost = {t: cost[t] for t in tenants}
    want_cost = {t: CK.cost_numpy(cost[t]).to_numpy() for t in tenants}
    clock = _RunningClock()
    svc, _, sched = _mt_world(8, breaker_threshold=3, breaker_reset_s=30.0,
                              clock=clock)

    def check(refined, out, what):
        for t in tenants:
            for name in ("assigned", "assigned_count", "nodes_needed",
                         "lp_bound", "unschedulable"):
                need(np.array_equal(
                    np.asarray(getattr(out[t], name)),
                    np.asarray(getattr(solved["outputs"][t], name))),
                    f"(d) {t} {what}: {name} differs from the no-fault run")
            same_bits(refined[t].to_numpy(), want_cost[t], f"(d) {t} {what}")

    try:
        with faults.injected_faults(seed=17) as reg:
            # one failed shared dispatch: its tenants are each served by
            # their own solve (the plan's one firing is spent by then)
            reg.plan("solver.dispatch", mode="error", times=1)
            check(sched.cost_all(cost), sched.solve_all(batch),
                  "the dispatch-fault round")
            reg.clear()
            reg.plan("tenancy.gather.t0003", mode="error")
            for r in range(3):
                check(sched.cost_all(cost), sched.solve_all(batch),
                      f"faulted round {r}")
        stats = sched.stats
        need(sched.breakers.is_open("t0003"), "(d) t0003's breaker is closed")
        need(stats.mirror_served == 0 and stats.fallback_served == 0,
             f"(d) mirror {stats.mirror_served} / floor "
             f"{stats.fallback_served} serves on the card")
        isolated = stats.isolated_dispatches
        need(isolated >= 6, f"(d) {isolated} isolated dispatches")
        clock.offset += 31.0
        # the cost round's gate admits t0003's probe: one isolated
        # dispatch, whose success closes the breaker
        check(sched.cost_all(cost), sched.solve_all(batch), "after the probe")
        need(not sched.breakers.is_open("t0003") and stats.probes == 1
             and stats.breaker_recoveries == 1,
             "(d) the probe did not close t0003's breaker")
        need(svc.backend_health() == "healthy", "(d) the FSM is not healthy")
    finally:
        svc.close()
    report(f"phase 17 (d): one failed dispatch, then t0003 faulted 3 "
           f"rounds: breaker trips "
           f"{stats.breaker_trips}, tenant failures {stats.tenant_failures},"
           f" isolated device dispatches {isolated}, mirror serves "
           f"{stats.mirror_served}, probes {stats.probes}, recoveries "
           f"{stats.breaker_recoveries}; every answer == the no-fault run")


def _mt_runtime(torch, workloads, root):
    """(e) KarpenterRuntime with a tenant config (4 tenants, weights 1-3,
    written as JSON) and the introspection plane, over phase 13 (c)'s
    10,000-pod world, for 3 ticks, behind the HTTP server: /debug/solver
    enabled with the kernels' build and the first-shape dispatches in its
    ledger; /metrics with karpenter_device_* from the card's memory
    stats, karpenter_tenant_active 4 and the compile family;
    /debug/selfslo with the tenants' board."""
    import urllib.request

    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
    from karpenter_tpu_torch.observability import MetricsServer
    from karpenter_tpu_torch.runtime import KarpenterRuntime, Options
    from karpenter_tpu_torch.store import Store

    config = os.path.join(root, "tenants.json")
    with open(config, "w") as f:
        json.dump([{"id": f"tenant-{i}", "weight": w}
                   for i, w in enumerate(MT_TENANT_WEIGHTS)], f)
    store, provider = Store(), FakeFactory()
    world = workloads.build_runtime_world(store, provider, **BINARY_SHAPE)
    clock = _StepClock()
    rt = KarpenterRuntime(
        Options(tenant_config=config, introspect=True,
                journal_dir=os.path.join(root, "j"), device=MT_DEVICE,
                **RUNTIME_OPTIONS),
        store=store, cloud_provider_factory=provider, clock=clock,
    )
    server = MetricsServer(rt.registry, port=0, host="127.0.0.1",
                           ledger=rt.decision_ledger, selfslo=rt.selfslo,
                           introspection=rt.solver_introspection)
    port = server.start()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as response:
            return response.read().decode()

    tick_ms = []
    try:
        for tick in range(3):
            if tick:
                clock.now += RUNTIME_TICK_S
                world.step_queues()
                workloads.churn_reconcile(world.cluster, RECONCILE_CHURN)()
            t0 = time.perf_counter()
            rt.manager.reconcile_all()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
        doc = json.loads(get("/debug/solver?limit=64"))
        need(doc["enabled"] is True, "(e) /debug/solver is not enabled")
        families = doc["compile"]["by_family"]
        need(families.get("kernels") == 1 and families.get("solve", 0) >= 1,
             f"(e) the ledger's families {families}")
        devices = doc["device_memory"]["devices"]
        need(devices and devices[0]["bytes_in_use"] > 0,
             f"(e) no card memory in /debug/solver: {devices}")
        text = get("/metrics?format=prometheus")
        for family in ("karpenter_device_bytes_in_use",
                       "karpenter_device_bytes_limit",
                       "karpenter_solver_compile_seconds"):
            need(family in text, f"(e) /metrics has no {family}")
        need(_metric(text, "karpenter_tenant_active") == 4.0,
             "(e) karpenter_tenant_active is not 4")
        board = json.loads(get("/debug/selfslo"))
        need(sorted(board.get("tenants", {})) ==
             [f"tenant-{i}" for i in range(4)],
             f"(e) /debug/selfslo's tenants {board.get('tenants')}")
        need(rt.solver_service.stats.fallbacks == 0,
             "(e) the runtime's service fell back")
    finally:
        server.stop()
        rt.close()
    tail = [(row["family"], row["rung"], row["seconds"])
            for row in doc["compile"]["ledger_tail"]]
    report(f"phase 17 (e): runtime with --tenant-config (4 tenants) and "
           f"--introspect over {BINARY_SHAPE}: ticks {tick_ms} ms; "
           f"/debug/solver ledger {families}, first records {tail[:6]}; "
           f"card memory {devices}; selfslo tenants {board['tenants']}")


def phase_multitenant(torch, TF, TB, workloads, started):
    """Phase 17: the multi-tenant control plane and the introspection
    plane on the card. Past MT_LATE_S of smoke (a)'s CPU twin is skipped
    (the card's replay is still held to the reference's pinned digests)
    and its sequential arm runs one round."""
    import shutil
    import tempfile

    late = time.perf_counter() - started > MT_LATE_S
    t0 = time.perf_counter()
    out = {"replay": _mt_replay(torch, late)}
    t1 = time.perf_counter()
    report(f"phase 17 (a): {t1 - t0} s")
    solved = _mt_solve_all(torch, TB, TF, workloads)
    out.update(launches_per_round=solved["launches_per_round"],
               ms=solved["ms"], ms_by=solved["ms_by"])
    t2 = time.perf_counter()
    report(f"phase 17 (b): {t2 - t1} s")
    _mt_families(torch, workloads)
    _mt_card_rule(torch, workloads, solved)
    t3 = time.perf_counter()
    report(f"phase 17 (c), (d): {t3 - t2} s")
    root = tempfile.mkdtemp(prefix="karpenter-tenancy-")
    try:
        _mt_runtime(torch, workloads, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report(f"phase 17 (e): {time.perf_counter() - t3} s")
    return out


# -- phase 18: the replicated control plane (replication/, --partitions) ------

# (a) three card replicas over phase 13 (c)'s world, 16 tenants
REPLICA_IDS = ("r0", "r1", "r2")
REPLICA_OPTIONS = dict(partitions=16, lease_duration_s=5.0)
REPLICA_SKEW_S = 1.0  # LeaderElector's default skew tolerance
REPLICA_TENANTS = 16
REPLICA_BEFORE = 4  # ticks before the kill
REPLICA_AFTER = 4  # ticks after it; 2 past REPLICA_LATE_S of smoke
REPLICA_LATE_S = 800.0
REPLICA_DEVICE = None  # the replicas' Options.device: the card
# (b) bench-failover's width (Makefile) and the reference's writes digest
# there (BASELINE.json's "256 tenants x 4 replicas failover (cpu)")
FAILOVER_WIDTH = dict(tenants=256, replicas=4, partitions=16, ticks=40, seed=0)
FAILOVER_PINS = dict(
    writes_digest="0ffab1567ef410bda2ba3e9ae58ab63d2ecaafdd06cdba931a9be850d2f4969b",
    victim_tenants=73, blackout_ticks_p99=6, reconverge_ticks=6)
# the reference's `--simulate --failover` report (its default world, seed
# 0): _report_crc of it, and its writes digest
FAILOVER_CLI_PINS = dict(
    report_crc=1398028848,
    writes_digest="fa414da7eb55db6357440b1f10d792903d5c84b9fbd056f2d5049fcffd753847")
FAILOVER_CARD_ARGS = ()  # extra flags of (b)'s --simulate (none: the card)
# (c) two binaries over one fake kube-apiserver
REPLICA_BINARY_SHAPE = dict(pods=1_000, types=30, seed=0)
REPLICA_BINARY_FLAGS = ("--partitions", "8", "--lease-duration", "3")
REPLICA_BINARY_LEASE_S = 3.0
REPLICA_BINARY_TICK_S = 0.5  # the binaries' --tick
REPLICA_BINARY_ARGS = ()  # extra flags (none: they run on the card)


class _CountCompaction:
    """While entered, every recovery journal built compacts on its record
    count alone: the auto-compaction's 30 s floor reads the host's
    monotonic clock, so phase 18's card fleet and its slower CPU twin
    would compact on different ticks and expose different
    karpenter_recovery_journal_bytes."""

    def __enter__(self):
        from karpenter_tpu_torch.recovery import journal as RJ

        self.cls, self.real = RJ.StateJournal, RJ.StateJournal.__init__
        real = self.real

        def init(journal, *args, **kwargs):
            real(journal, *args, **kwargs)
            journal.compact_min_interval_s = 0.0

        self.cls.__init__ = init
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.real


def _replica_fleet(workloads, device, root, after, each=None):
    """(a)'s script on `device`: phase 13 (c)'s world in one Store, three
    replicas with REPLICA_OPTIONS and a REPLICA_TENANTS-tenant config over
    it; REPLICA_BEFORE ticks of RUNTIME_TICK_S, the biggest owner
    killed on the next, `after` more. Returns (victim, per tick (died,
    fleet snapshot), the victim tenants' stale-write probe, the quantity
    strings of the world's pods and nodes, tick ms)."""
    with _CountCompaction():
        return _replica_fleet_run(workloads, device, root, after, each)


def _replica_fleet_run(workloads, device, root, after, each):
    """_replica_fleet's body."""
    from karpenter_tpu_torch.api.serialization import to_dict
    from karpenter_tpu_torch.cloudprovider.fake import FakeFactory
    from karpenter_tpu_torch.recovery.fence import FenceRejectedError
    from karpenter_tpu_torch.store import Store

    store, provider = Store(), FakeFactory()
    world = workloads.build_runtime_world(store, provider, **BINARY_SHAPE)
    quantities = [str(q) for pod in store.list("Pod")
                  for c in pod.spec.containers for q in c.requests.values()]
    quantities += [str(q) for node in store.list("Node")
                   for q in node.status.allocatable.values()]
    config = os.path.join(root, "tenants.json")
    with open(config, "w") as f:
        json.dump([{"id": f"tenant-{i:02d}"} for i in range(REPLICA_TENANTS)],
                  f)
    fleet = workloads.ReplicaFleet(
        store, provider, list(REPLICA_IDS), _StepClock(),
        dict(REPLICA_OPTIONS, tenant_config=config,
             journal_dir=os.path.join(root, "j"), device=device))
    trail, tick_ms = [], []

    def record(tick, died):
        tick_ms.append((time.perf_counter() - marks["t0"]) * 1e3)
        trail.append((died, fleet.snapshot(to_dict)))
        marks["t0"] = time.perf_counter()

    marks = {"t0": time.perf_counter()}
    try:
        victim = fleet.failover(world, REPLICA_BEFORE, after,
                                RECONCILE_CHURN, RUNTIME_TICK_S, record,
                                each=each)
        # the deposed replica's late write: its stale fence token against
        # each adopter's provider, whose validator the adoption seeded
        probe = {}
        for tenant, handoff in sorted(fleet.dead[victim].handoffs.items()):
            adopter = next(rid for rid in fleet.live()
                           if tenant in fleet.plane(rid).handoffs)
            validator = fleet.providers[adopter].fence_validator
            try:
                validator.admit(handoff.token())
                probe[tenant] = "applied"
            except FenceRejectedError:
                probe[tenant] = "rejected"
    finally:
        fleet.close()
    return victim, trail, probe, quantities, tick_ms


def _replica_check(victim, trail, probe, after):
    """(a)'s checks on one fleet's run: the victim died on its tick, the
    survivors own every partition, every victim tenant went WARMUP ->
    SERVING at a fence generation of 2 or more, and its stale write was
    rejected. Returns the victim tenants."""
    partitions = REPLICA_OPTIONS["partitions"]
    died = [d for d, _ in trail]
    need(died == [[]] * REPLICA_BEFORE + [[victim]] + [[]] * after,
         f"(a) replicas died {died}, the victim {victim}")
    owned = trail[REPLICA_BEFORE - 1][1]["state"][victim]["owned"]
    tenants = sorted(trail[REPLICA_BEFORE - 1][1]["state"][victim]["tenants"])
    need(owned and tenants, f"(a) the victim owned {owned}, {tenants}")
    final = trail[-1][1]["state"]
    held = sorted(p for s in final.values() for p in s["owned"])
    need(held == list(range(partitions)),
         f"(a) the survivors hold {held} of {partitions} partitions")
    seen = {}
    for _, snap in trail[REPLICA_BEFORE + 1:]:
        for s in snap["state"].values():
            for tenant in tenants:
                if tenant in s["tenants"]:
                    seen.setdefault(tenant, []).append(s["tenants"][tenant])
    for tenant in tenants:
        states = seen.get(tenant, [])
        need(states and states[0][0] == "warmup"
             and states[-1][0] == "serving"
             and all(g >= 2 for _, g, _ in states),
             f"(a) victim tenant {tenant}: {states}")
    need(probe and set(probe.values()) == {"rejected"},
         f"(a) the deposed replica's late writes: {probe}")
    return tenants


def _first_difference(a, b, path: str = "") -> str:
    """The path of the first leaf where two nested dicts / sequences of
    plain values differ, with both values (cut to 300 characters)."""
    if isinstance(a, dict) and isinstance(b, dict):
        for key in sorted(set(a) | set(b), key=str):
            if a.get(key) != b.get(key):
                return _first_difference(a.get(key), b.get(key),
                                         f"{path}/{key}")
    if (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
            and len(a) == len(b)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_difference(x, y, f"{path}[{i}]")
    return f"{path or '/'}: card {str(a)[:300]!r}, CPU {str(b)[:300]!r}"


def _replica_cpu_child(workloads, out_dir: str) -> None:
    """(a)'s CPU twin in a child: the same script with every replica on
    the CPU, its snapshots pickled."""
    import pickle

    t0 = time.perf_counter()
    after = int(os.environ["KARPENTER_SMOKE_REPLICA_AFTER"])
    victim, trail, probe, _, tick_ms = _replica_fleet(
        workloads, "cpu", out_dir, after)
    with open(os.path.join(out_dir, "replica_cpu.pickle"), "wb") as f:
        pickle.dump((victim, trail, probe), f)
    report(f"phase 18 (a), the CPU twin beside it: {len(trail)} ticks of "
           f"{len(REPLICA_IDS)} replicas in {time.perf_counter() - t0} s "
           f"(tick ms {tick_ms})")


def _failover_child(workloads, out_dir: str) -> None:
    """(b) in a child: `--simulate --failover` on the card through main()
    (the reference's report, pinned) and simulate_failover at
    bench-failover's width (the reference's digest, pinned)."""
    import contextlib
    import io
    import logging

    from karpenter_tpu_torch import __main__ as cli
    from karpenter_tpu_torch.simulate import simulate_failover

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--simulate", "--failover", *FAILOVER_CARD_ARGS])
    cli_s = time.perf_counter() - t0
    need(rc == 0, f"(b) --simulate --failover exited {rc}")
    got = json.loads(out.getvalue())
    crc = _report_crc(got)
    need(crc == FAILOVER_CLI_PINS["report_crc"]
         and got["writes_digest"] == FAILOVER_CLI_PINS["writes_digest"],
         f"(b) --simulate --failover's report crc {crc}, digest "
         f"{got['writes_digest']} != the reference's {FAILOVER_CLI_PINS}")
    # the wide world's adoptions, one log line each, stay out of the log
    logging.getLogger("karpenter_tpu_torch").setLevel(logging.WARNING)
    t0 = time.perf_counter()
    wide = simulate_failover(**FAILOVER_WIDTH)
    wide_s = time.perf_counter() - t0
    seen = dict(writes_digest=wide["writes_digest"],
                victim_tenants=len(wide["victim_tenants"]),
                blackout_ticks_p99=wide["blackout_ticks_p99"],
                reconverge_ticks=wide["reconverge_ticks"])
    need(seen == FAILOVER_PINS and wide["converged"]
         and wide["duplicate_actuations"] == wide["lost_actuations"] == 0
         and wide["stale_write_rejected"],
         f"(b) the failover world at {FAILOVER_WIDTH}: {seen} != the "
         f"reference's {FAILOVER_PINS}")
    report(f"phase 18 (b): `--simulate --failover` on the card == the "
           f"reference's report (crc {crc}) in {cli_s} s; at "
           f"{FAILOVER_WIDTH} (bench-failover) {seen} == the reference's, "
           f"{wide['handoffs_after_kill']} handoffs, fence rejections "
           f"{wide['fence_rejections']}, in {wide_s} s of host work")


def _replica_binaries(workloads):
    """(c) two `python -m karpenter_tpu_torch --apiserver URL --partitions
    8 --lease-duration 3 --replica-id r0|r1` over one fake: SIGKILL the
    bigger owner; the survivor's /debug/replicas lists all 8 partitions
    within lease + skew + 3 of its ticks."""
    server = _fake_apiserver()()
    server.start()
    binaries = {}
    try:
        workloads.build_kube_world([server], **REPLICA_BINARY_SHAPE)
        base = ["--apiserver", server.url, "--kube-insecure",
                "--cloud-provider", "fake", "--metrics-port", "0",
                "--tick", str(REPLICA_BINARY_TICK_S), "--leader-elect",
                *REPLICA_BINARY_FLAGS, *REPLICA_BINARY_ARGS]
        for rid in ("r0", "r1"):
            binaries[rid] = _Binary(base + ["--replica-id", rid])
        for binary in binaries.values():
            binary.wait_serving(300)

        def board(binary):
            status, body = binary.get("/debug/replicas")
            need(status == 200, f"(c) /debug/replicas answered {status}")
            return json.loads(body)

        partitions = int(REPLICA_BINARY_FLAGS[1])
        deadline = time.perf_counter() + 120
        while True:
            boards = {rid: board(b) for rid, b in binaries.items()}
            owned = sorted(p for b in boards.values() for p in b["owned"])
            if owned == list(range(partitions)) and all(
                    b["rounds"] >= 3 for b in boards.values()):
                break
            need(time.perf_counter() < deadline,
                 f"(c) the binaries never held every partition: {boards}")
            time.sleep(0.1)
        need(all(b["enabled"] for b in boards.values()),
             "(c) /debug/replicas is not enabled")
        victim = max(boards, key=lambda rid: (len(boards[rid]["owned"]), rid))
        survivor = next(rid for rid in boards if rid != victim)
        split = {rid: b["owned"] for rid, b in boards.items()}
        binaries[victim].proc.kill()
        killed = time.perf_counter()
        binaries[victim].proc.wait()
        polls = []  # (seconds since the kill, rounds, owned)
        deadline = killed + 60
        while True:
            b = board(binaries[survivor])
            polls.append((time.perf_counter() - killed, b["rounds"],
                          b["owned"]))
            if b["owned"] == list(range(partitions)):
                break
            need(time.perf_counter() < deadline,
                 f"(c) the survivor never took every partition: {polls[-1]}")
            time.sleep(0.02)
        expiry = REPLICA_BINARY_LEASE_S + REPLICA_SKEW_S
        at_expiry = max([r for s, r, _ in polls if s <= expiry] or
                        [polls[0][1]])
        taken_s, taken_rounds = polls[-1][0], polls[-1][1]
        need(taken_rounds - at_expiry <= 3,
             f"(c) the survivor took every partition {taken_s} s after the "
             f"kill, {taken_rounds - at_expiry} of its ticks past lease + "
             f"skew ({expiry} s)")
        need(all(h == survivor for h in b["holders"].values()),
             f"(c) holders after the takeover {b['holders']}")
        rc = binaries[survivor].stop()
        need(rc == 0, f"(c) the survivor exited {rc} on SIGTERM")
        leases = {d["metadata"]["name"]: d["spec"].get("holderIdentity")
                  for d in server.objects("leases")}
        report(f"phase 18 (c): two --apiserver --partitions {partitions} "
               f"binaries over {REPLICA_BINARY_SHAPE}: partitions {split}; "
               f"SIGKILL {victim}: {survivor}'s /debug/replicas listed all "
               f"{partitions} {taken_s} s after (lease + skew {expiry} s, "
               f"{taken_rounds - at_expiry} of its ticks past it); exit 0 "
               f"on SIGTERM, leases after {leases}")
    finally:
        for binary in binaries.values():
            binary.stop()
        server.stop()


def _replica_binaries_child(workloads, out_dir: str) -> None:
    """(c) and (b) in a child."""
    t0 = time.perf_counter()
    _replica_binaries(workloads)
    t1 = time.perf_counter()
    _failover_child(workloads, out_dir)
    report(f"phase 18 (c) {t1 - t0} s, (b) {time.perf_counter() - t1} s, "
           f"beside (a)")


def _quantity_parser(quantities):
    """(d) the C parser (native/quantity.c) loaded, and Quantity.parse
    through it == the Python oracle on `quantities`; both rates."""
    from karpenter_tpu_torch import native
    from karpenter_tpu_torch.utils import quantity as Q

    loaded = native.peek_kquantity() is not None
    t0 = time.perf_counter()
    parser = native.load_kquantity()
    build_s = time.perf_counter() - t0
    need(parser is not None, "(d) the C quantity parser did not build")
    Q._native_parser()
    need(native.peek_kquantity() is parser, "(d) the parser is not loaded")
    fast = [(q.value, q.format) for q in map(Q.Quantity.parse, quantities)]
    t0 = time.perf_counter()
    for s in quantities:
        Q.Quantity.parse(s)
    fast_s = time.perf_counter() - t0
    real = Q._native_parser
    Q._native_parser = lambda: None
    try:
        slow = [(q.value, q.format)
                for q in map(Q.Quantity.parse, quantities)]
        t0 = time.perf_counter()
        for s in quantities:
            Q.Quantity.parse(s)
        slow_s = time.perf_counter() - t0
    finally:
        Q._native_parser = real
    need(fast == slow, "(d) the C parser != the Python oracle")
    rates = (len(quantities) / fast_s, len(quantities) / slow_s)
    how = ("already loaded by the background build the world's first parse "
           "started" if loaded else f"built and loaded in {build_s} s")
    report(f"phase 18 (d): the C quantity parser {how}; on the world's "
           f"{len(quantities)} quantities "
           f"({len(set(quantities))} distinct) == the oracle; "
           f"Quantity.parse {rates[0]} /s through it, {rates[1]} /s "
           "through the regex oracle (host)")
    return rates


def phase_replication(torch, TF, TB, workloads, started):
    """Phase 18: the replicated control plane with its replicas on the
    card. (a)'s CPU twin, and (c) then (b), run in child processes beside
    (a); (d) reads (a)'s world."""
    import pickle
    import shutil
    import tempfile

    t0 = time.perf_counter()
    after = REPLICA_AFTER if t0 - started <= REPLICA_LATE_S else 2
    twin = _Child("_replica_cpu_child",
                  env={"KARPENTER_SMOKE_REPLICA_AFTER": str(after)})
    others = _Child("_replica_binaries_child")
    root = tempfile.mkdtemp(prefix="karpenter-replicas-")
    launches, captured = [], {}
    real_solve = TB.solve

    def solve(inputs, *args, **kwargs):
        if kwargs.get("backend") == "cuda":
            captured["inputs"] = inputs
        return real_solve(inputs, *args, **kwargs)

    def each(rid, tick):
        torch.cuda.synchronize()
        TF.reset_launch_counts()
        try:
            tick()
        finally:
            torch.cuda.synchronize()
            launches.append((rid, dict(TF.LAUNCHES)))

    try:
        TB.solve = solve
        try:
            victim, card, probe, quantities, tick_ms = _replica_fleet(
                workloads, REPLICA_DEVICE, root, after, each=each)
        finally:
            TB.solve = real_solve
        tenants = _replica_check(victim, card, probe, after)
        per_tick = {name: [n[name] for _, n in launches]
                    for name in ("fused_assign", "shelf_bfd")}
        need(all(n >= 1 for counts in per_tick.values() for n in counts),
             f"(a) a replica tick launched no kernel: {launches}")
        need(len(launches) == len(REPLICA_IDS) * (REPLICA_BEFORE + 1)
             + (len(REPLICA_IDS) - 1) * after,
             f"(a) {len(launches)} replica ticks")
        ms, ms_by = _deploy_kernel_ms(torch, TB, TF, captured["inputs"])
        rows = captured["inputs"].pod_requests.shape[0]
        groups = captured["inputs"].group_allocatable.shape[0]
        t1 = time.perf_counter()
        report(f"phase 18 (a): {len(REPLICA_IDS)} card replicas "
               f"({REPLICA_OPTIONS}, {REPLICA_TENANTS} tenants) over "
               f"{BINARY_SHAPE}: {REPLICA_BEFORE} ticks, {victim} (the "
               f"biggest owner) killed, {after} more; the survivors hold "
               f"all {REPLICA_OPTIONS['partitions']} partitions, "
               f"{len(tenants)} victim tenants adopted at fence generation "
               f">= 2, warmup -> serving, every stale write rejected; "
               f"launches per replica tick {per_tick}; fleet tick ms "
               f"{tick_ms}; device ms per launch at the last tick's "
               f"operands ({rows} rows x {groups} groups, {ms_by}): {ms}; "
               f"{t1 - t0} s")
        rates = _quantity_parser(quantities)
        twin.join()
        with open(twin.path("replica_cpu.pickle"), "rb") as f:
            cpu_victim, cpu, cpu_probe = pickle.load(f)
        need(cpu_victim == victim and cpu_probe == probe,
             f"(a) the CPU twin killed {cpu_victim}: {cpu_probe}")
        need(len(cpu) == len(card), f"(a) {len(cpu)} CPU ticks")
        for tick, (got, want) in enumerate(zip(card, cpu)):
            need(got == want, f"(a) tick {tick}: the card != the CPU twin "
                 f"at {_first_difference(got, want)}")
        report(f"phase 18 (a): card == CPU twin on every one of {len(card)} "
               f"ticks (ownership, handoffs, fence generations, series, "
               f"objects, cloud replicas, exposition)")
        others.join()
    finally:
        twin.close()
        others.close()
        shutil.rmtree(root, ignore_errors=True)
    report(f"phase 18: {time.perf_counter() - t0} s")
    return {"launches_per_replica_tick": per_tick, "ms": ms, "ms_by": ms_by,
            "parse_rates": rates}


# -- phase 19: multi-device (parallel/mesh.py, parallel/multihost.py) ---------

# the shards: virtual copies of the card (utils/device.force_virtual_devices)
SHARD_DEVICE = "cuda"
SHARD_DEVICES = 8
SHARD_MESHES = (("4x2", dict(n_devices=8)),
                ("2x2x2", dict(n_devices=8, slices=2)),
                ("8x1", dict(shape=(8, 1))))
SHARD_ITERS = 10  # sharded and single-device solves, timed in turns
# (b)'s constrained solve: the plain route on every shard (the cuda rung
# reroutes constraint operands), claims, pack classes and a spread slot
SHARD_CONSTRAINED = dict(pods=20_000, types=50, taints=8, labels=8, seed=3)
# (c): each rank's card-route solve across the two processes
SHARD_RANK_SHAPE = dict(pods=20_000, types=300, taints=64, labels=64, seed=0)

# (c)'s two ranks: python -c _SHARD_RANK <rank> <port> <device>
_SHARD_RANK = r"""
import json, sys, time
import torch
rank, port, device = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.parallel import mesh as PM, multihost
from karpenter_tpu_torch.utils.device import force_virtual_devices
force_virtual_devices(4, device)  # 4 shards per rank on one card
t0 = time.perf_counter()
assert multihost.initialize_multihost(f"127.0.0.1:{port}", 2, rank,
                                      kind=torch.device(device).type)
assert len(multihost.global_devices()) == 8
joined = time.perf_counter() - t0
PM.dryrun_fleet_step(8)  # global 4x2 and 2x2x2 meshes, then a service
dry = time.perf_counter() - t0 - joined
inputs = TB.inputs_from_numpy(workloads.build_inputs(**SHAPE), device)
mesh = PM.build_mesh(n_devices=8, slices=2)
assert mesh.multi_rank and len(mesh.local_positions()) == 4
card = torch.device(device).type == "cuda"
TF.reset_launch_counts()
out = PM.sharded_binpack(mesh, inputs, 32, backend="cuda" if card else "auto")
launches = dict(TF.LAUNCHES)
single = TB.solve(inputs, buckets=32, backend="cuda" if card else "torch",
                  device=device)
for name in ("assigned", "assigned_count", "nodes_needed", "lp_bound",
             "unschedulable"):
    a, b = getattr(out, name).cpu().numpy(), getattr(single, name).cpu().numpy()
    assert a.tobytes() == b.tobytes(), name
if card:
    want = PM.launch_plan(PM.shard_binpack_inputs(mesh, inputs))
    # and one pack of the fresh operands' masks
    assert launches == {**want, "pack_bits": 1} and want["fused_assign"] == 4, (
        launches, want)
print("RANK-OK " + json.dumps({"rank": rank, "join_s": joined,
      "dryrun_s": dry, "launches": launches,
      "nodes": int(out.nodes_needed.sum())}), flush=True)
"""


def _host_outputs(out) -> dict:
    """{field: host array} of an outputs dataclass (tensors or arrays)."""
    import dataclasses

    import torch

    return {
        f.name: (getattr(out, f.name).cpu().numpy()
                 if isinstance(getattr(out, f.name), torch.Tensor)
                 else np.asarray(getattr(out, f.name)))
        for f in dataclasses.fields(out)
    }


def _shard_profile_ms(torch, TF, MESH, mesh, inputs):
    """({wrapper: device ms per launch at the slab shape}, how): the
    profiler's rows over 5 sharded solves; where it lost a kernel's rows
    (late in a long process), each wrapper's time by CUDA events around
    50 calls on the first slab's operands."""
    solve = lambda: MESH.sharded_binpack(  # noqa: E731
        mesh, inputs, BUCKETS, backend="cuda")
    names = {"fused_assign": ("assign_kernel",),
             "demand_reduce": ("demand_reduce_kernel",),
             "shelf_bfd": KERNEL_NAMES["shelf_bfd"]}
    ms = {}
    try:
        prof, _ = profile_window(torch, solve, 5)
        rows = device_rows(torch, prof)
    except RuntimeError:
        rows = []
    for name, keys in names.items():
        hits = [(us, c) for us, c, key in rows if any(k in key for k in keys)]
        if hits:
            ms[name] = sum(us for us, _ in hits) / sum(c for _, c in hits) / 1e3
    if len(ms) == len(names):
        return ms, "profiler, 5 sharded solves"
    sh = MESH.shard_binpack_inputs(mesh, inputs)
    start, stop = sh.bounds("pod_requests")[0]
    words = TF.pack_operands(sh.whole)
    slab = sh.shards[0]
    slab_words = (words[0][start:stop], words[1][start:stop], words[2],
                  words[3])
    _, hist, partial, unsched = TF.fused_assign_scan(slab, BUCKETS,
                                                     slab_words)
    t1 = -(-hist.shape[0] // mesh.size)
    ms = {
        "fused_assign": time_ms(lambda: TF.fused_assign_scan(
            slab, BUCKETS, slab_words), 50),
        "demand_reduce": time_ms(lambda: TF.demand_reduce(partial, unsched),
                                 50),
        "shelf_bfd": time_ms(lambda: TF.shelf_bfd(hist[:t1].contiguous(),
                                                  BUCKETS), 50),
    }
    return ms, "CUDA events around 50 wrapper calls (the profiler lost rows)"


def _shard_direct(torch, TF, TB, MESH, inputs):
    """(a) sharded_binpack on the three meshes == solve(backend="cuda")
    bitwise, with the stated launches; p50/p95 in turns; ms per launch
    at the slab shape; the card's dry run."""
    single = TB.solve(inputs, buckets=BUCKETS, backend="cuda")
    want = _host_outputs(single)
    launches = {}
    for label, kwargs in SHARD_MESHES:
        mesh = MESH.build_mesh(**kwargs)
        plan = MESH.launch_plan(MESH.shard_binpack_inputs(mesh, inputs))
        TF.reset_launch_counts()
        out = MESH.sharded_binpack(mesh, inputs, BUCKETS, backend="cuda")
        torch.cuda.synchronize()
        launches[label] = dict(TF.LAUNCHES)
        # and one pack of the whole operands' masks
        need(launches[label] == {**plan, "pack_bits": 1},
             f"(a) {label}: launched {launches[label]}, stated {plan}")
        need(plan == {"fused_assign": SHARD_DEVICES, "demand_reduce": 1,
                      "shelf_bfd": SHARD_DEVICES},
             f"(a) {label}: an empty slab at the main path: {plan}")
        n = same_bits(_host_outputs(out), want,
                      f"(a) {label} sharded vs solve(backend='cuda')")
        need(int(out.nodes_needed.sum()) == MAIN_NODES,
             f"(a) {label}: nodes {int(out.nodes_needed.sum())}")
    mesh = MESH.build_mesh(n_devices=SHARD_DEVICES)
    sharded = lambda: MESH.sharded_binpack(  # noqa: E731
        mesh, inputs, BUCKETS, backend="cuda")
    single_fn = lambda: TB.solve(  # noqa: E731
        inputs, buckets=BUCKETS, backend="cuda")
    times = {"sharded": [], "single": []}
    for i in range(SHARD_ITERS):
        order = (("sharded", sharded), ("single", single_fn))
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    pct = {name: (float(np.percentile(t, 50)), float(np.percentile(t, 95)))
           for name, t in times.items()}
    ms, ms_by = _shard_profile_ms(torch, TF, MESH, mesh, inputs)
    t0 = time.perf_counter()
    MESH.dryrun_fleet_step(SHARD_DEVICES)
    dry_s = time.perf_counter() - t0
    report(f"phase 19 (a): sharded_binpack on {[l for l, _ in SHARD_MESHES]} "
           f"x {SHARD_DEVICES} shards of {SHARD_DEVICE} == solve(backend="
           f"'cuda') bitwise on {n} leaves (nodes {MAIN_NODES}); launches "
           f"per sharded solve {launches['4x2']}; p50/p95 ms over "
           f"{SHARD_ITERS} in turns: sharded {pct['sharded']}, single "
           f"{pct['single']} (host clock); device ms per launch at the slab "
           f"shape ({ms_by}): {ms}; dryrun_fleet_step({SHARD_DEVICES}) on "
           f"the card {dry_s} s")
    return {"launches": launches, "ms": ms, "ms_by": ms_by, "p50_p95": pct,
            "dryrun_s": dry_s}


def _shard_constrained(workloads):
    """(b)'s constrained operands: SHARD_CONSTRAINED's draw with claims,
    reservations, pack classes and a spread slot over per-domain caps."""
    rng = np.random.default_rng(SHARD_CONSTRAINED["seed"])
    fields = workloads.build_inputs(**SHARD_CONSTRAINED)
    p, t = SHARD_CONSTRAINED["pods"], SHARD_CONSTRAINED["types"]
    pack = np.zeros((p, 3), bool)
    pack[np.arange(p), rng.integers(0, 3, p)] = True
    fields.update(
        pod_weight=rng.integers(1, 5, p).astype(np.int32),
        pod_claim=rng.integers(0, 2, p, dtype=np.int32),
        group_reservation=rng.integers(0, 2, t, dtype=np.int32),
        pod_pack_class=pack,
        pod_spread_slot=rng.integers(0, 3, p, dtype=np.int32),
        group_domain=rng.integers(0, 4, t, dtype=np.int32),
        spread_cap=rng.integers(500, 4000, (2, 4), dtype=np.int32),
    )
    return fields


def _shard_service(torch, TF, TB, MESH, workloads, host_inputs, batch):
    """(b) SolverService() on the card over the virtual shards: the main
    path rides the shard route at the default threshold; at threshold 1
    decide, forecast, preempt, a constrained solve and a consolidation
    batch equal the single-device answers bitwise."""
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import service as S

    svc = S.SolverService(registry=GaugeRegistry())
    svc1 = S.SolverService(registry=GaugeRegistry(), shard_threshold=1)
    try:
        single = _host_outputs(TB.solve(host_inputs, buckets=BUCKETS,
                                        backend="cuda"))
        mesh = MESH.build_mesh(n_devices=SHARD_DEVICES)
        plan = MESH.launch_plan(MESH.shard_binpack_inputs(mesh, host_inputs))
        TF.reset_launch_counts()
        t0 = time.perf_counter()
        got = svc.solve(host_inputs)
        solve_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(TF.LAUNCHES)
        st = svc.stats
        need((st.shard_requests, st.shard_dispatches, st.shard_fallbacks,
              st.fallbacks) == (1, 1, 0, 0),
             f"(b) the main path through SolverService(): {st}")
        # the shard route uploads the host operands anew: one pack
        need(launches == {**plan, "pack_bits": 1},
             f"(b) launched {launches}, stated {plan}")
        svc.publish_gauges()
        devices = svc._g_shard.get("-", "-")
        need(devices == SHARD_DEVICES, f"(b) the shard gauge reads {devices}")
        same_bits(_host_outputs(got), single, "(b) service main path vs "
                  "single-device")
        checks = {}
        fleet = workloads.build_decision_inputs(0, FLEET_N, FLEET_M)
        checks["decide"] = (svc1.decide(fleet), svc.decide(fleet))
        forecast = workloads.build_fused_tick_inputs(0, **TICK_SHAPE)[
            "forecast"]
        checks["forecast"] = (svc1.forecast(forecast), svc.forecast(forecast))
        evict = workloads.build_preempt_inputs(**PREEMPT_SEAM)
        checks["preempt"] = (svc1.preempt(evict), svc.preempt(evict))
        constrained = TB.BinPackInputs(**_shard_constrained(workloads))
        checks["constrained"] = (svc1.solve(constrained),
                                 svc.solve(constrained))
        TF.reset_launch_counts()
        consolidated = svc1.consolidate(batch)
        batch_launches = dict(TF.LAUNCHES)
        for i, (a, b) in enumerate(zip(consolidated, svc.consolidate(batch))):
            checks[f"consolidate[{i}]"] = (a, b)
        for what, (a, b) in checks.items():
            same_bits(_host_outputs(a), _host_outputs(b),
                      f"(b) {what}: threshold 1 vs single-device")
        s1 = svc1.stats
        want = 4 + len(batch)
        need((s1.shard_dispatches, s1.shard_fallbacks, s1.fallbacks,
              st.fallbacks, st.shard_dispatches) == (want, 0, 0, 0, 1),
             f"(b) shard_dispatches {s1.shard_dispatches} (want {want}), "
             f"fallbacks {s1.shard_fallbacks} / {s1.fallbacks} / "
             f"{st.fallbacks}, single-device service {st.shard_dispatches}")
        need(batch_launches["demand_reduce"] == len(batch),
             f"(b) the batch launched {batch_launches}")
        report(f"phase 19 (b): SolverService() over {SHARD_DEVICES} virtual "
               f"shards: the main path at the default threshold took the "
               f"shard route (requests 1, dispatches 1, shard_fallbacks 0, "
               f"fallback_total 0, gauge {devices}), {solve_ms} ms, launches "
               f"{launches}, == single-device bitwise; at threshold 1 "
               f"{sorted(k for k in checks if '[' not in k)} and a "
               f"{len(batch)}-candidate consolidation batch (launches "
               f"{batch_launches}) == the single-device service bitwise")
        return {"launches": launches, "solve_ms": solve_ms,
                "batch_launches": batch_launches}
    finally:
        svc.close()
        svc1.close()


def _multidevice_child(workloads, out_dir: str) -> None:
    """(c) in a child: two ranks of one card joined over gloo, and beside
    them two `--multihost` sidecars joined into a fleet of their own."""
    import subprocess

    from karpenter_tpu_torch.ops import binpack as TB
    from karpenter_tpu_torch.sidecar.client import SolverClient

    t0 = time.perf_counter()
    port, coord = _free_port(), _free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    script = _SHARD_RANK.replace("**SHAPE", f"**{SHARD_RANK_SHAPE!r}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(rank), str(port), SHARD_DEVICE],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    ) for rank in (0, 1)]
    args = ("--multihost",) + (() if SHARD_DEVICE == "cuda"
                               else ("--device", "cpu"))
    sidecars = [_Sidecar([*_LOCAL_SIDECAR, *args], env=dict(
        os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(coord),
        WORLD_SIZE="2", RANK=str(rank))) for rank in (0, 1)]
    outs = []
    try:
        ports = [sidecar.wait_serving() for sidecar in sidecars]
        with np.load(os.environ["KARPENTER_SMOKE_OPERANDS"]) as data:
            inputs = TB.BinPackInputs(**{k: data[k] for k in data.files})
        with SolverClient(f"127.0.0.1:{ports[0]}",
                          timeout_seconds=120.0) as client:
            ok, health = client.health()
            need(ok and health["device_count"] == 2
                 and health["backend"] == SHARD_DEVICE,
                 f"(c) the coordinator's Health: {health}")
            remote = client.solve(inputs, buckets=BUCKETS)
        local = TB.solve(inputs, buckets=BUCKETS,
                         backend="cuda" if SHARD_DEVICE == "cuda" else "torch",
                         device=SHARD_DEVICE)
        n = same_bits(_host_outputs(remote), _host_outputs(local),
                      "(c) a --multihost sidecar's Solve vs in-process")
        t1 = time.perf_counter()
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for sidecar in sidecars:
            sidecar.stop()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        need(proc.returncode == 0 and "RANK-OK" in out,
             f"(c) rank {rank} failed:\n{out[-3000:]}")
        print(f"(c) rank {rank}: {out.strip().splitlines()[-1]}")
    report(f"phase 19 (c), beside (a) and (b): two ranks on one card joined "
           f"over gloo, each dryrun_fleet_step(8) on its global meshes and "
           f"a card-route solve at {SHARD_RANK_SHAPE} on a 2x2x2 mesh == "
           f"single-process bitwise; beside them two --multihost sidecars: "
           f"Health device_count 2, backend {SHARD_DEVICE}, a Solve RPC at "
           f"phase 16's operands ({inputs.pod_requests.shape[0]} rows x "
           f"{inputs.group_allocatable.shape[0]} groups) == in-process on "
           f"{n} leaves ({t1 - t0} s); (c) {time.perf_counter() - t0} s")


def phase_multidevice(torch, TF, TB, workloads, inputs, host_inputs,
                      deployment, disruption):
    """Phase 19: the shard route on the card (module docstring)."""
    import dataclasses
    import tempfile

    from karpenter_tpu_torch.parallel import mesh as MESH
    from karpenter_tpu_torch.utils import device as UD

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="karpenter-multidevice-")
    operands = os.path.join(root, "solve_operands.npz")
    solve_inputs = deployment["solve_inputs"]
    np.savez(operands, **{
        f.name: np.asarray(getattr(solve_inputs, f.name))
        for f in dataclasses.fields(solve_inputs)
        if getattr(solve_inputs, f.name) is not None
    })
    child = _Child("_multidevice_child",
                   env={"KARPENTER_SMOKE_OPERANDS": operands})
    try:
        UD.force_virtual_devices(SHARD_DEVICES, SHARD_DEVICE)
        try:
            direct = _shard_direct(torch, TF, TB, MESH, inputs)
            service = _shard_service(torch, TF, TB, MESH, workloads,
                                     host_inputs,
                                     disruption["profile"]["batch"])
        finally:
            UD.reset_virtual_devices()
        child.join(timeout=600)
    finally:
        child.close()
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    report(f"phase 19: {seconds} s")
    return {"direct": direct, "service": service, "seconds": seconds}


def profile_solves(torch, TB, inputs, n=ITERS):
    """Where a solve's time goes: the mean of back-to-back solves by CUDA
    events, then a torch.profiler window of n solves (device time by
    kernel, device busy share of the window). Returns {kernel name:
    (device us per solve, launches per solve)} over the device rows, or
    None when the profiler cannot trace the card (reported, not fatal)."""
    solve = lambda: TB.solve(inputs, buckets=BUCKETS, backend="cuda")  # noqa: E731
    b2b_ms = time_ms(solve, ITERS)
    report(f"main path solve back-to-back, CUDA events: {b2b_ms} ms")
    try:
        prof, wall_us = profile_window(torch, solve, n)
    except RuntimeError as exc:
        print(f"profiler: not available ({exc})")
        return None
    rows = device_rows(torch, prof)
    if not rows:
        print("profiler: no device rows")
        return None
    busy_us = sum(r[0] for r in rows)
    report(f"profiler, {n} solves: window {wall_us} us (profiler on), device "
           f"busy {busy_us} us = {busy_us / n} us/solve "
           f"({100.0 * busy_us / wall_us if wall_us else 0.0}% of the window; "
           f"{100.0 * busy_us / n / (1e3 * b2b_ms)}% of a back-to-back solve)")
    for dev_us, count, key in rows[:12]:
        print(f"  device {dev_us / n} us/solve  x{count / n}/solve  {key[:90]}")
    return {key: (dev_us / n, count / n) for dev_us, count, key in rows}


def profile_window(torch, fn, n, warmup=2):
    """(profile, wall us) of n calls of `fn` under torch.profiler. The
    schedule's warm-up steps run the profiler before the n recorded calls,
    so none of their device events is lost to its start; each warm-up
    call is synchronized before its step ends, so none of its kernels
    lands in the window; the window ends in synchronize()."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=warmup, active=n, repeat=1),
    ) as prof:
        for _ in range(warmup):
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            fn()
            if i == n - 1:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
    return prof, wall_us


# record_function ranges the profiled code opens: the profiler shows each
# as a device row spanning the kernels inside it, which are rows already
ANNOTATIONS = ("ProfilerStep", "pendingcapacity.solve", "solver.",
               "autoscaler.")


def device_rows(torch, prof):
    """[(device us, count, name)] of a profile's device-side rows (kernels,
    memcpy, memset), largest first: an aten op's row repeats the time of
    the kernels it launched, so only these are summed, and so does a
    record_function range on the device (ANNOTATIONS)."""
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith(ANNOTATIONS)):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    return sorted(rows, reverse=True)


def profile_per_call(torch, fn, n=5):
    """(device ops per call, kernels per call, device busy us per call) of
    `fn` from a torch.profiler window of n calls, or None when the
    profiler cannot trace the card or shows no device rows. Kernels leave
    out the memcpy and memset rows."""
    try:
        prof, _ = profile_window(torch, fn, n)
    except RuntimeError as exc:
        print(f"profiler: not available ({exc})")
        return None
    rows = device_rows(torch, prof)
    if not rows:
        return None
    ops = sum(count for _, count, _ in rows)
    kernels = sum(count for _, count, key in rows
                  if not key.startswith(("Memcpy", "Memset")))
    return ops / n, kernels / n, sum(us for us, _, _ in rows) / n


def device_ms(profile, wrapper):
    """(device ms per solve, device kernels per solve) of a wrapper's own
    kernels, from profile_solves' rows; (None, None) without them."""
    if not profile:
        return None, None
    hits = [v for key, v in profile.items()
            if any(name in key for name in KERNEL_NAMES[wrapper])]
    if not hits:
        return None, None
    return sum(us for us, _ in hits) / 1e3, sum(c for _, c in hits)


def kernel_records(torch, TB, TF, inputs, launches, profile, reconcile,
                   service, disruption, runtime, simulate, kube, deployment,
                   tenancy, replication, multidevice):
    """Per-kernel JSON records at the main path's shapes. `ms` is device
    time per launch from the profiler's rows of the kernel's own names
    (the fused row sums its two kernels); `call_ms` is the wrapper's time
    by CUDA events around 50 calls, which the host's enqueue bounds when
    the kernels are short. `launches` is the wrapper's count from the main
    path's single solve; `device_kernels_per_solve` counts the device
    kernels behind it (the fused wrapper launches two). Fails when the
    profiler shows none of a wrapper's kernels: `ms` never holds a host
    time. `reconcile_launches` is the wrapper's count over phase 9's first
    reconcile tick, `reconcile_ms` its device time per launch there (the
    fused kernel's generic instance at R = 4). `service_launches` is the
    wrapper's count over phase 10's one main-path request through
    SolverService(), `service_ms` its device time per launch there and
    `service_instance` the fused instance that ran (the cuda rung does not
    pad, so R = 3 takes the narrow one). `disruption_launches` is the
    wrapper's count over phase 12's rounds, `disruption_launches_per_plan`
    its launches per consolidation plan in the profiled plan (one per
    candidate with pods), `disruption_ms` its device time per launch
    there (T = the cluster's nodes, with the forbidden operand) and
    `disruption_instance` the fused instance(s) that ran.
    `runtime_launches_first_tick` is the wrapper's count over phase 13's
    first manager tick, `runtime_launches_per_tick` its counts over the
    churned ticks (each churn's event pass and the tick), and
    `runtime_ms` the device time per kernel launch in the runtime's
    profiled ticks. `simulate_launches` is the wrapper's count over phase
    14's in-process dry run on a card runtime (one solve),
    `simulate_what_if_launches` over its what-if delta (two solves),
    `simulate_ms` its device time per launch at the dry run's shapes;
    `simulate_consolidate_launches` over `--simulate --consolidate`'s
    report on the card (one per candidate with pods,
    `simulate_consolidate_candidates` of them) and
    `simulate_consolidate_ms` its device time per launch.
    `kube_launches_first_tick` is the wrapper's count over phase 15's
    first tick of the card runtime over the fake kube-apiserver,
    `kube_launches_per_tick` its counts over the timed churned ticks,
    `kube_ms` its device time per launch at the last churned tick's
    operands (solve(backend="cuda"), the service's cuda rung's call) and
    `kube_simulate_launches` its count over `--simulate --apiserver`.
    `sidecar_launches_per_tick` is the wrapper's count over phase 16's
    last churned tick of the controller split from its card (all of them
    in the sidecar's service), `sidecar_ms` its device time per launch at
    that tick's operands (`sidecar_ms_by`: the profiler's device time,
    or CUDA events around the wrapper where the profiler lost the rows),
    `sidecar_request_bytes` the tick's Solve
    request on the wire and `sidecar_transport` the leg that carried it
    (grpc and its version). `tenancy_launches_per_round` is the
    wrapper's count over one solve_all round of phase 17 (b)'s 64 tenants,
    `tenancy_ms` its device time per launch at their operands
    (`tenancy_ms_by` as `sidecar_ms_by`).
    `replication_launches_per_replica_tick` is the wrapper's count over
    each live replica's tick of phase 18 (a), in tick and replica order,
    `replication_ms` its device time per launch at the last tick's
    operands (`replication_ms_by` as `sidecar_ms_by`).
    `shard_launches_per_solve` is the wrapper's count over one sharded
    solve of the main path in phase 19 (a), by mesh (8 virtual shards of
    the card), and `shard_ms` its device time per launch at the slab
    shape (`shard_ms_by` as `sidecar_ms_by`); the fused record also
    carries the sharded solve's one demand reduction
    (`shard_reduce_launches_per_solve`, `shard_reduce_ms`), a launch of
    fused_assign.cu's second kernel through its own host entry."""
    assigned, hist, demand, _ = TF.fused_assign(inputs, BUCKETS)
    plain_demand = TF.fused_assign_reference(inputs, BUCKETS)[2]
    # each kernel's analytic work on this run's data (the scan visits a
    # row's groups up to its first feasible one): TF.kernel_cost, which
    # the introspection plane's cost attribution also reports
    costs = TF.kernel_cost(inputs, BUCKETS, assigned.cpu().numpy(),
                           hist.cpu().numpy())
    fused_ops, fused_bytes = costs["fused_assign"]
    shelf_operations, shelf_bytes = costs["shelf_bfd"]
    fused_call_ms = time_ms(lambda: TF.fused_assign(inputs, BUCKETS), 50)
    fused_plain_ms = time_ms(
        lambda: TF.fused_assign_reference(inputs, BUCKETS), 5
    )
    shelf_call_ms = time_ms(lambda: TF.shelf_bfd(hist, BUCKETS), 50)
    shelf_plain_ms = time_ms(lambda: TF.shelf_bfd_reference(hist, BUCKETS), 3)

    def bound(nbytes, ops):
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = ops / PEAK_OPS_PER_S * 1e3
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    fb, fby = bound(fused_bytes, fused_ops)
    sb, sby = bound(shelf_bytes, shelf_operations)
    got_nodes, got_count = TF.shelf_bfd(hist, BUCKETS)
    want_nodes, want_count = TF.shelf_bfd_reference(hist, BUCKETS)
    shelf_err = float(max((got_nodes - want_nodes).abs().max(),
                          (got_count - want_count).abs().max()))
    records = []
    for name, source, replaces, err, call_ms, plain_ms, b, by in (
        ("fused_assign", "karpenter_tpu_torch/csrc/fused_assign.cu",
         "karpenter_tpu/ops/pallas_binpack.py:46",
         float((demand.double() - plain_demand.double()).abs().max()),
         fused_call_ms, fused_plain_ms, fb, fby),
        ("shelf_bfd", "karpenter_tpu_torch/csrc/shelf_bfd.cu",
         "karpenter_tpu/ops/binpack.py:342", shelf_err,
         shelf_call_ms, shelf_plain_ms, sb, sby),
    ):
        ms, per_solve = device_ms(profile, name)
        need(ms is not None,
             f"{name}: the profiler shows no device time for "
             f"{KERNEL_NAMES[name]}")
        records.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "device_kernels_per_solve": per_solve,
            "reconcile_launches": reconcile["launches"][name],
            "reconcile_ms": reconcile[
                "fused_ms" if name == "fused_assign" else "shelf_ms"],
            "service_launches": service["launches"][name],
            "service_ms": service[
                "fused_ms" if name == "fused_assign" else "shelf_ms"],
            "service_instance": (service["instance"]
                                 if name == "fused_assign" else None),
            "disruption_launches": disruption["launches"][name],
            "disruption_launches_per_plan": disruption["profile"][
                "launches_per_plan"][name],
            "disruption_ms": disruption["profile"][
                "fused_ms" if name == "fused_assign" else "shelf_ms"],
            "disruption_instance": (disruption["profile"]["instances"]
                                    if name == "fused_assign" else None),
            "runtime_launches_first_tick": runtime["first_launches"][name],
            "runtime_launches_per_tick": runtime["launches_per_tick"][name],
            "runtime_ms": (runtime["profile"][name]["ms"]
                           if runtime["profile"] else None),
            "simulate_launches": simulate["dry_run"]["launches"][name],
            "simulate_what_if_launches": simulate["dry_run"][
                "what_if_launches"][name],
            "simulate_ms": simulate["dry_run"]["ms"][name],
            "simulate_consolidate_launches": simulate["consolidate"][
                "launches"][name],
            "simulate_consolidate_candidates": simulate["consolidate"][
                "candidates"],
            "simulate_consolidate_ms": simulate["consolidate"]["ms"][name],
            "kube_launches_first_tick": kube["first_launches"][name],
            "kube_launches_per_tick": kube["launches_per_tick"][name],
            "kube_ms": kube["ms"][name],
            "kube_simulate_launches": kube["dry_launches"][name],
            "sidecar_launches_per_tick": deployment["launches_per_tick"][
                name],
            "sidecar_ms": deployment["ms"][name],
            "sidecar_ms_by": deployment["ms_by"],
            "sidecar_request_bytes": deployment["request_bytes"],
            "sidecar_transport": deployment["transport"],
            "tenancy_launches_per_round": tenancy["launches_per_round"][
                name],
            "tenancy_ms": tenancy["ms"][name],
            "tenancy_ms_by": tenancy["ms_by"],
            "replication_launches_per_replica_tick": replication[
                "launches_per_replica_tick"][name],
            "replication_ms": replication["ms"][name],
            "replication_ms_by": replication["ms_by"],
            "shard_launches_per_solve": {
                label: counts[name]
                for label, counts in multidevice["direct"]["launches"].items()
            },
            "shard_ms": multidevice["direct"]["ms"][name],
            "shard_ms_by": multidevice["direct"]["ms_by"],
            **({"shard_reduce_launches_per_solve": {
                label: counts["demand_reduce"]
                for label, counts in multidevice["direct"]["launches"].items()
            }, "shard_reduce_ms": multidevice["direct"]["ms"]["demand_reduce"]}
               if name == "fused_assign" else {}),
            "max_abs_err": err,
            "ms": ms,
            "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": b,
            "bound_by": by,
            "library_ms": None,
        })
    records.append(pack_record(torch, TB, TF, inputs, launches, service))
    return records


def pack_record(torch, TB, TF, inputs, launches, service):
    """The pack kernel's record (csrc/fused_assign.cu's pack_bits_kernel)
    at the main path's four masks (100k x 64 twice, 300 x 64 twice, the
    labels inverted): `ms` its device time per launch (`ms_by`: the
    profiler over ITERS launches, or queued_ms where it lost the rows),
    `call_ms` pack_masks by CUDA events around 50 calls, `plain_ms` the
    plain pack_bits chain on the card for the same four masks,
    `bound_ms` the bytes read and written at PEAK_BYTES_PER_S, and
    `max_abs_err` the largest difference of any mask bit between the
    kernel's words and the plain version's (0 required). `launches` is
    the main path's first solve's count, `fresh_solve_launches` a cuda
    solve's of the same operands again (1 required: every solve packs),
    `service_launches` phase 10's main-path request's."""
    masks = (inputs.pod_intolerant, inputs.pod_required,
             inputs.group_taints, inputs.group_labels)
    invert = (False, False, False, True)
    pack = lambda: TF.pack_masks(masks, invert)  # noqa: E731
    plain = lambda: tuple(TF.pack_bits(~m if inv else m)  # noqa: E731
                          for m, inv in zip(masks, invert))
    got, want = pack(), plain()
    torch.cuda.synchronize()
    err = 0.0 if all(torch.equal(a, b) for a, b in zip(got, want)) else 1.0
    need(err == 0.0, "pack_masks' words != the plain pack_bits'")
    TF.reset_launch_counts()
    TB.solve(inputs, buckets=BUCKETS, backend="cuda")
    fresh_launches = TF.LAUNCHES["pack_bits"]
    need(fresh_launches == 1, f"a solve packed {fresh_launches} times")
    def ranged():
        # key_averages() keeps a kernel only under a host range or op
        with torch.profiler.record_function("pack_masks"):
            return pack()

    TF.reset_launch_counts()
    prof, _ = profile_window(torch, ranged, ITERS)
    need(TF.LAUNCHES["pack_bits"] == ITERS + 2,
         f"{ITERS + 2} pack_masks calls launched {TF.LAUNCHES}")
    rows = device_rows(torch, prof)
    hits = [(us, c) for us, c, key in rows if "pack_bits_kernel" in key]
    if hits:
        need(sum(c for _, c in hits) == ITERS,
             f"the profiler shows {hits} pack_bits_kernel rows for {ITERS} "
             f"launches")
        ms, ms_by = sum(us for us, _ in hits) / ITERS / 1e3, "profiler"
    else:
        ms, ms_by = queued_ms(torch, pack), (
            f"CUDA events around 50 launches queued behind a device sleep "
            f"(the profiler's {len(rows)} device rows hold none)")
    nbytes = (sum(m.numel() for m in masks)
              + sum(8 * w.numel() for w in got))
    record = {
        "name": "pack_bits",
        "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/fused_assign.cu",
        "replaces": ("karpenter_tpu_torch/ops/fused_assign.py::pack_bits "
                     "(a PyTorch chain; the reference pads its bool masks "
                     "in XLA, karpenter_tpu/ops/pallas_binpack.py:215)"),
        "launches": launches["pack_bits"],
        "fresh_solve_launches": fresh_launches,
        "service_launches": service["launches"]["pack_bits"],
        "bytes": nbytes,
        "max_abs_err": err,
        "ms": ms,
        "ms_by": ms_by,
        "call_ms": time_ms(pack, 50),
        "plain_ms": time_ms(plain, 5),
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }
    report(f"pack_bits_kernel at the main path's four masks: {ms} ms a "
           f"launch ({ms_by}; bound {record['bound_ms']} ms, {nbytes} bytes), "
           f"call {record['call_ms']} ms, plain chain {record['plain_ms']} "
           f"ms, words == plain")
    return record


def _failed_at(exc) -> str:
    """The innermost line of this script that a phase's exception passed
    through, less the `need` and `_Child.join` helpers: the check that
    failed."""
    import traceback

    here = os.path.abspath(__file__)
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if os.path.abspath(f.filename) == here
              and f.name not in ("need", "join")]
    if not frames:
        return "an unknown line"
    f = frames[-1]
    return f"chip_smoke.py:{f.lineno} in {f.name} ({(f.line or '').strip()})"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from karpenter_tpu_torch import kernels, workloads
        from karpenter_tpu_torch.forecast import models as M
        from karpenter_tpu_torch.ops import binpack as TB
        from karpenter_tpu_torch.ops import decision as D
        from karpenter_tpu_torch.ops import fused_assign as TF
        from karpenter_tpu_torch.ops import fusedtick as FT
        from karpenter_tpu_torch.parallel import mesh as MESH
        from karpenter_tpu_torch.utils.device import card_info
    except ImportError as exc:
        print(f"chip_smoke: the port's package is not importable: {exc}",
              file=sys.stderr)
        return 2
    # the plain path's f32 products run in full f32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    CARD["line"] = card_info()["line"]
    print(f"card: {CARD['line']}")
    started = t0 = time.perf_counter()
    kernels.build(verbose=True)
    report(f"kernel build (nvcc, parallel): {time.perf_counter() - t0} s")

    t0 = time.perf_counter()
    fields = workloads.build_inputs(**MAIN_SHAPE)
    inputs = TB.inputs_from_numpy(fields, "cuda")
    # the same problem as the host arrays a service caller hands over
    host_inputs = TB.BinPackInputs(**fields)
    torch.cuda.synchronize()
    print(f"main path inputs {MAIN_SHAPE}: {time.perf_counter() - t0} s")

    failed = []
    results = {}
    phases = [
        ("fused kernel vs plain",
         lambda: phase_fused(torch, TB, TF, inputs, workloads)),
        ("shelf kernel vs plain", lambda: phase_shelf(
            torch, TF, TF.fused_assign(inputs, BUCKETS)[1])),
        ("main path", lambda: phase_main(torch, TB, TF, inputs)),
        ("wide fleet solve", lambda: phase_wide_solve(torch, TB, workloads)),
        ("small card vs CPU", lambda: phase_small_vs_cpu(torch, TB, TF)),
        ("decision at fleet scale",
         lambda: phase_decision(torch, D, workloads)),
        ("fleet step", lambda: phase_fleet_step(
            torch, TB, TF, D, MESH, inputs,
            results["decision at fleet scale"])),
        ("fused tick", lambda: phase_fused_tick(torch, FT, M, workloads)),
        ("reconcile tick",
         lambda: phase_reconcile(torch, TB, TF, workloads)),
        ("solve service", lambda: phase_service(
            torch, TB, TF, workloads, inputs, host_inputs,
            results["reconcile tick"])),
        ("HA tick", lambda: phase_ha_tick(torch, FT, M, workloads)),
        ("disruption", lambda: phase_disruption(torch, TF, workloads)),
        ("controller binary", lambda: phase_runtime(
            torch, TF, workloads, started)),
        ("simulate", lambda: phase_simulate(torch, TF, workloads)),
        ("real-cluster mode", lambda: phase_kube(
            torch, TF, workloads, results["simulate"])),
        ("the shipped Deployment", lambda: phase_deployment(
            torch, TF, TB, workloads, started)),
        ("multi-tenant control plane", lambda: phase_multitenant(
            torch, TF, TB, workloads, started)),
        ("replicated control plane", lambda: phase_replication(
            torch, TF, TB, workloads, started)),
        ("multi-device", lambda: phase_multidevice(
            torch, TF, TB, workloads, inputs, host_inputs,
            results["the shipped Deployment"], results["disruption"])),
    ]
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            results[name] = run()
            print(f"PHASE OK: {name} ({time.perf_counter() - t0} s; "
                  f"{time.perf_counter() - started} s of smoke)")
        except Exception as exc:  # noqa: BLE001 — report every phase, then fail
            import traceback

            traceback.print_exc()
            print(f"PHASE FAILED: {name} ({time.perf_counter() - t0} s): "
                  f"{exc!r}")
            failed.append((name, _failed_at(exc), exc))
    if failed:
        # the reasons again at the very end of stderr, where a reader of
        # only its last lines finds them after later phases' logging
        for name, where, exc in failed:
            print(f"chip_smoke: phase {name!r} failed at {where}: "
                  f"{repr(exc)[:2000]}", file=sys.stderr)
        print(f"chip_smoke: failed phases {[n for n, _, _ in failed]}",
              file=sys.stderr)
        return 1
    _, launches = results["main path"]
    profile = profile_solves(torch, TB, inputs)
    records = kernel_records(torch, TB, TF, inputs, launches, profile,
                             results["reconcile tick"],
                             results["solve service"],
                             results["disruption"],
                             results["controller binary"],
                             results["simulate"],
                             results["real-cluster mode"],
                             results["the shipped Deployment"],
                             results["multi-tenant control plane"],
                             results["replicated control plane"],
                             results["multi-device"])
    records.extend(results["fused tick"])
    report(f"chip_smoke wall time: {time.perf_counter() - started} s "
           f"(kernel build and all nineteen phases)")
    print(f"card: {CARD['line']}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
