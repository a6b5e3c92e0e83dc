#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (karpenter_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (set-up, with ptxas's register,
shared-memory and stack report), then runs eight phases and fails (exit 1,
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
   stage's share of them, and the peak of allocated device memory.

Then it profiles 20 main-path solves (torch.profiler: device time by
kernel) and prints, before the last line, one JSON line of kernel records
(`ms` is device time per launch from the profiler, and the smoke fails
without it; `call_ms` is the wrapper's time by CUDA events around 50
calls), and as the last line
{"ok": true, "device": {...}}. Every line with a measured number ends
with the card's name and power limit. Without a CUDA device, or without
the rest of the repo beside it, it exits non-zero and prints no result.
Imports neither jax nor karpenter_tpu.
"""

from __future__ import annotations

import json
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
KERNEL_NAMES = {
    "fused_assign": ("assign_kernel", "demand_reduce_kernel"),
    "shelf_bfd": ("shelf_bfd_warp_kernel", "shelf_bfd_wide_kernel"),
}
# phases 6-8 at the repo's published sizes (BASELINE.json): 1000 tenants
# x 4 autoscalers padded to pad_to's 64-row bucket, 3 metrics; 2,048
# series x 64 samples; 64 pool groups x 4 pools
FLEET_N, FLEET_M = 4096, 3
TICK_SHAPE = dict(n=FLEET_N, m=FLEET_M, s=2048, t=64, groups=64, pools=4)
# the card's `nvidia-smi --query-gpu=name,power.limit` line, set in main()
CARD = {"line": "not read"}


def need(ok, what: str) -> None:
    """A check that holds under python -O too."""
    if not ok:
        raise AssertionError(what)


def report(line: str) -> None:
    """Print a line of measured numbers with the card it was measured on."""
    print(f"{line} [card: {CARD['line']}]")


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


def shelf_ops(hist: np.ndarray, buckets: int) -> int:
    """Integer steps the shelf algorithm takes on this histogram: each
    visit of a remnant slot (a min, a compare, two updates, a subtract) is
    counted as 5 operations, each size's bin opening as 10."""
    steps = 0
    for row in hist:
        bins = np.zeros(buckets + 1, np.int64)
        for k in range(buckets, 0, -1):
            c = int(row[k - 1])
            while c > 0:
                placed = False
                for rem in range(k, buckets + 1):
                    steps += 5
                    m = min(c, int(bins[rem]))
                    if m > 0:
                        bins[rem] -= m
                        bins[rem - k] += m
                        c -= m
                        placed = True
                    if c == 0:
                        break
                if not placed:
                    break
            if c > 0:
                steps += 10
                per_bin = buckets // k
                full, leftover = divmod(c, per_bin)
                bins[buckets - per_bin * k] += full
                if leftover > 0:
                    bins[buckets - leftover * k] += 1
    return steps


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
    for name, n in launches.items():
        need(n > 0, f"kernel {name} was not launched on the main path")
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
    for name, n in launches.items():
        need(n > 0, f"kernel {name} was not launched by fleet_step")
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
    report(f"fused tick phase: peak allocated device memory "
           f"{torch.cuda.max_memory_allocated()} bytes")


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


def device_rows(torch, prof):
    """[(device us, count, name)] of a profile's device-side rows (kernels,
    memcpy, memset), largest first: an aten op's row repeats the time of
    the kernels it launched, so only these are summed, and so does the
    schedule's `ProfilerStep#` annotation on the device."""
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("ProfilerStep")):
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


def kernel_records(torch, TB, TF, inputs, launches, profile):
    """Per-kernel JSON records at the main path's shapes. `ms` is device
    time per launch from the profiler's rows of the kernel's own names
    (the fused row sums its two kernels); `call_ms` is the wrapper's time
    by CUDA events around 50 calls, which the host's enqueue bounds when
    the kernels are short. `launches` is the wrapper's count from the main
    path's single solve; `device_kernels_per_solve` counts the device
    kernels behind it (the fused wrapper launches two). Fails when the
    profiler shows none of a wrapper's kernels: `ms` never holds a host
    time."""
    from karpenter_tpu_torch.ops.fused_assign import _packed

    pods, n_res = inputs.pod_requests.shape
    groups = inputs.group_allocatable.shape[0]
    intol_w, required_w, taint_w, nolabel_w = _packed(inputs)
    kw, lw = intol_w.shape[1], required_w.shape[1]
    assigned, hist, demand, _ = TF.fused_assign(inputs, BUCKETS)
    plain_demand = TF.fused_assign_reference(inputs, BUCKETS)[2]
    a = assigned.cpu().numpy()
    valid = inputs.pod_valid.cpu().numpy()
    # (row, group) pairs the scan visits: up to the first feasible group,
    # all groups for a row with none; invalid rows visit none
    pairs = int(np.where(a >= 0, a + 1, groups)[valid].sum())
    fused_ops = pairs * (n_res + kw + lw) + int((a >= 0).sum()) * (3 * n_res + 6)
    fused_bytes = (
        pods * (4 * n_res + 1 + 8 * (kw + lw) + 4)  # rows in, assigned out
        + groups * (4 * n_res + 8 * (kw + lw))  # groups in
        + groups * (4 * BUCKETS + 4 * n_res)  # hist, demand out
    )
    fused_call_ms = time_ms(lambda: TF.fused_assign(inputs, BUCKETS), 50)
    fused_plain_ms = time_ms(
        lambda: TF.fused_assign_reference(inputs, BUCKETS), 5
    )
    shelf_call_ms = time_ms(lambda: TF.shelf_bfd(hist, BUCKETS), 50)
    shelf_plain_ms = time_ms(lambda: TF.shelf_bfd_reference(hist, BUCKETS), 3)
    shelf_bytes = groups * (4 * BUCKETS + 4)
    shelf_operations = shelf_ops(hist.cpu().numpy(), BUCKETS)

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
            "max_abs_err": err,
            "ms": ms,
            "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": b,
            "bound_by": by,
            "library_ms": None,
        })
    return records


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
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    report(f"kernel build (nvcc, parallel): {time.perf_counter() - t0} s")

    t0 = time.perf_counter()
    fields = workloads.build_inputs(**MAIN_SHAPE)
    inputs = TB.inputs_from_numpy(fields, "cuda")
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
    ]
    for name, run in phases:
        try:
            results[name] = run()
            print(f"PHASE OK: {name}")
        except Exception as exc:  # noqa: BLE001 — report every phase, then fail
            import traceback

            traceback.print_exc()
            print(f"PHASE FAILED: {name}: {exc!r}")
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    _, launches = results["main path"]
    profile = profile_solves(torch, TB, inputs)
    records = kernel_records(torch, TB, TF, inputs, launches, profile)
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
