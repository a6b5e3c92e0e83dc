"""The cuda rung's split Solve and the fused HA tick on a CUDA card (solver/service.py
`_solve_cuda`). Every test carries the `cuda` marker and skips without a
card (the rung launches CUDA C++ kernels, which have no interpret mode);
on the CPU, tests/test_torch_trace_clock.py holds the spans.

  * one Solve records the stages `upload`, `launch`, `sync` and `device`;
  * per request, upload + launch + sync is at most `dispatch` and at
    least 90% of it;
  * `device` (two CUDA events on the worker's stream) is at least the
    device time of the kernels the Solve launched between them, read in
    a profiler window;
  * the events add no device operation, and the launches per Solve stay
    one fused and one shelf launch;
  * the service's fused HA tick: per tick, `fused_device` (two CUDA events
    around the graph's replay) is positive and at most `fused_replay` +
    `fused_fetch`, and one shape class is captured once over repeated
    ticks (on the CPU, tests/test_torch_trace_clock.py holds its spans).

This file imports neither jax nor the reference package:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_trace_cuda.py -q -s
"""

import pytest
import torch

from karpenter_tpu_torch import workloads
from karpenter_tpu_torch.metrics.registry import GaugeRegistry
from karpenter_tpu_torch.observability import tracing as T
from karpenter_tpu_torch.ops import fused_assign as TF
from karpenter_tpu_torch.ops.binpack import BinPackInputs
from karpenter_tpu_torch.solver import SolverService
from karpenter_tpu_torch.solver.service import _fetch_outputs

pytestmark = pytest.mark.cuda

SPLIT = ("upload", "launch", "sync")
N_SOLVES = 12


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cuda rung launches CUDA C++ "
                    "kernels with no interpret mode")


@pytest.fixture(scope="module")
def fields():
    return workloads.build_inputs(20_000, 300, 64, 64, 0)


@pytest.fixture
def service():
    service = SolverService(registry=GaugeRegistry())
    yield service
    service.close()


def _solve(service, fields):
    # a new inputs object each time, as a sidecar decodes one per RPC
    return service.solve(BinPackInputs(**fields))


def _rings(service):
    """{stage: its ring of ms, oldest first}."""
    with service._stage_lock:
        return {name: list(ring) for name, ring in service._stages.items()}


def test_one_solve_records_the_split_stages(service, fields):
    _solve(service, fields)
    rings = _rings(service)
    for stage in SPLIT + ("device", "dispatch", "fetch"):
        assert len(rings.get(stage, ())) == 1, (stage, rings)
    assert rings["device"][0] > 0


def test_split_sums_to_the_dispatch(service, fields):
    for _ in range(N_SOLVES):
        _solve(service, fields)
    rings = _rings(service)
    # the first Solve pays the first launch's note in `dispatch` alone
    for i in range(1, N_SOLVES):
        split = sum(rings[stage][i] for stage in SPLIT)
        dispatch = rings["dispatch"][i]
        print(f"solve {i}: " + ", ".join(
            f"{stage} {rings[stage][i]:.3f} ms"
            for stage in SPLIT + ("dispatch", "device")))
        assert split <= dispatch
        assert split >= 0.9 * dispatch, (split, dispatch)


def _device_rows(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def test_device_span_holds_the_kernels_between_the_events(service, fields):
    _solve(service, fields)  # the first launch stays out of the window
    before = dict(TF.LAUNCHES)
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        experimental_config=torch.profiler._ExperimentalConfig(
            profile_all_threads=True),
    ) as prof:
        for _ in range(N_SOLVES):
            _solve(service, fields)
        torch.cuda.synchronize()
    launched = {k: TF.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"fused_assign": N_SOLVES, "shelf_bfd": N_SOLVES,
                        "demand_reduce": 0, "pack_bits": N_SOLVES}
    device_ms = _rings(service)["device"][-N_SOLVES:]
    events = list(prof.profiler.kineto_results.events())
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA]
    dispatches = sorted((a, b) for n, a, b in host if n == "solver.dispatch")
    uploads = [(a, b) for n, a, b in host if n == "solver.upload"]
    assert len(dispatches) == N_SOLVES, len(dispatches)
    # the kernels a Solve launched between the events: launched (by
    # correlation id) inside its solver.dispatch range, after its upload
    launch_at = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() != torch.autograd.DeviceType.CUDA
                 and e.correlation_id()}
    kernel_ns = [0] * N_SOLVES
    for e in _device_rows(prof):
        if e.name().startswith("Memcpy"):
            continue
        at = launch_at.get(e.correlation_id())
        if at is None or any(a <= at <= b for a, b in uploads):
            continue
        for i, (a, b) in enumerate(dispatches):
            if a <= at <= b:
                kernel_ns[i] += e.duration_ns()
    print(f"\ndevice ms {[round(d, 4) for d in device_ms]}; kernels "
          f"between the events ms {[round(k / 1e6, 4) for k in kernel_ns]}")
    assert all(kernel_ns), kernel_ns
    for ms, ns in zip(device_ms, kernel_ns):
        assert ms * 1e6 >= ns


def test_events_add_no_device_operation(service, fields):
    """The service's Solve (with its two events) puts on the card the
    operations of a direct solve and fetch (with none)."""
    from karpenter_tpu_torch.ops import binpack as B

    _solve(service, fields)
    B.solve(BinPackInputs(**fields), backend="cuda")
    torch.cuda.synchronize()

    def ops(run):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                run()
            torch.cuda.synchronize()
        return sorted(e.name() for e in _device_rows(prof))

    direct = ops(lambda: _fetch_outputs(
        B.solve(BinPackInputs(**fields), backend="cuda")))
    served = ops(lambda: _solve(service, fields))
    print(f"\n{len(served)} device operations served, {len(direct)} direct")
    assert served == direct
    assert not T.profiling()


# -- the fused HA tick (ops/fusedtick.FusedTickProgram through the service)

FLEET_TICKS = 8


def _fleet(seed):
    return workloads.build_fused_tick_inputs(seed, 2048, 3, 1000, 64,
                                             groups=16, pools=4)


def test_fused_device_lies_within_replay_and_fetch(service):
    """Per tick, `fused_device` (two CUDA events around the replay) is
    positive and at most `fused_replay` + `fused_fetch`: the replay's work
    starts after its launch began and ends before the fetch returns."""
    for seed in range(FLEET_TICKS):
        service.fused_tick(_fleet(seed))
    rings = _rings(service)
    for stage in ("fused_pad", "fused_upload", "fused_replay", "fused_fetch",
                  "fused_device", "fused"):
        assert len(rings.get(stage, ())) == FLEET_TICKS, (stage, rings)
    print(f"\nfused_device ms {[round(d, 4) for d in rings['fused_device']]}")
    for device, replay, fetch in zip(rings["fused_device"],
                                     rings["fused_replay"],
                                     rings["fused_fetch"]):
        assert 0 < device <= replay + fetch, (device, replay, fetch)


def test_one_capture_over_repeated_ticks_of_one_shape(service):
    program = service.fused_program()
    for seed in range(FLEET_TICKS):
        service.fused_tick(_fleet(seed))
        assert program.captures == 1
    assert program.replays == FLEET_TICKS
    assert service.stats.fused_dispatches == FLEET_TICKS
