"""The forecast kernel (csrc/forecast.cu) on a CUDA card == the numpy mirror
`forecast_numpy` and the plain version `forecast_reference`, bit for bit,
on the edges of its launch plan and of the arithmetic; and one
`FusedTickProgram` replay of the HA fleet cell's draw == `fused_tick_numpy`
on every leaf. Every test carries the `cuda` marker and skips without a
card; on the CPU the plain version is held against the JAX reference by
tests/test_torch_forecast.py.

This file imports neither jax nor the reference package, so it also runs
where jax is not installed:

    KARPENTER_TEST_REAL_BACKEND=1 python -m pytest tests/test_torch_forecast_cuda.py -q
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.forecast import models as M
from karpenter_tpu_torch.ops import fusedtick as FT

pytestmark = pytest.mark.cuda

# the history lengths of the edges: 24 is a 1.5x rung of the service's
# ladder, 256 loads its tile in chunks
T_EDGES = (1, 2, 16, 24, 64, 256)


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these tests run the forecast kernel")


def draw(S: int, T: int, seed: int) -> M.ForecastInputs:
    """Numpy ForecastInputs of S series x T samples whose rows cycle
    through the edges: a plain row, all samples invalid, a single valid
    sample, equal times (the line's den <= 0), zero weights, a step below
    1e-3 s, and outliers for the Huber reweight; seasons cycle through 0,
    1, 2, 4, T and T + 3, and the model is drawn per row."""
    r = np.random.RandomState(seed)
    trend = r.uniform(-2, 2, (S, 1))
    values = (50 + trend * np.arange(T) + r.normal(0, 5, (S, T)))
    outlier = r.rand(S, T) < 0.05
    values = np.where(outlier, values + r.uniform(-300, 300, (S, T)), values)
    valid = r.rand(S, T) > 0.2
    times = -np.cumsum(r.uniform(5, 20, (S, T)), 1)[:, ::-1]
    weights = r.uniform(0.25, 2.0, (S, T))
    step_s = r.uniform(5, 30, S)
    kind = np.arange(S) % 7
    valid[kind == 1] = False
    single = np.flatnonzero(kind == 2)
    valid[single] = False
    valid[single, r.randint(0, T, single.size)] = True
    times[kind == 3] = -60.0
    weights[kind == 4] = 0.0
    step_s[kind == 5] = r.uniform(0, 9e-4, int((kind == 5).sum()))
    seasons = np.array([0, 1, 2, 4, T, T + 3], np.int32)
    return M.ForecastInputs(
        values=values.astype(np.float32),
        valid=valid,
        times=np.ascontiguousarray(times, np.float32),
        weights=weights.astype(np.float32),
        horizon=r.uniform(0, 300, S).astype(np.float32),
        step_s=step_s.astype(np.float32),
        model=r.randint(0, 2, S).astype(np.int32),
        season=seasons[np.arange(S) % seasons.size],
        alpha=r.uniform(0.05, 0.95, S).astype(np.float32),
        beta=r.uniform(0.01, 0.5, S).astype(np.float32),
        gamma=r.uniform(0.01, 0.5, S).astype(np.float32),
    )


def assert_same_bits(got, want, what):
    """Two forecasts (tensors, arrays or dicts of them) hold the same
    dtypes, shapes and bits."""
    got, want = M.ForecastOutputs.from_arrays(got), M.ForecastOutputs.from_arrays(want)
    for name in ("point", "sigma2", "n_valid"):
        x, y = getattr(got, name), getattr(want, name)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        bad = np.flatnonzero(x.view(np.int32) != y.view(np.int32))
        assert bad.size == 0, (
            f"{what}: {name} differs bitwise at {bad.size} series, first "
            f"{bad[:5]}: {x[bad[:5]]} vs {y[bad[:5]]}")


@pytest.mark.parametrize("S", [1, 33, 6149])
@pytest.mark.parametrize("T", T_EDGES)
def test_kernel_equals_mirror_and_plain_version(S, T):
    host = draw(S, T, seed=1000 * S + T)
    card = M.ForecastInputs.from_numpy(host, "cuda")
    M.reset_launch_counts()
    got = M.forecast(card)
    assert M.LAUNCHES["forecast"] == 1
    assert_same_bits(got, M.forecast_numpy(host), f"S={S} T={T} mirror")
    assert_same_bits(got, M.forecast_reference(card),
                     f"S={S} T={T} plain version on the card")


def test_history_past_the_shared_buffer():
    """T past what one series' seasonal buffer can hold in a block's
    shared memory: the buffer moves to the wrapper's scratch."""
    T = 12289
    assert not M.forecast_plan(T)[3]
    host = draw(40, T, seed=5)
    got = M.forecast(M.ForecastInputs.from_numpy(host, "cuda"))
    assert_same_bits(got, M.forecast_numpy(host), f"T={T}")


def test_empty_and_eager_launch_counts():
    """One launch per eager call with series, none without."""
    M.reset_launch_counts()
    out = M.forecast(M.ForecastInputs.from_numpy(draw(0, 16, 1), "cuda"))
    assert out.point.shape == (0,) and M.LAUNCHES["forecast"] == 0
    card = M.ForecastInputs.from_numpy(draw(64, 16, 2), "cuda")
    for _ in range(3):
        M.forecast(card)
    assert M.LAUNCHES["forecast"] == 3


def test_fleet_cell_replay_equals_the_mirror():
    """One FusedTickProgram replay of the fleet cell's draw (10,000 HAs x
    3 metrics, 5,000 series x 64 samples, 64 pool groups of 4), padded as
    the service's door pads it (S up to 6,144), == fused_tick_numpy on
    every leaf. The capture launches the kernel three times (two warm-ups
    and the capture); replays add none to the count."""
    from portbench.reference import fleet_draws

    fields = fleet_draws.build_fused_tick_inputs(
        7, n=10000, m=3, s=5000, t=64, groups=64, pools=4)
    host = FT.pad_series(FT.FusedTickInputs.from_arrays(fields), 6144)
    program = FT.FusedTickProgram("cuda")
    M.reset_launch_counts()
    program(host, host=True)
    assert program.captures == 1 and M.LAUNCHES["forecast"] == 3
    got = program(host, host=True).to_numpy()
    assert program.replays == 2 and M.LAUNCHES["forecast"] == 3
    want = FT.fused_tick_numpy(host).to_numpy()
    leaves = 0
    for stage, group in want.items():
        assert (got[stage] is None) == (group is None), stage
        for name, y in (group or {}).items():
            x = got[stage][name]
            assert x.dtype == y.dtype and x.shape == y.shape, (stage, name)
            assert x.tobytes() == y.tobytes(), f"{stage}.{name} differs"
            leaves += 1
    assert leaves >= 27, leaves
