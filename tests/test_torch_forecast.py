"""The port's forecast program (karpenter_tpu_torch/forecast/models.py) ==
the reference's numpy mirror `forecast_numpy`, bitwise, and == the jitted
`forecast_jit` wherever that agrees with its own mirror.

The reference's jitted program and mirror differ in one sigma2 element
of tests/test_forecast.py::TestParity's first draw; the port follows the
mirror there (the mirror is the op-order spec). Inputs are the reference
tests' adversarial draws (ramps, seasonality, gaps, mixed models,
seasons 0, 1, 4, 8 and 3T), made once with numpy.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.forecast import models as RM
from karpenter_tpu_torch import kernels
from karpenter_tpu_torch.forecast import models as M

from test_forecast import SEED, random_forecast_inputs
from test_torch_decision import assert_bitwise


def port_forecast(ref_inputs):
    return M.forecast(M.ForecastInputs.from_numpy(ref_inputs, "cpu"))


def jit_equals_mirror(ref_inputs) -> bool:
    jit = RM.forecast_jit(ref_inputs)
    mirror = RM.forecast_numpy(ref_inputs)
    return all(
        np.asarray(getattr(jit, f)).tobytes()
        == np.asarray(getattr(mirror, f)).tobytes()
        for f in ("point", "sigma2", "n_valid")
    )


class TestForecastParity:
    def test_reference_parity_draws_follow_the_mirror(self):
        """tests/test_forecast.py::TestParity::test_bit_for_bit_across_buckets's
        own draws, in its order: the port equals forecast_numpy on all of
        them, including the one where forecast_jit does not."""
        rng = np.random.RandomState(SEED)
        for S, T in [(1, 8), (5, 16), (33, 64), (128, 32)]:
            inputs = random_forecast_inputs(rng, S, T)
            assert_bitwise(
                port_forecast(inputs), RM.forecast_numpy(inputs), f"S={S} T={T}"
            )

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_against_jit_where_it_equals_its_mirror(self, seed):
        inputs = random_forecast_inputs(np.random.RandomState(seed), 48, 32)
        # pinned first, so a draw where the reference disagrees with
        # itself fails here instead of quietly weakening the check
        assert jit_equals_mirror(inputs), f"seed {seed}: jit != numpy"
        port = port_forecast(inputs)
        assert_bitwise(port, RM.forecast_jit(inputs), f"jit seed={seed}")
        assert_bitwise(port, RM.forecast_numpy(inputs), f"numpy seed={seed}")

    @pytest.mark.parametrize(
        "model, season",
        [
            (RM.MODEL_LINEAR, 0),
            (RM.MODEL_HOLT_WINTERS, 1),
            (RM.MODEL_HOLT_WINTERS, 4),
            (RM.MODEL_HOLT_WINTERS, 7),
        ],
    )
    def test_each_model_and_season(self, model, season):
        inputs = random_forecast_inputs(np.random.RandomState(11), 24, 16)
        inputs = dataclasses.replace(
            inputs,
            model=np.full(24, model, np.int32),
            season=np.full(24, season, np.int32),
        )
        assert_bitwise(port_forecast(inputs), RM.forecast_numpy(inputs),
                       f"model={model} season={season}")

    def test_rows_without_valid_samples(self):
        inputs = random_forecast_inputs(np.random.RandomState(12), 16, 16)
        valid = np.array(inputs.valid)
        valid[::3] = False  # every third series has no sample at all
        valid[1, :-1] = False  # one sample only
        inputs = dataclasses.replace(inputs, valid=valid)
        port = port_forecast(inputs)
        assert_bitwise(port, RM.forecast_numpy(inputs), "no valid samples")
        out = port.to_numpy()
        assert (out["n_valid"][::3] == 0).all()
        assert (out["point"][::3] == 0.0).all()
        assert np.isfinite(out["sigma2"]).all()


class TestShapePlumbing:
    def test_padding_preserves_every_bit(self):
        inputs = random_forecast_inputs(np.random.RandomState(13), 6, 24)
        port_in = M.ForecastInputs.from_numpy(inputs, "cpu")
        bare = M.forecast(port_in)
        padded = M.pad_forecast_inputs(port_in, 32)
        stacked = M.concat_forecast_inputs([padded, padded], 16)
        assert stacked.values.shape == (16, 32)
        assert not stacked.valid[12:].any()
        out = M.forecast(stacked)
        for start in (0, 6):
            part = M.slice_forecast_outputs(out, start, start + 6)
            for f in ("point", "sigma2", "n_valid"):
                assert torch.equal(getattr(part, f), getattr(bare, f)), f

    def test_plumbing_matches_the_reference(self):
        inputs = random_forecast_inputs(np.random.RandomState(14), 5, 10)
        ref = RM.concat_forecast_inputs([RM.pad_forecast_inputs(inputs, 16)], 8)
        port = M.concat_forecast_inputs(
            [M.pad_forecast_inputs(M.ForecastInputs.from_numpy(inputs, "cpu"), 16)],
            8,
        ).to_numpy()
        for f in dataclasses.fields(RM.ForecastInputs):
            want = np.asarray(getattr(ref, f.name))
            assert port[f.name].dtype == want.dtype, f.name
            np.testing.assert_array_equal(port[f.name], want, f.name)

    def test_pad_rejects_a_shorter_bucket(self):
        inputs = M.ForecastInputs.from_numpy(
            random_forecast_inputs(np.random.RandomState(15), 2, 10), "cpu"
        )
        assert M.pad_forecast_inputs(inputs, 10) is inputs
        with pytest.raises(ValueError):
            M.pad_forecast_inputs(inputs, 8)


class TestKernelRoute:
    """`forecast` launches csrc/forecast.cu for CUDA tensors and runs the
    plain version for CPU tensors (the card's side is
    tests/test_torch_forecast_cuda.py); the launch plan follows T alone."""

    def test_cpu_tensors_take_the_plain_version(self):
        inputs = M.ForecastInputs.from_numpy(
            random_forecast_inputs(np.random.RandomState(16), 12, 16), "cpu"
        )
        M.reset_launch_counts()
        got = M.forecast(inputs)
        assert M.LAUNCHES["forecast"] == 0
        assert_bitwise(got, M.forecast_reference(inputs), "plain version")

    def test_other_devices_raise(self):
        cpu = M.ForecastInputs.from_numpy(
            random_forecast_inputs(np.random.RandomState(17), 4, 16), "cpu"
        )
        inputs = M.ForecastInputs(**{
            f.name: getattr(cpu, f.name).to("meta")
            for f in dataclasses.fields(cpu)
        })
        with pytest.raises(ValueError, match="unsupported device"):
            M.forecast(inputs)

    def test_loader_names_the_source_and_its_entry(self):
        assert "forecast" in kernels.SOURCES
        entries = kernels._SIGNATURES["forecast"]
        argtypes, restype = entries["forecast_launch"]
        # 11 operands, S, T and the plan's three ints, 3 outputs, the
        # seasonal scratch and the stream
        assert len(argtypes) == 11 + 5 + 5 and restype is ctypes.c_int
        assert "forecast_error_string" in entries

    def test_plan_constants_match_the_source(self):
        source = (kernels.CSRC / "forecast.cu").read_text()
        assert f"kMaxSeries = {M.MAX_SERIES};" in source
        assert f"kSharedBudget = {M.SHARED_BUDGET};" in source
        assert f"kModelHoltWinters = {M.MODEL_HOLT_WINTERS};" in source
        assert "13LL * (series + 1) * chunk" in source
        assert "kMinStep = 1e-3f;" in source
        assert M._MIN_STEP_S == float(np.float32(1e-3))
        assert f"kHuberK2 = {M._HUBER_K2}f;" in source

    @pytest.mark.parametrize(
        "T", [1, 2, 16, 24, 32, 48, 64, 96, 256, 384, 1536, 12080, 12081,
              65536])
    def test_plan_takes_the_shape(self, T):
        """Every plan fits the budget with the largest tile that holds its
        seasonal buffer; the fleet's T = 64 loads its whole history once
        into 32-series tiles; past T = 12,080 the buffer leaves shared
        memory."""
        series, chunk, shared, shared_season = M.forecast_plan(T)
        assert series in (1, 2, 4, 8, 16, 32) and 1 <= chunk <= T
        assert shared <= M.SHARED_BUDGET
        season = 4 * T * series if shared_season else 0
        assert shared == season + 13 * (series + 1) * chunk
        assert chunk == T or shared + 13 * (series + 1) > M.SHARED_BUDGET
        if series < M.MAX_SERIES:  # twice the series would not fit
            assert 8 * T * series + 26 * (series + 1) * min(T, 32) > (
                M.SHARED_BUDGET)
        assert shared_season == (T <= 12080)
        if T <= 64:
            assert (series, chunk) == (32, T)

    def test_plan_refuses_an_empty_history(self):
        with pytest.raises(ValueError):
            M.forecast_plan(0)
