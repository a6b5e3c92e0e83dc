"""The port's seeded `--simulate` worlds against the reference's at one
--sim-seed other than each world's default, on the CPU, through the CLI
(`--simulate --<world> --sim-seed N --device cpu`): the seed reaches the
world and the port's report equals the reference's, less the wall-clock
fields (tests/test_torch_simulate_worlds.py has the default seeds and
WALL_CLOCK)."""

from __future__ import annotations

import pytest

from tests.test_torch_simulate_worlds import (
    CONSTRAINTS_DIGESTS,
    PORT,
    REF,
    WALL_CLOCK,
    WORLDS,
    _drop,
    report_cache,
)

SEEDED = {world: other for world, (_, other) in WORLDS.items()
          if other is not None}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    return report_cache(tmp_path_factory)


@pytest.mark.parametrize("world", sorted(SEEDED))
def test_report_equals_the_reference(reports, world):
    skip = WALL_CLOCK.get(world, ())
    seed = SEEDED[world]
    got = reports(world, seed, PORT)
    assert got["config"]["seed"] == seed
    assert _drop(got, skip) == _drop(reports(world, seed, REF), skip)


def test_constraints_at_sim_seed_8(reports):
    """tests/test_simlab.py::TestCLI: seed 8 kills another zone."""
    reseeded = reports("constraints", 8, PORT)
    assert reseeded["dead_zone"] == "z2"
    assert reseeded["digests"] != CONSTRAINTS_DIGESTS
