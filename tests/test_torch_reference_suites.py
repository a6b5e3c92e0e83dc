"""The reference's own unit suites, run against the port.

`load_suite(name, namespace)` reads `tests/test_<name>.py` as text,
rewrites the package name `karpenter_tpu` to `karpenter_tpu_torch`,
applies the suite's documented renames (SUBSTITUTIONS), compiles the
result under the reference file's own path (so tracebacks and pytest's
locations point at the reference's lines) and execs it into `namespace`,
the globals of a thin `tests/test_torch_ref_<name>.py`. Each suite keeps
its own fixtures, classes and node IDs there, and `--dist loadfile`
spreads the thin files over the workers like any other test file.

What the loader adds or takes away:

  * Cross-suite helpers (`from test_faults import ...`, also as
    `from tests.test_pendingcapacity import ...`) are loaded the
    same way, once per process, as modules named `torch_ref_<module>`;
    the import statement is pointed at that name. `tests/fake_apiserver`
    imports nothing of either package and is imported as it is.
  * pytest rewrites the asserts of the modules it imports, not of code
    exec'd from a string. The loader runs pytest's own rewriter
    (`_pytest.assertion.rewrite.rewrite_asserts`) over the parsed tree
    before it compiles it, so a failing case shows its values as a
    collected reference test would.
  * An autouse fixture makes `resolve_device(None)` mean the CPU in every
    module of the port that imported it by name. The port's default
    stays the card; only these tests ask for the CPU.
  * DESELECTED names each case left out, with its reason. A case is left
    out only when it tests a JAX internal (jax.jit over port inputs, jnp
    parity, the `_compiled` cache, the "pallas" rung, jax.devices()),
    runs the binary without `--device cpu`, or is a wall-clock overhead
    guard (the reference's own copy is unsteady under a loaded host).

The loader imports nothing of `karpenter_tpu`: it reads the files.
"""

from __future__ import annotations

import ast
import importlib
import os
import re
import sys
import types

import pytest
from _pytest.assertion.rewrite import rewrite_asserts

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

_PACKAGE = re.compile(r"\bkarpenter_tpu\b")

# the port's names for what the reference's tests name: the backend
# "xla" is the port's "torch" rung (solver/service.py), and the profiler
# the reference probes, jax.profiler, is torch.profiler here
# (observability/profiler.py). Each jax.jit program `*_jit` is the
# port's eager program of the same operands (`decide_jit` -> `decide`,
# `cost_jit` -> `cost_decide`, `poolgroup_jit` -> `poolgroup_decide`,
# `poolgroup_independent_jit` -> the same with enforce=False,
# `forecast_jit` -> `forecast`, `fused_tick_jit` and
# `jax.jit(FT.fused_tick)` -> `fused_tick`). fusedtick's `_leaves`
# flattens an output tree with jax.tree_util, which takes the port's
# dataclasses (no registered pytrees) for single leaves and would
# compare object pointers; the port's walk flattens their fields in
# order, None dropped, as jax flattens the reference's. Each pair must
# occur in its suite.
_XLA_IS_TORCH = ('"xla"', '"torch"')
_TREE_LEAVES = (
    "    import jax\n\n"
    "    return jax.tree_util.tree_leaves(\n"
    "        jax.tree_util.tree_map(np.asarray, tree)\n"
    "    )\n"
)
_DATACLASS_LEAVES = (
    "    import dataclasses\n\n"
    "    if dataclasses.is_dataclass(tree):\n"
    "        return [leaf for f in dataclasses.fields(tree)\n"
    "                for leaf in _leaves(getattr(tree, f.name))]\n"
    "    return [] if tree is None else [np.asarray(tree)]\n"
)
SUBSTITUTIONS = {
    "chaos": (_XLA_IS_TORCH,),
    "consolidation": (_XLA_IS_TORCH,),
    "cost": (_XLA_IS_TORCH, ("CK.cost_jit", "CK.cost_decide")),
    "decision_kernel": (("D.decide_jit", "D.decide"),),
    "forecast": (
        _XLA_IS_TORCH,
        ("D.decide_jit", "D.decide"),
        ("M.forecast_jit", "M.forecast"),
    ),
    "fusedtick": (
        _XLA_IS_TORCH,
        ("FT.fused_tick_jit", "FT.fused_tick"),
        (_TREE_LEAVES, _DATACLASS_LEAVES),
    ),
    "poolgroup": (
        ("CK.cost_jit", "CK.cost_decide"),
        ("PGK.poolgroup_independent_jit",
         "(lambda inputs: PGK.poolgroup_decide(inputs, enforce=False))"),
        ("PGK.poolgroup_jit", "PGK.poolgroup_decide"),
        ("jax.jit(FT.fused_tick)", "FT.fused_tick"),
    ),
    "encoder_delta": (_XLA_IS_TORCH,),
    "faults": (_XLA_IS_TORCH,),
    "introspect": (_XLA_IS_TORCH,),
    "numpy_binpack": (_XLA_IS_TORCH,),
    "observability": (_XLA_IS_TORCH,),
    "preemption": (_XLA_IS_TORCH,),
    "resident": (_XLA_IS_TORCH,),
    "simlab": (_XLA_IS_TORCH,),
    "solver_service": (_XLA_IS_TORCH,),
    "tenancy": (_XLA_IS_TORCH,),
    "profiler": (('"jax.profiler"', '"torch.profiler"'),),
}

_DEVICE_PUT = (
    "jax.device_put over the port's dataclass (a JAX internal); "
    "counterpart: {}"
)
_WALL_CLOCK = (
    "wall-clock overhead guard: unsteady under a loaded host (the "
    "reference's own copy fails there too)"
)
_NO_DEVICE_CPU = "runs the binary without --device cpu; counterpart: {}"

# suite -> {"Class::test" or "test": reason}; each must name a case
DESELECTED = {
    "constraints": {
        "TestKernelSemantics::test_constraint_mask_parity_jnp_np":
            "jnp parity (constraint_mask(xp=jnp)); counterpart: "
            "test_torch_numpy_binpack.py's constraint-mask parity",
        "TestPallasGuard::test_fold_for_pallas_reroutes_constrained_inputs":
            "_fold_for_pallas and its 'xla' route; counterpart: "
            "test_torch_port_counterparts.py TestConstraintReroute",
        "TestPallasGuard::test_service_reroutes_and_counts":
            "the 'pallas' rung; counterpart: "
            "test_torch_port_counterparts.py TestConstraintReroute",
        "TestRegressionGuard::test_batched_constrained_beats_per_group_loop":
            _WALL_CLOCK,
    },
    "fusedtick": {
        "TestCompileCacheRestart::test_restart_prewarns_from_cache_zero_fresh_rows":
            "jax.config's persistent XLA compilation cache (the port "
            "compiles no program; its --compile-cache-dir names the "
            "kernels' build directory); counterpart: test_torch_cli.py "
            "test_compile_cache_dir_names_the_kernel_build_dir",
        "TestFusedRegressionGuard::test_live_fused_not_slower_than_chained":
            _WALL_CLOCK,
    },
    "introspect": {
        "TestServiceCompileLedger::test_miss_recorded_with_cost_attribution":
            "XLA's cost analysis at lowering (flops and bytes of a compiled "
            "program, an 'xla' rung); counterpart: test_torch_introspect.py",
        "TestServiceCompileLedger::test_dispatch_spans_gain_cost_args":
            "XLA's cost analysis at lowering; counterpart: "
            "test_torch_introspect.py",
        "TestIntrospectOverheadGuard::test_enabled_vs_disabled_tick_overhead":
            _WALL_CLOCK,
    },
    "numpy_binpack": {
        "TestDispatcher::test_auto_on_cpu_routes_to_numpy":
            "jax.default_backend(), and the reference's degraded mode: its "
            "auto solve on a CPU backend is the accelerator-outage numpy "
            "rung; the port has no such mode (ROADMAP 'Deliberate "
            "divergences') and its numpy rung equals the reference's in "
            "test_torch_numpy_binpack.py",
    },
    "observability": {
        "TestTracingOverheadGuard::test_enabled_vs_disabled_tick_overhead":
            _WALL_CLOCK,
        "TestTraceExportAcceptance::test_simulate_trace_export_end_to_end":
            _NO_DEVICE_CPU.format(
                "test_torch_port_counterparts.py TestCliOnCpu"
            ),
    },
    "poolgroup": {
        "TestPoolGroupRegressionGuard::test_live_joint_not_slower_than_per_pool":
            _WALL_CLOCK,
    },
    "preemption": {
        "TestKernelParity::test_xla_equals_numpy_bit_identically":
            _DEVICE_PUT.format("test_torch_preempt.py "
                               "test_port_equals_reference_bit_identically"),
        "TestKernelParity::test_parity_survives_bucket_padding":
            _DEVICE_PUT.format("test_torch_preempt.py "
                               "test_parity_survives_bucket_padding"),
        "TestKernelParity::test_nodeless_fleet_is_unplaceable_on_both_backends":
            _DEVICE_PUT.format("test_torch_preempt.py "
                               "test_nodeless_fleet_is_unplaceable"),
        "TestBatchedIndependence::test_batched_equals_per_candidate_on_device":
            _DEVICE_PUT.format("test_torch_preempt.py "
                               "test_batched_equals_per_candidate"),
        "TestPriorityOffBinpack::test_absent_equals_zero_operands":
            _DEVICE_PUT.format("test_torch_host_operands.py "
                               "TestPriorityOffBinpack"),
        "TestPriorityOffBinpack::test_priority_steers_away_from_preemptible_tiers":
            _DEVICE_PUT.format("test_torch_host_operands.py "
                               "TestPriorityOffBinpack"),
        "TestPriorityOffBinpack::test_large_preference_scores_survive_steering":
            _DEVICE_PUT.format("test_torch_host_operands.py "
                               "TestPriorityOffBinpack"),
        "TestPriorityOffBinpack::test_steer_is_lexicographically_senior_to_score":
            _DEVICE_PUT.format("test_torch_host_operands.py "
                               "TestPriorityOffBinpack"),
    },
    "resident": {
        "TestShardThresholdCrossing::test_crossing_rebuilds_then_scatters_both_modes":
            "a mesh over jax.devices() (the reference's 8 virtual CPU "
            "devices); counterpart: test_torch_shard_service.py of the "
            "same name, over force_virtual_devices",
    },
    "simlab": {
        "TestKernelParity::test_step_jit_matches_numpy_bitwise":
            "sim_step_jit (a jax.jit program); counterpart: "
            "test_torch_simstep.py",
        "TestKernelParity::test_batched_step_matches_numpy_bitwise":
            "sim_step_jit (a jax.jit program); counterpart: "
            "test_torch_simstep.py",
        "TestKernelParity::test_vmapped_rollout_matches_per_cluster_jit_and_numpy":
            "sim_rollout_jit and jax.vmap; counterpart: test_torch_simstep.py",
        "TestCLI::test_default_seed_digests_pinned_and_sim_seed_threads":
            _NO_DEVICE_CPU.format("test_torch_port_counterparts.py "
                                  "TestCliOnCpu"),
        "TestRegressionGuard::test_batched_beats_sequential_live": _WALL_CLOCK,
    },
    "simulate": {
        "TestSimulateCLI::test_cli_simulate_with_what_if":
            _NO_DEVICE_CPU.format("test_torch_port_counterparts.py "
                                  "TestCliOnCpu"),
        "TestSimulateCLI::test_cli_rejects_non_list_what_if":
            _NO_DEVICE_CPU.format("test_torch_port_counterparts.py "
                                  "TestCliOnCpu"),
        "TestSimulateFidelity::test_empty_what_if_list_still_yields_delta_shape":
            _NO_DEVICE_CPU.format("test_torch_port_counterparts.py "
                                  "TestCliOnCpu"),
    },
    "solver_service": {
        "TestMetricsSurface::test_decide_routes_and_counts":
            "decide_jit (a jax.jit program); counterpart: "
            "test_torch_solver_service.py test_decide_equals_direct_decide",
        "TestPipelinedDispatch::test_inflight_device_failure_degrades_to_numpy":
            "the XLA compile cache _compiled_for; counterpart: "
            "test_torch_solver_service.py "
            "test_inflight_failure_degrades_to_numpy",
        "TestLatencyRegressionGuard::test_idle_service_p50_within_2x_of_direct":
            _WALL_CLOCK,
        "TestDonationParity::test_donating_compile_matches_non_donating":
            "XLA buffer donation (the port compiles nothing and donates "
            "nothing)",
        "TestShardedDispatch::test_above_threshold_routes_through_mesh_with_parity":
            "a mesh over jax.devices(); counterpart: "
            "test_torch_shard_service.py of the same name",
        "TestShardedDispatch::test_shard_failure_degrades_to_single_device_then_sticks":
            "a mesh over jax.devices(); counterpart: "
            "test_torch_shard_service.py of the same name",
        "TestShardedDispatch::test_shard_and_single_device_compile_families_never_alias":
            "a mesh over jax.devices(); counterpart: "
            "test_torch_shard_service.py of the same name",
        "TestShardedDispatch::test_consolidate_routes_through_mesh_with_parity":
            "a mesh over jax.devices(); counterpart: "
            "test_torch_shard_service.py of the same name",
    },
    "provenance": {
        "TestProvenanceOverheadGuard::test_enabled_vs_disabled_tick_overhead":
            _WALL_CLOCK,
    },
    "recovery": {
        "TestCacheResetSeams::test_solver_service_reset_caches":
            "the XLA compile cache _compiled; counterpart: "
            "test_torch_port_counterparts.py TestCacheResetSeams",
        "TestCacheResetSeams::test_recovery_boot_invalidates_process_caches":
            "the XLA compile cache _compiled; counterpart: "
            "test_torch_port_counterparts.py TestCacheResetSeams",
    },
    "tenancy": {
        "TestRegressionGuard::test_batched_multitenant_beats_sequential_loop":
            _WALL_CLOCK,
    },
    "wiring": {
        "TestCLI::test_main_runs_and_exits": _NO_DEVICE_CPU.format(
            "test_torch_port_counterparts.py TestCliOnCpu"
        ),
        "TestCLI::test_main_with_leader_election": _NO_DEVICE_CPU.format(
            "test_torch_port_counterparts.py TestCliOnCpu"
        ),
        "TestRealClusterModeCLI::test_main_against_fake_apiserver_converges":
            _NO_DEVICE_CPU.format(
                "test_torch_port_counterparts.py TestCliOnCpu"
            ),
    },
}

# the modules that import resolve_device by name
_RESOLVE_DEVICE_USERS = (
    "karpenter_tpu_torch.utils.device",
    "karpenter_tpu_torch.ops.binpack",
    "karpenter_tpu_torch.ops.fusedtick",
    "karpenter_tpu_torch.ops.preempt",
    "karpenter_tpu_torch.parallel.mesh",
    "karpenter_tpu_torch.solver.service",
    "karpenter_tpu_torch.utils.backend",
    "karpenter_tpu_torch.utils.operands",
)

_HELPER_PREFIX = "torch_ref_"


def reference_path(module: str) -> str:
    return os.path.join(TESTS_DIR, f"{module}.py")


def port_source(module: str, suite=None) -> str:
    """The reference file's text with the package renamed and the suite's
    substitutions applied."""
    with open(reference_path(module), encoding="utf-8") as fh:
        text = fh.read()
    for old, new in SUBSTITUTIONS.get(suite, ()):
        if old not in text:
            raise AssertionError(
                f"substitution {old!r} matches nothing in {module}.py"
            )
        text = text.replace(old, new)
    return _PACKAGE.sub("karpenter_tpu_torch", text)


def _helper(module: str) -> types.ModuleType:
    """A cross-suite helper module, loaded through the loader once."""
    name = _HELPER_PREFIX + module
    loaded = sys.modules.get(name)
    if loaded is None:
        loaded = types.ModuleType(name)
        loaded.__file__ = reference_path(module)
        sys.modules[name] = loaded
        try:
            exec(_compile(module, module[len("test_"):]), loaded.__dict__)
        except BaseException:
            del sys.modules[name]
            raise
    return loaded


class _HelperImports(ast.NodeTransformer):
    """`from test_x import ...` and `from tests.test_x import ...` ->
    `from torch_ref_test_x import ...`."""

    def visit_ImportFrom(self, node):
        module = node.module or ""
        if module.startswith("tests.test_"):
            module = module[len("tests."):]
        if node.level == 0 and module.startswith("test_"):
            _helper(module)
            node.module = _HELPER_PREFIX + module
        return node

    def visit_Import(self, node):
        for alias in node.names:
            if alias.name.startswith("test_"):
                raise AssertionError(
                    f"`import {alias.name}`: only `from test_x import ...` "
                    "is rewritten"
                )
        return node


def compile_source(source: str, path: str):
    """`source` compiled under `path`, its helper imports pointed at the
    loader's modules and its asserts rewritten as pytest rewrites them."""
    tree = ast.parse(source, filename=path)
    tree = _HelperImports().visit(tree)
    ast.fix_missing_locations(tree)
    rewrite_asserts(tree, source.encode("utf-8"), path)
    return compile(tree, path, "exec", dont_inherit=True)


def _compile(module: str, suite):
    return compile_source(port_source(module, suite), reference_path(module))


@pytest.fixture(autouse=True)
def _port_defaults_to_cpu(monkeypatch):
    """resolve_device(None) -> the CPU for the duration of one case. Every
    module is imported before any is patched, so none binds the patch."""
    modules = [importlib.import_module(name) for name in _RESOLVE_DEVICE_USERS]
    original = modules[0].resolve_device

    def resolve_cpu(device=None):
        return original("cpu" if device is None else device)

    for module in modules:
        monkeypatch.setattr(module, "resolve_device", resolve_cpu)
    yield


def _deselect(suite: str, namespace: dict) -> None:
    for case in DESELECTED.get(suite, {}):
        owner, _, test = case.rpartition("::")
        holder = namespace[owner] if owner else None
        if holder is None:
            if test not in namespace:
                raise AssertionError(f"{suite}: no test {case}")
            del namespace[test]
        else:
            if test not in vars(holder):
                raise AssertionError(f"{suite}: no test {case}")
            delattr(holder, test)


def load_suite(suite: str, namespace: dict) -> None:
    """Exec the reference's tests/test_<suite>.py, ported, into the
    calling module's globals."""
    exec(_compile(f"test_{suite}", suite), namespace)
    _deselect(suite, namespace)
    namespace["_port_defaults_to_cpu"] = _port_defaults_to_cpu


# -- the loader's own checks ---------------------------------------------------


def _thin_suites():
    return sorted(
        name[len("test_torch_ref_"):-len(".py")]
        for name in os.listdir(TESTS_DIR)
        if name.startswith("test_torch_ref_") and name.endswith(".py")
    )


def test_every_table_entry_names_a_loaded_suite():
    suites = set(_thin_suites())
    assert set(DESELECTED) <= suites
    # a substitution may serve a cross-suite helper (test_faults) alone
    for suite in suites | set(SUBSTITUTIONS):
        assert os.path.exists(reference_path(f"test_{suite}")), suite


@pytest.mark.parametrize("suite", sorted(DESELECTED))
def test_deselected_cases_exist_in_the_reference(suite):
    tree = ast.parse(port_source(f"test_{suite}", suite))
    classes = {node.name: node for node in tree.body
               if isinstance(node, ast.ClassDef)}
    for case, reason in DESELECTED[suite].items():
        owner, _, test = case.rpartition("::")
        body = classes[owner].body if owner else tree.body
        assert any(getattr(node, "name", None) == test for node in body), case
        assert reason.strip(), case


def test_failing_assert_shows_its_values():
    namespace = {}
    exec(compile_source(
        "def check():\n    x = [1, 2]\n    assert x == [1, 3]\n",
        os.path.join(TESTS_DIR, "snippet.py"),
    ), namespace)
    with pytest.raises(AssertionError) as info:
        namespace["check"]()
    assert "[1, 2] == [1, 3]" in str(info.value)


def test_helper_imports_point_at_the_loaders_modules():
    tree = _HelperImports().visit(ast.parse(
        "from tests.test_pendingcapacity import pending_pod\n"
        "from test_faults import FakeClock\n"
        "from tests.fake_apiserver import FakeApiServer\n"
    ))
    assert [node.module for node in tree.body] == [
        "torch_ref_test_pendingcapacity", "torch_ref_test_faults",
        "tests.fake_apiserver",
    ]
    assert sys.modules["torch_ref_test_faults"].__file__ == reference_path(
        "test_faults")


def test_package_rename_leaves_the_port_alone():
    assert _PACKAGE.sub("karpenter_tpu_torch", (
        "from karpenter_tpu.ops import binpack; import karpenter_tpu_torch; "
        "python -m karpenter_tpu"
    )) == (
        "from karpenter_tpu_torch.ops import binpack; import "
        "karpenter_tpu_torch; python -m karpenter_tpu_torch"
    )


def test_loader_imports_nothing_of_the_reference():
    with open(os.path.abspath(__file__), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    assert not [name for name in imported
                if name.split(".")[0] == "karpenter_tpu"]
