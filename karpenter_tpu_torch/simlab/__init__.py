"""SimLab: trace-driven fleet simulator with a gym-style step API.

ROADMAP item 1 (docs/simulator.md): promote the deterministic
`--simulate` replay worlds into a seeded trace-driven simulator whose
batched device stepping makes policy search and scenario fuzzing run
thousands of cluster-days per minute — the same batch-everything trick
as the decide/cost/forecast kernels. Three planes:

  registry   `Scenario` specs (seeded workload trace generator, fault
             schedule drawn from the chaos registry, pricing events) —
             every existing `--simulate` world re-registers here with
             its CLI replay preserved bit-identically, and
             `--simulate --list` prints the catalog.
  env        `SimEnv` reset(seed)/step(action) over columnar fleet
             state; `BatchedSimEnv` stacks N independently-seeded
             clusters and advances them as ONE batched device program
             through the SolverService seam (ops/simstep.py).
  policy     a `Policy` protocol, the reactive baseline, and
             `SearchTunedPolicy` — grid/evolution search over decision
             knobs against batched rollouts; the frozen winner slots
             into the live runtime as the `simlab` algorithm
             (autoscaler/algorithms/simlab_policy.py) behind the
             never-block contract, with the provenance ledger exported
             as the labeled training/eval stream (simlab/labels.py).

The port's copy of karpenter_tpu/simlab: the same registry, trails,
gym envs and search, stepping through the port's SolverService (the
tensor programs of ops/simstep.py on the card, or the numpy mirror).
"""

from karpenter_tpu_torch.simlab.env import (
    BatchedSimEnv,
    SimEnv,
    SimParams,
    SimTrails,
    composite_reward,
)
from karpenter_tpu_torch.simlab.labels import label_stream, stage_index
from karpenter_tpu_torch.simlab.policy import (
    Policy,
    ReactivePolicy,
    SearchResult,
    SearchTunedPolicy,
    search_tuned_policy,
)
from karpenter_tpu_torch.simlab.registry import (
    Scenario,
    catalog,
    catalog_text,
    get_scenario,
    register_scenario,
    scenarios,
    select_for,
)

# registering the built-in scenarios is an import side effect, like the
# algorithm registry's trend/simlab registrations
import karpenter_tpu_torch.simlab.builtin  # noqa: F401,E402

__all__ = [
    "BatchedSimEnv",
    "Policy",
    "ReactivePolicy",
    "Scenario",
    "SearchResult",
    "SearchTunedPolicy",
    "SimEnv",
    "SimParams",
    "SimTrails",
    "catalog",
    "catalog_text",
    "composite_reward",
    "get_scenario",
    "label_stream",
    "register_scenario",
    "scenarios",
    "search_tuned_policy",
    "select_for",
    "stage_index",
]
