"""Seeded input draws, frozen.

Copied unchanged from karpenter_tpu_torch/workloads.py at commit fa3f937
(`build_inputs`, itself the draw of bench.py's `build_inputs` in the
reference package), so that a later change to the program's workloads
cannot move the benchmark's inputs. `build_inputs` takes anything
np.random.default_rng takes as its seed (the generators pass a
SeedSequence).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def build_inputs(
    pods: int, types: int, taints: int, labels: int, seed: int,
    affinity: float = 0.0, anti: float = 0.0,
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    # pod requests: cpu in cores, memory in GiB, 1 pod slot
    req = np.stack(
        [
            rng.uniform(0.05, 8.0, pods),
            rng.uniform(0.1, 32.0, pods),
            np.ones(pods),
        ],
        axis=1,
    ).astype(np.float32)
    # instance types: cpu 2..128 cores, proportional memory, 110 pod slots
    cpu = rng.choice([2, 4, 8, 16, 32, 64, 96, 128], types).astype(np.float32)
    mem = cpu * rng.choice([2.0, 4.0, 8.0], types).astype(np.float32)
    alloc = np.stack([cpu, mem, np.full(types, 110.0, np.float32)], axis=1)
    fields = {
        "pod_requests": req,
        "pod_valid": np.ones((pods,), bool),
        "pod_intolerant": rng.random((pods, taints)) < 0.05,
        "group_taints": rng.random((types, taints)) < 0.1,
        "pod_required": rng.random((pods, labels)) < 0.03,
        "group_labels": rng.random((types, labels)) < 0.8,
        "group_allocatable": alloc,
    }
    if affinity > 0:
        # a fraction `affinity` of pods carry required node affinity, drawn
        # from a handful of shared prototype forbidden rows
        prototypes = rng.random((4, types)) < 0.3
        which = rng.integers(0, prototypes.shape[0], pods)
        fields["pod_group_forbidden"] = prototypes[which] & (
            rng.random((pods, 1)) < affinity
        )
    if anti > 0:
        # a fraction `anti` of pods carry hostname self-anti-affinity
        fields["pod_exclusive"] = rng.random(pods) < anti
    return fields
