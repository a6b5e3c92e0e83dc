"""Fleet-wide eviction planning (counterpart of karpenter_tpu/ops/preempt.py):
"what do I evict to place this?" for every candidate pod against every
node, in one program.

1. EVICTABILITY [C, V]: victim v may be evicted for candidate c iff it is
   valid, policy allows it (`victim_evictable`: the host folds
   do-not-disrupt and coordination holds into it), and either its
   priority is strictly below the candidate's or its node is a
   preemptible/spot tier.
2. MINIMAL EVICTION PREFIX: victims arrive sorted by (node, priority,
   index), so per node the evictable victims form a lowest-priority-first
   order; per (candidate, node) the shortest prefix whose freed capacity
   (plus the node's free capacity) fits the candidate, from one global
   cumsum re-based per node.
3. PLACEMENT [C]: each candidate takes the lexicographically smallest
   (evictions, node) feasible placement; candidates are planned
   independently, so a batched plan equals C single-candidate plans row
   for row, and the host engine resolves conflicts.

Integer arithmetic makes every backend agree bit for bit: resources are
quantized to QUANT units per axis maximum (need rounds up, free and freed
round down), after which every cumsum, comparison and minimum is exact
int32. The only float ops are the elementwise scale, multiply, floor and
ceil, in the reference's order. So `preempt_plan` (PyTorch ops on the
service's device: the reference runs XLA even on the TPU, there is no
Pallas preempt kernel) equals `preempt_numpy` (the reference's host
mirror, copied) on every output.

Production callers submit through `SolverService.preempt`; this module
is the program-level entry.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from karpenter_tpu_torch.utils.device import DeviceLike, resolve_device
from karpenter_tpu_torch.utils.operands import BOOL, F32, I32, Operands

# Integer capacity resolution: every resource axis is scaled so its
# largest operand maps to QUANT units. V victims * QUANT stays inside i32
# for V <= MAX_VICTIMS.
QUANT = 65536
MAX_VICTIMS = 16384
# i32 sentinel for "no feasible placement" in the key minimum
_NO_FIT = np.int32(2**31 - 1)
# `need` values above every possible free + freed total clip here before
# the f32 -> i32 conversion: the largest left-hand side is one node's
# free (<= QUANT) plus a full victim prefix (<= MAX_VICTIMS * QUANT =
# 2^30), so a need at the clip is unplaceable, and no out-of-range float
# is ever converted.
_NEED_CLIP = np.float32(2**30 + 2**17)
_DENOM_FLOOR = np.float32(1e-30)


@dataclass
class PreemptInputs(Operands):
    """Structure-of-arrays eviction-planning problem: C candidate pending
    pods, N node columns, V victim occupancy rows, R resource axes.

    Input contract (the planner and the service's padding uphold it; the
    program does not re-verify): victims sorted by (node, priority,
    index); invalid rows and columns zeroed; padding node columns
    forbidden for every candidate."""

    pod_requests: torch.Tensor  # f32[C, R] candidate requests
    pod_priority: torch.Tensor  # i32[C]
    pod_valid: torch.Tensor  # bool[C]
    pod_node_forbidden: torch.Tensor  # bool[C, N] host-folded feasibility
    node_free: torch.Tensor  # f32[N, R] free (unreserved) capacity
    node_tier: torch.Tensor  # i32[N] 0 = on-demand, >0 = preemptible/spot
    victim_requests: torch.Tensor  # f32[V, R] scheduler-effective requests
    victim_priority: torch.Tensor  # i32[V]
    victim_node: torch.Tensor  # i32[V] column index (sorted axis)
    victim_valid: torch.Tensor  # bool[V]
    victim_evictable: torch.Tensor  # bool[V] policy mask

    KINDS = {
        "pod_requests": F32, "pod_priority": I32, "pod_valid": BOOL,
        "pod_node_forbidden": BOOL, "node_free": F32, "node_tier": I32,
        "victim_requests": F32, "victim_priority": I32, "victim_node": I32,
        "victim_valid": BOOL, "victim_evictable": BOOL,
    }


@dataclass
class PreemptOutputs(Operands):
    chosen_node: torch.Tensor  # i32[C] placement column, -1 = unplaceable
    evict_count: torch.Tensor  # i32[C] evictions the placement needs
    evict_mask: torch.Tensor  # bool[C, V] the minimal eviction set per plan
    unplaceable: torch.Tensor  # i32 scalar: valid candidates with no plan

    KINDS = {
        "chosen_node": I32, "evict_count": I32, "evict_mask": BOOL,
        "unplaceable": I32,
    }


# -- the PyTorch program --------------------------------------------------------


def _quantize(inputs: PreemptInputs):
    """(need i32[C, R], free i32[N, R], shed i32[V, R]). The scale's
    denominator is the max over the node and victim families only, never
    the candidates, so a single-candidate subproblem over the same fleet
    quantizes identically (the batched == independent property)."""
    n_res = inputs.pod_requests.shape[1]
    denom = torch.full(
        (n_res,), float(_DENOM_FLOOR), dtype=F32,
        device=inputs.pod_requests.device,
    )
    if inputs.node_free.shape[0]:  # N = 0 has no node max
        denom = torch.maximum(denom, inputs.node_free.amax(dim=0))
    if inputs.victim_requests.shape[0]:  # V = 0 likewise
        denom = torch.maximum(denom, inputs.victim_requests.amax(dim=0))
    scale = float(QUANT) / denom  # f32[R], one IEEE division each
    need = torch.clamp_max(
        torch.ceil(inputs.pod_requests * scale), float(_NEED_CLIP)
    ).to(I32)
    free = torch.floor(inputs.node_free * scale).to(I32)
    shed = torch.floor(inputs.victim_requests * scale).to(I32)
    return need, free, shed


def _evictable(inputs: PreemptInputs) -> torch.Tensor:
    """bool[C, V]: victim v may be evicted to admit candidate c."""
    victim_tier = inputs.node_tier[inputs.victim_node.long()]
    outranked = inputs.victim_priority[None, :] < inputs.pod_priority[:, None]
    reclaimable = (victim_tier > 0)[None, :]
    return (
        (inputs.victim_valid & inputs.victim_evictable)[None, :]
        & (outranked | reclaimable)
        & inputs.pod_valid[:, None]
    )


def _node_base_index(victim_node: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """i32[N]: index of the last victim before each node's segment (the
    sorted-victim contract makes segments contiguous), -1 when a node's
    segment starts at row 0. O(V + N) via bincount and an exclusive
    cumsum."""
    counts = torch.bincount(victim_node.long(), minlength=n_nodes)[:n_nodes]
    counts = counts.to(I32)
    before = torch.cumsum(counts, dim=0, dtype=I32) - counts
    return before - 1


def _per_node(table: torch.Tensor, base_idx: torch.Tensor,
              victim_node: torch.Tensor) -> torch.Tensor:
    """`table` ([C, V, ...] inclusive prefix along the victim axis)
    re-based per node: each victim's entry minus the prefix total of
    every earlier node's segment."""
    gather = base_idx.clamp_min(0).long()
    base = table.index_select(1, gather)  # [C, N, ...]
    shape = (1, -1) + (1,) * (table.dim() - 2)
    base = torch.where((base_idx >= 0).view(shape), base, 0)
    return table - base.index_select(1, victim_node.long())


def _plan(inputs: PreemptInputs) -> PreemptOutputs:
    """The program over PreemptInputs of tensors on one device, in the
    reference's order of operations (module docstring)."""
    dev = inputs.pod_requests.device
    c = inputs.pod_requests.shape[0]
    n_nodes = inputs.node_free.shape[0]
    n_victims = inputs.victim_requests.shape[0]
    if n_nodes == 0:
        # a nodeless fleet places nothing: every valid candidate is
        # unplaceable
        return PreemptOutputs(
            chosen_node=torch.full((c,), -1, dtype=I32, device=dev),
            evict_count=torch.zeros(c, dtype=I32, device=dev),
            evict_mask=torch.zeros((c, n_victims), dtype=BOOL, device=dev),
            unplaceable=inputs.pod_valid.to(I32).sum(dtype=I32),
        )
    evictable = _evictable(inputs)  # bool[C, V]
    need, free, shed = _quantize(inputs)
    valid = inputs.pod_valid[:, None]
    if n_victims:  # V = 0 plans from free space only
        victim_col = inputs.victim_node.long()
        base_idx = _node_base_index(inputs.victim_node, n_nodes)
        # within-node inclusive prefix of freed capacity per candidate
        shed_c = shed[None, :, :] * evictable[:, :, None].to(I32)
        gcum = torch.cumsum(shed_c, dim=1, dtype=I32)  # i32[C, V, R]
        prefix = _per_node(gcum, base_idx, inputs.victim_node)
        # the same re-based prefix over eviction counts
        cnt_g = torch.cumsum(evictable.to(I32), dim=1, dtype=I32)
        cnt = _per_node(cnt_g, base_idx, inputs.victim_node)  # i32[C, V]
        # placement keys: (evictions, node) packed lexicographically
        fit_v = (
            free.index_select(0, victim_col)[None, :, :] + prefix
            >= need[:, None, :]
        ).all(dim=2)
        allowed_v = ~inputs.pod_node_forbidden.index_select(1, victim_col)
        key_v = torch.where(
            fit_v & allowed_v & valid,
            cnt * n_nodes + inputs.victim_node[None, :],
            int(_NO_FIT),
        )
        best_v = key_v.amin(dim=1)
    else:
        cnt = torch.zeros((c, 0), dtype=I32, device=dev)
        best_v = torch.full((c,), int(_NO_FIT), dtype=I32, device=dev)

    fit_0 = (free[None, :, :] >= need[:, None, :]).all(dim=2)  # bool[C, N]
    key_0 = torch.where(
        fit_0 & ~inputs.pod_node_forbidden & valid,
        torch.arange(n_nodes, dtype=I32, device=dev)[None, :],
        int(_NO_FIT),
    )
    best = torch.minimum(best_v, key_0.amin(dim=1))  # i32[C]
    placed = best != int(_NO_FIT)
    chosen = torch.where(placed, best % n_nodes, -1).to(I32)
    evict_count = torch.where(placed, best // n_nodes, 0).to(I32)
    evict_mask = (
        placed[:, None]
        & (inputs.victim_node[None, :] == chosen[:, None])
        & evictable
        & (cnt <= evict_count[:, None])
    )
    unplaceable = (inputs.pod_valid & ~placed).to(I32).sum(dtype=I32)
    return PreemptOutputs(
        chosen_node=chosen,
        evict_count=evict_count,
        evict_mask=evict_mask,
        unplaceable=unplaceable,
    )


def preempt_plan(inputs, device: DeviceLike = None) -> PreemptOutputs:
    """The program on `device` (the CUDA card by default; tensor operands
    keep their own device when none is named). `inputs` is the port's
    PreemptInputs, the reference's dataclass or a dict of numpy arrays;
    the outputs are tensors on that device. One call plans every
    candidate."""
    if device is None and isinstance(
        getattr(inputs, "pod_requests", None), torch.Tensor
    ):
        device = inputs.pod_requests.device
    return _plan(PreemptInputs.from_numpy(inputs, resolve_device(device)))


# -- numpy mirror ---------------------------------------------------------------
# The reference's host program (its `_plan` over numpy arrays), copied:
# the parity oracle and the service's numpy rung. Like the reference's,
# its count prefix accumulates in numpy's default integer, so
# chosen_node and evict_count come back int64 when V > 0 (equal values).


def _quantize_numpy(inputs: PreemptInputs):
    denom = np.float32(1e-30) * np.ones(
        inputs.pod_requests.shape[1], np.float32
    )
    if inputs.node_free.shape[0]:
        denom = np.maximum(denom, np.max(inputs.node_free, axis=0))
    if inputs.victim_requests.shape[0]:
        denom = np.maximum(denom, np.max(inputs.victim_requests, axis=0))
    scale = np.float32(QUANT) / denom
    need = np.minimum(
        np.ceil(inputs.pod_requests * scale[None, :]), _NEED_CLIP
    ).astype(np.int32)
    free = np.floor(inputs.node_free * scale[None, :]).astype(np.int32)
    shed = np.floor(inputs.victim_requests * scale[None, :]).astype(np.int32)
    return need, free, shed


def _evictable_numpy(inputs: PreemptInputs):
    victim_tier = inputs.node_tier[inputs.victim_node]
    outranked = inputs.victim_priority[None, :] < inputs.pod_priority[:, None]
    reclaimable = (victim_tier > 0)[None, :]
    return (
        (inputs.victim_valid & inputs.victim_evictable)[None, :]
        & (outranked | reclaimable)
        & inputs.pod_valid[:, None]
    )


def _node_base_index_numpy(victim_node, n_nodes: int):
    counts = np.bincount(victim_node, minlength=n_nodes)[:n_nodes].astype(
        np.int32
    )
    before = np.cumsum(counts, dtype=np.int32) - counts
    return before - 1


def _plan_numpy(inputs: PreemptInputs) -> PreemptOutputs:
    xp = np
    evictable = _evictable_numpy(inputs)
    n_nodes = inputs.node_free.shape[0]
    n_victims = inputs.victim_requests.shape[0]
    if n_nodes == 0:
        c = inputs.pod_requests.shape[0]
        return PreemptOutputs(
            chosen_node=xp.full(c, -1, np.int32),
            evict_count=xp.zeros(c, np.int32),
            evict_mask=xp.zeros((c, n_victims), bool),
            unplaceable=xp.sum(
                inputs.pod_valid.astype(np.int32), dtype=np.int32
            ),
        )
    need, free, shed = _quantize_numpy(inputs)

    if n_victims:
        shed_c = shed[None, :, :] * evictable[:, :, None].astype(np.int32)
        gcum = xp.cumsum(shed_c, axis=1, dtype=np.int32)
        base_idx = _node_base_index_numpy(inputs.victim_node, n_nodes)
        base = xp.where(
            (base_idx >= 0)[None, :, None],
            xp.take(gcum, xp.maximum(base_idx, 0), axis=1),
            np.int32(0),
        )
        prefix = gcum - xp.take(base, inputs.victim_node, axis=1)

        cnt_g = xp.cumsum(evictable.astype(np.int32), axis=1)
        cnt_base = xp.where(
            (base_idx >= 0)[None, :],
            xp.take(cnt_g, xp.maximum(base_idx, 0), axis=1),
            np.int32(0),
        )
        cnt = cnt_g - xp.take(cnt_base, inputs.victim_node, axis=1)

        victim_col = inputs.victim_node
        fit_v = xp.all(
            xp.take(free, victim_col, axis=0)[None, :, :] + prefix
            >= need[:, None, :],
            axis=2,
        )
        allowed_v = ~xp.take(inputs.pod_node_forbidden, victim_col, axis=1)
        key_v = xp.where(
            fit_v & allowed_v & inputs.pod_valid[:, None],
            cnt * np.int32(n_nodes) + victim_col[None, :],
            _NO_FIT,
        )
        best_v = xp.min(key_v, axis=1)
    else:
        cnt = xp.zeros((inputs.pod_requests.shape[0], 0), np.int32)
        best_v = _NO_FIT

    fit_0 = xp.all(free[None, :, :] >= need[:, None, :], axis=2)
    key_0 = xp.where(
        fit_0 & ~inputs.pod_node_forbidden & inputs.pod_valid[:, None],
        xp.arange(n_nodes, dtype=np.int32)[None, :],
        _NO_FIT,
    )

    best = xp.minimum(best_v, xp.min(key_0, axis=1))
    placed = best != _NO_FIT
    chosen = xp.where(placed, best % np.int32(n_nodes), np.int32(-1))
    evict_count = xp.where(placed, best // np.int32(n_nodes), np.int32(0))
    evict_mask = (
        placed[:, None]
        & (inputs.victim_node[None, :] == chosen[:, None])
        & evictable
        & (cnt <= evict_count[:, None])
    )
    unplaceable = xp.sum(
        (inputs.pod_valid & ~placed).astype(np.int32), dtype=np.int32
    )
    return PreemptOutputs(
        chosen_node=chosen,
        evict_count=evict_count,
        evict_mask=evict_mask,
        unplaceable=unplaceable,
    )


def preempt_numpy(inputs) -> PreemptOutputs:
    """The host mirror: PreemptInputs (either package's, or a dict) of
    host arrays in, PreemptOutputs of numpy arrays out. Equal to
    preempt_plan on every output (integer arithmetic; module
    docstring)."""
    return _plan_numpy(PreemptInputs.from_arrays(inputs))


def solve_preempt(inputs, backend: str = "auto",
                  device: DeviceLike = None) -> PreemptOutputs:
    """Program-level dispatcher: 'torch' (preempt_plan on `device`, the
    card by default; 'cuda' names the same program on the card — there is
    no hand-written preempt kernel), 'numpy', or 'auto' (torch on the
    card, numpy when device='cpu'). Production callers use
    SolverService.preempt."""
    n_victims = int(inputs.victim_requests.shape[0])
    if n_victims > MAX_VICTIMS:
        raise ValueError(
            f"preempt solve supports at most {MAX_VICTIMS} victims "
            f"(i32 capacity headroom), got {n_victims}"
        )
    if backend == "auto":
        backend = "numpy" if resolve_device(device).type == "cpu" else "torch"
    if backend == "numpy":
        return preempt_numpy(inputs)
    if backend in ("torch", "cuda"):
        return preempt_plan(inputs, device)
    raise ValueError(f"unknown preempt backend {backend!r}")
