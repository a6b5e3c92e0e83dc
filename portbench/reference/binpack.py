"""The bin-pack solve in plain numpy: the reference that `correct` holds
`SolverService.solve` against, and its lower-precision control.

The semantics are the port's (karpenter_tpu_torch/ops/binpack.py at commit
fa3f937, the reference package's contract), written here from scratch for
the operands the benchmark's generators send: requests, validity, taints,
labels, an optional pod_group_forbidden and pod_weight. A snapshot with
any other operand (score, priority, spread or exclusive constraints) is
refused, never judged by semantics it does not have.

1. feasibility [P, T]: every resource fits (request <= allocatable), the
   group has some allocatable, no taint the pod does not tolerate, every
   label the pod requires, no group the row forbids, a valid row;
2. assignment: the first feasible group (first fit), -1 where none is;
3. the assigned group's dominant share max_r(request / allocatable),
   quantized up into B buckets and clamped to [1, B], f32 arithmetic;
4. per group: the weighted count, the [T, B] histogram, the shelf
   best-fit-decreasing node count over it (`shelf_nodes`, vectorized over
   groups; `shelf_nodes_scalar` is the same algorithm item by item), and
   the LP bound max_r ceil(demand / allocatable - 1e-5) with the demand
   summed in f64 and rounded once to f32;
5. the weighted count of valid rows with no group.

With requests in [0.05, 32] the f64 demand sums are exact in any order
(every partial sum is a multiple of 2**-28 below 2**22), so the integer
outputs are exact whatever order the program sums in.

`precision="bf16"` is the control: the same program with every float
operand and the quotient rounded to bfloat16 first, the step below the
f32 the configuration states.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.reference import roofline

OUTPUTS = ("assigned", "assigned_count", "nodes_needed", "lp_bound",
           "unschedulable")
OPERANDS = ("pod_requests", "pod_valid", "pod_intolerant", "pod_required",
            "pod_group_forbidden", "pod_weight", "group_allocatable",
            "group_taints", "group_labels")
# what `answer` gives beyond the program's outputs (the roofline's
# counts read it; never compared)
NOT_COMPARED = ("hist",)
_ROW_BLOCK = 25_000  # rows per feasibility block: [block, T] bools at a time


def to_bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bfloat16 (ties to even), kept as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> 16) & 1))) & np.uint32(0xFFFF0000)
    return rounded.view(np.float32)


def _first_fit(fields: Dict[str, np.ndarray], rnd) -> np.ndarray:
    """i32[P]: each row's first feasible group, -1 where none."""
    req = rnd(fields["pod_requests"])
    alloc = rnd(fields["group_allocatable"])
    valid = np.asarray(fields["pod_valid"], bool)
    taints = np.asarray(fields["group_taints"], np.float32)
    missing = (~np.asarray(fields["group_labels"], bool)).astype(np.float32)
    has_alloc = (alloc > 0).any(axis=1)
    n_pods, n_groups = req.shape[0], alloc.shape[0]
    assigned = np.full(n_pods, -1, np.int32)
    for lo in range(0, n_pods, _ROW_BLOCK):
        hi = min(lo + _ROW_BLOCK, n_pods)
        fits = np.broadcast_to(has_alloc[None, :], (hi - lo, n_groups)).copy()
        for r in range(req.shape[1]):
            fits &= req[lo:hi, r, None] <= alloc[None, :, r]
        # 0/1 products: exact counts of violated taints and missing labels
        intol = np.asarray(fields["pod_intolerant"][lo:hi], np.float32)
        required = np.asarray(fields["pod_required"][lo:hi], np.float32)
        fits &= (intol @ taints.T) < 0.5
        fits &= (required @ missing.T) < 0.5
        forbidden = fields.get("pod_group_forbidden")
        if forbidden is not None:
            fits &= ~np.asarray(forbidden[lo:hi], bool)
        fits &= valid[lo:hi, None]
        first = np.argmax(fits, axis=1)
        assigned[lo:hi] = np.where(fits.any(axis=1), first, -1)
    return assigned


def _buckets(req, alloc, assigned, buckets: int, rnd) -> np.ndarray:
    """i32[P]: the assigned group's dominant share, quantized into
    [1, buckets] (f32 arithmetic; unassigned rows read group 0)."""
    a = alloc[np.maximum(assigned, 0)]
    share = np.zeros(req.shape[0], np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for r in range(req.shape[1]):
            q = rnd(req[:, r] / np.where(a[:, r] > 0, a[:, r], np.float32(1)))
            s = np.where(a[:, r] > 0, q, np.float32(np.inf))
            s = np.where((a[:, r] <= 0) & (req[:, r] <= 0), np.float32(0), s)
            share = np.maximum(share, s)
        scaled = np.ceil(share * np.float32(buckets))
    return np.clip(scaled, 1, buckets).astype(np.int32)


def shelf_nodes(hist: np.ndarray, buckets: int) -> np.ndarray:
    """i32[T]: shelf best-fit-decreasing node counts of i32[T, B] item
    histograms (items of size k / B), all groups at once. Sizes go
    descending; items of size k first fill open bins best fit (smallest
    sufficient remnant first, one item per bin per pass), then open bins
    of floor(B / k) items each. floor(B / k) passes place every item an
    open bin can take."""
    n_groups = hist.shape[0]
    rem_index = np.arange(buckets + 1)
    bins = np.zeros((n_groups, buckets + 1), np.int64)
    total = np.zeros(n_groups, np.int64)
    rows = np.arange(n_groups)
    for k in range(buckets, 0, -1):
        c = hist[:, k - 1].astype(np.int64)
        usable = (rem_index >= k)[None, :]
        for _ in range(buckets // k):
            avail = np.where(usable, bins, 0)
            before = np.cumsum(avail, axis=1) - avail
            place = np.minimum(np.maximum(c[:, None] - before, 0), avail)
            bins = bins - place + np.roll(place, -k, axis=1)
            c = c - place.sum(axis=1)
        per_bin = buckets // k
        full, leftover = c // per_bin, c % per_bin
        total += full + (leftover > 0)
        bins[:, buckets - per_bin * k] += full
        partial = leftover > 0
        bins[rows[partial], buckets - leftover[partial] * k] += 1
    return total.astype(np.int32)


def shelf_nodes_scalar(hist: np.ndarray, buckets: int) -> np.ndarray:
    """shelf_nodes item by item (the tests' witness for it)."""
    totals = np.zeros(hist.shape[0], np.int64)
    for t, row in enumerate(hist):
        bins = np.zeros(buckets + 1, np.int64)
        for k in range(buckets, 0, -1):
            c = int(row[k - 1])
            while c > 0:
                placed = False
                for rem in range(k, buckets + 1):
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
                per_bin = buckets // k
                full, leftover = divmod(c, per_bin)
                totals[t] += full + (leftover > 0)
                bins[buckets - per_bin * k] += full
                if leftover > 0:
                    bins[buckets - leftover * k] += 1
    return totals.astype(np.int32)


def binpack_reference(fields: Dict[str, np.ndarray], buckets: int,
                      precision: str = "f32") -> Dict[str, np.ndarray]:
    """The five BinPackOutputs (numpy) plus "hist" (i32[T, B]), for the
    roofline's counts. precision "f32" is the reference, "bf16" the
    control."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    unknown = sorted(set(fields) - set(OPERANDS))
    if unknown:
        raise ValueError(f"the reference has no semantics for {unknown}")
    rnd = to_bf16 if precision == "bf16" else (
        lambda x: np.asarray(x, np.float32))
    req = rnd(fields["pod_requests"])
    alloc = rnd(fields["group_allocatable"])
    valid = np.asarray(fields["pod_valid"], bool)
    weight = fields.get("pod_weight")
    weight = np.ones(req.shape[0], np.int64) if weight is None else (
        np.asarray(weight, np.int64))
    n_groups = alloc.shape[0]

    assigned = _first_fit(fields, rnd)
    has = assigned >= 0
    bucket = _buckets(req, alloc, assigned, buckets, rnd)
    w_row = np.where(has, weight, 0)
    cell = np.maximum(assigned, 0).astype(np.int64) * buckets + bucket - 1
    hist = np.bincount(cell, weights=w_row, minlength=n_groups * buckets)
    hist = hist.astype(np.int64).reshape(n_groups, buckets)
    demand = np.stack([
        np.bincount(np.maximum(assigned, 0), weights=w_row * req[:, r].astype(
            np.float64), minlength=n_groups)
        for r in range(req.shape[1])
    ], axis=1).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_res = np.where(
            alloc > 0,
            np.ceil(demand / np.where(alloc > 0, alloc, np.float32(1))
                    - np.float32(1e-5)),
            np.float32(0),
        )
    return {
        "assigned": assigned,
        "assigned_count": hist.sum(axis=1).astype(np.int32),
        "nodes_needed": shelf_nodes(hist, buckets),
        "lp_bound": per_res.max(axis=1).astype(np.int32),
        "unschedulable": np.int32(np.sum(np.where(~has & valid, weight, 0))),
        "hist": hist.astype(np.int32),
    }


# -- what the harness and the control call (the configuration's
# "reference" names this module) --


def answer(config: dict, ops: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The reference's answer to one request's operands."""
    return binpack_reference(ops, int(config["buckets"]))


def control(config: dict, ops: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The control: the reference one precision down (bfloat16)."""
    out = binpack_reference(ops, int(config["buckets"]), precision="bf16")
    out.pop("hist")
    return out


def work(config: dict, ops: Dict[str, np.ndarray], want: dict) -> dict:
    """{kernel: (operations, bytes)} of one launch on these operands, by
    the reference's assignment and histogram (`want`, from `answer`)."""
    return roofline.kernel_cost(ops, int(config["buckets"]),
                                want["assigned"], want["hist"])
