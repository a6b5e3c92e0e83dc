"""Degraded-mode bin-pack: the XLA program's semantics in plain numpy,
shaped for CPUs.

Why this exists: the XLA program (ops/binpack.py) is laid out for the
TPU — its bucket histogram is a B-deep stack of [P, T] masked reductions,
O(P*T*B) elementwise work that the MXU-fed vector units eat for free but
that DOMINATES a CPU fallback solve (seconds at the 100k x 300 bench
scale). A CPU doesn't want that layout; it wants the sparse one: each pod
has exactly ONE assigned group, so every post-assignment aggregate is an
O(P) scatter (np.bincount), not an O(P*T*B) dense reduction. Feasibility
stays dense ([P, K] @ [K, T] bitset matmuls ride BLAS sgemm), assignment
is one argmax, and the shelf-BFD histogram walk is O(B^2) over [T, B+1] —
trivial.

In the reference this backend is what solve(backend="auto") picks on a
CPU jax backend — the accelerator-outage degraded mode. Outputs
are pinned equal to the reference's binpack_numpy and to the port's
plain program by tests/test_torch_numpy_binpack.py (same argmax
tie-breaks, same f32 quantization arithmetic) — exactly for
assigned/assigned_count/nodes_needed/unschedulable; lp_bound within +-1
at f32-resolution boundaries, where this path's f64 demand
accumulation is strictly MORE accurate than the accelerator's f32
einsum and the shared -1e-5 ceil guard is smaller than one f32 ulp of
the ratio (above ~84 nodes demanded per group).

reference: the reference stubs this producer entirely
(pkg/metrics/producers/pendingcapacity/producer.go:29-31); its design doc
warns the naive host form "scales linearly with node groups and
unschedulable pods" (docs/designs/DESIGN.md) — this is the non-naive
host form for when the accelerator is away.

The port's copy of karpenter_tpu/ops/numpy_binpack.py. What differs:
it takes the port's BinPackInputs (numpy arrays, or tensors, which it
reads on the host); the reservation/spread mask, the steer matrix and
the lexicographic choice are the port's single definitions in
ops/binpack.py, evaluated on CPU tensors that share the numpy buffers
(integer arithmetic and first-maximum argmax, so the same bits); the C
helper is the port's copy (native/). The caller reaches it by naming
it, solve(backend="numpy") or the solve service's numpy rung: it needs
no card and returns numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_tpu_torch.ops.binpack import (
    BinPackInputs,
    BinPackOutputs,
    constraint_mask,
    has_constraint_operands,
    steer_matrix,
    steered_choice,
)


def _as_np(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    return arr if dtype is None else arr.astype(dtype, copy=False)


def _cpu(x):
    """A CPU tensor sharing `x`'s numpy buffer (None stays None); a
    read-only array is copied first, since torch tensors are writable."""
    if x is None:
        return None
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def _np(t):
    return None if t is None else t.numpy()


def _pack_bits(matrix: np.ndarray, lib=None) -> np.ndarray:
    """bool[N, K] -> uint64[N, W] little-endian bit words (the native
    kernel's taint/label operand layout). With the native lib, one
    scalar C pass (memory-bound, shape-indifferent) replaces
    np.packbits, which pays per-row overhead on narrow matrices and a
    full 64-column bool pad on wide ones — the pack was most of the
    degraded-mode solve before this."""
    n, k = matrix.shape
    words = max(1, -(-k // 64))
    if lib is not None and n and k:
        import ctypes

        src = np.asarray(matrix)
        if src.dtype != np.bool_:
            # the C octet-gather needs strictly 0/1 bytes
            src = src != 0
        src = (
            # bool and uint8 share layout: view, don't cast-copy
            src.view(np.uint8)
            if src.flags.c_contiguous
            else np.ascontiguousarray(src).view(np.uint8)
        )
        out = np.empty((n, words), np.uint64)
        lib.karpenter_pack_bits(
            ctypes.c_longlong(n),
            ctypes.c_longlong(k),
            ctypes.c_longlong(words),
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        return out
    padded = np.zeros((n, words * 64), bool)
    padded[:, :k] = matrix
    return np.ascontiguousarray(
        np.packbits(padded, axis=1, bitorder="little")
    ).view(np.uint64)


# one-slot identity-keyed pack cache (the reference's numpy path has the
# same): callers that pass the SAME BinPackInputs object again (the encode
# memo, the bench's steady-state loop) skip re-packing the [P, K] bool
# operands into bit words — ~2 ms of pure memory traffic per solve at the
# 100k x 64-taint scale. Contract: inputs are immutable once passed to
# solve().
_pack_memo = None


def _packed_operands(inputs, intolerant, taints, labels, required, lib):
    global _pack_memo
    memo = _pack_memo
    if inputs is not None and memo is not None and memo[0] is inputs:
        return memo[1]
    packed = (
        _pack_bits(intolerant, lib),
        _pack_bits(taints, lib),
        _pack_bits(required, lib),
        _pack_bits(~labels, lib),
    )
    if inputs is not None:
        _pack_memo = (inputs, packed)
    return packed


def _assign_native(
    lib, requests, valid, intolerant, required, alloc, taints, labels,
    forbidden, score, weight, exclusive, buckets, inputs=None,
):
    """One fused native pass: (assigned, assigned_count, histogram,
    demand, unschedulable). Same contract as the numpy stages it
    replaces; parity pinned by tests/test_torch_numpy_binpack.py."""
    import ctypes

    n_pods, n_resources = requests.shape
    n_groups = alloc.shape[0]
    (
        intolerant_words,
        taint_words,
        required_words,
        missing_words,
    ) = _packed_operands(inputs, intolerant, taints, labels, required, lib)

    assigned = np.empty(n_pods, np.int32)
    assigned_count = np.zeros(n_groups, np.int64)
    histogram = np.zeros((n_groups, buckets), np.int64)
    demand = np.zeros((n_groups, n_resources), np.float64)
    unschedulable = np.zeros(1, np.int64)

    def ptr(arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    requests = np.ascontiguousarray(requests, np.float32)
    alloc_c = np.ascontiguousarray(alloc, np.float32)
    valid_c = np.ascontiguousarray(valid, np.uint8)
    forbidden_c = (
        None
        if forbidden is None
        else np.ascontiguousarray(forbidden, np.uint8)
    )
    score_c = (
        None if score is None else np.ascontiguousarray(score, np.float32)
    )
    weight_c = (
        None if weight is None else np.ascontiguousarray(weight, np.int64)
    )
    exclusive_c = (
        None
        if exclusive is None
        else np.ascontiguousarray(exclusive, np.uint8)
    )
    null = ctypes.POINTER(ctypes.c_float)()
    entry, extra = _assign_entry(lib, ctypes, n_pods)
    entry(
        ctypes.c_longlong(n_pods),
        ctypes.c_longlong(n_groups),
        ctypes.c_longlong(n_resources),
        ctypes.c_longlong(intolerant_words.shape[1]),
        ctypes.c_longlong(required_words.shape[1]),
        ctypes.c_longlong(buckets),
        ptr(requests, ctypes.c_float),
        ptr(valid_c, ctypes.c_ubyte),
        ptr(intolerant_words, ctypes.c_uint64),
        ptr(required_words, ctypes.c_uint64),
        ptr(alloc_c, ctypes.c_float),
        ptr(taint_words, ctypes.c_uint64),
        ptr(missing_words, ctypes.c_uint64),
        (
            ptr(forbidden_c, ctypes.c_ubyte)
            if forbidden_c is not None
            else ctypes.POINTER(ctypes.c_ubyte)()
        ),
        ptr(score_c, ctypes.c_float) if score_c is not None else null,
        (
            ptr(weight_c, ctypes.c_longlong)
            if weight_c is not None
            else ctypes.POINTER(ctypes.c_longlong)()
        ),
        (
            ptr(exclusive_c, ctypes.c_ubyte)
            if exclusive_c is not None
            else ctypes.POINTER(ctypes.c_ubyte)()
        ),
        ptr(assigned, ctypes.c_int32),
        ptr(assigned_count, ctypes.c_longlong),
        ptr(histogram, ctypes.c_longlong),
        ptr(demand, ctypes.c_double),
        ptr(unschedulable, ctypes.c_longlong),
        *extra,
    )
    return assigned, assigned_count, histogram, demand, int(unschedulable[0])


# minimum pods per thread before fan-out pays: below this, the per-call
# pthread create/join (~tens of us each) rivals the whole fused solve
# (a 1000-pod tick measures ~0.2 ms), so small solves stay single-pass
_MIN_PODS_PER_THREAD = 8192


def _assign_entry(lib, ctypes, n_pods: int):
    """The native entry point + trailing args: the threaded choice phase
    when the host has cores for it AND the problem is big enough to
    amortize spawn/join. KARPENTER_SOLVER_THREADS overrides both (an
    explicit operator/test choice bypasses the size gate); 0/1, a small
    auto-sized solve, or a prebuilt .so without the symbol = the fused
    single pass. Outputs are bitwise identical either way: the C side
    accumulates every aggregate sequentially in pod order."""
    n_threads = _solver_threads(n_pods)
    if n_threads > 1 and hasattr(lib, "karpenter_assign_mt"):
        return lib.karpenter_assign_mt, (ctypes.c_longlong(n_threads),)
    return lib.karpenter_assign, ()


def _solver_threads(n_pods: int) -> int:
    """Choice-phase thread count. Explicit KARPENTER_SOLVER_THREADS is
    honored as-is; otherwise the CPUs actually AVAILABLE to this
    process — sched_getaffinity sees cgroup cpusets/affinity where
    os.cpu_count() reports the node's cores and would oversubscribe a
    cpu-limited pod — capped by the size gate. 1 = the fused pass."""
    import os

    raw = os.environ.get("KARPENTER_SOLVER_THREADS", "")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            return 1
    try:
        cores = len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # non-Linux
        cores = os.cpu_count() or 1
    return min(cores, max(1, n_pods // _MIN_PODS_PER_THREAD))


def _feasibility_np(
    requests, valid, intolerant, required, alloc, taints, labels, forbidden
):
    """bool[P, T], boolean-identical to ops/binpack._feasibility. The
    taint/label violations stay f32 matmuls here too: measured on this
    class of CPU, single-threaded BLAS sgemm beats a packed-uint64
    broadcast formulation (which is memory-traffic-bound on the [P, T]
    word temps) — and the small-integer counts are exact in f32."""
    fits = np.ones((requests.shape[0], alloc.shape[0]), bool)
    for r in range(requests.shape[1]):
        fits &= requests[:, r : r + 1] <= alloc[None, :, r]
    fits &= np.any(alloc > 0, axis=1)[None, :]
    taint_violations = intolerant.astype(np.float32) @ taints.astype(
        np.float32
    ).T
    label_violations = required.astype(np.float32) @ (~labels).astype(
        np.float32
    ).T
    fits &= taint_violations < 0.5
    fits &= label_violations < 0.5
    if forbidden is not None:
        fits &= ~forbidden
    fits &= valid[:, None]
    return fits


# the C shelf pass keeps its per-group bin state in a stack VLA; cap the
# bucket count it accepts so a pathological caller degrades to the numpy
# path instead of overflowing the thread stack (production uses <= 64)
_NATIVE_SHELF_MAX_BUCKETS = 4096


def _shelf_bfd(histogram: np.ndarray, buckets: int, lib) -> np.ndarray:
    """i32[T, B] -> i32[T]: the C pass when the kernel is loaded (the
    [T, B+1] state is tiny — the numpy form pays ~1000 array-op
    dispatches of interpreter overhead per solve), else numpy."""
    if lib is not None and buckets <= _NATIVE_SHELF_MAX_BUCKETS:
        import ctypes

        hist = np.ascontiguousarray(histogram, np.int64)
        total = np.zeros(histogram.shape[0], np.int64)
        lib.karpenter_shelf_bfd(
            ctypes.c_longlong(histogram.shape[0]),
            ctypes.c_longlong(buckets),
            hist.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            total.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        )
        return total.astype(np.int32)
    return _shelf_bfd_np(histogram, buckets)


def _shelf_bfd_np(histogram: np.ndarray, buckets: int) -> np.ndarray:
    """i32[T, B] -> i32[T]; the vectorized shelf best-fit-decreasing of
    ops/binpack._shelf_bfd, same pass structure, numpy state."""
    n_groups = histogram.shape[0]
    rem_index = np.arange(buckets + 1, dtype=np.int64)
    bins = np.zeros((n_groups, buckets + 1), np.int64)
    total = np.zeros(n_groups, np.int64)
    for k in range(buckets, 0, -1):
        c = histogram[:, k - 1].astype(np.int64)
        for _ in range(buckets):
            if not c.any():
                break  # pure speedup: remaining passes are no-ops
            avail = np.where(
                (rem_index[None, :] >= k) & (rem_index[None, :] > 0),
                bins,
                0,
            )
            cum_before = np.cumsum(avail, axis=1) - avail
            place = np.clip(c[:, None] - cum_before, 0, avail)
            bins = bins - place + np.roll(place, -k, axis=1)
            c = c - place.sum(axis=1)
        per_bin = buckets // k
        full_bins = c // per_bin
        leftover = c - full_bins * per_bin
        has_partial = (leftover > 0).astype(np.int64)
        total += full_bins + has_partial
        full_rem = buckets - per_bin * k
        bins[:, full_rem] += full_bins
        partial_rem = buckets - leftover * k
        bins[np.arange(n_groups), partial_rem] += has_partial
    return total.astype(np.int32)


def _assign_numpy(
    requests, valid, intolerant, required, alloc, taints, labels,
    forbidden, score, weight, exclusive, buckets, steer=None,
    claim=None, reservation=None, slot=None, domain=None, caps=None,
    pack_class=None,
):
    """The pure-numpy assignment pass (the fallback while the C kernel's
    background build finishes, and the only pass expressing the
    two-stage lexicographic steer+score choice and the constraint
    plane). Sparse layout: everything after the argmax scatters over
    the ONE assigned group per pod — O(P), where the dense XLA layout
    is O(P*T*(B|R))."""
    _, n_resources = requests.shape
    n_groups = alloc.shape[0]
    feasible = _feasibility_np(
        requests, valid, intolerant, required, alloc, taints, labels,
        forbidden,
    )
    # reservation + spread mask: the shared integer-exact definition
    # (ops/binpack.constraint_mask on CPU tensors) — bitwise identical to
    # the plain program's feasibility stage by construction
    cmask = _np(constraint_mask(
        *(_cpu(a) for a in (claim, reservation, slot, domain, caps)),
        _cpu(weight), _cpu(valid),
    ))
    if cmask is not None:
        feasible = feasible & cmask
    any_feasible = feasible.any(axis=1)
    if score is None and steer is None:
        choice = np.argmax(feasible, axis=1)
    else:
        choice = steered_choice(
            _cpu(feasible), _cpu(score), _cpu(steer)
        ).numpy()
    assigned = np.where(any_feasible, choice, -1).astype(np.int32)

    rows = np.nonzero(any_feasible & valid)[0]
    groups_of = choice[rows]
    w_of = (
        np.ones(len(rows), np.int64)
        if weight is None
        else weight[rows]
    )

    assigned_count = np.bincount(
        groups_of, weights=w_of, minlength=n_groups
    ).astype(np.int32)

    # dominant share of each assigned pod ON ITS GROUP ONLY, f32 ops
    # in the same order as _dominant_share so the quantized bucket
    # matches the XLA program bit for bit
    share = np.zeros(len(rows), np.float32)
    row_alloc = alloc[groups_of]  # [n, R]
    row_req = requests[rows]
    for r in range(n_resources):
        a = row_alloc[:, r]
        s = np.where(
            a > 0,
            row_req[:, r] / np.maximum(a, np.float32(1e-30)),
            np.float32(np.inf),
        ).astype(np.float32)
        s = np.where(
            (a <= 0) & (row_req[:, r] <= 0), np.float32(0.0), s
        )
        share = np.maximum(share, s)
    bucket_of = np.clip(
        np.ceil(share * np.float32(buckets)).astype(np.int64),
        1,
        buckets,
    )
    if exclusive is not None:
        # hostname self-anti-affinity: the pod takes a whole node
        bucket_of = np.where(exclusive[rows], buckets, bucket_of)
    if pack_class is None:
        histogram = np.bincount(
            groups_of.astype(np.int64) * buckets + (bucket_of - 1),
            weights=w_of,
            minlength=n_groups * buckets,
        ).reshape(n_groups, buckets)
    else:
        # per-class histograms [C*T, B], mirroring the XLA program's
        # class-partitioned shelf exactly: rows with no class bit fold
        # to the shared class 0, and a row counts in EVERY set class
        # (one-hot by compiler contract, but the mirror pins the kernel
        # semantics, not the contract)
        n_classes = pack_class.shape[1]
        pc = pack_class.copy()
        pc[:, 0] |= ~pc.any(axis=1)
        histogram = np.zeros((n_classes * n_groups, buckets), np.float64)
        flat = groups_of.astype(np.int64) * buckets + (bucket_of - 1)
        for c in range(n_classes):
            m = pc[rows, c]
            histogram[c * n_groups : (c + 1) * n_groups] = np.bincount(
                flat[m], weights=w_of[m], minlength=n_groups * buckets
            ).reshape(n_groups, buckets)

    # f64 demand accumulation in pod order — bitwise-identical to
    # the native kernel's accumulation
    demand64 = np.zeros((n_groups, n_resources), np.float64)
    np.add.at(
        demand64, groups_of, row_req.astype(np.float64) * w_of[:, None]
    )
    unsched_mask = (~any_feasible) & valid
    if weight is None:
        unschedulable = int(unsched_mask.sum())
    else:
        unschedulable = int(weight[unsched_mask].sum())
    return assigned, assigned_count, histogram, demand64, unschedulable


def _steered(inputs: BinPackInputs, score):
    """(score, steer) under priority x tier steering, mirroring the
    XLA kernel exactly (ops/binpack.steer_matrix/steered_choice are the
    single definitions). Score-free steering folds the steer matrix
    INTO the score slot — the native C pass consumes it unchanged, and
    argmax-over-steer equals the lexicographic choice when no base
    score exists. A fleet carrying BOTH keeps them separate for the
    two-stage choice (and routes around the native pass, which takes a
    single score operand)."""
    if inputs.pod_priority is None or inputs.group_tier is None:
        return score, None
    steer = steer_matrix(
        _cpu(_as_np(inputs.pod_priority, np.int32)),
        _cpu(_as_np(inputs.group_tier, np.int32)),
    ).numpy()
    if score is None:
        return steer, None
    return score, steer


def binpack_numpy(  # lint: allow-complexity — the bitwise numpy mirror: mirrors every optional-operand arm of the XLA kernel
    inputs: BinPackInputs, buckets: int = 32, use_native: bool = True
) -> BinPackOutputs:
    """use_native=True (default) routes the assignment pass through the
    C kernel (native/binpack_kernel.c) when a toolchain has built it —
    the scalar scan early-exits at the first feasible group, making the
    pass nearly O(P) on realistic inputs where the dense numpy stages
    are O(P*T). Falls back to the pure-numpy stages silently; both are
    pinned equal to the XLA program by tests/test_torch_numpy_binpack.py."""
    requests = _as_np(inputs.pod_requests, np.float32)
    valid = _as_np(inputs.pod_valid, bool)
    intolerant = _as_np(inputs.pod_intolerant, bool)
    required = _as_np(inputs.pod_required, bool)
    alloc = _as_np(inputs.group_allocatable, np.float32)
    taints = _as_np(inputs.group_taints, bool)
    labels = _as_np(inputs.group_labels, bool)
    forbidden = (
        None
        if inputs.pod_group_forbidden is None
        else _as_np(inputs.pod_group_forbidden, bool)
    )
    score = (
        None
        if inputs.pod_group_score is None
        else _as_np(inputs.pod_group_score, np.float32)
    )
    weight = (
        None
        if inputs.pod_weight is None
        else _as_np(inputs.pod_weight, np.int64)
    )
    exclusive = (
        None
        if inputs.pod_exclusive is None
        else _as_np(inputs.pod_exclusive, bool)
    )
    score, steer = _steered(inputs, score)
    constrained = has_constraint_operands(inputs)
    claim = (
        None
        if inputs.pod_claim is None
        else _as_np(inputs.pod_claim, np.int32)
    )
    reservation = (
        None
        if inputs.group_reservation is None
        else _as_np(inputs.group_reservation, np.int32)
    )
    slot = (
        None
        if inputs.pod_spread_slot is None
        else _as_np(inputs.pod_spread_slot, np.int32)
    )
    domain = (
        None
        if inputs.group_domain is None
        else _as_np(inputs.group_domain, np.int32)
    )
    caps = (
        None
        if inputs.spread_cap is None
        else _as_np(inputs.spread_cap, np.int32)
    )
    pack_class = (
        None
        if inputs.pod_pack_class is None
        else _as_np(inputs.pod_pack_class, bool)
    )
    n_pods, n_resources = requests.shape
    n_groups = alloc.shape[0]

    lib = None
    # steer != None means BOTH a preference score and tier steering are
    # live: the choice is two-stage (lexicographic) and the native
    # kernel's single-score argmax can't express it — numpy stages only.
    # Constraint-plane operands route around the native pass the same
    # way: its fixed C argument list predates them, and silently
    # dropping an operand would change the answer.
    if use_native and n_pods and steer is None and not constrained:
        # never block a degraded-mode tick inside a cc subprocess: use
        # the kernel only once its background build has finished, and
        # run the numpy stages meanwhile (peek/ensure-async pattern,
        # native/__init__.py)
        from karpenter_tpu_torch.native import (
            ensure_kbinpack_async,
            peek_kbinpack,
        )

        lib = peek_kbinpack()
        if lib is None:
            ensure_kbinpack_async()
    if lib is not None:
        (
            assigned,
            assigned_count64,
            histogram,
            demand64,
            unschedulable,
        ) = _assign_native(
            lib, requests, valid, intolerant, required, alloc, taints,
            labels, forbidden, score, weight, exclusive, buckets,
            inputs=inputs,
        )
        assigned_count = assigned_count64.astype(np.int32)
    else:
        (
            assigned,
            assigned_count,
            histogram,
            demand64,
            unschedulable,
        ) = _assign_numpy(
            requests, valid, intolerant, required, alloc, taints, labels,
            forbidden, score, weight, exclusive, buckets, steer=steer,
            claim=claim, reservation=reservation, slot=slot,
            domain=domain, caps=caps, pack_class=pack_class,
        )

    nodes_needed = _shelf_bfd(histogram, buckets, lib)
    if pack_class is not None:
        # class-partitioned shelf: [C*T] node counts sum across classes
        nodes_needed = (
            nodes_needed.reshape(-1, n_groups).sum(axis=0).astype(np.int32)
        )

    # LP bound: f64-accumulated demand — strictly more accurate than the
    # XLA program's f32 einsum; at demand/allocatable ratios above ~84
    # one f32 ulp exceeds the shared -1e-5 ceil guard, so the two
    # backends may legitimately differ by +-1 there (the documented
    # lp_bound exception)
    demand = demand64.astype(np.float32)
    per_resource = np.where(
        alloc > 0,
        np.ceil(
            demand / np.maximum(alloc, np.float32(1e-30))
            - np.float32(1e-5)
        ),
        np.float32(0.0),
    )
    lp_bound = per_resource.max(axis=1).astype(np.int32)

    return BinPackOutputs(
        assigned=assigned,
        assigned_count=assigned_count,
        nodes_needed=nodes_needed,
        lp_bound=lp_bound,
        unschedulable=np.int32(unschedulable),
    )
