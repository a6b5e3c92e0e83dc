"""Multi-device scale-out of the solver: mesh, layouts, padding, the
sharded programs and the fleet step (counterpart of
karpenter_tpu/parallel/mesh.py).

The reference shards the pods x groups constraint matrix over a
`jax.sharding.Mesh` and lets GSPMD partition the jitted programs. PyTorch
has neither, so the port partitions by hand:

  * a `Mesh` is a numpy object array of devices with axis names (pods x
    groups, or slice x pods x groups), each entry also naming the rank
    that owns it (parallel/multihost.py); `build_mesh` takes the
    reference's `shape=` and `slices=` forms with its errors;
  * a layout (`binpack_shardings`, `forecast_shardings`, ...) says, per
    operand, which mesh axes its rows split over (`Split`), or that it is
    whole on every shard (None). The port splits the row axis over EVERY
    mesh axis, in mesh order, and keeps the group side whole: the fused
    stage picks a row's first feasible (or best-scored) group, so each
    shard needs every column, and splitting T would need a cross-shard
    argmin before the histogram and a second pass. The pods x groups
    factorization still sets the padding (`mesh_extents`), bit for bit
    the reference's;
  * `shard_*_inputs` pad the operands, put them on the mesh's home device
    (its first entry this process owns) and place each owned shard's
    slab on its device (`Sharded`); on one device a slab is a view;
  * the sharded programs run each shard's slab, gather the per-shard
    results in position order on the home device (across ranks with
    torch.distributed's all_gather over gloo), reduce them exactly, and
    slice the outputs back to the caller's rows.

The bin-pack's card route (`sharded_binpack` on CUDA shards, the cuda
rung's counterpart) runs the two hand-written kernels on every shard:

  * fused stage: each shard's row slab is a whole number of the fused
    kernel's 512-row blocks (ops/fused_assign.ROWS_PER_BLOCK), in global
    row order; `fused_assign_scan` writes the slab's assigned rows, its
    [T, B] histogram, and its blocks' f64 demand and unschedulable
    partials into views of one global buffer. `demand_reduce` then
    reduces all of them once. The partials are those of one
    single-device launch, so demand, lp_bound and unschedulable are its
    bits by construction; mesh padding rows are invalid and add +0.0;
  * hist and assigned_count are integer sums, exact in any order;
  * shelf tail and lp_bound: T splits over the shards (a group's shelf
    depends on its own histogram row only), one `shelf_bfd` launch per
    non-empty group slab.
A sharded solve on one rank launches `fused_assign` once per non-empty
row slab (a shard whose slab is empty, as where P < 512 x shards,
launches nothing), `demand_reduce` once, and `shelf_bfd` once per
non-empty group slab: at 100k pods x 300 groups on 8 shards, 8 + 1 + 8.
Each rank of a joined fleet launches its own shards' kernels and the one
reduction over the gathered partials.

The plain route runs ops/binpack's plain program on each shard: on the
CPU, and on the card for the traffic the single-device cuda rung already
sends there (constraint operands, score plus priority; counted in
ops/binpack.REROUTES). The spread constraint's rank is the one row-
coupled quantity: each slab starts from the weighted slot totals of the
slabs before it (integers, exact). Demand is each slab's f64 sum, added
in slab order and rounded once to f32: the single call's sum, which
differs only where f64 itself rounds (never at the tests' shapes).

Shards that share one device (utils/device.force_virtual_devices) run one
after another on its stream. On distinct cards each shard's kernels run
on its own device's current stream and the gather copies to the home
device; that copy path and NCCL are not exercised on a one-card machine.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.ops import binpack as TB
from karpenter_tpu_torch.ops.decision import DecisionInputs, DecisionOutputs, decide
from karpenter_tpu_torch.ops.fused_assign import ROWS_PER_BLOCK
from karpenter_tpu_torch.utils.device import DeviceLike, resolve_device
from karpenter_tpu_torch.utils.functional import pad_to_multiple as _pad_dim
from karpenter_tpu_torch.utils.operands import on_device

AXIS_PODS = "pods"
AXIS_GROUPS = "groups"
AXIS_SLICE = "slice"  # cross-host axis in multi-host deployments


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class Mesh:
    """Devices on named axes: `devices` an object array of torch.device in
    the mesh's shape, `ranks` the owning rank of each entry."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    ranks: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, position: int) -> torch.device:
        """The device of flat position `position` (mesh order)."""
        return self.devices.flat[position]

    def local_positions(self) -> List[int]:
        """The flat positions this process owns, in mesh order."""
        from karpenter_tpu_torch.parallel.multihost import process_index

        rank = process_index()
        return [p for p in range(self.size) if int(self.ranks.flat[p]) == rank]

    @property
    def multi_rank(self) -> bool:
        return len(set(int(r) for r in self.ranks.flat)) > 1

    @property
    def home(self) -> torch.device:
        """Where gathered results land: the first entry this process owns."""
        local = self.local_positions()
        if not local:
            raise ValueError("this process owns no entry of the mesh")
        return self.device_at(local[0])


def factorize(n: int) -> Tuple[int, int]:
    """Split n devices into (pods, groups) mesh extents, pods-major.

    Rows (pods) dominate the problem size (100k pods vs 300 types at the
    bench scale), so the pods axis gets the larger factor.
    """
    best = (n, 1)
    for g in range(1, int(np.sqrt(n)) + 1):
        if n % g == 0:
            best = (n // g, g)
    return best


def _entries(devices) -> Tuple[list, list]:
    """(devices, ranks) from torch devices or names (this process's) or
    (rank, device) pairs."""
    from karpenter_tpu_torch.parallel.multihost import process_index

    devs, ranks = [], []
    for entry in devices:
        if isinstance(entry, tuple):
            rank, dev = entry
        else:
            rank, dev = process_index(), entry
        devs.append(torch.device(dev))
        ranks.append(int(rank))
    return devs, ranks


def _object_array(items, shape) -> np.ndarray:
    array = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        array[i] = item
    return array.reshape(shape)


def build_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    slices: int = 1,
    shape: Optional[Tuple[int, int]] = None,
) -> Mesh:
    """2D pods x groups mesh, or 3D slice x pods x groups when slices > 1.

    The slice axis models multi-host scale-out: a slice's devices are one
    host's. `devices` defaults to parallel/multihost.global_devices():
    the visible CUDA cards (or the virtual devices of
    utils/device.force_virtual_devices), every rank's after a join.

    `shape` overrides the pods-major factorization with explicit
    (pods, groups) extents — the SolverService mesh-shape knob for
    operators whose problem aspect ratio disagrees with the default
    split. Mutually exclusive with slices > 1.
    """
    if devices is None:
        from karpenter_tpu_torch.parallel.multihost import global_devices

        devices = global_devices()
    devs, ranks = _entries(devices)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs, ranks = devs[:n_devices], ranks[:n_devices]
    n = len(devs)
    if shape is not None:
        if slices > 1:
            raise ValueError("shape= and slices>1 are mutually exclusive")
        pods, groups = shape
        if pods * groups > n:
            raise ValueError(
                f"mesh shape {shape} needs {pods * groups} devices, have {n}"
            )
        k = pods * groups
        return Mesh(_object_array(devs[:k], (pods, groups)),
                    (AXIS_PODS, AXIS_GROUPS),
                    np.array(ranks[:k]).reshape(pods, groups))
    if slices > 1:
        if n % slices:
            raise ValueError(f"{n} devices not divisible into {slices} slices")
        pods, groups = factorize(n // slices)
        dims = (slices, pods, groups)
        return Mesh(_object_array(devs, dims),
                    (AXIS_SLICE, AXIS_PODS, AXIS_GROUPS),
                    np.array(ranks).reshape(dims))
    pods, groups = factorize(n)
    return Mesh(_object_array(devs, (pods, groups)), (AXIS_PODS, AXIS_GROUPS),
                np.array(ranks).reshape(pods, groups))


def _row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the row (pods / fleet / series / candidates)
    dimension shards over: every axis, in mesh order (the reference's are
    (slice, pods) or pods, with the groups axis splitting the columns)."""
    return tuple(mesh.axis_names)


def mesh_extents(mesh: Mesh) -> Tuple[int, int]:
    """(row extent, group extent): the divisibility the reference's pod
    and group axes must satisfy on this mesh, which the port's padding
    keeps bit for bit — rows fold the slice axis in on a 3D mesh. This
    pair is what the SolverService folds into its dispatch key."""
    return (
        mesh.shape[AXIS_PODS] * mesh.shape.get(AXIS_SLICE, 1),
        mesh.shape[AXIS_GROUPS],
    )


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Split:
    """An operand's dimension `dim` split into one slab per combination of
    `axes` (mesh order). Each slab is a multiple of `align` rows, in
    order; the trailing slabs may be short or empty."""

    axes: Tuple[str, ...]
    align: int = 1
    dim: int = 0


def slab_bounds(n: int, parts: int, align: int = 1) -> List[Tuple[int, int]]:
    """[(start, stop)] of `parts` slabs over n rows, each a whole number
    of `align`-row chunks but the last non-empty one."""
    step = -(-n // (align * parts)) * align if n else 0
    return [(min(k * step, n), min((k + 1) * step, n)) for k in range(parts)]


def _slab_index(mesh: Mesh, split: Split, position: int) -> Tuple[int, int]:
    """(slab index, slab count) of a flat mesh position under `split`."""
    coords = np.unravel_index(position, mesh.devices.shape)
    index, parts = 0, 1
    for axis, coord, extent in zip(mesh.axis_names, coords,
                                   mesh.devices.shape):
        if axis in split.axes:
            index = index * extent + int(coord)
            parts *= extent
    return index, parts


def position_bounds(mesh: Mesh, split: Split, n: int) -> List[Tuple[int, int]]:
    """[(start, stop)] of each flat mesh position's slab of n rows."""
    out = []
    for position in range(mesh.size):
        index, parts = _slab_index(mesh, split, position)
        out.append(slab_bounds(n, parts, split.align)[index])
    return out


def binpack_shardings(  # lint: allow-complexity — one rule per operand, optional operands included
    mesh: Mesh,
    with_weight: bool = False,
    with_forbidden: bool = False,
    with_score: bool = False,
    with_exclusive: bool = False,
    with_priority: bool = False,
    with_tier: bool = False,
    with_claim: bool = False,
    with_reservation: bool = False,
    with_pack_class: bool = False,
    with_spread_slot: bool = False,
    with_domain: bool = False,
    with_spread_cap: bool = False,
    batch: bool = False,
) -> TB.BinPackInputs:
    """A BinPackInputs-shaped layout: every pod-major operand (the 2D
    pods x groups forbidden and score included) splits its rows over
    every mesh axis in slabs of the fused kernel's 512-row blocks; the
    group side and the constraint universe ([S, D] caps) are whole on
    every shard. batch=True describes a SolverService-coalesced stack
    [B, ...]: its leading axis is whole and the rows are dimension 1."""
    rows = Split(_row_axes(mesh), ROWS_PER_BLOCK, 1 if batch else 0)
    return TB.BinPackInputs(
        pod_requests=rows,
        pod_valid=rows,
        pod_intolerant=rows,
        pod_required=rows,
        group_allocatable=None,
        group_taints=None,
        group_labels=None,
        pod_weight=rows if with_weight else None,
        pod_group_forbidden=rows if with_forbidden else None,
        pod_group_score=rows if with_score else None,
        pod_exclusive=rows if with_exclusive else None,
        pod_priority=rows if with_priority else None,
        group_tier=None,
        pod_claim=rows if with_claim else None,
        group_reservation=None,
        pod_pack_class=rows if with_pack_class else None,
        pod_spread_slot=rows if with_spread_slot else None,
        group_domain=None,
        spread_cap=None,
    )


def stacked_binpack_shardings(
    mesh: Mesh, presence: Tuple[bool, ...]
) -> TB.BinPackInputs:
    """binpack_shardings for a coalesced batch stack, keyed by the solver
    service's operand-presence tuple (solver/bucketing.presence: weight,
    forbidden, score, exclusive, priority, tier, claim, reservation,
    pack_class, spread_slot, domain, spread_cap)."""
    w, f, sc, e, pr, ti, cl, rv, pcls, ss, dom, cap = presence
    return binpack_shardings(
        mesh, with_weight=w, with_forbidden=f, with_score=sc,
        with_exclusive=e, with_priority=pr, with_tier=ti, with_claim=cl,
        with_reservation=rv, with_pack_class=pcls, with_spread_slot=ss,
        with_domain=dom, with_spread_cap=cap, batch=True,
    )


def _row_layout(cls, mesh: Mesh, whole_fields: Sequence[str] = ()):
    """A layout of `cls` with every field's rows split over the mesh,
    but `whole_fields`."""
    rows = Split(_row_axes(mesh))
    return cls(**{
        f.name: None if f.name in whole_fields else rows
        for f in dataclasses.fields(cls)
    })


def forecast_shardings(mesh: Mesh):
    """ForecastInputs-shaped layout: the SERIES axis splits over the mesh
    (every series' recurrence is independent, so each shard runs the
    single-device program on its series and the outputs are its bits)."""
    from karpenter_tpu_torch.forecast.models import ForecastInputs

    return _row_layout(ForecastInputs, mesh)


def preempt_shardings(mesh: Mesh):
    """PreemptInputs-shaped layout: the CANDIDATE axis splits over the
    mesh (candidates are planned independently); nodes and victims are
    whole on every shard, so the within-node victim prefix scans stay
    local. The only cross-candidate aggregate (`unplaceable`) is an
    integer sum."""
    from karpenter_tpu_torch.ops.preempt import PreemptInputs

    return _row_layout(PreemptInputs, mesh, (
        "node_free", "node_tier", "victim_requests", "victim_priority",
        "victim_node", "victim_valid", "victim_evictable",
    ))


def decision_shardings(mesh: Mesh) -> DecisionInputs:
    """DecisionInputs-shaped layout: the autoscaler fleet axis N splits
    over the mesh; `now` is whole."""
    return _row_layout(DecisionInputs, mesh, ("now",))


# ---------------------------------------------------------------------------
# Padding (the reference's outputs, bit for bit; numpy in, numpy out;
# tensors in, tensors out)
# ---------------------------------------------------------------------------


def _pad_rows(x, n: int, fill=0):
    """x grown along dimension 0 to n rows of `fill`."""
    if x is None or x.shape[0] == n:
        return x
    extra = (n - x.shape[0],) + tuple(x.shape[1:])
    if isinstance(x, torch.Tensor):
        return torch.cat([x, torch.full(extra, fill, dtype=x.dtype,
                                        device=x.device)])
    x = np.asarray(x)
    return np.concatenate([x, np.full(extra, fill, dtype=x.dtype)])


def _pad_cols(x, n: int):
    """x grown along dimension 1 to n zero columns."""
    if x is None or x.shape[1] == n:
        return x
    extra = (x.shape[0], n - x.shape[1])
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros(extra)], dim=1)
    x = np.asarray(x)
    return np.concatenate([x, np.zeros(extra, x.dtype)], axis=1)


def pad_binpack_inputs_for_mesh(
    inputs: TB.BinPackInputs, mesh: Mesh
) -> TB.BinPackInputs:
    """Grow P to a multiple of the mesh's row extent and T of its group
    extent. Padding rows carry pod_valid=False; padding columns carry
    zero allocatable, which the feasibility test already rejects —
    masked, never truncated. Every optional operand is carried: weight,
    claim and spread slot pad 0 (inert on invalid rows), pack-class rows
    all-false, forbidden and score with zeros on both axes, priority 0,
    tier, reservation and domain 0 on zero-alloc columns; the [S, D] cap
    table has no pod or group axis."""
    p_extent, g_extent = mesh_extents(mesh)
    P0 = inputs.pod_requests.shape[0]
    T0 = inputs.group_allocatable.shape[0]
    P1, T1 = _pad_dim(P0, p_extent), _pad_dim(T0, g_extent)
    if P1 == P0 and T1 == T0:
        return inputs
    pod_fields = (
        "pod_requests", "pod_valid", "pod_intolerant", "pod_required",
        "pod_weight", "pod_exclusive", "pod_priority", "pod_claim",
        "pod_pack_class", "pod_spread_slot",
    )
    group_fields = (
        "group_allocatable", "group_taints", "group_labels", "group_tier",
        "group_reservation", "group_domain",
    )
    fields = {name: _pad_rows(getattr(inputs, name), P1)
              for name in pod_fields}
    fields.update({name: _pad_rows(getattr(inputs, name), T1)
                   for name in group_fields})
    for name in ("pod_group_forbidden", "pod_group_score"):
        fields[name] = _pad_cols(_pad_rows(getattr(inputs, name), P1), T1)
    return TB.BinPackInputs(**fields, spread_cap=inputs.spread_cap)


def _pad_all_rows(inputs, n: int):
    """Every field of an operand dataclass but its 0-d ones grown to n rows
    of zeros."""
    return dataclasses.replace(inputs, **{
        f.name: _pad_rows(getattr(inputs, f.name), n)
        for f in dataclasses.fields(inputs)
        if getattr(inputs, f.name) is not None
        and np.ndim(getattr(inputs, f.name)) > 0
    })


def pad_decision_inputs_for_mesh(
    inputs: DecisionInputs, mesh: Mesh
) -> DecisionInputs:
    """Grow the fleet axis N to a multiple of the mesh's row extent.
    Padding rows have no valid metrics, so they decide spec_replicas (a
    no-op) and max_replicas=0 keeps every derived flag benign."""
    N0 = inputs.spec_replicas.shape[0]
    N1 = _pad_dim(N0, mesh_extents(mesh)[0])
    return inputs if N1 == N0 else _pad_all_rows(inputs, N1)


def pad_forecast_inputs_for_mesh(inputs, mesh: Mesh):
    """Grow the series axis S to a multiple of the mesh's row extent.
    Padding series are all-invalid, so every recurrence sees no samples
    and their output rows — sliced off by sharded_forecast — are inert."""
    S0 = inputs.values.shape[0]
    S1 = _pad_dim(S0, mesh_extents(mesh)[0])
    return inputs if S1 == S0 else _pad_all_rows(inputs, S1)


def pad_preempt_inputs_for_mesh(inputs, mesh: Mesh):
    """Grow the candidate axis C to a multiple of the mesh's row extent.
    Padding candidates are invalid (never counted unplaceable) and
    forbidden on every node (never placed); victims and nodes are
    untouched, so the quantization scales — a function of the node and
    victim maxima — equal the unpadded problem's."""
    C0 = inputs.pod_requests.shape[0]
    C1 = _pad_dim(C0, mesh_extents(mesh)[0])
    if C1 == C0:
        return inputs
    return dataclasses.replace(
        inputs,
        pod_requests=_pad_rows(inputs.pod_requests, C1),
        pod_priority=_pad_rows(inputs.pod_priority, C1),
        pod_valid=_pad_rows(inputs.pod_valid, C1),
        pod_node_forbidden=_pad_rows(inputs.pod_node_forbidden, C1, True),
    )


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


@dataclass
class Sharded:
    """Operands placed on a mesh: `whole` the padded operands on the
    mesh's home device, `shards` each owned position's operands (its slab
    of every split field, on the position's device), per `layout`."""

    mesh: Mesh
    layout: object
    whole: object
    shards: Dict[int, object]

    def bounds(self, name: str) -> List[Tuple[int, int]]:
        """Each position's (start, stop) along the split dimension of
        field `name`."""
        split = getattr(self.layout, name)
        value = getattr(self.whole, name)
        return position_bounds(self.mesh, split, value.shape[split.dim])

    def field(self, name: str) -> np.ndarray:
        """Field `name` rebuilt on the host from the shards' pieces, in
        position order (every position must be this process's)."""
        split = getattr(self.layout, name)
        pieces = [getattr(self.shards[p], name).cpu().numpy()
                  for p in range(self.mesh.size)]
        if split is None:
            return pieces[0]
        return np.concatenate(pieces, axis=split.dim)


def _piece(value, split: Optional[Split], bounds, device):
    if value is None:
        return None
    if split is not None:
        start, stop = bounds
        value = value.narrow(split.dim, start, stop - start)
    return value.to(device)


def place(mesh: Mesh, whole, layout) -> Sharded:
    """Each owned position's slab of `whole` (an operand dataclass on the
    home device) per `layout`."""
    names = [f.name for f in dataclasses.fields(whole)]
    bounds = {
        name: position_bounds(
            mesh, getattr(layout, name),
            getattr(whole, name).shape[getattr(layout, name).dim],
        )
        for name in names
        if getattr(whole, name) is not None
        and getattr(layout, name) is not None
    }
    shards = {}
    for position in mesh.local_positions():
        device = mesh.device_at(position)
        shards[position] = dataclasses.replace(whole, **{
            name: _piece(
                getattr(whole, name), getattr(layout, name),
                bounds[name][position] if name in bounds else None, device,
            )
            for name in names
        })
    return Sharded(mesh, layout, whole, shards)


def _binpack_on(inputs, device: torch.device) -> TB.BinPackInputs:
    return TB.BinPackInputs(**{
        f.name: TB._as_field(f.name, getattr(inputs, f.name), device)
        for f in dataclasses.fields(TB.BinPackInputs)
    })


def shard_binpack_inputs(mesh: Mesh, inputs: TB.BinPackInputs) -> Sharded:
    """Pad, put on the mesh's home device and place per
    binpack_shardings (tensors or host arrays in)."""
    whole = pad_binpack_inputs_for_mesh(_binpack_on(inputs, mesh.home), mesh)
    return place(mesh, whole, binpack_shardings(
        mesh,
        with_weight=whole.pod_weight is not None,
        with_forbidden=whole.pod_group_forbidden is not None,
        with_score=whole.pod_group_score is not None,
        with_exclusive=whole.pod_exclusive is not None,
        with_priority=whole.pod_priority is not None,
        with_tier=whole.group_tier is not None,
        with_claim=whole.pod_claim is not None,
        with_reservation=whole.group_reservation is not None,
        with_pack_class=whole.pod_pack_class is not None,
        with_spread_slot=whole.pod_spread_slot is not None,
        with_domain=whole.group_domain is not None,
        with_spread_cap=whole.spread_cap is not None,
    ))


def shard_decision_inputs(mesh: Mesh, inputs) -> Sharded:
    whole = DecisionInputs.from_numpy(inputs, mesh.home)
    return place(mesh, pad_decision_inputs_for_mesh(whole, mesh),
                 decision_shardings(mesh))


def shard_forecast_inputs(mesh: Mesh, inputs) -> Sharded:
    from karpenter_tpu_torch.forecast.models import ForecastInputs

    whole = ForecastInputs.from_numpy(inputs, mesh.home)
    return place(mesh, pad_forecast_inputs_for_mesh(whole, mesh),
                 forecast_shardings(mesh))


def shard_preempt_inputs(mesh: Mesh, inputs) -> Sharded:
    from karpenter_tpu_torch.ops.preempt import PreemptInputs

    whole = PreemptInputs.from_numpy(inputs, mesh.home)
    return place(mesh, pad_preempt_inputs_for_mesh(whole, mesh),
                 preempt_shardings(mesh))


# ---------------------------------------------------------------------------
# Gathering per-shard results
# ---------------------------------------------------------------------------


def exchange(mesh: Mesh, local: Dict[int, tuple]) -> Dict[int, tuple]:
    """Every position's results on the home device, from each owned
    position's tuple of tensors: moved there on one rank, gathered from
    every rank (torch.distributed.all_gather_object over gloo, host
    arrays) when the mesh spans several. Every rank must call it."""
    home = mesh.home
    if not mesh.multi_rank:
        return {p: tuple(t.to(home) for t in values)
                for p, values in local.items()}
    import torch.distributed as dist

    payload = {p: tuple(t.cpu().numpy() for t in values)
               for p, values in local.items()}
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, payload)
    return {
        p: tuple(torch.from_numpy(np.asarray(a)).to(home) for a in values)
        for part in gathered for p, values in part.items()
    }


def _sum_ints(parts: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """The exact integer sum of `parts` (zeros shaped as `like` when none)."""
    if not parts:
        return torch.zeros_like(like)
    return torch.stack(parts).sum(dim=0, dtype=like.dtype)


# ---------------------------------------------------------------------------
# The sharded bin-pack
# ---------------------------------------------------------------------------


def _group_tail(sh: Sharded, hists, demand, shelf) -> tuple:
    """(nodes_needed, assigned_count or None, lp_bound) with T split over
    the shards: `shelf(hist slab)` gives a slab's (nodes, count-or-None)."""
    mesh, whole = sh.mesh, sh.whole
    n_groups = whole.group_allocatable.shape[0]
    group_bounds = position_bounds(mesh, Split(_row_axes(mesh)), n_groups)
    local = {}
    for position in sh.shards:
        t0, t1 = group_bounds[position]
        if t0 == t1:
            continue  # an empty group slab launches nothing
        device = mesh.device_at(position)
        nodes, count = shelf(hists[..., t0:t1, :].contiguous().to(device))
        lp = TB.lp_bound_of(demand[t0:t1].to(device),
                            whole.group_allocatable[t0:t1].to(device))
        local[position] = (nodes, lp) if count is None else (nodes, lp, count)
    parts = [v for _, v in sorted(exchange(mesh, local).items())]
    home = mesh.home
    if not parts:
        empty = torch.zeros(0, dtype=torch.int32, device=home)
        return empty, empty, empty
    nodes = torch.cat([v[0] for v in parts])
    lp = torch.cat([v[1] for v in parts])
    count = torch.cat([v[2] for v in parts]) if len(parts[0]) > 2 else None
    return nodes, count, lp


def launch_plan(sh: Sharded) -> Dict[str, int]:
    """The launches this process makes for a card-route solve of `sh`, by
    LAUNCHES key: one scan per owned non-empty row slab, one reduction,
    one shelf per owned non-empty group slab. Not in it: the one pack of
    the whole operands' masks ("pack_bits", ops/fused_assign.pack_operands),
    one launch per sharded solve."""
    rows = sh.bounds("pod_requests")
    groups = position_bounds(sh.mesh, Split(_row_axes(sh.mesh)),
                             sh.whole.group_allocatable.shape[0])
    return {
        "fused_assign": sum(rows[p][0] < rows[p][1] for p in sh.shards),
        "shelf_bfd": sum(groups[p][0] < groups[p][1] for p in sh.shards),
        "demand_reduce": 1,
    }


def _card_route(sh: Sharded, buckets: int) -> TB.BinPackOutputs:
    """The fused kernels on every shard (module docstring)."""
    from karpenter_tpu_torch.ops import fused_assign as TF

    mesh, whole = sh.mesh, sh.whole
    home = mesh.home
    n_pods, n_res = whole.pod_requests.shape
    n_groups = whole.group_allocatable.shape[0]
    words = TF.pack_operands(whole)
    assigned, _, partial, unsched_partial = TF.scan_buffers(
        n_pods, n_groups, n_res, buckets, home
    )
    row_bounds = sh.bounds("pod_requests")
    local = {}
    for position, shard in sh.shards.items():
        start, stop = row_bounds[position]
        if start == stop:
            continue  # an empty row slab launches nothing
        device = mesh.device_at(position)
        b0, b1 = start // ROWS_PER_BLOCK, -(-stop // ROWS_PER_BLOCK)
        out = None
        if device == home:
            # write straight into the global buffers' views
            out = (assigned[start:stop],
                   torch.empty((n_groups, buckets), dtype=torch.int32,
                               device=device),
                   partial[b0:b1], unsched_partial[b0:b1])
        slab_words = (words[0][start:stop].to(device),
                      words[1][start:stop].to(device),
                      words[2].to(device), words[3].to(device))
        local[position] = TF.fused_assign_scan(shard, buckets, slab_words, out)
    hists = []
    for position, (a, hist, part, unsched) in sorted(
        exchange(mesh, local).items()
    ):
        hists.append(hist)
        if position in local and mesh.device_at(position) == home:
            continue  # already in place
        start, stop = row_bounds[position]
        b0, b1 = start // ROWS_PER_BLOCK, -(-stop // ROWS_PER_BLOCK)
        assigned[start:stop].copy_(a)
        partial[b0:b1].copy_(part)
        unsched_partial[b0:b1].copy_(unsched)
    hist = _sum_ints(hists, torch.zeros((n_groups, buckets), dtype=torch.int32,
                                        device=home))
    demand, unschedulable = TF.demand_reduce(partial, unsched_partial)
    nodes, count, lp = _group_tail(
        sh, hist, demand, lambda h: TF.shelf_bfd(h, buckets)
    )
    return TB.BinPackOutputs(assigned=assigned, assigned_count=count,
                             nodes_needed=nodes, lp_bound=lp,
                             unschedulable=unschedulable)


def _rank_offsets(sh: Sharded) -> Dict[int, Optional[torch.Tensor]]:
    """Each position's spread-slot rank offset: the weighted slot totals
    of the slabs before it, in slab order (None without spread)."""
    whole = sh.whole
    row_bounds = sh.bounds("pod_requests")
    if TB.slot_totals(whole) is None:
        return {p: None for p in range(sh.mesh.size)}
    offsets, running, seen = {}, None, {}
    for position, (start, stop) in enumerate(row_bounds):
        if (start, stop) in seen:
            offsets[position] = seen[(start, stop)]
            continue
        rows = dataclasses.replace(whole, **{
            name: getattr(whole, name)[start:stop]
            for name in ("pod_spread_slot", "pod_weight", "pod_valid")
            if getattr(whole, name) is not None
        })
        totals = TB.slot_totals(rows)
        if running is None:
            running = torch.zeros_like(totals)
        offsets[position] = seen[(start, stop)] = running
        running = running + totals
    return offsets


def _plain_route(sh: Sharded, buckets: int) -> TB.BinPackOutputs:
    """The plain program on every shard (module docstring)."""
    mesh, whole = sh.mesh, sh.whole
    home = mesh.home
    n_groups = whole.group_allocatable.shape[0]
    n_res = whole.pod_requests.shape[1]
    row_bounds = sh.bounds("pod_requests")
    offsets = _rank_offsets(sh)
    local = {}
    for position, shard in sh.shards.items():
        start, stop = row_bounds[position]
        if start == stop:
            continue
        offset = offsets[position]
        device = mesh.device_at(position)
        assigned, bucket, w_row = TB.assign_rows(
            shard, buckets, None if offset is None else offset.to(device)
        )
        local[position] = (
            assigned,
            TB.class_histograms(assigned, bucket, w_row, shard.pod_pack_class,
                                n_groups, buckets),
            TB.group_counts(assigned, w_row, n_groups),
            TB.weighted_demand64(assigned, w_row, shard.pod_requests,
                                 n_groups),
            TB.unschedulable_of(assigned, shard.pod_valid, shard.pod_weight),
        )
    parts = [v for _, v in sorted(exchange(mesh, local).items())]
    n_classes = (1 if whole.pod_pack_class is None
                 else whole.pod_pack_class.shape[1])
    i32 = torch.int32
    hists = _sum_ints([v[1] for v in parts], torch.zeros(
        (n_classes, n_groups, buckets), dtype=i32, device=home))
    count = _sum_ints([v[2] for v in parts],
                      torch.zeros(n_groups, dtype=i32, device=home))
    demand64 = torch.zeros((n_groups, n_res), dtype=torch.float64, device=home)
    for v in parts:  # slab order: one f64 sum, rounded once
        demand64 = demand64 + v[3]
    demand = demand64.to(torch.float32)
    nodes, _, lp = _group_tail(
        sh, hists, demand, lambda h: (TB.nodes_of(h, buckets), None)
    )
    assigned = (torch.cat([v[0] for v in parts]) if parts
                else torch.zeros(0, dtype=i32, device=home))
    return TB.BinPackOutputs(
        assigned=assigned, assigned_count=count, nodes_needed=nodes,
        lp_bound=lp,
        unschedulable=_sum_ints([v[4] for v in parts],
                                torch.zeros((), dtype=i32, device=home)),
    )


def binpack_sharded(sh: Sharded, buckets: int = TB.DEFAULT_BUCKETS,
                    backend: str = "auto") -> TB.BinPackOutputs:
    """The bin-pack over placed operands; outputs at the padded sizes, on
    the home device. backend 'cuda' (the card route; inputs the fused
    path does not take reroute to the plain one, counted in
    ops/binpack.REROUTES), 'torch' (the plain program on every shard), or
    'auto': 'cuda' when every owned shard is on a card, else 'torch'."""
    devices = [sh.mesh.device_at(p) for p in sh.shards]
    if backend == "auto":
        backend = ("cuda" if devices and all(d.type == "cuda" for d in devices)
                   else "torch")
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown sharded binpack backend {backend!r}")
    if backend == "cuda":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("backend 'cuda' needs every shard on a CUDA card")
        folded, backend = TB._fold_for_fused(sh.whole)
        if backend == "cuda":
            if folded is not sh.whole:
                sh = place(sh.mesh, folded, dataclasses.replace(
                    sh.layout, pod_group_score=sh.layout.pod_priority,
                    pod_priority=None,
                ))
            return _card_route(sh, buckets)
    return _plain_route(sh, buckets)


def sharded_binpack(
    mesh: Mesh, inputs: TB.BinPackInputs, buckets: int = TB.DEFAULT_BUCKETS,
    backend: str = "auto",
) -> TB.BinPackOutputs:
    """Run the bin-pack partitioned over the mesh (backend as
    binpack_sharded). Outputs are sliced back to the caller's P and T on
    the home device — mesh padding is an implementation detail, and
    padded rows (assigned=-1) must not leak into consumers that count
    unschedulable pods. Every rank of a joined mesh passes the same
    inputs."""
    n_pods = inputs.pod_requests.shape[0]
    n_groups = inputs.group_allocatable.shape[0]
    out = binpack_sharded(shard_binpack_inputs(mesh, inputs), buckets, backend)
    return TB.BinPackOutputs(
        assigned=out.assigned[:n_pods],
        assigned_count=out.assigned_count[:n_groups],
        nodes_needed=out.nodes_needed[:n_groups],
        lp_bound=out.lp_bound[:n_groups],
        unschedulable=out.unschedulable,  # padding rows are ~pod_valid
    )


# ---------------------------------------------------------------------------
# The sharded row programs: decide, forecast, preempt
# ---------------------------------------------------------------------------


def rows_sharded(sh: Sharded, program, out_cls):
    """`program` (operands -> `out_cls`) on each owned shard's rows, the
    outputs gathered in row order on the home device: row fields
    concatenated, 0-d fields (the integer aggregates) summed. Position 0
    always runs, so the outputs carry their shapes when every slab is
    empty."""
    first = next(f.name for f in dataclasses.fields(sh.whole)
                 if getattr(sh.layout, f.name) is not None)
    row_bounds = sh.bounds(first)
    names = [f.name for f in dataclasses.fields(out_cls)]
    local = {}
    for position, shard in sh.shards.items():
        start, stop = row_bounds[position]
        if start == stop and position != 0:
            continue
        out = program(shard)
        local[position] = tuple(getattr(out, name) for name in names)
    parts = [v for _, v in sorted(exchange(sh.mesh, local).items())]
    fields = {}
    for i, name in enumerate(names):
        values = [v[i] for v in parts]
        fields[name] = (_sum_ints(values, values[0]) if values[0].ndim == 0
                        else torch.cat(values))
    return out_cls(**fields)


def _slice_rows(out, n: int):
    return dataclasses.replace(out, **{
        f.name: getattr(out, f.name)[:n]
        for f in dataclasses.fields(out)
        if getattr(out, f.name).ndim > 0
    })


def sharded_decide(mesh: Mesh, inputs) -> DecisionOutputs:
    """The decision program with the fleet axis partitioned over the
    mesh; outputs sliced back to the caller's N. Each row's arithmetic
    is the single-device program's, so the outputs are its bits."""
    inputs = DecisionInputs.from_numpy(inputs, mesh.home)
    n = inputs.spec_replicas.shape[0]
    return _slice_rows(rows_sharded(shard_decision_inputs(mesh, inputs),
                                    decide, DecisionOutputs), n)


def sharded_forecast(mesh: Mesh, inputs):
    """The batched forecast program with its series axis partitioned over
    the mesh; outputs sliced back to the caller's S. Bitwise equal to the
    single-device program (and so to forecast_numpy)."""
    from karpenter_tpu_torch.forecast import models as FM

    inputs = FM.ForecastInputs.from_numpy(inputs, mesh.home)
    n = inputs.values.shape[0]
    return _slice_rows(rows_sharded(shard_forecast_inputs(mesh, inputs),
                                    FM.forecast, FM.ForecastOutputs), n)


def sharded_preempt(mesh: Mesh, inputs):
    """The eviction-planning program with its candidate axis partitioned
    over the mesh; outputs sliced back to the caller's C. Bitwise equal to
    the single-device program (integer capacity arithmetic)."""
    from karpenter_tpu_torch.ops.preempt import (
        PreemptInputs,
        PreemptOutputs,
        preempt_plan,
    )

    inputs = PreemptInputs.from_numpy(inputs, mesh.home)
    n = inputs.pod_requests.shape[0]
    return _slice_rows(rows_sharded(shard_preempt_inputs(mesh, inputs),
                                    preempt_plan, PreemptOutputs), n)


# ---------------------------------------------------------------------------
# The fleet step
# ---------------------------------------------------------------------------


def fleet_step(
    decision_inputs,
    binpack_inputs,
    buckets: int = TB.DEFAULT_BUCKETS,
    device: DeviceLike = None,
):
    """ONE tick of the whole control plane's device math: every
    autoscaler's decision plus the global pending-pods bin-pack. Operands
    placed by shard_decision_inputs / shard_binpack_inputs run the
    sharded programs (outputs at the padded sizes, on the mesh's home
    device); others run on one device (the card unless device='cpu',
    where the bin-pack takes the fused CUDA path). Host operands (numpy
    leaves, as the reference's fleet_step takes) are placed on that
    device first."""
    if isinstance(decision_inputs, Sharded):
        d_out = rows_sharded(decision_inputs, decide, DecisionOutputs)
    else:
        d_out = decide(on_device(decision_inputs, resolve_device(device)))
    if isinstance(binpack_inputs, Sharded):
        b_out = binpack_sharded(binpack_inputs, buckets)
    else:
        dev = resolve_device(device)
        b_out = TB.solve(TB.on_device(binpack_inputs, dev), buckets=buckets,
                         device=dev)
    return d_out, b_out


# ---------------------------------------------------------------------------
# Tiny-shape builders (dryrun + tests)
# ---------------------------------------------------------------------------


def example_binpack_inputs(
    P_: int = 32, T: int = 8, R: int = 3, K: int = 8, L: int = 8,
    seed: int = 0, device: DeviceLike = None,
) -> TB.BinPackInputs:
    rng = np.random.default_rng(seed)
    req = rng.uniform(0.1, 4.0, (P_, R)).astype(np.float32)
    alloc = rng.uniform(4.0, 16.0, (T, R)).astype(np.float32)
    intol = rng.random((P_, K)) < 0.2
    taints = rng.random((T, K)) < 0.2
    required = rng.random((P_, L)) < 0.15
    labels = rng.random((T, L)) < 0.7
    return TB.inputs_from_numpy(
        {
            "pod_requests": req,
            "pod_valid": np.ones((P_,), bool),
            "pod_intolerant": intol,
            "pod_required": required,
            "group_allocatable": alloc,
            "group_taints": taints,
            "group_labels": labels,
        },
        device,
    )


def example_decision_inputs(
    N: int = 16, M: int = 4, seed: int = 1, device: DeviceLike = None
) -> DecisionInputs:
    rng = np.random.default_rng(seed)
    fields = {
        "metric_value": rng.uniform(0.0, 100.0, (N, M)).astype(np.float32),
        "target_value": rng.uniform(1.0, 60.0, (N, M)).astype(np.float32),
        "target_type": rng.integers(0, 3, (N, M), dtype=np.int32),
        "metric_valid": rng.random((N, M)) < 0.8,
        "spec_replicas": rng.integers(0, 20, (N,), dtype=np.int32),
        "status_replicas": rng.integers(0, 20, (N,), dtype=np.int32),
        "min_replicas": rng.integers(0, 3, (N,), dtype=np.int32),
        "max_replicas": rng.integers(10, 40, (N,), dtype=np.int32),
        "up_window": np.zeros((N,), np.int32),
        "down_window": np.full((N,), 300, np.int32),
        "up_policy": np.zeros((N,), np.int32),
        "down_policy": np.zeros((N,), np.int32),
        "last_scale_time": rng.uniform(0.0, 100.0, (N,)).astype(np.float32),
        "has_last_scale": rng.random((N,)) < 0.5,
        "now": np.float32(250.0),
        # K = 2 policy slots, mixed Count/Percent, some invalid
        "up_ptype": rng.integers(0, 2, (N, 2), dtype=np.int32),
        "up_pvalue": rng.integers(1, 10, (N, 2), dtype=np.int32),
        "up_pperiod": rng.integers(30, 300, (N, 2), dtype=np.int32),
        "up_pvalid": rng.random((N, 2)) < 0.5,
        "down_ptype": rng.integers(0, 2, (N, 2), dtype=np.int32),
        "down_pvalue": rng.integers(1, 10, (N, 2), dtype=np.int32),
        "down_pperiod": rng.integers(30, 300, (N, 2), dtype=np.int32),
        "down_pvalid": rng.random((N, 2)) < 0.5,
    }
    return DecisionInputs.from_numpy(fields, device)


def dryrun_inputs(device: DeviceLike = None):
    """(decision, bin-pack) operands of the dry run: the widest operand
    set the production encoder emits (weight, forbidden, score,
    exclusive, and the constraint plane's claims, pack classes and a
    spread slot with per-domain caps) at P = 33, which is no multiple of
    any mesh's row extent, so the padding path runs and one that dropped
    an operand would break the equality."""
    rng = np.random.default_rng(7)
    weights = np.ones(33, np.int32)
    weights[:4] = 5  # a few multiplied shape rows: 49 pods in 33 rows
    pack_class = np.zeros((33, 3), bool)
    pack_class[np.arange(33), rng.integers(0, 3, 33)] = True
    dev = resolve_device(device)
    base = example_binpack_inputs(P_=33, T=8, K=8, L=8, device=dev)
    extra = {
        "pod_weight": weights,
        "pod_group_forbidden": rng.random((33, 8)) < 0.3,
        "pod_group_score": rng.integers(0, 100, (33, 8)).astype(np.float32),
        "pod_exclusive": rng.random(33) < 0.25,
        "pod_claim": rng.integers(0, 2, 33, dtype=np.int32),
        "group_reservation": rng.integers(0, 2, 8, dtype=np.int32),
        "pod_pack_class": pack_class,
        "pod_spread_slot": rng.integers(0, 3, 33, dtype=np.int32),
        "group_domain": rng.integers(0, 2, 8, dtype=np.int32),
        "spread_cap": rng.integers(1, 30, (2, 2), dtype=np.int32),
    }
    binpack_inputs = dataclasses.replace(base, **{
        name: TB._as_field(name, value, dev) for name, value in extra.items()
    })
    return example_decision_inputs(N=16, M=4, device=dev), binpack_inputs


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dryrun_fleet_step(n_devices: int) -> None:
    """Run one full sharded tick on an n-device mesh and prove it EQUALS
    the single-device program element for element (the counterpart of
    the reference's multichip dry run): dryrun_inputs' widest operand
    set, re-certified on a 3D slice x pods x groups mesh when the device
    count allows, then the production route: a SolverService with the
    shard threshold at 1 must take its shard route and answer the same
    bits. The devices are build_mesh's (the visible CUDA cards, the
    virtual devices of utils/device.force_virtual_devices, every rank's
    after a join); every rank of a joined fleet runs it."""
    meshes = [build_mesh(n_devices=n_devices)]
    if n_devices % 2 == 0 and n_devices >= 4:
        meshes.append(build_mesh(n_devices=n_devices, slices=2))
    home = meshes[0].home
    d_ref_in, b_ref_in = dryrun_inputs(home)
    # single-device reference: the same programs, no mesh (the plain
    # bin-pack: constraint operands take it on every rung)
    d_ref, b_ref = fleet_step(d_ref_in, b_ref_in, buckets=8, device=home)
    assert int(b_ref.assigned_count.sum()) + int(b_ref.unschedulable) == 49
    assert d_ref.desired.shape[0] == 16

    for mesh in meshes:
        d_in = shard_decision_inputs(mesh, d_ref_in)
        b_in = shard_binpack_inputs(mesh, b_ref_in)
        d_out, b_out = fleet_step(d_in, b_in, buckets=8)
        # sharded == single-device, bitwise, after stripping mesh padding
        for got, want in (
            (b_out.assigned[:33], b_ref.assigned),
            (b_out.assigned_count[:8], b_ref.assigned_count),
            (b_out.nodes_needed[:8], b_ref.nodes_needed),
            (b_out.lp_bound[:8], b_ref.lp_bound),
            (b_out.unschedulable, b_ref.unschedulable),
            (d_out.desired[:16], d_ref.desired),
        ):
            np.testing.assert_array_equal(_host(got), _host(want))

    # the PRODUCTION route onto a mesh of this process's own devices: a
    # SolverService with the shard threshold forced low must route this
    # solve through its shard route and answer bit-identically
    from karpenter_tpu_torch.metrics.registry import GaugeRegistry
    from karpenter_tpu_torch.solver import SolverService

    service = SolverService(
        registry=GaugeRegistry(), shard_threshold=1,
        shard_devices=n_devices, device=home,
        backend="cuda" if home.type == "cuda" else "torch",
    )
    try:
        svc_out = service.solve(b_ref_in, buckets=8)
        # a 1-device dry run has no mesh to build: the service must fall
        # through to the single-device program (still parity-checked)
        expected = 1 if service._shard_mesh() is not None else 0
        assert service.stats.shard_dispatches == expected, service.stats
        assert service.stats.shard_fallbacks == 0, service.stats
        for name in ("assigned", "assigned_count", "nodes_needed",
                     "lp_bound", "unschedulable"):
            np.testing.assert_array_equal(
                _host(getattr(svc_out, name)), _host(getattr(b_ref, name)),
                err_msg=name,
            )
    finally:
        service.close()
