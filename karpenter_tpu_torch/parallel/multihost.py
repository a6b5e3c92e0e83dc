"""Multi-host initialization: the torch.distributed seam for multi-host
solver deployments (counterpart of karpenter_tpu/parallel/multihost.py).

`parallel/mesh.py` builds its meshes over `global_devices()`: the
process's own devices until a join, then every rank's, each entry naming
the rank that owns it. This module is the one place the join lives.

Deployment contract: run one solver sidecar per host (`python -m
karpenter_tpu_torch.sidecar --multihost`); the topology comes from
explicit arguments or from torch's standard rendezvous environment, as
torchrun sets it (MASTER_ADDR + MASTER_PORT, WORLD_SIZE, RANK). After a
join, `build_mesh()` spans every rank's devices and each rank runs the
shards it owns; the sharded programs exchange their per-shard results
through `torch.distributed` over gloo, on host tensors.

Where the port differs from the reference, deliberately:

  * torch has no cluster auto-detection (the reference asks
    jax.distributed to find a TPU pod, GKE or Slurm topology): with no
    topology configured the seam returns False at once, the single-host
    case;
  * the environment names are torch's (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK), not JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES
    and JAX_PROCESS_ID;
  * torch has no backend whose initialization a later join must precede
    (the reference's join raises after XLA starts); what the port
    refuses instead is a second join whose topology conflicts with the
    first;
  * the collectives are gloo's over the host, never NCCL's: NCCL cannot
    put two ranks on one card, and a fleet's exchange is a few MB per
    solve.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import torch

from karpenter_tpu_torch.utils.device import visible_devices
from karpenter_tpu_torch.utils.log import logger

# (coordinator address, processes, this process's rank) once joined
_joined: Optional[Tuple[str, int, int]] = None
# [(rank, device)] of every rank's devices, gathered at the join
_fleet: Optional[List[Tuple[int, torch.device]]] = None


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def _resolve_topology(coordinator_address, num_processes, process_id):
    """Resolve each parameter (explicit argument, then torch's standard
    env var) and enforce all-or-nothing: a PARTIAL topology raises —
    silently degrading a mis-wired multi-host fleet to N independent
    single-host solvers would double-solve the fleet."""
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
        elif addr or port:
            raise ValueError(
                "partial multihost topology: MASTER_ADDR and MASTER_PORT "
                f"must be set together (got {addr!r}, {port!r})"
            )
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    explicit = (coordinator_address, num_processes, process_id)
    configured = [value for value in explicit if value is not None]
    if configured and len(configured) != len(explicit):
        raise ValueError(
            "partial multihost topology: coordinator_address, "
            f"num_processes, process_id must be set together (got "
            f"{explicit!r}); a half-configured host joining single-host "
            "would double-solve the fleet while the rest hang"
        )
    return explicit


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    kind: Optional[str] = None,
    timeout_s: float = 120.0,
) -> bool:
    """Join a multi-host deployment with torch.distributed (gloo).

    Resolution order per parameter: explicit argument, then torch's
    standard env var. With a full topology the join is mandatory and any
    failure raises. With none, returns False: the single-host case. A
    PARTIAL topology always raises. `kind` ("cuda" or "cpu") picks the
    devices this rank brings (utils/device.visible_devices); the fleet's
    list is gathered once, at the join.

    Idempotent per process: a second call with no topology, or the same
    one, returns True; one whose topology conflicts raises."""
    global _joined, _fleet
    topology = _resolve_topology(coordinator_address, num_processes, process_id)
    if _joined is not None:
        if topology[0] is None or topology == _joined:
            return True
        raise RuntimeError(
            f"multihost: already joined as {_joined!r}; a second join with "
            f"{topology!r} conflicts"
        )
    if topology[0] is None:
        logger().info("no multihost topology configured; single-host")
        return False
    import torch.distributed as dist

    address, world, rank = topology
    dist.init_process_group(
        "gloo", init_method=f"tcp://{address}", world_size=int(world),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s),
    )
    local = [str(device) for device in visible_devices(kind)]
    gathered: list = [None] * int(world)
    dist.all_gather_object(gathered, local)
    _fleet = [
        (r, torch.device(name))
        for r, names in enumerate(gathered) for name in names
    ]
    _joined = (address, int(world), int(rank))
    logger().info(
        "multihost: process %d/%d, %d global device(s)",
        rank, world, len(_fleet),
    )
    return True


def joined() -> bool:
    return _joined is not None


def process_index() -> int:
    """This process's rank (0 when not joined)."""
    return _joined[2] if _joined is not None else 0


def process_count() -> int:
    return _joined[1] if _joined is not None else 1


def global_devices(kind: Optional[str] = None) -> List[Tuple[int, torch.device]]:
    """[(rank, device)]: every rank's devices after a join (as each rank
    saw them at the join), else this process's visible devices."""
    if _fleet is not None:
        return list(_fleet)
    return [(0, device) for device in visible_devices(kind)]
