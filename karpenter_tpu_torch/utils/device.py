"""Device resolution, the devices a mesh may span, and card identity
(counterpart of karpenter_tpu/utils/backend.py's device half).

The reference's "auto" backend quietly drops to the CPU when the
accelerator is missing. The port does not: an entry point resolves its
device here, which gives the CUDA card by default, the CPU only when the
caller names it, and raises when the card is asked for (explicitly or by
default) and absent.

`visible_devices` is the one list the mesh (parallel/mesh.py) and the
solve service's shard route read. It holds the process's CUDA cards,
unless `force_virtual_devices(n, device)` made it n copies of one device:
the counterpart of the reference's `force_virtual_cpu`, which gives JAX n
virtual CPU devices. Shards that share one device run one after another
on it, with every partition, slab and reduction of a real mesh. Tests
call it in a fixture and undo it with `reset_virtual_devices()`; the chip
smoke calls it for cuda:0; nothing in production does.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import List, Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]

# (n, device) after force_virtual_devices, else None
_VIRTUAL: Optional[tuple] = None


def force_virtual_devices(n: int, device: DeviceLike = "cpu") -> None:
    """Make visible_devices() n copies of `device` (the CPU by default; a
    CUDA device must exist). Replaces any earlier setting."""
    global _VIRTUAL
    if n < 1:
        raise ValueError(f"need at least one virtual device, got {n}")
    _VIRTUAL = (int(n), indexed(resolve_device(device)))


def reset_virtual_devices() -> None:
    """Undo force_virtual_devices: visible_devices() is the real cards
    again."""
    global _VIRTUAL
    _VIRTUAL = None


def visible_devices(kind: Optional[str] = None) -> List[torch.device]:
    """The devices a mesh may span in this process: the virtual list of
    force_virtual_devices, else every CUDA card (raising without one).
    `kind` ("cuda" or "cpu") asks for devices of that type: the virtual
    list when its devices are of it, else the process's own (every CUDA
    card; the one CPU)."""
    if _VIRTUAL is not None and (kind is None or _VIRTUAL[1].type == kind):
        n, dev = _VIRTUAL
        return [dev] * n
    if kind == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """torch.device for an entry point: None means the CUDA card.

    Raises RuntimeError when a CUDA device is requested (or defaulted to)
    and torch sees none — never a silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def indexed(dev: torch.device) -> torch.device:
    """`dev` with its index: a CUDA device named without one is the
    current card (what a tensor placed there reports as its device)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def card_info(index: int = 0) -> dict:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (`line`), plus torch's name for it. Raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    line: Optional[str] = None
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        proc = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={index}"],
            capture_output=True, text=True, timeout=30, check=False,
        )
        if proc.returncode == 0 and proc.stdout.strip():
            line = proc.stdout.strip().splitlines()[0]
    return {
        "name": torch.cuda.get_device_name(index),
        "count": torch.cuda.device_count(),
        "line": line if line is not None else "nvidia-smi unavailable",
    }
