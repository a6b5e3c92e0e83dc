"""Boot-time backend set-up for the controller binary (counterpart of
`ensure_usable_backend` and `configure_compile_cache` in
karpenter_tpu/utils/backend.py).

The reference probes its accelerator in a subprocess and, when the probe
fails, switches JAX to the CPU so decisions keep flowing. The port does
not degrade: `ensure_usable_backend` resolves the device the operator
asked for (the CUDA card unless `cpu` is named), builds and loads the
hand-written CUDA kernels on the card, and raises with the reason on any
failure, so the process exits instead of running without the card.

The reference's persistent compile cache holds compiled XLA programs.
The port compiles nothing at run time but its CUDA kernels, whose shared
libraries `kernels.build()` writes to a directory keyed by a digest of
source and flags; `configure_compile_cache` points that directory
elsewhere, so a restarted process loads the libraries instead of
running nvcc again.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from karpenter_tpu_torch.utils.device import DeviceLike, resolve_device


def configure_compile_cache(path: Optional[str]) -> bool:
    """Build the CUDA kernels into `path` (no-op when empty). Must run
    before the first build of a process: a library already loaded stays
    loaded from where it was built."""
    if not path:
        return False
    from karpenter_tpu_torch import kernels

    target = Path(path).expanduser().resolve()
    target.mkdir(parents=True, exist_ok=True)
    kernels.BUILD = target
    return True


def ensure_usable_backend(device: DeviceLike = None) -> str:
    """Resolve `device` (None or "cuda" = the card) and, on the card,
    build and load every CUDA kernel. Returns a one-line note naming the
    device; raises RuntimeError when the card was asked for and is
    absent, or when a kernel does not build or load."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"{dev.type} (named by the operator; no CUDA kernel runs)"
    import torch

    from karpenter_tpu_torch import kernels

    kernels.build()
    for name in kernels.SOURCES:
        kernels.library(name)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return (
        f"cuda:{index} ({torch.cuda.get_device_name(index)}), kernels "
        f"{', '.join(kernels.SOURCES)} loaded from {kernels.BUILD}"
    )
