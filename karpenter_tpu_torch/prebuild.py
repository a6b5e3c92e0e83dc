"""Build every native artifact of the port into the package, ahead of use.

    python -m karpenter_tpu_torch.prebuild [KERNEL_DIR]

compiles every CUDA kernel (csrc/*.cu, `kernels.build()`: nvcc, sm_90a)
and both C host helpers (native/binpack_kernel.c and native/quantity.c,
`load_kbinpack` / `load_kquantity`: the interpreter's C compiler) into
the imported package's `_build/` (the CUDA kernels into KERNEL_DIR
instead where one is given: the directory a sidecar's
--compile-cache-dir names), loads every library, and prints one JSON
line: {"package": the package directory, "build": the kernels' build
directory, "libraries": {name: path}}. It raises (exit 1) when a build
or a load fails.

The port's image runs it in its build stage (Dockerfile.torch), so the
runtime stage, which has no CUDA toolkit and no C compiler, loads the
prebuilt libraries: `kernels.build()` finds each target, keyed by a
digest of its source and NVCC_FLAGS, and calls no nvcc. Loading needs
no card: the kernels link the CUDA runtime statically and reach the
driver at their first call.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys


def prebuild() -> dict:
    """name -> library path, every library built and loaded."""
    from karpenter_tpu_torch import kernels
    from karpenter_tpu_torch.native import load_kbinpack, load_kquantity

    libraries = {name: str(path) for name, path in kernels.build().items()}
    for path in libraries.values():
        ctypes.CDLL(path)
    binpack, quantity = load_kbinpack(), load_kquantity()
    if binpack is None:
        raise RuntimeError("native/binpack_kernel.c did not build or load")
    if quantity is None:
        raise RuntimeError("native/quantity.c did not build or load")
    libraries["kbinpack"] = binpack._name
    libraries["kquantity"] = quantity.__file__
    return libraries


def main(argv=None) -> int:
    from karpenter_tpu_torch import kernels

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1:
        print(__doc__.splitlines()[2].strip(), file=sys.stderr)
        return 2
    if argv:  # imports torch (utils.device): only where a directory is named
        from karpenter_tpu_torch.utils.backend import configure_compile_cache

        configure_compile_cache(argv[0])
    libraries = prebuild()
    print(json.dumps({
        "package": os.path.dirname(os.path.abspath(__file__)),
        "build": str(kernels.BUILD),
        "libraries": libraries,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
