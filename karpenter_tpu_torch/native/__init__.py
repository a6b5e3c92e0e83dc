"""The numpy rung's C helper (binpack_kernel.c), built on demand, with a
pure-numpy fallback.

The port's copy of the kbinpack half of karpenter_tpu/native/__init__.py;
binpack_kernel.c is the reference's source, code unchanged (two comments
shortened). It is a host
kernel of the numpy rung (ops/numpy_binpack.py), not a device kernel:
absence of a C toolchain degrades to the numpy stages silently, exactly
as in the reference. The reference's quantity parser (quantity.c) stays
out: the port keeps the pure-Python parser, the reference's own oracle
for it.

Build: compiled once with the running interpreter's sysconfig compiler
into karpenter_tpu_torch/_build/ (listed in .gitignore); rebuilt when
the .c source is newer than the .so.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lock = threading.Lock()


def _compile(src: str, out: str) -> bool:
    include = sysconfig.get_path("include")
    cc = sysconfig.get_config_var("CC") or "cc"
    # compile to a private temp path, then atomically publish: a concurrent
    # or killed compile must never leave a torn .so at the final path (it
    # would carry a fresh mtime and silently disable the accelerator
    # forever after)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [
        *cc.split(),
        "-O2",
        "-fPIC",
        "-shared",
        "-pthread",  # the threaded assignment variant (binpack_kernel.c)
        f"-I{include}",
        src,
        "-o",
        tmp,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
        if proc.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _build_and_load(src_name: str, so_name: str, bind):
    """The build-on-demand scaffold: staleness check, compile, bind.
    Returns the bound handle or None; callers own the caching."""
    src = os.path.join(_HERE, src_name)
    so = os.path.join(_BUILD_DIR, so_name)
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        stale = (
            not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)
        )
        if stale and not _compile(src, so):
            return None
        return bind(so)
    except Exception:
        return None


def _bind_ctypes(so: str):
    import ctypes

    lib = ctypes.CDLL(so)
    lib.karpenter_assign.restype = None
    lib.karpenter_shelf_bfd.restype = None
    lib.karpenter_pack_bits.restype = None
    if hasattr(lib, "karpenter_assign_mt"):  # older prebuilt .so lacks it
        lib.karpenter_assign_mt.restype = None
    return lib


_kbinpack = None
_kbinpack_tried = False
_kbinpack_async_started = False


def load_kbinpack() -> Optional[object]:
    """ctypes handle to the fused assignment kernel (binpack_kernel.c),
    building it on demand; None without a toolchain (callers use the
    numpy path). Plain C, no CPython API — loaded with ctypes.CDLL, and
    the call releases the GIL for its whole O(P*T) worst-case scan."""
    global _kbinpack, _kbinpack_tried
    with _lock:
        if _kbinpack is not None or _kbinpack_tried:
            return _kbinpack
        _kbinpack_tried = True
        _kbinpack = _build_and_load(
            "binpack_kernel.c", "_kbinpack.so", _bind_ctypes
        )
        return _kbinpack


def peek_kbinpack() -> Optional[object]:
    """The kernel if it has finished loading, else None. Never blocks —
    the degraded-mode solve must not spend its tick budget inside a cc
    subprocess; it runs the numpy stages until the handle appears."""
    return _kbinpack


def ensure_kbinpack_async() -> None:
    """Kick off the kernel build/load in a daemon thread."""
    global _kbinpack_async_started
    with _lock:
        if _kbinpack_async_started or _kbinpack is not None:
            return
        _kbinpack_async_started = True
    threading.Thread(target=load_kbinpack, daemon=True).start()
