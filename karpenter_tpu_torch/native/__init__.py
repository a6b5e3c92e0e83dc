"""Native (C) host helpers, built on demand, with pure-Python and numpy
fallbacks: the numpy rung's assignment helper (binpack_kernel.c) and the
resource.Quantity parser (quantity.c).

The port's copy of karpenter_tpu/native/__init__.py. binpack_kernel.c is
the reference's source, code unchanged (two comments shortened), and
quantity.c is the reference's source unchanged. Both are host code, not
device kernels: binpack_kernel.c serves the numpy rung
(ops/numpy_binpack.py), and quantity.c the parse of every manifest and
pod watch event (utils/quantity.py, whose regex parser is its oracle).
Absence of a C toolchain degrades to the numpy stages and the Python
parser silently, exactly as in the reference.

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


def _bind_extension(so: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location("_kquantity", so)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bind_ctypes(so: str):
    import ctypes

    lib = ctypes.CDLL(so)
    lib.karpenter_assign.restype = None
    lib.karpenter_shelf_bfd.restype = None
    lib.karpenter_pack_bits.restype = None
    if hasattr(lib, "karpenter_assign_mt"):  # older prebuilt .so lacks it
        lib.karpenter_assign_mt.restype = None
    return lib


_kquantity = None
_tried = False


def load_kquantity() -> Optional[object]:
    """The _kquantity extension module, building it if needed; None when
    no toolchain is available (callers use the Python path)."""
    global _kquantity, _tried
    with _lock:
        if _kquantity is not None or _tried:
            return _kquantity
        _tried = True
        _kquantity = _build_and_load(
            "quantity.c", "_kquantity.so", _bind_extension
        )
        return _kquantity


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
    """Kick off the kernel build/load in a daemon thread (the
    ensure_kquantity_async pattern)."""
    global _kbinpack_async_started
    with _lock:
        if _kbinpack_async_started or _kbinpack is not None:
            return
        _kbinpack_async_started = True
    threading.Thread(target=load_kbinpack, daemon=True).start()


_async_started = False


def peek_kquantity() -> Optional[object]:
    """The extension if it has finished loading, else None. Never blocks."""
    return _kquantity


def ensure_kquantity_async() -> None:
    """Kick off the build/load in a daemon thread. Callers use the Python
    path until peek_kquantity() turns non-None, so a cold compile never
    blocks a latency-sensitive first request (e.g. an admission webhook)."""
    global _async_started
    with _lock:
        if _async_started or _kquantity is not None:
            return
        _async_started = True
    threading.Thread(target=load_kquantity, daemon=True).start()
