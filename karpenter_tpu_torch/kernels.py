"""Builds and loads the port's hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into a shared library with a
plain C interface, at first use, into karpenter_tpu_torch/_build/ (listed
in .gitignore); the library's name carries a digest of the source and the
flags, so a changed source never loads a stale build. Libraries load with
ctypes: every pointer and the stream pass as c_void_p (a bare Python int
would be cut to 32 bits), every size as c_int. Nothing here falls back: a
missing nvcc, a failed build or a non-zero cudaError_t raises.

`build()` starts one nvcc per source, all at once, so the set-up time of a
cold run is that of the slowest source, not their sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("fused_assign", "shelf_bfd", "forecast", "tick_rows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> {C function: (argtypes, restype)}
_SIGNATURES = {
    "fused_assign": {
        # 11 operands; P, T, R, KW, LW, B; the launch plan (n_blocks,
        # narrow, shared_bytes, key_bits); 6 outputs and scratch; the stream
        "fused_assign_launch": ([_P] * 11 + [_I] * 10 + [_P] * 7, _I),
        # its two halves: the scan (4 outputs and the stream) and the
        # reduction (partials, n_blocks, T * R, 2 outputs, the stream)
        "fused_assign_scan": ([_P] * 11 + [_I] * 10 + [_P] * 5, _I),
        "fused_assign_reduce": ([_P, _P, _I, _I, _P, _P, _P], _I),
        # the bit packing of up to 4 masks: 4 inputs, 4 outputs, their rows
        # and widths, the invert bits, the mask count, the stream
        "pack_bits_launch": ([_P] * 8 + [_I] * 10 + [_P], _I),
        "fused_assign_error_string": ([_I], ctypes.c_char_p),
    },
    "shelf_bfd": {
        "shelf_bfd_launch": ([_P, _I, _I, _P, _P, _P], _I),
        "shelf_bfd_error_string": ([_I], ctypes.c_char_p),
    },
    "forecast": {
        # 11 operands; S, T and the plan (series, chunk, shared_bytes); 3
        # outputs, the seasonal scratch (or null) and the stream
        "forecast_launch": ([_P] * 11 + [_I] * 5 + [_P] * 5, _I),
        "forecast_error_string": ([_I], ctypes.c_char_p),
    },
    "tick_rows": {
        # 5 series operands; S, N, M; the winners grid and the stream
        "tick_scatter_launch": ([_P] * 5 + [_I] * 3 + [_P] * 2, _I),
        # the array of operand and output pointers, its length; N, M, K;
        # the stream
        "tick_rows_launch": ([_P, _I, _I, _I, _I, _P], _I),
        "tick_rows_error_string": ([_I], ctypes.c_char_p),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc; raises when the CUDA toolkit is not installed."""
    found = shutil.which("nvcc")
    if found is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of karpenter_tpu_torch cannot be built"
        )
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, in parallel.
    With verbose=True, ptxas reports registers, shared memory and spills
    (returned compiler output is printed). Returns name -> library path."""
    names = list(names)
    unknown = set(names) - set(SOURCES)
    if unknown:
        raise ValueError(f"unknown kernel sources {sorted(unknown)}")
    targets = {name: _target(name) for name in names}
    pending = {n: t for n, t in targets.items() if verbose or not t.exists()}
    if not pending:
        return targets
    compiler = nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, target in pending.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        if verbose and out.strip():
            print(f"[nvcc {name}.cu]\n{out.strip()}")
        os.replace(tmp, pending[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _LIBS[name] = lib
    return lib


def pointer_array(pointers: Sequence[Optional[int]]) -> ctypes.Array:
    """The pointers (ints, None for null) as a C array of void*, which a
    c_void_p parameter takes; the caller keeps it alive past the call."""
    return (ctypes.c_void_p * len(pointers))(*pointers)


def check(name: str, err: int, what: str) -> None:
    """Raise when a launch returned a non-zero cudaError_t."""
    if err != 0:
        text = getattr(library(name), f"{name}_error_string")(err)
        raise RuntimeError(
            f"{what}: CUDA error {err} ({text.decode() if text else '?'})"
        )
