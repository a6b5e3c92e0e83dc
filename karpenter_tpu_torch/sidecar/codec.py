"""Self-describing array framing for the solver sidecar wire format (the
port's copy of karpenter_tpu/sidecar/codec.py, byte for byte on the wire:
either package's client talks to either package's server).

Layout: 8-byte little-endian header length, JSON header, then the raw
C-order little-endian array buffers concatenated in header order. The
header is a list of [name, dtype, shape] triples plus an optional "meta"
dict (backend info, error strings). Arrays round-trip zero-copy on decode
(numpy views over the message buffer).

What differs: `pack` and `pack_dataclass` also take torch tensors. A
dataclass whose leaves lie on a CUDA card is copied to the host once
(utils/operands.fetch), never leaf by leaf.

This is the byte-level stand-in for proto/solver.proto's TensorBatch (see
sidecar/__init__.py for why no generated stubs).
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_LEN = struct.Struct("<Q")


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def pack(arrays: Dict[str, Any], meta: Optional[Dict[str, Any]] = None
         ) -> bytes:
    entries = []
    buffers = []
    for name, arr in arrays.items():
        arr = _host(arr)
        shape = list(arr.shape)  # before ascontiguousarray: it promotes 0-d to 1-d
        arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">":  # wire format is little-endian
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        entries.append([name, arr.dtype.str, shape])
        buffers.append(arr.tobytes())
    header = json.dumps({"tensors": entries, "meta": meta or {}}).encode()
    return b"".join([_LEN.pack(len(header)), header] + buffers)


def unpack(data: bytes) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    (header_len,) = _LEN.unpack_from(data, 0)
    header = json.loads(data[8 : 8 + header_len])
    offset = 8 + header_len
    arrays: Dict[str, np.ndarray] = {}
    for name, dtype_str, shape in header["tensors"]:
        dtype = np.dtype(dtype_str)
        count = int(np.prod(shape)) if shape else 1
        nbytes = dtype.itemsize * count
        arrays[name] = np.frombuffer(
            data, dtype=dtype, count=count, offset=offset
        ).reshape(tuple(shape))
        offset += nbytes
    return arrays, header.get("meta", {})


def pack_dataclass(obj, meta: Optional[Dict[str, Any]] = None) -> bytes:
    """Any array dataclass (BinPackInputs, DecisionInputs, ...) -> wire
    bytes, one tensor per field. None-valued optional fields (e.g.
    BinPackInputs.pod_weight) are simply absent from the wire. Leaves on
    a CUDA card come to the host in one copy."""
    fields = [f.name for f in dataclasses.fields(obj)
              if getattr(obj, f.name) is not None]
    if any(isinstance(getattr(obj, name), torch.Tensor)
           and getattr(obj, name).device.type != "cpu" for name in fields):
        from karpenter_tpu_torch.utils.operands import fetch

        obj = fetch(obj)
    return pack({name: getattr(obj, name) for name in fields}, meta)


def unpack_dataclass(cls, data: bytes):
    """Wire bytes -> cls hydrated with numpy arrays. Field-name match is
    exact for required fields; fields with a dataclass default may be
    absent (they take the default — how optional tensors like pod_weight
    stay wire-compatible across versions). Extra tensors are an error,
    same strictness as the YAML codec."""
    arrays, meta = unpack(data)
    required = {
        f.name
        for f in dataclasses.fields(cls)
        if f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    }
    names = {f.name for f in dataclasses.fields(cls)}
    if not (required <= set(arrays) <= names):
        raise ValueError(
            f"tensor set mismatch for {cls.__name__}: "
            f"got {sorted(arrays)}, want {sorted(required)} <= got <= "
            f"{sorted(names)}"
        )
    return cls(**arrays), meta
