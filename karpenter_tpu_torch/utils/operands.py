"""Operand dataclasses carried across from numpy (the port's analogue of
loading weights).

A dataclass of tensors that mixes in `Operands` and names each field's
kind in `KINDS` (a torch dtype, or another `Operands` class for a nested
group) gets:

- `Cls.from_numpy(src, device=None)`: `src` is the reference's dataclass
  of the same name (its fields as numpy or array-likes), or a dict of
  numpy arrays. Every field becomes a tensor on the device with its dtype
  pinned (f32, i32, bool; a scalar such as `now` becomes a 0-d tensor),
  nested groups recurse, and a field that is None or absent stays None.
  The device defaults to the CUDA card and raises without one.
- `obj.to_numpy()`: a dict of numpy arrays, nested dicts for nested
  groups, None kept (tensor leaves copied to the host, numpy leaves as
  they are).
- `obj.to(device)`: the same operands on another device.
- `on_device(obj, device=None)`: the operands as tensors, host leaves
  placed beside the operands' tensors or on the default device (the
  programs' first step, so they take host operands as the reference's
  jitted programs do), or everything on `device` when one is named.
- `Cls.from_arrays(src)`: the same operands as host numpy arrays with
  the dtypes pinned (the host view the numpy mirrors and the solve
  service's families take).
- `fetch(tree)`: a tree of device tensors as the same dataclasses of
  numpy arrays, in ONE device->host copy (`FETCHES` counts the calls);
  `host_seam(program, Cls)` wraps a tensor program as a host-operand
  callable: upload, run on the device, fetch once.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Mapping

import numpy as np
import torch

from karpenter_tpu_torch.utils.device import DeviceLike, indexed, resolve_device

F32, I32, BOOL = torch.float32, torch.int32, torch.bool

_NUMPY_DTYPES = {F32: np.float32, I32: np.int32, BOOL: np.bool_}

# device->host fetches made by `fetch` (tests read the delta of one call)
FETCHES = {"count": 0}


def _is_group(kind) -> bool:
    return isinstance(kind, type) and issubclass(kind, Operands)


def _field_of(src, name: str):
    if isinstance(src, Mapping):
        return src.get(name)
    return getattr(src, name, None)


def as_tensor(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor of `dtype` on `device` that never aliases the caller's
    array (numpy, a numpy scalar, or anything np.asarray takes)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype).contiguous()
    array = np.array(np.asarray(value), order="C")
    return torch.from_numpy(array).to(device=device, dtype=dtype)


class Operands:
    KINDS: ClassVar[dict]

    @classmethod
    def from_numpy(cls, src, device: DeviceLike = None):
        dev = resolve_device(device)
        unknown = set(src) - set(cls.KINDS) if isinstance(src, Mapping) else ()
        if unknown:
            raise ValueError(f"unknown {cls.__name__} fields {sorted(unknown)}")
        kwargs = {}
        for name, kind in cls.KINDS.items():
            value = _field_of(src, name)
            if value is None:
                continue
            if _is_group(kind):
                kwargs[name] = kind.from_numpy(value, dev)
            else:
                kwargs[name] = as_tensor(value, kind, dev)
        return cls(**kwargs)

    @classmethod
    def from_arrays(cls, src):
        """The operands as host numpy arrays with the dtypes pinned (a
        scalar such as `now` stays a numpy scalar); nested groups
        recurse, None and absent fields stay None. Tensors are copied to
        the host."""
        kwargs = {}
        for name, kind in cls.KINDS.items():
            value = _field_of(src, name)
            if value is None:
                continue
            if _is_group(kind):
                kwargs[name] = kind.from_arrays(value)
            else:
                if isinstance(value, torch.Tensor):
                    value = value.detach().cpu().numpy()
                array = np.asarray(value, _NUMPY_DTYPES[kind])
                kwargs[name] = array[()] if array.ndim == 0 else array
        return cls(**kwargs)

    def to_numpy(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value is None:
                out[f.name] = None
            elif isinstance(value, Operands):
                out[f.name] = value.to_numpy()
            elif isinstance(value, torch.Tensor):
                out[f.name] = value.detach().cpu().numpy()
            else:  # already a host array (a fetched tree)
                out[f.name] = np.asarray(value)
        return out

    def to(self, device: DeviceLike):
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            **{
                f.name: None if getattr(self, f.name) is None
                else getattr(self, f.name).to(dev)
                for f in dataclasses.fields(self)
            },
        )


def _leaves(obj, out):
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if isinstance(value, Operands):
            _leaves(value, out)
        elif value is not None:
            out.append(value)
    return out


def on_device(inputs: Operands, device: DeviceLike = None) -> Operands:
    """`inputs` as tensors. Operands without a host array come back as
    they are. With one (a numpy array, or any array np.asarray takes;
    scalars do not count), every field is placed on the device of the
    operands' tensors, or on the default device when none is a tensor:
    the reference's jitted programs take host operands the same way.
    With `device`, every field is placed there (tensors moved, host
    leaves and scalars uploaded), and operands already all there come
    back as they are."""
    leaves = _leaves(inputs, [])
    if device is not None:
        dev = indexed(resolve_device(device))
        if all(isinstance(v, torch.Tensor) and v.device == dev for v in leaves):
            return inputs
        return type(inputs).from_numpy(inputs, dev)
    if not any(
        not isinstance(v, torch.Tensor) and np.ndim(v) > 0 for v in leaves
    ):
        return inputs
    devices = [v.device for v in leaves if isinstance(v, torch.Tensor)]
    return type(inputs).from_numpy(inputs, devices[0] if devices else None)


def _rebuild(obj, arrays):
    kwargs = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if isinstance(value, Operands):
            kwargs[f.name] = _rebuild(value, arrays)
        elif isinstance(value, torch.Tensor):
            kwargs[f.name] = arrays[id(value)]
    return dataclasses.replace(obj, **kwargs)


def fetch(tree):
    """A tree of Operands holding f32 / i32 / bool tensors (any one
    device) as the same dataclasses holding numpy arrays, in one
    device->host copy: every
    leaf is viewed as bytes and concatenated on its device, copied once,
    and split back on the host (4-byte leaves first, so every slice
    stays aligned). None stays None; a tree without tensors passes
    through."""
    leaves = [v for v in _leaves(tree, []) if isinstance(v, torch.Tensor)]
    if not leaves:
        return tree
    FETCHES["count"] += 1
    order = sorted(leaves, key=lambda t: -t.element_size())
    packed = torch.cat([
        t.detach().contiguous().reshape(-1).view(torch.uint8) for t in order
    ]).cpu().numpy()
    arrays = {}
    offset = 0
    for t in order:
        nbytes = t.numel() * t.element_size()
        chunk = packed[offset:offset + nbytes].view(_NUMPY_DTYPES[t.dtype])
        arrays[id(t)] = chunk.reshape(tuple(t.shape))
        offset += nbytes
    return _rebuild(tree, arrays)


def host_seam(program, in_cls, device: DeviceLike = None):
    """`program` (a tensor program over `in_cls` operands) as a callable
    that takes host operands (numpy leaves, or the reference's
    dataclass) and answers host numpy: the operands are uploaded to
    `device` (the card by default), the program runs there, and the
    outputs come back in one fetch."""

    def run(inputs):
        return fetch(program(in_cls.from_numpy(inputs, device)))

    run.__name__ = f"{getattr(program, '__name__', 'program')}_host"
    run.__doc__ = (
        f"{run.__name__}(inputs): host operands -> host outputs, "
        f"through {run.__name__[:-5]} on the device (utils/operands.host_seam)."
    )
    return run
