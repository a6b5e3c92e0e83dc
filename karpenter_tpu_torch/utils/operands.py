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
  groups, None kept.
- `obj.to(device)`: the same operands on another device.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Mapping

import numpy as np
import torch

from karpenter_tpu_torch.utils.device import DeviceLike, resolve_device

F32, I32, BOOL = torch.float32, torch.int32, torch.bool


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

    def to_numpy(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value is None:
                out[f.name] = None
            elif isinstance(value, Operands):
                out[f.name] = value.to_numpy()
            else:
                out[f.name] = value.detach().cpu().numpy()
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
