"""Fast structural clone for API objects — the store's copy primitive.

The store isolates every read/write with a deep copy (store/store.py); at
fleet scale that copy IS the control plane's hottest host path (a 1%-churn
tick over 100k pods performs thousands of pod copies). copy.deepcopy pays
for generality it doesn't need here — memo dicts, reduce/reconstruct
protocol, cycle detection. API objects are trees of dataclasses, builtin
containers, scalars, and immutable leaves, so a direct recursive rebuild
is ~10x faster, and a COMPILED per-dataclass cloner (straight-line field
assignments generated on first use) removes the per-field loop overhead
on top of that.

Semantics vs copy.deepcopy, by design:
- Quantity instances are SHARED, not copied: Quantity is immutable by
  contract (utils/quantity.py — all arithmetic returns new instances).
- Aliasing inside one object tree is not preserved (each reference is
  cloned independently). API objects are plain trees; nothing relies on
  internal sharing.
- Unknown types fall back to copy.deepcopy, so correctness never depends
  on this module knowing every type.
"""

from __future__ import annotations

import copy
from dataclasses import fields, is_dataclass
from typing import Any, Callable, Dict

from karpenter_tpu_torch.utils.quantity import Quantity


def _identity(x: Any) -> Any:
    return x


def fast_clone(x: Any) -> Any:
    cloner = _CLONERS.get(x.__class__)
    if cloner is None:
        cloner = _register_cloner(x.__class__)
    return cloner(x)


def _clone_dict(x: dict) -> dict:
    return {k: fast_clone(v) for k, v in x.items()}


def _clone_list(x: list) -> list:
    return [fast_clone(v) for v in x]


def _clone_tuple(x: tuple) -> tuple:
    return tuple(fast_clone(v) for v in x)


def _clone_set(x: set) -> set:
    return {fast_clone(v) for v in x}


# exact-class dispatch (subclasses take the registration path, so e.g. a
# dict subclass is NOT silently flattened to a plain dict)
_CLONERS: Dict[type, Callable[[Any], Any]] = {
    str: _identity,
    int: _identity,
    float: _identity,
    bool: _identity,
    type(None): _identity,
    bytes: _identity,
    Quantity: _identity,  # immutable by contract: shared
    dict: _clone_dict,
    list: _clone_list,
    tuple: _clone_tuple,
    set: _clone_set,
}


def _register_cloner(cls: type) -> Callable[[Any], Any]:
    """First encounter of a class: compile a straight-line cloner for
    dataclasses (frozen ones assign via object.__setattr__, same trick
    dataclasses' own __init__ uses), fall back to copy.deepcopy for
    anything else."""
    if is_dataclass(cls):
        names = tuple(f.name for f in fields(cls))
        frozen = cls.__dataclass_params__.frozen
        assign = (
            (lambda n: f"    _set(n, {n!r}, _c(x.{n}))")
            if frozen
            else (lambda n: f"    n.{n} = _c(x.{n})")
        )
        lines = [
            "def _cloner(x, _new=object.__new__, _cls=_CLS, _c=fast_clone,"
            " _set=object.__setattr__):",
            "    n = _new(_cls)",
            *[assign(name) for name in names],
            "    return n",
        ]
        namespace = {"_CLS": cls, "fast_clone": fast_clone, "object": object}
        exec("\n".join(lines), namespace)  # noqa: S102 — own class metadata
        cloner = namespace["_cloner"]
    else:
        cloner = copy.deepcopy
    _CLONERS[cls] = cloner
    return cloner
