"""YAML/dict codec for the API types — kubectl-manifest fidelity.

reference: the CRD YAML shapes in docs/examples/*.yaml and the kubebuilder
JSON tags on the Go structs (e.g. pkg/apis/autoscaling/v1alpha1/
horizontalautoscaler.go:33-58 `json:"scaleTargetRef"`, metricsproducer.go:
22-44 `json:"scheduleSpec"`). The reference gets (de)serialization from the
apiserver + controller-gen; here a reflective codec hydrates the Python
dataclasses from the SAME manifests, so the reference's docs/examples drive
this framework's tests unchanged (the envtest pattern,
pkg/test/environment/namespace.go:57-83).

Key mapping is mechanical camelCase<->snake_case with per-field overrides
for the places the reference's JSON tag differs from the Go field
(`scheduleSpec` -> ScheduleSpec field `schedule`).

The port's copy of karpenter_tpu/api/serialization.py. PyYAML is
imported only by load_yaml and dump_yaml, so the durable store's JSON
records need none. The key mappings and each class's resolved field
types are memoized (pure functions of a name or a class): resolving the
type hints per decoded object made opening a 100k-pod data dir take
minutes.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import typing
from typing import Any, Dict, List, Type

from karpenter_tpu_torch.api.core import (
    Container,
    Namespace,
    Node,
    ObjectMeta,
    Pod,
)
from karpenter_tpu_torch.api.horizontalautoscaler import HorizontalAutoscaler
from karpenter_tpu_torch.api.metricsproducer import MetricsProducer
from karpenter_tpu_torch.api.poolgroup import PoolGroup
from karpenter_tpu_torch.api.scalablenodegroup import ScalableNodeGroup
from karpenter_tpu_torch.utils.quantity import Quantity

API_VERSION = "autoscaling.karpenter.sh/v1alpha1"
CORE_API_VERSION = "v1"  # Node/Pod are core/v1 kinds
AUTOSCALING_KINDS = (
    "HorizontalAutoscaler",
    "MetricsProducer",
    "PoolGroup",
    "ScalableNodeGroup",
)

KINDS: Dict[str, type] = {
    "HorizontalAutoscaler": HorizontalAutoscaler,
    "MetricsProducer": MetricsProducer,
    "PoolGroup": PoolGroup,
    "ScalableNodeGroup": ScalableNodeGroup,
    # core kinds so test fixtures can be manifests too
    "Node": Node,
    "Pod": Pod,
    "Namespace": Namespace,
}

# YAML key -> dataclass field, where mechanical mapping doesn't hold
# (reference JSON tags vs field names)
_KEY_TO_FIELD = {
    "scheduleSpec": "schedule",
    "apiVersion": "api_version",
}
_FIELD_TO_KEY = {v: k for k, v in _KEY_TO_FIELD.items()}

_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")


@functools.lru_cache(maxsize=1024)
def camel_to_snake(name: str) -> str:
    return _CAMEL_RE.sub("_", name).lower()


@functools.lru_cache(maxsize=1024)
def snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part.capitalize() for part in rest)


@functools.lru_cache(maxsize=None)
def _field_types(cls: type) -> Dict[str, Any]:
    return typing.get_type_hints(cls)


def _unwrap_optional(tp: Any) -> Any:
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(value: Any, tp: Any, lenient: bool = False) -> Any:
    tp = _unwrap_optional(tp)
    if value is None:
        return None
    if typing.get_origin(tp) is not None:
        return _coerce_generic(value, tp, lenient)
    return _coerce_scalar(value, tp, lenient)


def _coerce_generic(value: Any, tp: Any, lenient: bool) -> Any:
    """Containers and unions (types with a typing origin)."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        # Union[int, str] (resourceVersion): numeric when locally minted,
        # opaque string from a real apiserver — prefer int, keep strings
        try:
            return int(value)
        except (TypeError, ValueError):
            return value
    if origin in (list, List):
        (item_tp,) = typing.get_args(tp) or (Any,)
        return [_coerce(v, item_tp, lenient=lenient) for v in value]
    if origin in (dict, Dict):
        args = typing.get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {
            k: _coerce(v, val_tp, lenient=lenient) for k, v in value.items()
        }
    return value


def _coerce_scalar(value: Any, tp: Any, lenient: bool) -> Any:
    """One arm per wire type: Quantity, nested dataclass, primitives."""
    if tp is Quantity:
        return Quantity.parse(str(value))
    if dataclasses.is_dataclass(tp):
        return from_dict(tp, value, lenient=lenient)
    if tp is float:
        if lenient and isinstance(value, str):
            # apiserver timestamps are RFC3339 strings; our model keeps
            # epoch floats
            return _rfc3339_to_epoch(value)
        return float(value)
    if tp is int:
        return int(value)
    if tp is str:
        return str(value)
    if tp is bool:
        return bool(value)
    return value


def _rfc3339_to_epoch(value: str) -> float:
    import datetime as _dt

    text = value.replace("Z", "+00:00")
    return _dt.datetime.fromisoformat(text).timestamp()


def _flatten_container_resources(data: Dict[str, Any]) -> Dict[str, Any]:
    """Real-apiserver dialect: requests/limits nest under `resources`
    (core/v1 ResourceRequirements); our manifest dialect flattens to
    `requests`. Lenient (apiserver-read) decode accepts both; strict
    user manifests still hard-error on `resources` so misconfig never
    silently drops limits/requests."""
    nested = data.get("resources") or {}
    data = {k: v for k, v in data.items() if k != "resources"}
    if "requests" not in data and "requests" in nested:
        data["requests"] = nested["requests"]
    return data


def _resolve_field(cls: Type, key: str, field_names, lenient: bool):
    """Manifest key -> dataclass field name; None = skip this key."""
    if key in ("apiVersion", "kind") and "api_version" not in field_names:
        return None  # envelope keys on top-level kinds
    field = _KEY_TO_FIELD.get(key, camel_to_snake(key))
    if field in field_names:
        return field
    if lenient:
        return None
    raise ValueError(
        f"unknown field {key!r} for {cls.__name__} "
        f"(known: {sorted(field_names)})"
    )


def from_dict(cls: Type, data: Dict[str, Any], lenient: bool = False):
    """Hydrate dataclass `cls` from a manifest-shaped dict (camelCase keys).
    Unknown keys are an error — same posture as apiserver structural schemas
    (silently dropped config is misconfig that 'works').

    lenient=True skips unknown keys instead: the decode posture for objects
    COMING FROM a real apiserver, which carry dozens of standard fields
    (managedFields, generation, pod volumes, ...) this model deliberately
    doesn't track. User manifests stay strict."""
    if data is None:
        data = {}
    if lenient and cls is Container and "resources" in data:
        data = _flatten_container_resources(data)
    types = _field_types(cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        field = _resolve_field(cls, key, field_names, lenient)
        if field is not None:
            kwargs[field] = _coerce(value, types[field], lenient=lenient)
    return cls(**kwargs)


_META_INTERNAL = ("uid", "resource_version", "creation_timestamp")


def to_dict(obj, top_level: bool = True) -> Dict[str, Any]:
    """Manifest-shaped dict (camelCase, defaults and None dropped)."""
    assert dataclasses.is_dataclass(obj)
    out: Dict[str, Any] = {}
    if top_level and type(obj).__name__ in KINDS:
        kind = type(obj).__name__
        out["apiVersion"] = (
            API_VERSION if kind in AUTOSCALING_KINDS else CORE_API_VERSION
        )
        out["kind"] = kind
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if isinstance(obj, ObjectMeta) and f.name in _META_INTERNAL:
            continue
        if value is None or value == {} or value == []:
            continue
        key = _FIELD_TO_KEY.get(f.name, snake_to_camel(f.name))
        out[key] = _value_to_plain(value)
    return out


def _value_to_plain(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return to_dict(value, top_level=False)
    if isinstance(value, Quantity):
        return str(value)
    if isinstance(value, list):
        return [_value_to_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _value_to_plain(v) for k, v in value.items()}
    return value


def from_manifest(doc: Dict[str, Any], lenient: bool = False):
    """One YAML document (with apiVersion/kind envelope) -> API object."""
    kind = doc.get("kind")
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r} (known: {sorted(KINDS)})")
    api_version = doc.get("apiVersion", "")
    if kind in AUTOSCALING_KINDS:
        if api_version != API_VERSION:
            raise ValueError(
                f"unsupported apiVersion {api_version!r} for {kind}"
            )
    elif api_version not in ("", CORE_API_VERSION):
        # core kinds: absent is tolerated (test fixtures), wrong rejected —
        # same symmetry as the v1 stamp to_dict emits
        raise ValueError(f"unsupported apiVersion {api_version!r} for {kind}")
    body = {k: v for k, v in doc.items() if k not in ("apiVersion", "kind")}
    return from_dict(KINDS[kind], body, lenient=lenient)


def load_yaml(text: str) -> List[Any]:
    """All documents in a (possibly multi-doc) YAML string -> API objects."""
    import yaml

    return [
        from_manifest(doc)
        for doc in yaml.safe_load_all(text)
        if doc is not None
    ]


def load_yaml_file(path: str) -> List[Any]:
    with open(path) as f:
        return load_yaml(f.read())


def dump_yaml(*objects) -> str:
    import yaml

    return yaml.safe_dump_all(
        [to_dict(o) for o in objects], sort_keys=False, default_flow_style=False
    )
