"""CRD + deployment manifest generation from the API dataclasses.

The reference generates its CRD YAML with controller-gen from kubebuilder
markers on the Go structs (reference: Makefile:37-53 codegen target,
config/crd/*.yaml output, the scale-subresource marker at
pkg/apis/autoscaling/v1alpha1/scalablenodegroup.go:51). Here the Python
dataclasses ARE the schema source: this module reflects them into OpenAPI
v3 structural schemas so `config/crd/` can never drift from the types the
control plane actually validates — the same single-source-of-truth property
controller-gen gives the reference.

The port's copy of karpenter_tpu/codegen.py, reflecting the port's own
api/ dataclasses: its CRDs, chart copies and API reference are byte for
byte the committed files, which is what `--apiserver` needs (the port's
types match the deployed schema). The API reference keeps the
committed header, which names the API package it documents
(DOCS_SOURCE).

Run `python -m karpenter_tpu_torch.codegen DIR` to write DIR/crd/ (and
the chart's crds/ beside DIR when the chart is there), or
`python -m karpenter_tpu_torch.codegen --docs FILE` for the API
reference; tests/test_torch_codegen.py asserts committed == regenerated.
"""

from __future__ import annotations

import dataclasses
import sys
import typing
from typing import Any, Dict

import yaml

from karpenter_tpu_torch.api.horizontalautoscaler import HorizontalAutoscaler
from karpenter_tpu_torch.api.metricsproducer import MetricsProducer
from karpenter_tpu_torch.api.poolgroup import PoolGroup
from karpenter_tpu_torch.api.scalablenodegroup import ScalableNodeGroup
from karpenter_tpu_torch.api.serialization import _FIELD_TO_KEY, snake_to_camel
from karpenter_tpu_torch.utils.quantity import Quantity

GROUP = "autoscaling.karpenter.sh"
VERSION = "v1alpha1"
# the API package the committed docs/API.md names in its header: the
# port regenerates that file byte for byte, header included
DOCS_SOURCE = "karpenter_tpu/api/"

CRD_KINDS = {
    "HorizontalAutoscaler": {
        "cls": HorizontalAutoscaler,
        "plural": "horizontalautoscalers",
        "shortNames": ["ha"],
        "printcolumns": [
            # reference: kubectl printcolumn markers,
            # horizontalautoscaler.go:192-200
            {
                "name": "Min",
                "type": "integer",
                "jsonPath": ".spec.minReplicas",
            },
            {
                "name": "Desired",
                "type": "integer",
                "jsonPath": ".status.desiredReplicas",
            },
            {
                "name": "Max",
                "type": "integer",
                "jsonPath": ".spec.maxReplicas",
            },
            {
                "name": "Ready",
                "type": "string",
                "jsonPath": '.status.conditions[?(@.type=="Ready")].status',
            },
        ],
    },
    "MetricsProducer": {
        "cls": MetricsProducer,
        "plural": "metricsproducers",
        "shortNames": ["mp"],
        "printcolumns": [
            {
                "name": "Ready",
                "type": "string",
                "jsonPath": '.status.conditions[?(@.type=="Ready")].status',
            },
        ],
    },
    "PoolGroup": {
        "cls": PoolGroup,
        "plural": "poolgroups",
        "shortNames": ["pg"],
        "printcolumns": [
            {
                "name": "Coordinated",
                "type": "boolean",
                "jsonPath": ".status.coordinated",
            },
            {
                "name": "Hourly",
                "type": "number",
                "jsonPath": ".status.expectedHourly",
            },
        ],
    },
    "ScalableNodeGroup": {
        "cls": ScalableNodeGroup,
        "plural": "scalablenodegroups",
        "shortNames": ["sng"],
        # reference: scale-subresource kubebuilder marker,
        # scalablenodegroup.go:51
        "scale": {
            "specReplicasPath": ".spec.replicas",
            "statusReplicasPath": ".status.replicas",
        },
        "printcolumns": [
            {
                "name": "Replicas",
                "type": "integer",
                "jsonPath": ".status.replicas",
            },
            {
                "name": "Type",
                "type": "string",
                "jsonPath": ".spec.type",
            },
        ],
    },
}


def _unwrap_optional(tp: Any) -> Any:
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def schema_for_type(tp: Any) -> Dict[str, Any]:
    """Python type -> OpenAPI v3 structural schema node."""
    tp = _unwrap_optional(tp)
    origin = typing.get_origin(tp)
    if origin in (list, typing.List):
        (item,) = typing.get_args(tp) or (Any,)
        return {"type": "array", "items": schema_for_type(item)}
    if origin in (dict, typing.Dict):
        args = typing.get_args(tp)
        val = args[1] if len(args) == 2 else Any
        return {
            "type": "object",
            "additionalProperties": schema_for_type(val),
        }
    return _schema_for_scalar(tp)


def _schema_for_scalar(tp: Any) -> Dict[str, Any]:
    if tp is Quantity:
        # apimachinery resource.Quantity serializes as a string
        return {"type": "string"}
    if dataclasses.is_dataclass(tp):
        return schema_for_dataclass(tp)
    if tp is int:
        return {"type": "integer"}
    if tp is float:
        return {"type": "number"}
    if tp is bool:
        return {"type": "boolean"}
    if tp is str:
        return {"type": "string"}
    # Any / unknown: accept arbitrary structure
    return {"x-kubernetes-preserve-unknown-fields": True}


def schema_for_dataclass(cls: type) -> Dict[str, Any]:
    hints = typing.get_type_hints(cls)
    props = {}
    for f in dataclasses.fields(cls):
        key = _FIELD_TO_KEY.get(f.name, snake_to_camel(f.name))
        props[key] = schema_for_type(hints[f.name])
    return {"type": "object", "properties": props}


def crd_manifest(kind: str) -> Dict[str, Any]:
    info = CRD_KINDS[kind]
    cls = info["cls"]
    hints = typing.get_type_hints(cls)
    spec_schema = schema_for_type(hints["spec"])
    status_schema = schema_for_type(hints["status"])
    version: Dict[str, Any] = {
        "name": VERSION,
        "served": True,
        "storage": True,
        "schema": {
            "openAPIV3Schema": {
                "type": "object",
                "properties": {
                    "apiVersion": {"type": "string"},
                    "kind": {"type": "string"},
                    "metadata": {"type": "object"},
                    "spec": spec_schema,
                    "status": status_schema,
                },
            }
        },
        "subresources": {"status": {}},
        "additionalPrinterColumns": info["printcolumns"],
    }
    if "scale" in info:
        version["subresources"]["scale"] = info["scale"]
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {
            "name": f"{info['plural']}.{GROUP}",
            "annotations": {
                # cert-manager CA injection for conversion/admission,
                # reference: config/crd kustomize patches
                "cert-manager.io/inject-ca-from": (
                    "karpenter/karpenter-serving-cert"
                ),
            },
        },
        "spec": {
            "group": GROUP,
            "names": {
                "kind": kind,
                "listKind": f"{kind}List",
                "plural": info["plural"],
                "singular": kind.lower(),
                "shortNames": info["shortNames"],
            },
            "scope": "Namespaced",
            "versions": [version],
        },
    }


def crd_yaml(kind: str) -> str:
    return yaml.safe_dump(
        crd_manifest(kind), sort_keys=False, default_flow_style=False
    )


def write_crds(config_dir: str) -> list:
    import os

    crd_dir = os.path.join(config_dir, "crd")
    os.makedirs(crd_dir, exist_ok=True)
    # the Helm chart installs CRDs via the crds/ convention (applied
    # before templates, never templated); write the SAME content there so
    # the chart can't drift from the types — both copies are codegen
    # outputs, pinned equal by tests/test_codegen.py
    chart_crds = os.path.join(
        os.path.dirname(os.path.abspath(os.path.normpath(config_dir))),
        "charts",
        "karpenter-tpu",
        "crds",
    )
    chart_present = os.path.isdir(os.path.dirname(chart_crds))
    if chart_present:
        os.makedirs(chart_crds, exist_ok=True)
    written = []
    for kind, info in CRD_KINDS.items():
        content = crd_yaml(kind)
        path = os.path.join(crd_dir, f"{GROUP}_{info['plural']}.yaml")
        with open(path, "w") as f:
            f.write(content)
        written.append(path)
        if chart_present:
            chart_path = os.path.join(
                chart_crds, f"{GROUP}_{info['plural']}.yaml"
            )
            with open(chart_path, "w") as f:
                f.write(content)
            written.append(chart_path)
    return written


# ---------------------------------------------------------------------------
# API reference docs (the reference generates docs/README.md with
# gen-crd-api-reference-docs, Makefile:72-77; here the same reference is
# rendered straight from the dataclasses that ARE the schema)
# ---------------------------------------------------------------------------


def _type_label(tp: Any) -> str:
    tp = _unwrap_optional(tp)
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # non-Optional unions, e.g. int | str
        # \| keeps the label inside one markdown table cell
        return " \\| ".join(
            _type_label(arg)
            for arg in typing.get_args(tp)
            if arg is not type(None)
        )
    if origin in (list, typing.List):
        (item,) = typing.get_args(tp) or (Any,)
        return f"[]{_type_label(item)}"
    if origin in (dict, typing.Dict):
        args = typing.get_args(tp)
        val = _type_label(args[1]) if len(args) == 2 else "object"
        return f"map[string]{val}"
    if dataclasses.is_dataclass(tp):
        return f"[{tp.__name__}](#{tp.__name__.lower()})"
    return getattr(tp, "__name__", str(tp))


def _field_default_label(f) -> str:
    if f.default is not dataclasses.MISSING:
        return repr(f.default)
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f.default_factory.__name__ + "()"
    return ""


def _render_class_docs(cls, queue: list) -> list:
    """Markdown section for one API dataclass; nested dataclass types are
    appended to `queue` for later sections."""
    lines = [f"## {cls.__name__}", ""]
    doc = (cls.__doc__ or "").strip()
    if doc and not doc.startswith(f"{cls.__name__}("):
        # real docstring (the auto-generated dataclass signature is noise)
        lines.append(doc.split("\n\n")[0])
        lines.append("")
    lines.append("| Field | Type | Default |")
    lines.append("|---|---|---|")
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        key = _FIELD_TO_KEY.get(f.name, snake_to_camel(f.name))
        tp = _unwrap_optional(hints[f.name])
        if dataclasses.is_dataclass(tp):
            queue.append(tp)
        else:
            for arg in typing.get_args(tp):
                arg = _unwrap_optional(arg)
                if dataclasses.is_dataclass(arg):
                    queue.append(arg)
        default = _field_default_label(f)
        lines.append(f"| `{key}` | {_type_label(hints[f.name])} | {default} |")
    lines.append("")
    return lines


def api_docs_markdown() -> str:
    """One markdown API reference for the three CRDs, generated from the
    API dataclasses (single source of truth with the CRD schemas above)."""
    lines = [
        "# API reference",
        "",
        f"Group `{GROUP}`, version `{VERSION}`. Generated by "
        f"`make docs` from `{DOCS_SOURCE}` — do not edit by hand.",
        "",
    ]
    rendered = set()
    queue = [CRD_KINDS[kind]["cls"] for kind in CRD_KINDS]
    while queue:
        cls = queue.pop(0)
        if cls.__name__ in rendered:
            continue
        rendered.add(cls.__name__)
        lines.extend(_render_class_docs(cls, queue))
    return "\n".join(lines)


def write_api_docs(path: str = "docs/API.md") -> str:
    with open(path, "w") as f:
        f.write(api_docs_markdown())
    return path


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if args and args[0] == "--docs":
        print(f"wrote {write_api_docs(args[1] if len(args) > 1 else 'docs/API.md')}")
        return 0
    config_dir = args[0] if args else "config"
    for path in write_crds(config_dir):
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
