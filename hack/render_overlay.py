#!/usr/bin/env python3
"""Render one of this repo's kustomize trees without kustomize.

Usage: python3 hack/render_overlay.py config/torch > rendered.yaml

`render(directory)` reads `directory/kustomization.yaml` and returns the
documents `kubectl kustomize directory` emits, in resource order (kustomize
itself may sort them by kind). It understands only what the repo's trees
use, and raises `Unsupported` on anything else, so a tree that grows a
feature this reader cannot render fails loudly instead of being rendered
wrong:

  * `resources`: YAML files, and directories that hold a
    kustomization.yaml (rendered recursively);
  * `patches` with a `target` (group, version, kind, name, namespace) and
    an inline `patch` that is a JSON 6902 operation list with the ops
    add, remove, replace and test.

Where kubectl is at hand, `kubectl kustomize` renders the same trees.
"""

from __future__ import annotations

import copy
import pathlib
import sys

import yaml

KUSTOMIZATION_KEYS = {"apiVersion", "kind", "resources", "patches"}
TARGET_KEYS = {"group", "version", "kind", "name", "namespace"}
OPS = {"add", "remove", "replace", "test"}


class Unsupported(ValueError):
    """A kustomization feature this reader does not render."""


def render(directory) -> list:
    """The documents of the kustomize tree at `directory`."""
    root = pathlib.Path(directory)
    kustomization = yaml.safe_load((root / "kustomization.yaml").read_text())
    unknown = set(kustomization) - KUSTOMIZATION_KEYS
    if unknown:
        raise Unsupported(f"{root}/kustomization.yaml uses {sorted(unknown)}")
    docs = []
    for rel in kustomization.get("resources") or []:
        docs.extend(_resource(root / rel))
    for entry in kustomization.get("patches") or []:
        _patch(docs, entry, root)
    return docs


def _resource(path: pathlib.Path) -> list:
    if path.is_dir():
        if not (path / "kustomization.yaml").is_file():
            raise Unsupported(f"{path}: a directory without kustomization.yaml")
        return render(path)
    if not path.is_file():
        raise Unsupported(f"{path}: not a file or a directory (remote?)")
    return [d for d in yaml.safe_load_all(path.read_text()) if d is not None]


def _matches(doc: dict, target: dict) -> bool:
    group, _, version = doc.get("apiVersion", "").rpartition("/")
    meta = doc.get("metadata") or {}
    have = {"group": group, "version": version, "kind": doc.get("kind"),
            "name": meta.get("name"), "namespace": meta.get("namespace")}
    return all(have[key] == value for key, value in target.items())


def _patch(docs: list, entry: dict, root: pathlib.Path) -> None:
    if set(entry) != {"target", "patch"}:
        raise Unsupported(f"{root}: a patch with {sorted(entry)} (only an "
                          "inline JSON 6902 patch with a target is rendered)")
    target = entry["target"]
    if not set(target) <= TARGET_KEYS:
        raise Unsupported(f"{root}: a patch target with {sorted(target)}")
    ops = yaml.safe_load(entry["patch"])
    if not isinstance(ops, list):
        raise Unsupported(f"{root}: a strategic-merge patch (not a JSON "
                          "6902 operation list)")
    hits = [i for i, doc in enumerate(docs) if _matches(doc, target)]
    if not hits:
        raise ValueError(f"{root}: the patch target {target} matches nothing")
    for i in hits:
        doc = copy.deepcopy(docs[i])
        for op in ops:
            apply_op(doc, op)
        docs[i] = doc


def _tokens(path: str) -> list:
    if not path.startswith("/"):
        raise ValueError(f"a JSON pointer starts with '/': {path!r}")
    return [t.replace("~1", "/").replace("~0", "~")
            for t in path[1:].split("/")]


def _index(node: list, token: str, adding: bool) -> int:
    if adding and token == "-":
        return len(node)
    index = int(token)
    if not 0 <= index < len(node) + (1 if adding else 0):
        raise ValueError(f"index {index} out of range {len(node)}")
    return index


def _walk(doc, path: str):
    """(the node that holds the pointer's last token, that token)."""
    *parents, last = _tokens(path)
    node = doc
    for token in parents:
        node = (node[_index(node, token, False)] if isinstance(node, list)
                else node[token])
    return node, last


def _existing(node, token: str, path: str):
    if isinstance(node, list):
        return _index(node, token, False)
    if token not in node:
        raise ValueError(f"{path}: no such member")
    return token


def apply_op(doc, op: dict) -> None:
    """One JSON 6902 operation (add, remove, replace or test) on `doc`,
    in place; a failed test or a missing path raises ValueError."""
    kind = op.get("op")
    if kind not in OPS:
        raise Unsupported(f"JSON 6902 op {kind!r}")
    node, last = _walk(doc, op["path"])
    if kind == "add":
        value = copy.deepcopy(op["value"])
        if isinstance(node, list):
            node.insert(_index(node, last, True), value)
        else:
            node[last] = value
        return
    key = _existing(node, last, op["path"])
    if kind == "test":
        if node[key] != op["value"]:
            raise ValueError(f"test {op['path']}: {node[key]!r} != "
                             f"{op['value']!r}")
    elif kind == "remove":
        del node[key]
    else:
        node[key] = copy.deepcopy(op["value"])


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__.splitlines()[2], file=sys.stderr)
        return 2
    yaml.safe_dump_all(render(argv[0]), sys.stdout, sort_keys=False)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
