"""One loader for operator-supplied JSON-or-YAML config files.

Three CLI surfaces accept "a JSON or YAML file" (--what-if,
--tenant-config, --pricing-file) and each used to hand-roll the same
try-json-else-yaml sequence; format behavior (encoding, error shape)
now lives here once. JSON is tried first — every JSON document is valid
YAML, but json.loads is the cheaper and stricter parser, and a clear
json error message beats yaml's for the common case.

The port's copy of karpenter_tpu/utils/configfile.py, changed only in
its imports.
"""

from __future__ import annotations

from typing import Any


def load_json_or_yaml(path: str) -> Any:
    """Parse `path` as JSON, falling back to YAML. Raises ValueError
    (with the path) when neither parser accepts the content; I/O errors
    propagate as-is."""
    with open(path) as f:
        text = f.read()
    import json

    try:
        return json.loads(text)
    except ValueError:
        pass
    try:
        import yaml

        return yaml.safe_load(text)
    except Exception as error:  # noqa: BLE001 — unified parse error
        raise ValueError(
            f"{path}: neither valid JSON nor YAML ({error})"
        ) from error
