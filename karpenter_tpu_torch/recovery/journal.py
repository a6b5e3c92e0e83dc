"""Durable file replacement and the journal's key codec (copies of
`atomic_write`, `key_str` and `key_tuple` from
karpenter_tpu/recovery/journal.py; the journal itself comes with a later
slice)."""

from __future__ import annotations

import json
import os


def key_str(key: tuple) -> str:
    """Tuple key -> canonical JSON string (nested tuples become lists)."""

    def listify(x):
        if isinstance(x, (tuple, list)):
            return [listify(e) for e in x]
        return x

    return json.dumps(listify(key), sort_keys=True, separators=(",", ":"))


def key_tuple(s: str) -> tuple:
    """JSON string key -> tuple (nested lists become tuples)."""

    def tupleize(x):
        if isinstance(x, list):
            return tuple(tupleize(e) for e in x)
        return x

    return tupleize(json.loads(s))


def atomic_write(path: str, text: str, dir_fsync: bool = True) -> None:
    """Durably replace `path` with `text`: tmp write + fsync + rename +
    directory fsync, so a crash at any point leaves either the old file
    or the new one, never a torn mix."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if dir_fsync:
        dir_fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
