"""Durable file replacement (a copy of `atomic_write` from
karpenter_tpu/recovery/journal.py; the journal itself comes with a later
slice)."""

from __future__ import annotations

import os


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
