"""Small functional helpers (reference: pkg/utils/functional/functional.go:24-91).

merge_into reproduces the JSON-merge defaulting trick the reference uses for
scaling-rule defaults (horizontalautoscaler.go:249-265): fields that are set
(non-None) on src overlay the corresponding fields on dest.
"""

from __future__ import annotations

import dataclasses


def merge_into(dest, *srcs):
    """Overlay non-None dataclass fields of each src onto dest, in order."""
    for src in srcs:
        if src is None:
            continue
        for field in dataclasses.fields(src):
            value = getattr(src, field.name)
            if value is not None:
                setattr(dest, field.name, value)
    return dest


def pad_to_multiple(n: int, bucket: int) -> int:
    """Round n up to a multiple of bucket, with a floor of one bucket.

    The shared padding policy for compiled shapes (solver universes, mesh
    divisibility): sizes GROW to the next bucket so recompiles happen only on
    bucket crossings, and padded slots are masked, never truncated.
    """
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)
