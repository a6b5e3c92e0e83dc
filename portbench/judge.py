"""The comparison that decides `correct`: the program's answers against
the plain reference's, leaf by leaf, over the answers the run checks.

Numbers (each held to the limit the configuration file states):
- `int_mismatches`: integer and boolean elements that differ (exact; a
  leaf missing from the answer, or of another shape, counts each of its
  elements);
- `unanswered`: requests that raised or never returned.
A reference leaf of floats is refused: no configuration states a float
output yet, and a comparison for one needs its own number and limit.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    elif tree is not None:
        yield prefix[:-1], np.asarray(tree)


def int_mismatches(got, want) -> int:
    """Integer and boolean elements of one answer that differ from the
    reference's."""
    got_leaves = dict(_leaves(got))
    ints = 0
    for path, ref in _leaves(want):
        if ref.dtype.kind == "f":
            raise ValueError(f"{path}: float leaves have no comparison")
        ans = got_leaves.get(path)
        if ans is None or ans.shape != ref.shape:
            ints += max(1, ref.size)
            continue
        ints += int(np.count_nonzero(ans.astype(np.int64)
                                     != ref.astype(np.int64)))
    return ints


def judge(pairs: Iterable[Tuple[object, object]], unanswered: int,
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {number: {"value", "limit"}}) over (answer, reference)
    pairs. Every number the configuration gives a limit is reported;
    correct holds when at least one answer was judged and no number
    passes its limit."""
    values = {"int_mismatches": 0.0, "unanswered": float(unanswered)}
    n = 0
    for got, want in pairs:
        values["int_mismatches"] += int_mismatches(got, want)
        n += 1
    checks = {name: {"value": values[name], "limit": float(limit)}
              for name, limit in limits.items()}
    correct = n > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
