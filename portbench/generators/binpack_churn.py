"""Generator: pending-pods snapshots that churn, one per client.

Each client owns a snapshot of the pending-pods problem, drawn by
reference/draws.build_inputs at the configuration's sizes (`pods`,
`types`, `taints`, `labels`, and the mix's `affinity`, a share of pods
with a dense pod_group_forbidden row). Each request replaces
`churn_rows` pod rows (every pod_* operand) with rows of a pool of
`pool_rows` drawn at set-up, in place, and hands the program the
snapshot's arrays: new host operands on every request.

A mix's `dedicated` list reserves instance types for groups of pods, as
taints and labels do for GPU or licensed nodes: group i marks the next
`types` types from the end of the (price-ordered) list with taint
column `taint` and label column `label`; a `share` of the pods require
that label and tolerate that taint, and every other pod does not
tolerate it.

Client c's k-th request is a pure function of (seed, c, k), so `replay`
rebuilds the operands of any request.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable

import numpy as np

from portbench import traffic
from portbench.reference import draws

# SeedSequence streams: (seed, stream, ...)
_SNAPSHOT, _POOL, _DEDICATED, _UPDATE = range(4)


class Traffic:
    def __init__(self, config: dict, mix: dict, seed: int):
        self.seed = seed
        self.clients = int(mix["clients"])
        self.churn_rows = int(mix["churn_rows"])
        self._mix = mix
        self._config = config
        self.pristine = [
            self._draw(int(config["pods"]),
                       traffic.seed_sequence(seed, _SNAPSHOT, c), c)
            for c in range(self.clients)
        ]
        pool = self._draw(int(mix["pool_rows"]),
                          traffic.seed_sequence(seed, _POOL), self.clients)
        self.pool = {name: a for name, a in pool.items()
                     if name.startswith("pod_")}
        self.live = [copy.deepcopy(s) for s in self.pristine]

    def _draw(self, pods: int, seq, stream: int) -> Dict[str, np.ndarray]:
        config, mix = self._config, self._mix
        types = int(config["types"])
        fields = draws.build_inputs(
            pods, types, int(config["taints"]), int(config["labels"]), seq,
            affinity=float(mix.get("affinity", 0.0)))
        groups = mix.get("dedicated", ())
        if groups:
            rng = np.random.default_rng(
                traffic.seed_sequence(self.seed, _DEDICATED, stream))
            u = rng.random(pods)
            hi, lo_share = types, 0.0
            for group in groups:
                lo = hi - int(group["types"])
                k, lab = int(group["taint"]), int(group["label"])
                mine = (lo_share <= u) & (u < lo_share + group["share"])
                ours = (np.arange(types) >= lo) & (np.arange(types) < hi)
                fields["group_taints"][:, k] = ours
                fields["group_labels"][:, lab] = ours
                fields["pod_intolerant"][:, k] = ~mine
                fields["pod_required"][:, lab] = mine
                hi, lo_share = lo, lo_share + group["share"]
        return fields

    def operands(self, client: int) -> Dict[str, np.ndarray]:
        return self.live[client]

    def _apply(self, fields, client: int, k: int) -> None:
        rng = np.random.default_rng(
            traffic.seed_sequence(self.seed, _UPDATE, client, k))
        n_pods = fields["pod_requests"].shape[0]
        rows = rng.choice(n_pods, self.churn_rows, replace=False)
        take = rng.integers(0, self.pool["pod_requests"].shape[0],
                            self.churn_rows)
        for name, rows_of_pool in self.pool.items():
            fields[name][rows] = rows_of_pool[take]

    def update(self, client: int, k: int) -> None:
        """Apply request k's churn to the client's live snapshot."""
        self._apply(self.live[client], client, k)

    def replay(self, client: int, ks: Iterable[int]) -> Dict[int, dict]:
        """{k: the operands request k was sent with} (copies)."""
        fields = copy.deepcopy(self.pristine[client])
        out, done = {}, 0
        for k in sorted(set(ks)):
            for j in range(done, k + 1):
                self._apply(fields, client, j)
            done = k + 1
            out[k] = copy.deepcopy(fields)
        return out
