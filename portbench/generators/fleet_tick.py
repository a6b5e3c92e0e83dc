"""Generator: one cluster's HorizontalAutoscaler fleet per client, ticking.

Each client owns one fleet, drawn by reference/fleet_draws.py at the
configuration's sizes (`has` autoscalers x `metrics`, `series` forecast
series of `history` samples, `groups` pool groups of `pools` pools) from
(seed, client). Each request is one tick `tick_s` seconds after the
last: `now` advances by `tick_s`, every series' window slides by one
sample (the oldest leaves; the newest value, its valid bit and its time,
`tick_s` after the last, are drawn), and the observed metric values and
their valid bits are drawn anew, all from (seed, client, k) in the
draw's ranges. Replicas are not fed back from the answers, so a request
is a pure function of (seed, client, k) and `replay` rebuilds any one.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable

import numpy as np

from portbench import traffic
from portbench.reference import fleet_draws

# SeedSequence streams: (seed, stream, ...)
_FLEET, _TICK = range(2)


class Traffic:
    def __init__(self, config: dict, mix: dict, seed: int):
        self.seed = seed
        self.clients = int(mix["clients"])
        self.tick_s = float(config["tick_s"])
        self.pristine = [
            fleet_draws.build_fused_tick_inputs(
                np.random.MT19937(traffic.seed_sequence(seed, _FLEET, c)),
                int(config["has"]), int(config["metrics"]),
                int(config["series"]), int(config["history"]),
                groups=int(config["groups"]), pools=int(config["pools"]))
            for c in range(self.clients)
        ]
        self.live = [copy.deepcopy(f) for f in self.pristine]

    def operands(self, client: int) -> dict:
        return self.live[client]

    def _apply(self, fields: dict, client: int, k: int) -> None:
        rng = np.random.default_rng(
            traffic.seed_sequence(self.seed, _TICK, client, k))
        dec, fc = fields["decision"], fields["forecast"]
        n, m = dec["metric_value"].shape
        s = fc["values"].shape[0]
        dec["now"] = np.float32(np.float64(dec["now"]) + self.tick_s)
        dec["metric_value"] = rng.uniform(0, 100, (n, m)).astype(np.float32)
        dec["metric_valid"] = rng.random((n, m)) > 0.2
        newest = {
            "values": rng.uniform(0, 100, s).astype(np.float32),
            "valid": rng.random(s) > 0.2,
            "times": (fc["times"][:, -1].astype(np.float64)
                      + self.tick_s).astype(np.float32),
        }
        for name, column in newest.items():
            fc[name] = np.concatenate([fc[name][:, 1:], column[:, None]], 1)

    def update(self, client: int, k: int) -> None:
        """Turn the client's live fleet into request k's tick."""
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
