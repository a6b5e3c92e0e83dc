"""What every generator and the harness share: the seed's streams and the
schedule requests are sent on.

A generator is a module under generators/, named by the configuration's
"generator" key (or the mix's, which takes precedence), with a class
`Traffic(config, mix, seed)`: `clients`, `operands(client)` (the operands
the client's next request hands the program), `update(client, k)` (turn
them into request k's, before it is sent) and `replay(client, ks)` ({k:
a copy of request k's operands}, for the judge). Its draws come from the
seed through `seed_sequence`, so any whole number is a seed and the same
seed gives the same operands.

Schedule: `clients` clients, together offering `rate_per_s` requests a
second; client c's request k is due at (k + c / clients) * clients /
rate_per_s after the window opens, and is sent when it is due or, if the
client's previous request is still out, when that one returns.
"""

from __future__ import annotations

import numpy as np

_SAMPLE = 4  # the judge's stream; generators use streams 0-3 and 5 on


def seed_sequence(seed: int, *words: int) -> np.random.SeedSequence:
    """The stream `words` of a seed; any whole number is a seed."""
    return np.random.SeedSequence([int(seed) % 2**64, *words])


def due_offset(client: int, k: int, clients: int, rate_per_s: float) -> float:
    """Seconds after the window opens at which client's request k is due."""
    return (k + client / clients) * clients / rate_per_s


def sampler_rng(seed: int, client: int) -> np.random.Generator:
    """The stream that picks which of a client's answers are judged."""
    return np.random.default_rng(seed_sequence(seed, _SAMPLE, client))
