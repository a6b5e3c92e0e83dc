"""The control of `correct`: the plain reference computed one precision
below the configuration's (bfloat16 for its float32: the reference
module's `control`), put in the program's place and judged by the same
comparison, must come out as not correct. The benchmark's own runs never
run it.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3

For each seed it draws the cell's traffic, takes from each client a
request drawn from the seed among its first `--requests` (as many
answers as a run checks), answers it with the control, and judges the
answers against the reference's. It prints one line per seed with every
number beside the configuration's limit, and exits 0 when the control
failed on every seed, 1 when it passed on any.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

from portbench import harness, judge, traffic


def readings(cell: harness.Cell, seed: int, requests: int) -> Dict[str, dict]:
    gen = cell.traffic(seed)
    reference = cell.module("reference")
    per_client = int(cell.mix["sample_per_client"])
    pairs = []
    for c in range(gen.clients):
        rng = traffic.sampler_rng(seed, c)
        ks = rng.choice(requests, min(per_client, requests), replace=False)
        for k, ops in gen.replay(c, ks.tolist()).items():
            want = harness.compared(reference,
                                    reference.answer(cell.config, ops))
            pairs.append((reference.control(cell.config, ops), want))
    _, checks = judge.judge(pairs, 0, cell.config["limits"])
    return checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--requests", type=int, default=100,
                        help="draw each checked request among a client's "
                             "first this many")
    args = parser.parse_args(argv)
    cell = harness.find_cell(args.workload)
    failed_every_seed = True
    for seed in args.seeds:
        checks = readings(cell, seed, args.requests)
        fails = any(c["value"] > c["limit"] for c in checks.values())
        failed_every_seed &= fails
        print(f"control {args.workload} seed {seed}: "
              + ", ".join(f"{n} {c['value']!r} (limit {c['limit']!r})"
                          for n, c in checks.items())
              + (" -> not correct" if fails else " -> PASSED"), flush=True)
    return 0 if failed_every_seed else 1


if __name__ == "__main__":
    sys.exit(main())
