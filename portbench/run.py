"""Runs one cell of the benchmark once, as the check calls it:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It needs the CUDA cards the cell asks for:
without them it exits 2 and prints no result. The last lines of standard
error are the numbers compared, each beside its limit; the last line of
standard output is the result, one JSON object. A run whose process holds
jax, jaxlib, flax or karpenter_tpu (the JAX package) once the window has
closed exits 3 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_tpu")


def forbidden_modules():
    """The loaded modules whose top-level name (before the first dot) is a
    forbidden one, compared whole: karpenter_tpu_torch is not
    karpenter_tpu."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)


def _card_line(torch) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    print(f"card: {_card_line(torch)}; torch {torch.__version__}",
          file=sys.stderr, flush=True)
    platform = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell.chips}
    outcome = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          device="cuda", started=STARTED, platform=platform)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in outcome.lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(outcome.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
