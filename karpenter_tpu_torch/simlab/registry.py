"""The SimLab scenario registry (docs/simulator.md).

A `Scenario` is the declarative record that replaces the hand-grown
`__main__._run_simulation` dispatch chain: every `--simulate` world
registers NAME + one-line DESCRIPTION + the CLI FLAGS that select it +
a `select` predicate + a `run(args, store)` callable that replays the
world bit-identically (the pinned digests are the contract), plus —
for worlds promoted to the gym plane — a `trails(seed)` generator the
`SimEnv`/`BatchedSimEnv` core steps through the device seam.

`--simulate --list` prints `catalog_text()`, and the doc-drift lint in
tests/test_simlab.py holds the docs/simulator.md catalog table and
this registry in two-direction sync (the PR 12 metrics-lint pattern).

Selection order: predicates are evaluated in ascending `order`, first
match wins — this preserves the precedence the old elif chain encoded
(trace-only before constraints before eventloop ... before the default
karpenter world).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from karpenter_tpu_torch.simlab.env import SimParams, SimTrails


@dataclass(frozen=True)
class Scenario:
    """One registered simulation world (module docstring)."""

    name: str
    description: str  # one line, mirrored into docs/simulator.md
    flags: str  # the CLI spelling that selects it, for --list
    order: int  # selection precedence (ascending, first match wins)
    select: Callable[[object], bool]  # predicate over parsed args
    run: Callable[[object, object], None]  # (args, store) CLI replay
    seeded: bool = True  # honors --sim-seed
    default_seed: int = 0  # the hardcoded seed the digests pin
    trails: Optional[Callable[[int], SimTrails]] = None  # gym plane
    params: SimParams = field(default_factory=SimParams)


_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    if scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def scenarios() -> Dict[str, Scenario]:
    """Registered scenarios in selection (ascending `order`) order."""
    return dict(
        sorted(_REGISTRY.items(), key=lambda kv: kv[1].order)
    )


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(
            f"unknown scenario {name!r} (registered: {known})"
        ) from None


def select_for(args) -> Scenario:
    """The scenario whose predicate matches the parsed CLI args (first
    match in `order`; the default `karpenter` world matches always)."""
    for scenario in scenarios().values():
        if scenario.select(args):
            return scenario
    raise RuntimeError(
        "no scenario matched --simulate flags; the default world "
        "should be unconditional"
    )


def catalog() -> list:
    """Rows for --simulate --list and the docs drift lint: (name,
    description, flags, seeded)."""
    return [
        (s.name, s.description, s.flags, s.seeded)
        for s in scenarios().values()
    ]


def catalog_text() -> str:
    rows = catalog()
    name_w = max(len(r[0]) for r in rows)
    flags_w = max(len(r[2]) for r in rows)
    lines = ["Registered simulation scenarios (--simulate ...):", ""]
    for name, desc, flags, seeded in rows:
        seed_tag = "--sim-seed" if seeded else "fixed"
        lines.append(
            f"  {name:<{name_w}}  {flags:<{flags_w}}  "
            f"[{seed_tag}]  {desc}"
        )
    lines.append("")
    lines.append(
        "Seeded scenarios accept --sim-seed N; defaults reproduce the "
        "pinned digests."
    )
    return "\n".join(lines)
