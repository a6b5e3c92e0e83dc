"""Self-SLO monitor: the control plane watches its OWN service level.

An SLO-driven autoscaler must account for its decisions AND notice when
it is the thing violating an SLO (PAPERS.md: "An SLO Driven and
Cost-Aware Autoscaling Framework for Kubernetes"); the lead-time
discipline of BLITZSCALE only pays off if a regression in
`karpenter_reconcile_e2e_seconds` is detected by the system itself, not
by a human reading dashboards after the fact. This module runs the
classic MULTI-WINDOW, MULTI-BURN-RATE evaluation (the SRE-workbook
alerting shape) over the control plane's own health signals:

  * the existing `karpenter_reconcile_e2e_seconds` histogram — each
    evaluation reads (samples <= objective, total samples) cumulatively
    (HistogramVec.le_totals) and the delta since the last evaluation is
    this tick's good/bad event stream;
  * the solver backend-health FSM — a degraded FSM contributes one BAD
    control-health event per evaluation (the plane is serving numpy-
    degraded decisions), a healthy one a good event. This is what lets
    a 100%-fault chaos run burn the budget even while no actuations
    complete;
  * per-tenant breakers (the MultiTenantScheduler board) — each OPEN
    breaker is a bad event per evaluation, each closed tenant a good
    one, and the per-tenant view feeds the /debug/selfslo scoreboard;
  * the device-memory high watermark (the solver introspection plane,
    observability/devicetelemetry.py, --introspect) — a tick whose
    bytes_in_use/bytes_limit crossed the watermark on any device is a
    bad event, a healthy poll a good one, and no telemetry (plane off,
    or a backend without memory stats) contributes nothing.

Each window (fast 5m/1h page pair + slow 6h/3d ladder) gets a BURN RATE
— (bad/total over the window) / error budget — published as
`karpenter_selfslo_burn_rate{name=<window>}` with
`karpenter_selfslo_budget_remaining{name=<window>}` (fraction of the
window's error budget unspent) and
`karpenter_selfslo_window_violations_total{name=<window>}`. When BOTH
fast windows exceed their threshold the monitor trips: it records a
`selfslo_burn` flight-recorder event — a trip-class kind, so the ring
auto-dumps into --journal-dir with trace backlinks (the flight recorder's dump machinery)
— and `karpenter_selfslo_tripped` goes 1 until the fast window's burn
falls back under threshold (hysteresis: one dump per incident, not one
per tick). Budget RECOVERS as bad events age out of the sliding
windows; the chaos suite pins trip -> dump -> post-fault recovery.

State is a bounded list of cumulative (ts, good, bad) snapshots — one
tuple per evaluation (the manager tick), pruned past the longest
window; window deltas are bisect lookups. O(1) per tick, no per-event
Python objects.

The port's copy of karpenter_tpu/observability/selfslo.py.
"""

from __future__ import annotations

import bisect
import time as _time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

SUBSYSTEM = "selfslo"

# flight-recorder kind for a fast-burn trip (flightrecorder.DUMP_KINDS
# includes it: a burn trip is exactly the "degradation an operator wants
# the surrounding context for" the dump discipline exists for)
BURN_EVENT = "selfslo_burn"


@dataclass(frozen=True)
class BurnWindow:
    """One evaluation window: `threshold` is the burn rate that counts
    as a violation (SRE-workbook defaults: the page pair burns 14.4x —
    2% of a 30d budget in 1h — and the slow ladder 6x / 1x)."""

    name: str
    seconds: float
    threshold: float


DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow("5m", 300.0, 14.4),
    BurnWindow("1h", 3600.0, 14.4),
    BurnWindow("6h", 21600.0, 6.0),
    BurnWindow("3d", 259200.0, 1.0),
)


class SelfSLOMonitor:
    """One per runtime (module docstring); `evaluate()` runs on the
    manager tick hook.

    Seams (all optional, so tests compose pieces freely):
      histogram      the karpenter_reconcile_e2e_seconds HistogramVec
                     (anything with `.le_totals(bound) -> (good, total)`)
      fsm_source     () -> "healthy" | "degraded" (SolverService
                     .backend_health)
      tenant_source  () -> {tenant_id: breaker_open_bool}
      memory_source  () -> Optional[bool] — the device-memory
                     high-watermark trip from the solver introspection
                     plane (observability/devicetelemetry.py): True =
                     breached (bad event), False = healthy (good),
                     None = no telemetry (disabled plane or a backend
                     without memory stats) — contributes no event
      replica_source () -> Optional[bool] — the replicated control
                     plane's health (replication/plane.py slo_source):
                     True = mid-failover (lease renew failures or
                     tenants still warming; bad event), False =
                     serving steadily (good), None = replication off
                     or no lease round yet — contributes no event
      recorder       the flight recorder burn trips dump through
                     (default: the process default)
    """

    def __init__(
        self,
        registry=None,
        objective_s: float = 1.0,
        target: float = 0.99,
        clock=_time.time,
        histogram=None,
        fsm_source: Optional[Callable[[], str]] = None,
        tenant_source: Optional[Callable[[], Dict[str, bool]]] = None,
        memory_source: Optional[Callable[[], Optional[bool]]] = None,
        replica_source: Optional[Callable[[], Optional[bool]]] = None,
        recorder=None,
        windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
    ):
        if not 0.0 < target < 1.0:
            raise ValueError(f"selfslo target must be in (0, 1): {target}")
        self.objective_s = objective_s
        self.target = target
        self.error_budget = 1.0 - target
        self.clock = clock
        self.histogram = histogram
        self.fsm_source = fsm_source
        self.tenant_source = tenant_source
        self.memory_source = memory_source
        self.replica_source = replica_source
        self._recorder = recorder
        self.windows = tuple(windows)
        # cumulative snapshot series, one entry per evaluate(): parallel
        # lists (ts sorted ascending) pruned past the longest window
        self._ts: list = []
        self._good: list = []
        self._bad: list = []
        self._cum_good = 0
        self._cum_bad = 0
        self._last_hist: Tuple[int, int] = (0, 0)
        self.tripped = False
        self.trips_total = 0
        self._last_eval: Optional[dict] = None
        self._g_burn = self._g_budget = self._c_violations = None
        self._g_tripped = None
        if registry is not None:
            self._g_burn = registry.register(SUBSYSTEM, "burn_rate")
            self._g_budget = registry.register(
                SUBSYSTEM, "budget_remaining"
            )
            self._c_violations = registry.register(
                SUBSYSTEM, "window_violations_total", kind="counter"
            )
            self._g_tripped = registry.register(SUBSYSTEM, "tripped")
            self._g_tripped.set("-", "-", 0.0)

    def _recorder_or_default(self):
        if self._recorder is not None:
            return self._recorder
        from karpenter_tpu_torch.observability.flightrecorder import (
            default_flight_recorder,
        )

        return default_flight_recorder()

    # -- the per-tick evaluation -------------------------------------------

    def _hist_events(self) -> Tuple[int, int]:
        if self.histogram is None:
            return 0, 0
        le, total = self.histogram.le_totals(self.objective_s)
        last_le, last_total = self._last_hist
        d_total = max(0, total - last_total)
        d_le = min(max(0, le - last_le), d_total)
        self._last_hist = (le, total)
        return d_le, d_total - d_le

    def _fsm_events(self) -> Tuple[int, int]:
        if self.fsm_source is None:
            return 0, 0
        if self.fsm_source() == "healthy":
            return 1, 0
        return 0, 1

    def _tenant_events(self) -> Tuple[int, int]:
        if self.tenant_source is None:
            return 0, 0
        opens = list(self.tenant_source().values())
        bad = sum(1 for is_open in opens if is_open)
        return len(opens) - bad, bad

    def _memory_events(self) -> Tuple[int, int]:
        """The FOURTH source (observability/devicetelemetry.py):
        device HBM pressure burns budget like a degraded FSM — None
        (no telemetry) stays quiet, contributing no event."""
        if self.memory_source is None:
            return 0, 0
        high = self.memory_source()
        if high is True:
            return 0, 1
        if high is False:
            return 1, 0
        return 0, 0

    def _replica_events(self) -> Tuple[int, int]:
        """The FIFTH source (karpenter_tpu/replication, the /debug/
        replicas scoreboard): a replica mid-failover — held-lease renew
        failures or tenants still in handoff warm-up — burns budget
        like a degraded FSM; None (replication off, or no lease round
        yet) stays quiet."""
        if self.replica_source is None:
            return 0, 0
        degraded = self.replica_source()
        if degraded is True:
            return 0, 1
        if degraded is False:
            return 1, 0
        return 0, 0

    def _collect(self) -> Tuple[int, int]:
        """(good, bad) increments for THIS evaluation across the five
        sources. Source failures degrade to 'no events', never raise —
        the monitor must not take the tick down with it."""
        good = bad = 0
        for source in (
            self._hist_events, self._fsm_events,
            self._tenant_events, self._memory_events,
            self._replica_events,
        ):
            try:
                d_good, d_bad = source()
            except Exception:  # noqa: BLE001 — observation only
                continue
            good += d_good
            bad += d_bad
        return good, bad

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One monitoring pass: fold the sources' increments into the
        snapshot series, compute every window's burn rate, publish the
        gauges, and trip/recover the fast-burn alarm."""
        if now is None:
            now = self.clock()
        good, bad = self._collect()
        self._cum_good += good
        self._cum_bad += bad
        self._ts.append(now)
        self._good.append(self._cum_good)
        self._bad.append(self._cum_bad)
        self._prune(now)

        windows: Dict[str, dict] = {}
        for window in self.windows:
            burn, budget_remaining, d_bad, d_total = self._window_burn(
                now, window.seconds
            )
            violating = burn > window.threshold
            windows[window.name] = {
                "seconds": window.seconds,
                "burn_rate": round(burn, 4),
                "budget_remaining": round(budget_remaining, 4),
                "threshold": window.threshold,
                "violating": violating,
                "bad": d_bad,
                "total": d_total,
            }
            if self._g_burn is not None:
                self._g_burn.set(window.name, "-", burn)
                self._g_budget.set(window.name, "-", budget_remaining)
                if violating:
                    self._c_violations.inc(window.name, "-")
        self._update_trip(now, windows)
        self._last_eval = {
            "at": now,
            "objective_s": self.objective_s,
            "target": self.target,
            "tripped": self.tripped,
            "windows": windows,
        }
        return self._last_eval

    def _prune(self, now: float) -> None:
        horizon = now - max(w.seconds for w in self.windows) - 1.0
        cut = bisect.bisect_left(self._ts, horizon)
        # keep one snapshot BEFORE the horizon as the delta baseline
        cut = max(0, cut - 1)
        if cut:
            del self._ts[:cut]
            del self._good[:cut]
            del self._bad[:cut]

    def _window_burn(
        self, now: float, seconds: float
    ) -> Tuple[float, float, int, int]:
        """(burn_rate, budget_remaining, bad, total) over the trailing
        window: deltas against the newest snapshot at or before the
        window start (cumulative series, so this is exact)."""
        start = now - seconds
        i = bisect.bisect_right(self._ts, start) - 1
        base_good = self._good[i] if i >= 0 else 0
        base_bad = self._bad[i] if i >= 0 else 0
        d_good = self._cum_good - base_good
        d_bad = self._cum_bad - base_bad
        d_total = d_good + d_bad
        if d_total <= 0:
            return 0.0, 1.0, 0, 0
        ratio = d_bad / d_total
        burn = ratio / self.error_budget
        allowed = self.error_budget * d_total
        budget_remaining = max(0.0, 1.0 - d_bad / allowed)
        return burn, budget_remaining, d_bad, d_total

    def _update_trip(self, now: float, windows: Dict[str, dict]) -> None:
        """Page-pair trip with hysteresis: BOTH fast windows over
        threshold arms the trip (one selfslo_burn event + auto-dump per
        incident); the FAST window dropping back under re-arms."""
        fast = [windows[w.name] for w in self.windows[:2]]
        firing = len(fast) >= 2 and all(w["violating"] for w in fast)
        if firing and not self.tripped:
            self.tripped = True
            self.trips_total += 1
            if self._g_tripped is not None:
                self._g_tripped.set("-", "-", 1.0)
            self._recorder_or_default().record(
                BURN_EVENT,
                objective_s=self.objective_s,
                target=self.target,
                burn_fast=fast[0]["burn_rate"],
                burn_slow=fast[1]["burn_rate"],
                window_fast=self.windows[0].name,
                window_slow=self.windows[1].name,
            )
        elif self.tripped and not fast[0]["violating"]:
            self.tripped = False
            if self._g_tripped is not None:
                self._g_tripped.set("-", "-", 0.0)

    # -- the debug surface -------------------------------------------------

    def _board_solver_backend(self) -> str:
        try:
            return self.fsm_source()
        except Exception:  # noqa: BLE001 — observation only
            return "unknown"

    def _board_device_memory(self) -> str:
        try:
            high = self.memory_source()
        except Exception:  # noqa: BLE001 — observation only
            return "unknown"
        if high is None:
            return "off"
        return "high" if high else "ok"

    def _board_tenants(self) -> Dict[str, dict]:
        try:
            return {
                tenant: {
                    "breaker_open": bool(is_open),
                    "degraded": bool(is_open),
                }
                for tenant, is_open in sorted(
                    self.tenant_source().items()
                )
            }
        except Exception:  # noqa: BLE001 — observation only
            return {}

    def scoreboard(self) -> dict:
        """/debug/selfslo: the last evaluation plus the per-tenant
        degradation view (breaker state per tenant), the solver FSM,
        and the device-memory posture — the 'how degraded is the
        control plane, and for whom' page."""
        board = dict(self._last_eval or {
            "at": None,
            "objective_s": self.objective_s,
            "target": self.target,
            "tripped": self.tripped,
            "windows": {},
        })
        board["trips_total"] = self.trips_total
        if self.fsm_source is not None:
            board["solver_backend"] = self._board_solver_backend()
        if self.memory_source is not None:
            board["device_memory"] = self._board_device_memory()
        if self.tenant_source is not None:
            board["tenants"] = self._board_tenants()
        return board
