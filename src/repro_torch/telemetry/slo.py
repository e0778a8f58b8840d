"""Declarative SLOs over the metrics registry, with burn-rate windows
(the port of ``repro/telemetry/slo.py``, the same code).

An :class:`Slo` names a registry metric and an objective on it:

- histogram metrics are judged on a percentile
  (``serving.ttft_s p99 <= 1.0``),
- counter/gauge metrics on their value, optionally as a **ratio**
  against a second metric (``serving.cancelled_requests /
  serving.finished_requests <= 0.05``, ``kv.free_pages /
  kv.num_pages >= 0.05``).

:class:`SloMonitor` evaluates a set of objectives against the
process-global registry (pure host-side reads — it is safe to call every
engine step) and tracks each objective's **error budget burn** over
multiple trailing windows, SRE-style: each evaluation contributes a
good/bad event per SLO; the burn rate over a window is
``bad_fraction / budget_frac``; an SLO is *breaching* only when **all**
its windows burn at or above their factor, so a single bad step inside
an otherwise-healthy long window does not page.  Objectives whose
metrics have not been observed yet are vacuously healthy
(``observed=False``) rather than breaching at startup.

Results come back as a structured :class:`SloReport` (embedded in
``telemetry.export.health()``) and are mirrored into the registry as
``slo.<name>.ok`` / ``slo.<name>.value`` gauges plus ``slo.evaluations``
/ ``slo.violations`` counters.  Stdlib only; reads the registry, never
the device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Deque, Dict, List, Mapping, Optional, Tuple

# Import names straight from the submodule: the package re-exports a
# ``registry()`` *function* that shadows the submodule attribute.
from repro_torch.telemetry.registry import (Histogram, MetricsRegistry,
                                      registry as _global_registry)

__all__ = ["Slo", "SloStatus", "SloReport", "SloMonitor", "Window",
           "DEFAULT_WINDOWS", "default_slos"]


@dataclasses.dataclass(frozen=True)
class Window:
    """One burn-rate window: trailing ``span_s`` seconds must burn error
    budget at >= ``factor`` x the sustainable rate to count as hot."""

    name: str
    span_s: float
    factor: float = 1.0


# Short window catches fast burns; the long window keeps one bad step
# from paging.  Spans are sized for this repo's seconds-long serving
# runs, not a production week (override per monitor for real deploys).
DEFAULT_WINDOWS: Tuple[Window, ...] = (
    Window("short", span_s=2.0, factor=1.0),
    Window("long", span_s=30.0, factor=1.0),
)


@dataclasses.dataclass(frozen=True)
class Slo:
    """One objective over a registry metric.

    ``objective`` is ``"max"`` (value must stay <= threshold) or
    ``"min"`` (>=).  ``percentile`` selects the statistic for histogram
    metrics; ``total`` divides the value by another metric's value
    (ratio objectives).
    """

    name: str
    metric: str
    objective: str          # "max" | "min"
    threshold: float
    percentile: Optional[float] = None
    total: Optional[str] = None

    def __post_init__(self):
        if self.objective not in ("max", "min"):
            raise ValueError(f"slo {self.name}: objective must be 'max' or "
                             f"'min', got {self.objective!r}")

    def describe(self) -> str:
        stat = self.metric
        if self.percentile is not None:
            stat += f" p{self.percentile:g}"
        if self.total is not None:
            stat += f" / {self.total}"
        op = "<=" if self.objective == "max" else ">="
        return f"{stat} {op} {self.threshold:g}"


@dataclasses.dataclass(frozen=True)
class SloStatus:
    """One objective's verdict at one evaluation."""

    name: str
    objective: str          # human-readable, e.g. "serving.ttft_s p99 <= 1"
    value: Optional[float]  # None when the metric has no observations yet
    threshold: float
    ok: bool                # vacuously True when not observed
    observed: bool
    burn_rates: Dict[str, float]
    breaching: bool         # every window at/above its factor

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SloReport:
    """All objectives' verdicts at one evaluation (one engine step)."""

    step: int
    statuses: Tuple[SloStatus, ...]

    @property
    def ok(self) -> bool:
        return all(s.ok for s in self.statuses)

    @property
    def breaching(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.statuses if s.breaching)

    def as_dict(self) -> Dict[str, object]:
        return {"step": self.step, "ok": self.ok,
                "breaching": list(self.breaching),
                "statuses": [s.as_dict() for s in self.statuses]}

    def format_report(self) -> str:
        lines = [f"slo report @ step {self.step}: "
                 f"{'OK' if self.ok else 'VIOLATING'}"]
        for s in self.statuses:
            val = f"{s.value:.4g}" if s.value is not None else "n/a"
            state = ("ok" if s.ok else
                     "BREACHING" if s.breaching else "violating")
            burns = " ".join(f"{w}={b:.2f}" for w, b in s.burn_rates.items())
            lines.append(f"  {s.name:<14} {s.objective:<44} "
                         f"value={val:<10} {state} burn[{burns}]")
        return "\n".join(lines)


def default_slos(*, ttft_p99_s: float = 2.0, error_rate: float = 0.05,
                 min_free_page_frac: float = 0.02) -> Tuple[Slo, ...]:
    """The stock serving objectives from the engine's own metric names:
    tail time-to-first-token, request error rate, KV-pool headroom."""
    return (
        Slo("ttft_p99", "serving.ttft_s", "max", ttft_p99_s, percentile=99),
        Slo("error_rate", "serving.cancelled_requests", "max", error_rate,
            total="serving.finished_requests"),
        Slo("kv_headroom", "kv.free_pages", "min", min_free_page_frac,
            total="kv.num_pages"),
    )


def _metric_value(reg: MetricsRegistry, name: str,
                  percentile: Optional[float]) -> Optional[float]:
    m = reg.get(name)
    if m is None:
        return None
    if isinstance(m, Histogram):
        if m.count == 0:
            return None
        return m.percentile(percentile if percentile is not None else 50.0)
    return float(m.value)


class SloMonitor:
    """Evaluates objectives against the registry and tracks budget burn.

    ``budget_frac`` is the error budget: the tolerated fraction of bad
    evaluations (default 1% — at factor 1.0 a window goes hot once more
    than 1% of its evaluations violate).  ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, slos: Optional[Tuple[Slo, ...]] = None, *,
                 windows: Tuple[Window, ...] = DEFAULT_WINDOWS,
                 budget_frac: float = 0.01,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        if not (0.0 < budget_frac <= 1.0):
            raise ValueError(f"budget_frac must be in (0, 1], "
                             f"got {budget_frac}")
        if not windows:
            raise ValueError("SloMonitor needs at least one window")
        self.slos: Tuple[Slo, ...] = tuple(
            slos if slos is not None else default_slos())
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate slo names: {names}")
        self.windows = tuple(windows)
        self.budget_frac = float(budget_frac)
        self._clock = clock
        self._reg = registry
        self._max_span = max(w.span_s for w in self.windows)
        # per-slo trailing (timestamp, bad) events
        from collections import deque
        self._events: Dict[str, Deque[Tuple[float, int]]] = {
            s.name: deque() for s in self.slos}
        self._evals = 0
        self._last_report: Optional[SloReport] = None

    def _registry(self) -> MetricsRegistry:
        return self._reg if self._reg is not None else _global_registry()

    def _burn_rates(self, events, now: float) -> Dict[str, float]:
        out = {}
        for w in self.windows:
            lo = now - w.span_s
            bad = total = 0
            for ts, b in reversed(events):
                if ts < lo:
                    break
                total += 1
                bad += b
            frac = bad / total if total else 0.0
            out[w.name] = frac / self.budget_frac
        return out

    def observe(self, step: int = 0) -> SloReport:
        """Evaluate every objective now; host-side registry reads only."""
        reg = self._registry()
        now = self._clock()
        self._evals += 1
        statuses = []
        for slo in self.slos:
            value = _metric_value(reg, slo.metric, slo.percentile)
            observed = value is not None
            if observed and slo.total is not None:
                denom = _metric_value(reg, slo.total, None)
                if denom is None or denom == 0.0:
                    value, observed = None, False
                else:
                    value = value / denom
            if not observed:
                ok = True      # vacuous: no traffic yet is not an outage
            elif slo.objective == "max":
                ok = value <= slo.threshold
            else:
                ok = value >= slo.threshold
            events = self._events[slo.name]
            events.append((now, 0 if ok else 1))
            while events and events[0][0] < now - self._max_span:
                events.popleft()
            burns = self._burn_rates(events, now)
            breaching = observed and not ok and all(
                burns[w.name] >= w.factor for w in self.windows)
            statuses.append(SloStatus(
                name=slo.name, objective=slo.describe(),
                value=value, threshold=slo.threshold, ok=ok,
                observed=observed, burn_rates=burns, breaching=breaching))
            reg.gauge(f"slo.{slo.name}.ok").set(1.0 if ok else 0.0)
            if value is not None:
                reg.gauge(f"slo.{slo.name}.value").set(value)
            if not ok:
                reg.counter("slo.violations").inc()
        reg.counter("slo.evaluations").inc()
        report = SloReport(step=step, statuses=tuple(statuses))
        self._last_report = report
        return report

    @property
    def last_report(self) -> Optional[SloReport]:
        return self._last_report

    @property
    def evaluations(self) -> int:
        return self._evals

    def as_dict(self) -> Optional[Dict[str, object]]:
        return self._last_report.as_dict() if self._last_report else None
