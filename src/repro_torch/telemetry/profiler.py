"""Continuous profiler: modeled-vs-measured attribution + plan-regret
audit (the port of ``repro/telemetry/profiler.py``).

The accounting layer (:mod:`repro_torch.telemetry.gemm_account`) records
*what* a run dispatched — signature, format, shape class, plan
provenance, modeled time.  This module closes the loop on *how much it
actually cost*: after a run, never inside it (every measurement here is a
standalone execution of the signature's granted plan on seeded operands,
:func:`repro_torch.core.autotune.measure_plan`: CUDA events on the card,
the host clock on the CPU), :class:`DispatchProfiler` times each distinct
dispatch signature and joins the measured time against the planner's
prediction and the accountant's provenance records, producing

- the **calibration table**: per-(shape_class, fmt, plan_source) rows of
  ``modeled_s``, ``measured_s``, their error ratio, dispatch count and
  cumulative time share — the check of the planner's Hopper price
  against the card, installable into
  :func:`repro_torch.core.perfmodel.set_calibration`;
- the **plan-regret audit**: for the hottest cached signatures, the
  granted plan is raced against its analytic runner-up
  (:meth:`PlanCache.runner_up`), and signatures where the grant
  measurably loses are flagged — optionally feeding
  :meth:`PlanCache.recalibrate`, which re-grants from the full
  measured-refinement search.

Measurement cost scales with *distinct signatures*, not dispatches: a
serving run with thousands of steps and a dozen distinct shapes costs a
dozen timed launches.  ``max_signatures`` caps each :meth:`sample` at
the hottest unmeasured signatures (by modeled time x dispatch count);
repeated samples extend coverage.  All profiler-issued launches run
under :func:`gemm_account.suppress` so profiling never pollutes the
accounting it reads.

Usage::

    with account_gemms() as acct:
        engine.run()
    prof = DispatchProfiler(acct)
    prof.sample()                      # time the hot signatures
    print(prof.format_calibration_table())
    audit = prof.regret_audit(recalibrate=True)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.telemetry import gemm_account

__all__ = ["DispatchProfiler", "CalibrationRow", "profile_records"]

# (m, n, k, fmt, policy, backend, group) — the accountant's plan-join key.
_Key = Tuple[int, int, int, str, str, str, int]


@dataclasses.dataclass(frozen=True)
class CalibrationRow:
    """One (shape_class, fmt, plan_source) aggregate of the join."""

    shape_class: str
    fmt: str
    plan_source: str
    dispatches: int
    grouped: int
    signatures: int      # distinct dispatch signatures in this row
    sampled: int         # signatures with a wall-clock measurement
    modeled_s: float     # sum over *sampled* records of modeled launch time
    measured_s: float    # sum over sampled records of measured launch time
    error_ratio: float   # measured_s / modeled_s (nan when unsampled)
    time_share: float    # measured_s / total measured across all rows

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _record_key(r) -> _Key:
    return (r.m, r.n, r.k, r.fmt, str(r.policy), r.backend, max(r.group, 1))


class DispatchProfiler:
    """Sampling wall-clock attributor over a :class:`GemmAccountant`.

    ``accountant=None`` reads the process-installed accountant at sample
    time.  ``iters`` is the per-signature measurement count (median, one
    warmup — :func:`repro_torch.core.autotune.measure_plan`); ``device``
    where the signatures are timed (None: the card).
    """

    def __init__(self, accountant: Optional[gemm_account.GemmAccountant]
                 = None, *, max_signatures: int = 64, iters: int = 1,
                 regret_tolerance: float = 0.25, device=None):
        self._acct = accountant
        self.max_signatures = int(max_signatures)
        self.iters = int(iters)
        self.regret_tolerance = float(regret_tolerance)
        self.device = device
        self._measured: Dict[_Key, float] = {}    # per-launch seconds
        self._modeled: Dict[_Key, float] = {}     # per-launch seconds
        self._failed: Dict[_Key, str] = {}        # unmeasurable signatures
        self._last_audit: List[Dict[str, object]] = []

    # -- sources ---------------------------------------------------------------
    def accountant(self) -> Optional[gemm_account.GemmAccountant]:
        return self._acct if self._acct is not None else gemm_account.active()

    def _records(self):
        acct = self.accountant()
        return list(acct.records) if acct is not None else []

    def _cached_signature(self, key: _Key):
        """The plan cache's GemmSignature matching a dispatch key (the
        most recently granted one when epilogue variants share a key)."""
        from repro_torch.core import autotune
        match = None
        for sig in autotune.plan_cache()._plans:
            if (sig.m, sig.n, sig.k, sig.fmt, str(sig.policy), sig.backend,
                    sig.group) == key:
                match = sig
        return match

    def _modeled_for(self, key: _Key, records) -> float:
        """Perf-model launch seconds for one signature: the accountant's
        joined prediction when the planner granted one, the analytic
        solve otherwise (the plain ``torch`` products)."""
        for r in records:
            if r.modeled_s is not None:
                return float(r.modeled_s)
        m, n, k, fmt, policy, _backend, group = key
        from repro_torch.core import perfmodel
        return perfmodel.analytic_seconds(m, n, k, fmt=fmt, policy=policy,
                                          group=group)

    def _plan_for(self, key: _Key):
        """An executable ExecutionPlan for one dispatch key: the cached
        grant when the planner saw the signature, an analytic-base plan
        otherwise (route ``"torch"`` for a dispatch that ran no kernel:
        the plain product it executed)."""
        import dataclasses as _dc

        from repro_torch.core import autotune
        from repro_torch.core.formats import FORMATS
        sig = self._cached_signature(key)
        if sig is not None:
            return autotune.plan_cache()._plans[sig]
        m, n, k, fmt, policy, backend, group = key
        solver_policy = "amx" if policy == "amx" else "mte"
        sig = autotune.GemmSignature.for_format(
            m, n, k, FORMATS.get(fmt, FORMATS["fp32"]), "float32",
            policy=solver_policy, group=group)
        plan = autotune.plan_cache().analytic_candidates(sig)[0]
        if backend != "kernels" or policy == "torch":
            plan = _dc.replace(plan, route="torch")
        return plan

    # -- sampling --------------------------------------------------------------
    def sample(self, max_signatures: Optional[int] = None) -> int:
        """Measure the hottest still-unmeasured signatures (by modeled
        launch time x dispatch count), after the run.  Returns the number
        of signatures measured this call."""
        from repro_torch.core import autotune
        budget = self.max_signatures if max_signatures is None \
            else int(max_signatures)
        by_key: Dict[_Key, list] = {}
        for r in self._records():
            by_key.setdefault(_record_key(r), []).append(r)
        for key, recs in by_key.items():
            if key not in self._modeled:
                self._modeled[key] = self._modeled_for(key, recs)
        todo = [key for key in by_key
                if key not in self._measured and key not in self._failed]
        todo.sort(key=lambda key: -self._modeled[key] * len(by_key[key]))
        measured = 0
        for key in todo[:budget]:
            plan = self._plan_for(key)
            try:
                with gemm_account.suppress():
                    self._measured[key] = autotune.measure_plan(
                        plan, iters=self.iters, device=self.device)
                measured += 1
            except (ValueError, NotImplementedError) as e:
                # Same contract as PlanCache._build: a capability
                # mismatch means this signature cannot be replayed
                # standalone — it stays in the dispatch counts, out of
                # the measured aggregate.  Real kernel bugs propagate.
                self._failed[key] = str(e)
        return measured

    # -- the calibration table -------------------------------------------------
    def calibration_table(self) -> List[CalibrationRow]:
        """The modeled-vs-measured join, aggregated per
        (shape_class, fmt, plan_source), hottest measured rows first."""
        agg: Dict[Tuple[str, str, str], Dict[str, object]] = {}
        for r in self._records():
            key = _record_key(r)
            row = agg.setdefault((r.shape_class, r.fmt, r.plan_source), {
                "dispatches": 0, "grouped": 0, "keys": set(),
                "modeled_s": 0.0, "measured_s": 0.0, "sampled_keys": set()})
            row["dispatches"] += 1
            row["grouped"] += int(r.kind == "grouped")
            row["keys"].add(key)
            t = self._measured.get(key)
            if t is not None:
                row["sampled_keys"].add(key)
                row["measured_s"] += t
                row["modeled_s"] += self._modeled.get(key, 0.0)
        total_measured = sum(row["measured_s"] for row in agg.values())
        rows = []
        for (sc, fmt, src), row in agg.items():
            modeled, measured = row["modeled_s"], row["measured_s"]
            ratio = measured / modeled if modeled > 0 and measured > 0 \
                else float("nan")
            rows.append(CalibrationRow(
                shape_class=sc, fmt=fmt, plan_source=src,
                dispatches=row["dispatches"], grouped=row["grouped"],
                signatures=len(row["keys"]),
                sampled=len(row["sampled_keys"]),
                modeled_s=modeled, measured_s=measured, error_ratio=ratio,
                time_share=(measured / total_measured
                            if total_measured > 0 else 0.0)))
        rows.sort(key=lambda r: (-r.measured_s, r.shape_class, r.fmt,
                                 r.plan_source))
        return rows

    def format_calibration_table(self) -> str:
        rows = self.calibration_table()
        if not rows:
            return "calibration: no dispatches recorded"
        header = (f"{'shape class':<12} {'fmt':<8} {'source':<10} "
                  f"{'disp':>5} {'sig':>4} {'modeled us':>11} "
                  f"{'measured us':>12} {'err ratio':>10} {'share':>6}")
        lines = [header, "-" * len(header)]
        for r in rows:
            err = f"{r.error_ratio:10.2f}" if r.error_ratio == r.error_ratio \
                else f"{'-':>10}"
            lines.append(
                f"{r.shape_class:<12} {r.fmt:<8} {r.plan_source:<10} "
                f"{r.dispatches:>5} {r.signatures:>4} "
                f"{r.modeled_s * 1e6:>11.2f} {r.measured_s * 1e6:>12.2f} "
                f"{err} {r.time_share:>6.2f}")
        lines.append(f"({len(self._measured)} signatures measured, "
                     f"{len(self._failed)} unmeasurable)")
        return "\n".join(lines)

    def install_calibration(self) -> int:
        """Install each sampled (shape_class, fmt) measured/modeled ratio
        into :func:`repro_torch.core.perfmodel.set_calibration`.  Returns the
        number of ratios installed (rows without finite ratios skipped)."""
        from repro_torch.core import perfmodel
        by_cf: Dict[Tuple[str, str], List[float]] = {}
        for r in self.calibration_table():
            if r.error_ratio == r.error_ratio and r.error_ratio > 0 \
                    and not math.isinf(r.error_ratio):
                by_cf.setdefault((r.shape_class, r.fmt), []).append(
                    (r.error_ratio, r.measured_s))
        n = 0
        for (sc, fmt), pairs in by_cf.items():
            total = sum(w for _, w in pairs)
            ratio = (sum(rr * w for rr, w in pairs) / total if total > 0
                     else pairs[0][0])
            perfmodel.set_calibration(sc, fmt, ratio)
            n += 1
        return n

    # -- plan-regret audit -----------------------------------------------------
    def regret_audit(self, top_k: int = 4, *, recalibrate: bool = False,
                     tolerance: Optional[float] = None
                     ) -> List[Dict[str, object]]:
        """Race the cache's granted plans against their analytic
        runners-up for the ``top_k`` hottest recorded signatures.

        A signature is *flagged* when the granted plan is measurably
        slower than the runner-up by more than ``tolerance`` (relative);
        with ``recalibrate=True`` flagged signatures are re-granted from
        measurement via :meth:`PlanCache.recalibrate`.  Returns one
        entry per audited signature (``flagged`` / ``regret`` /
        ``recalibrated`` fields); the last audit is kept for
        :meth:`summary`.
        """
        from repro_torch.core import autotune
        tol = self.regret_tolerance if tolerance is None else float(tolerance)
        cache = autotune.plan_cache()
        by_key: Dict[_Key, int] = {}
        for r in self._records():
            key = _record_key(r)
            by_key[key] = by_key.get(key, 0) + 1
        hot = []
        for key, n_disp in by_key.items():
            sig = self._cached_signature(key)
            if sig is None:
                continue   # planner-bypassing dispatch: nothing to regret
            weight = self._modeled.get(key, 0.0) * n_disp
            hot.append((weight, n_disp, sig))
        hot.sort(key=lambda t: -t[0])
        audit: List[Dict[str, object]] = []
        for _, n_disp, sig in hot[:int(top_k)]:
            granted = cache._plans.get(sig)
            runner = cache.runner_up(sig)
            if granted is None or runner is None:
                continue
            try:
                with gemm_account.suppress():
                    t_granted = autotune.measure_plan(
                        granted, iters=self.iters, device=self.device)
                    t_runner = autotune.measure_plan(
                        runner, iters=self.iters, device=self.device)
            except (ValueError, NotImplementedError):
                continue
            regret = (t_granted - t_runner) / max(t_runner, 1e-12)
            flagged = t_granted > t_runner * (1.0 + tol)
            entry: Dict[str, object] = {
                "signature": f"{sig.m}x{sig.n}x{sig.k}/{sig.fmt}"
                             + (f"/g{sig.group}" if sig.group > 1 else ""),
                "dispatches": n_disp,
                "granted_route": granted.route,
                "granted_source": granted.source,
                "runner_route": runner.route,
                "granted_s": t_granted,
                "runner_s": t_runner,
                "regret": regret,
                "flagged": flagged,
                "recalibrated": False,
            }
            if flagged and recalibrate:
                new = cache.recalibrate(sig, device=self.device)
                entry["recalibrated"] = True
                entry["new_route"] = new.route
                entry["new_source"] = new.source
            audit.append(entry)
        self._last_audit = audit
        return audit

    # -- health snapshot -------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        """The structured snapshot ``telemetry.export.health`` embeds."""
        rows = self.calibration_table()
        finite = [r.error_ratio for r in rows
                  if r.error_ratio == r.error_ratio]
        return {
            "signatures": len(self._modeled),
            "sampled": len(self._measured),
            "unmeasurable": len(self._failed),
            "rows": [r.as_dict() for r in rows],
            "mean_error_ratio": (sum(finite) / len(finite)
                                 if finite else None),
            "regret": {
                "audited": len(self._last_audit),
                "flagged": sum(1 for e in self._last_audit if e["flagged"]),
                "recalibrated": sum(1 for e in self._last_audit
                                    if e["recalibrated"]),
            },
        }


def profile_records(accountant: Optional[gemm_account.GemmAccountant] = None,
                    **kwargs) -> DispatchProfiler:
    """One-shot convenience: build a profiler over ``accountant`` (or the
    installed one) and run a single :meth:`~DispatchProfiler.sample`."""
    prof = DispatchProfiler(accountant, **kwargs)
    prof.sample()
    return prof
