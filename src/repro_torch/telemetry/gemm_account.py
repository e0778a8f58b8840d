"""Per-GEMM dispatch accounting — the Fig. 7 traffic table, live (the port
of ``repro/telemetry/gemm_account.py``).

The paper's efficiency argument is *per shape class*: square GEMMs fill
a rigid tile fine; tall/skinny ones (decode GEMVs, M <= 32 or N <= 32
with deep K) are where the flexible MTE geometry wins.  This module
counts what a run actually dispatches along exactly that axis.

Hooked at the same seams :func:`repro_torch.graph.trace.trace_gemms`
uses — ``dispatch.mte_gemm`` (``torch`` / ``reference`` backends),
``kernels/ops.py`` (the kernels), compiled-program node execution
(:mod:`repro_torch.graph.schedule`) — plus the plain-torch fallbacks
``formats.torch_gemm`` / ``torch_grouped`` (the self-recording seams
:func:`suppress` their inner calls), so every GEMM the stack can issue
passes through one ``record_*`` call.

A record is one **distinct dispatch as the host issues it**: each eager
call, and each call made while a CUDA graph is captured.  A graph replay
runs no Python and adds no record, and the all-inactive warm-up before a
capture runs under :func:`suppress` — so, as in the JAX package, where
the hooks fire once per ``jax.jit`` trace, the replayed decode step's
GEMMs are recorded once, at their capture, and the grouped decode q/k/v
projection is ONE record, not three.

Plan provenance rides along: :meth:`GemmAccountant.note_plan` is called
by the plan cache (``cache-hit`` / ``analytic`` / ``measured`` /
``warmstart``) and for a pinned geometry (``program`` — a grant from a
compiled graph program), keyed by the dispatch signature; ``record_*``
joins the two.  Dispatches that never consult the planner (the plain
``torch`` route) report ``unplanned``.

Usage::

    with account_gemms() as acct:
        engine.run()
    print(acct.format_table())

Stdlib only.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

__all__ = ["shape_class", "GemmRecord", "GemmAccountant", "account_gemms",
           "active", "active_unsuppressed", "suppress", "install",
           "uninstall"]

# The tall/skinny threshold of the paper's shape families.
_SKINNY = 32


def shape_class(m: int, n: int, k: int) -> str:
    """The paper's M/N/K families.

    - ``tall_skinny``: M <= 32 or N <= 32 with deep K — decode GEMVs and
      speculative verify chunks, the shapes Figs 7-10 are about.
    - ``small``: every dimension <= 32 (one tile; a class of its own so
      it cannot masquerade as a tall/skinny win).
    - ``square``: largest/smallest dimension within 4x.
    - ``rect``: everything else (e.g. wide unembeddings at large M).
    """
    m, n, k = int(m), int(n), int(k)
    if max(m, n, k) <= _SKINNY:
        return "small"
    if min(m, n) <= _SKINNY and k > _SKINNY:
        return "tall_skinny"
    dims = (m, n, k)
    return "square" if max(dims) <= 4 * min(dims) else "rect"


@dataclasses.dataclass(frozen=True)
class GemmRecord:
    """One dispatched GEMM (or grouped GEMM) at a choke point."""

    kind: str          # "gemm" | "grouped"
    m: int
    n: int
    k: int
    group: int
    fmt: str           # FormatPolicy name
    policy: str        # "mte" | "amx" | "torch" (plain product, no planner)
    backend: str       # "kernels" | "torch" | "reference"
    shape_class: str
    plan_source: str   # "cache-hit" | "analytic" | "measured" |
    #                    "warmstart" | "program" | "unplanned"
    modeled_s: Optional[float]   # the planner's predicted seconds


_PlanKey = Tuple[int, int, int, str, str, str, int]


class GemmAccountant:
    """Collects :class:`GemmRecord` s and aggregates the traffic table."""

    def __init__(self):
        self.records: List[GemmRecord] = []
        self._plan_info: Dict[_PlanKey, Tuple[str, float]] = {}

    # -- planner-side hook ----------------------------------------------------
    def note_plan(self, sig, source: str, predicted_s: float) -> None:
        """Called by the plan cache whenever a plan is granted; the
        signature fields key the join with the dispatch-side record."""
        key = (sig.m, sig.n, sig.k, sig.fmt, str(sig.policy), sig.backend,
               sig.group)
        self._plan_info[key] = (str(source), float(predicted_s))

    def _plan_for(self, key: _PlanKey,
                  override: Optional[Tuple[str, Optional[float]]]
                  ) -> Tuple[str, Optional[float]]:
        if override is not None:
            return override
        info = self._plan_info.get(key)
        return info if info is not None else ("unplanned", None)

    # -- dispatch-side hooks --------------------------------------------------
    def record_gemm(self, m: int, n: int, k: int, *, fmt: str, policy: str,
                    backend: str, plan_source: Optional[str] = None,
                    modeled_s: Optional[float] = None) -> None:
        key = (int(m), int(n), int(k), fmt, str(policy), backend, 1)
        src, mod = self._plan_for(
            key, (plan_source, modeled_s) if plan_source else None)
        self.records.append(GemmRecord(
            kind="gemm", m=int(m), n=int(n), k=int(k), group=1, fmt=fmt,
            policy=str(policy), backend=backend,
            shape_class=shape_class(m, n, k), plan_source=src,
            modeled_s=mod))

    def record_grouped(self, group: int, m: int, n: int, k: int, *,
                       fmt: str, policy: str, backend: str,
                       plan_source: Optional[str] = None,
                       modeled_s: Optional[float] = None) -> None:
        key = (int(m), int(n), int(k), fmt, str(policy), backend,
               int(group))
        src, mod = self._plan_for(
            key, (plan_source, modeled_s) if plan_source else None)
        self.records.append(GemmRecord(
            kind="grouped", m=int(m), n=int(n), k=int(k), group=int(group),
            fmt=fmt, policy=str(policy), backend=backend,
            shape_class=shape_class(m, n, k), plan_source=src,
            modeled_s=mod))

    # -- aggregation ----------------------------------------------------------
    def table(self) -> List[Dict[str, object]]:
        """Traffic rows aggregated by (shape_class, fmt), tall/skinny
        first — dispatch count, grouped share, plan sources seen, total
        modeled time, one example signature."""
        agg: Dict[Tuple[str, str], Dict[str, object]] = {}
        for r in self.records:
            row = agg.setdefault((r.shape_class, r.fmt), {
                "shape_class": r.shape_class, "fmt": r.fmt,
                "dispatches": 0, "grouped": 0, "modeled_s": 0.0,
                "sources": set(), "example": f"{r.m}x{r.n}x{r.k}"
                + (f"/g{r.group}" if r.group > 1 else "")})
            row["dispatches"] += 1
            row["grouped"] += int(r.kind == "grouped")
            if r.modeled_s is not None:
                row["modeled_s"] += r.modeled_s * max(1, r.group)
            row["sources"].add(r.plan_source)
        order = {"tall_skinny": 0, "small": 1, "square": 2, "rect": 3}
        rows = sorted(agg.values(),
                      key=lambda x: (order.get(x["shape_class"], 9),
                                     x["fmt"]))
        for row in rows:
            row["sources"] = ",".join(sorted(row["sources"]))
        return rows

    def format_table(self) -> str:
        """The printable shape-class/format traffic table (Fig. 7 axis)."""
        rows = self.table()
        if not rows:
            return "per-GEMM accounting: no dispatches recorded"
        header = (f"{'shape class':<12} {'fmt':<8} {'dispatches':>10} "
                  f"{'grouped':>8} {'modeled us':>11} {'plan sources':<24} "
                  f"example")
        lines = [header, "-" * len(header)]
        for r in rows:
            mod = (f"{r['modeled_s'] * 1e6:11.2f}" if r["modeled_s"]
                   else f"{'-':>11}")
            lines.append(f"{r['shape_class']:<12} {r['fmt']:<8} "
                         f"{r['dispatches']:>10} {r['grouped']:>8} "
                         f"{mod} {r['sources']:<24} {r['example']}")
        lines.append(f"total: {len(self.records)} distinct compiled "
                     f"GEMM dispatches")
        return "\n".join(lines)


_ACTIVE: Optional[GemmAccountant] = None
_SUPPRESS = 0


def active() -> Optional[GemmAccountant]:
    """The installed accountant, or None (the common, zero-cost case)."""
    return _ACTIVE


def active_unsuppressed() -> Optional[GemmAccountant]:
    """The accountant, unless a self-recording seam suppressed the
    launches underneath it (see :func:`suppress`)."""
    return None if _SUPPRESS else _ACTIVE


@contextmanager
def suppress():
    """Hide nested ``ops`` and ``formats.torch_gemm`` / ``torch_grouped``
    records.

    Seams that record themselves (``dispatch.mte_gemm``, the
    compiled-program node runners, the reference oracles) execute their
    math through the lower seams; wrapping that inner compute here keeps
    each dispatch a single record instead of two.  The profiler's timed
    launches and the warm-up before a CUDA-graph capture run under it
    too.  The engine issues its launches from one thread, so a module
    counter is enough."""
    global _SUPPRESS
    _SUPPRESS += 1
    try:
        yield
    finally:
        _SUPPRESS -= 1


def install(acct: GemmAccountant) -> GemmAccountant:
    global _ACTIVE
    _ACTIVE = acct
    return acct


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextmanager
def account_gemms():
    """``with account_gemms() as acct:`` — collect every GEMM dispatched
    in the block (same scoping contract as ``trace_gemms``)."""
    prev = _ACTIVE
    acct = GemmAccountant()
    install(acct)
    try:
        yield acct
    finally:
        if prev is None:
            uninstall()
        else:
            install(prev)
