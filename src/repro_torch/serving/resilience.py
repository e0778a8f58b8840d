"""Fault injection, request-level containment and crash recovery for the
serving engine (the port of ``repro/serving/resilience.py``; host-only
code, copied: the port imports nothing of the JAX package).

Four pieces, as in the JAX package:

- **error taxonomy**: :class:`RequestError` and its subclasses
  (:class:`DeadlineExceeded`, :class:`Shed`, :class:`PoisonedOutput`,
  :class:`CapacityExceeded`) name every way a request can end other than
  normal completion; each carries a stable ``code`` the engine stamps
  into the request's :class:`Response`.  :class:`EngineCrash` is an
  engine-level failure, the supervised restart's trigger.
- **Response**: what ``ServingEngine.run()`` returns per request, the
  generated tokens (it subclasses ``list``) plus ``status``, ``error``
  and ``metrics``.
- **FaultInjector**: a seeded, deterministic plan of :class:`Fault`
  specs (page-allocation failure, chunk-compute exception, NaN/inf
  logits on a chosen request and step, a straggling step, a crash) that
  the engine's hooks consult; every firing is logged in ``.fired``, so
  the same plan (or seed) gives the same firings and the same outputs.
  ``random_plan`` draws from numpy's ``default_rng`` as the JAX package
  does, so one seed draws one plan in both packages.
- **crash recovery**: :func:`serve_with_recovery` runs an engine under
  :func:`repro_torch.distributed.fault.supervise`; a crash (or a
  watchdog-detected straggler) snapshots the engine's host state
  (``ServingEngine.snapshot()``), drops the engine, builds a fresh one
  and restores it (``restore()``), so in-flight requests re-admit through
  the prefix cache and re-attach their published KV pages.

Nothing here imports the engine: the engine imports this module, and
:func:`serve_with_recovery` receives an engine factory.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "RequestError", "DeadlineExceeded", "Shed", "PoisonedOutput",
    "CapacityExceeded", "EngineCrash", "Response", "FAULT_KINDS", "Fault",
    "FaultInjector", "serve_with_recovery",
]


# -- error taxonomy -----------------------------------------------------------


class RequestError(RuntimeError):
    """A request ended abnormally; ``code`` is its :class:`Response`
    status string."""

    code = "error"

    def __init__(self, message: str = "", *, rid: Optional[int] = None):
        super().__init__(message or self.__class__.__name__)
        self.rid = rid


class DeadlineExceeded(RequestError):
    """The request's deadline passed before it finished; its partial
    output is returned with this status."""

    code = "deadline"


class Shed(RequestError):
    """Admission control rejected the request at ``submit`` (queue depth
    or committed-token watermark exceeded)."""

    code = "shed"


class PoisonedOutput(RequestError):
    """The request's logits went NaN/inf; its slot was quarantined."""

    code = "poisoned"


class CapacityExceeded(RequestError):
    """The request can never be admitted (pool or token budget too small
    for it alone)."""

    code = "capacity"


class EngineCrash(RuntimeError):
    """An injected (or real) engine-level crash: the supervised restart's
    trigger, distinct from any per-request error."""


# -- structured per-request result --------------------------------------------


class Response(list):
    """Generated tokens + completion status for one request."""

    def __init__(self, tokens: Sequence[int] = (), *, rid: int,
                 status: str = "ok", error: Optional[RequestError] = None,
                 metrics: Optional[dict] = None):
        super().__init__(int(t) for t in tokens)
        self.rid = int(rid)
        self.status = status
        self.error = error
        self.metrics = dict(metrics or {})

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def tokens(self):
        return list(self)

    def __repr__(self) -> str:
        return (f"Response(rid={self.rid}, status={self.status!r}, "
                f"tokens={list(self)!r})")


# -- deterministic fault injection --------------------------------------------

FAULT_KINDS = ("alloc_fail", "chunk_exception", "poison_logits",
               "straggle", "crash")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault: ``kind``, and the triggers that narrow when it
    fires: ``step`` (the engine step from which it may fire; None: the
    first opportunity), ``rid`` (the target of poison and chunk faults),
    ``chunk`` (a chunk fault's chunk index).  ``count`` caps its firings
    (an injector outlives an engine restart, so a ``count=1`` crash does
    not fire again on the restarted engine)."""

    kind: str
    step: Optional[int] = None
    rid: Optional[int] = None
    chunk: Optional[int] = None
    count: int = 1
    value: float = float("nan")   # the poison payload (nan / inf)
    delay_s: float = 0.0          # a straggle's sleep

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


class FaultInjector:
    """Executes a fault plan: the engine calls the hooks, and the
    injector decides from the plan and its own firing history alone
    whether a fault fires.  Each firing is appended to ``fired`` as
    ``(step, kind, target)``."""

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0):
        self.faults: List[Fault] = list(faults)
        self.seed = int(seed)
        self._remaining = [max(0, int(f.count)) for f in self.faults]
        self.fired: List[tuple] = []

    # -- plan construction ----------------------------------------------------
    @classmethod
    def random_plan(cls, seed: int, *, n_faults: int = 3, max_step: int = 16,
                    rids: Sequence[int] = (0, 1, 2, 3),
                    kinds: Sequence[str] = ("alloc_fail", "poison_logits",
                                            "chunk_exception")
                    ) -> "FaultInjector":
        """A plan drawn from ``seed`` (crash and straggle are opt-in: they
        need a supervisor)."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = str(rng.choice(list(kinds)))
            faults.append(Fault(
                kind=kind,
                step=int(rng.integers(1, max_step)),
                rid=int(rng.choice(list(rids))),
                chunk=None,
                value=float(rng.choice([np.nan, np.inf, -np.inf])),
            ))
        return cls(faults, seed=seed)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Parse a command-line plan ``kind[:k=v[,k=v...]][;kind...]``,
        e.g. ``poison_logits:rid=0,step=5;straggle:step=3,delay_s=0.5``."""
        faults = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            kind, _, argstr = part.partition(":")
            kw: Dict[str, object] = {}
            for item in filter(None, (a.strip() for a in argstr.split(","))):
                key, _, val = item.partition("=")
                if key in ("step", "rid", "chunk", "count"):
                    kw[key] = int(val)
                elif key in ("value", "delay_s"):
                    kw[key] = float(val)
                else:
                    raise ValueError(f"unknown fault field {key!r} in "
                                     f"{part!r}")
            faults.append(Fault(kind=kind.strip(), **kw))
        return cls(faults)

    # -- firing machinery -----------------------------------------------------
    def _take(self, i: int, step: int, target) -> bool:
        if self._remaining[i] <= 0:
            return False
        self._remaining[i] -= 1
        kind = self.faults[i].kind
        self.fired.append((int(step), kind, target))
        # The firing on the installed trace, between the engine spans it
        # perturbed.
        from repro_torch.telemetry import tracing
        tr = tracing.active()
        if tr is not None:
            tr.instant(f"fault.{kind}",
                       args={"step": int(step), "target": repr(target)})
        return True

    def _matches(self, f: Fault, *, step: int, rid: Optional[int] = None,
                 chunk: Optional[int] = None) -> bool:
        if f.step is not None and step < f.step:
            return False
        if f.rid is not None and rid is not None and f.rid != rid:
            return False
        if f.chunk is not None and chunk is not None and f.chunk != chunk:
            return False
        return True

    # -- engine hooks ---------------------------------------------------------
    def step_begin(self, step: int, pool=None) -> None:
        """The engine step's preamble: crashes, stragglers and
        page-allocation failures fire here.  ``pool`` (a ``KVPagePool``)
        takes an allocation failure as a consume-once counter its next
        ``ensure``/``admit_prefix`` honours."""
        for i, f in enumerate(self.faults):
            if f.kind == "straggle" and self._matches(f, step=step) \
                    and self._remaining[i] > 0:
                self._take(i, step, None)
                time.sleep(f.delay_s)
            elif f.kind == "alloc_fail" and pool is not None \
                    and self._matches(f, step=step) and self._remaining[i] > 0:
                self._take(i, step, None)
                pool.inject_alloc_failures += 1
            elif f.kind == "crash" and self._matches(f, step=step) \
                    and self._remaining[i] > 0:
                self._take(i, step, None)
                raise EngineCrash(f"injected crash at step {step}")

    def chunk_fault(self, step: int, rid: int, chunk: int) -> None:
        """Raise the injected chunk-compute fault when one is armed for
        this (request, chunk)."""
        for i, f in enumerate(self.faults):
            if f.kind == "chunk_exception" \
                    and self._matches(f, step=step, rid=rid, chunk=chunk) \
                    and self._remaining[i] > 0:
                self._take(i, step, (rid, chunk))
                raise RequestError(
                    f"injected chunk-compute fault (rid={rid}, "
                    f"chunk={chunk})", rid=rid)

    def poison_value(self, step: int, rid: int) -> Optional[float]:
        """The NaN/inf payload that overwrites ``rid``'s logits at this
        step, or None."""
        for i, f in enumerate(self.faults):
            if f.kind == "poison_logits" \
                    and self._matches(f, step=step, rid=rid) \
                    and self._remaining[i] > 0:
                self._take(i, step, rid)
                return f.value
        return None


# -- supervised serving (crash / straggler recovery) --------------------------


def serve_with_recovery(make_engine: Callable[[], object],
                        requests: Sequence[object], *,
                        max_restarts: int = 3, backoff_s: float = 0.0,
                        keep_cache: bool = True,
                        log=print) -> Dict[int, Response]:
    """Serve ``requests`` on a supervised engine with snapshot/restore.

    ``make_engine`` builds a fresh ``ServingEngine`` (the same parameters
    and config each time).  The first attempt submits ``requests``; on
    any failure (an :class:`EngineCrash`, a watchdog's
    ``StragglerError``, ...) the dying engine's host state is
    snapshotted, the engine is dropped, and the next attempt restores the
    snapshot: finished responses carry over, live requests re-admit, and
    with ``keep_cache=True`` the dying engine's device cache and the
    snapshot's page registrations let the prefix cache re-attach the
    published KV.  The dropped engine's weights and graph pools are freed
    before the next one is built: only its cache survives.  Past
    ``max_restarts`` restarts ``supervise`` raises; → the final response
    dict."""
    from repro_torch.distributed.fault import supervise

    state: Dict[str, object] = {"snap": None, "cache": None, "out": None}

    def attempt(i: int) -> None:
        eng = make_engine()
        if state["snap"] is not None:
            cache, state["cache"] = state["cache"], None
            eng.restore(state["snap"], cache=cache if keep_cache else None)
            del cache
        else:
            for req in requests:
                eng.submit(req)
        try:
            state["out"] = eng.run()
        except Exception as e:
            state["snap"] = eng.snapshot()
            state["cache"] = eng.cache
            # The traceback's frames hold the engine: clear them, so the
            # supervisor's saved exception does not keep its weights and
            # graph pools alive while the next engine is built.
            del eng
            traceback.clear_frames(e.__traceback__)
            raise

    supervise(attempt, max_restarts=max_restarts, backoff_s=backoff_s,
              log=log)
    return state["out"]  # type: ignore[return-value]
