"""Span tracer with a zero-overhead no-op default (the port of
``repro/telemetry/tracing.py``, the same code).

``current()`` always returns a tracer-shaped object, so call sites need
no ``if`` guards::

    from repro_torch.telemetry import tracing
    with tracing.current().span("decode"):
        ...host-side work...

When no tracer is installed, ``current()`` is the module-wide
:data:`NOOP` singleton and ``NOOP.span(name)`` returns ONE reusable
no-op context manager — no object, list or dict is allocated per call,
which is what lets the serving hot loop stay instrumented
unconditionally (the ``test_telemetry`` no-op test asserts the
singleton identity and output bit-identity).

A real :class:`Tracer` records **Chrome/Perfetto trace-event JSON**
(the ``trace_event`` format both ``chrome://tracing`` and
``ui.perfetto.dev`` load directly):

- ``span(name)`` -> one phase-``X`` *complete* event per exit, with
  ``ts`` (begin) and ``dur`` in integer microseconds relative to tracer
  creation.  Nesting is positional: a child's ``[ts, ts+dur]`` interval
  sits inside its parent's on the same ``pid``/``tid``.
- ``instant(name, args=...)`` -> one phase-``i`` instant event (request
  lifecycle marks, fault firings).

Timestamps come from an injectable host clock (``time.perf_counter``)
and never wait for the device: a span never calls
``torch.cuda.synchronize()``, so it adds no sync to the engine's async
pipeline, and a span around a kernel launch measures the host's
enqueue, not the kernel.  Inside a CUDA-graph capture a span fires once,
at the capture; a replay runs no Python and records none.
``export(path)`` writes ``{"traceEvents": [...], "displayTimeUnit":
"ms"}``; :func:`validate_trace` is the schema check CI runs on the
artifact.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

__all__ = ["Tracer", "NOOP", "current", "active", "install", "uninstall",
           "trace_to", "span_overlaps", "validate_trace",
           "validate_trace_file"]

_PID = 1   # single-process engine: fixed pid/tid, nesting is by interval
_TID = 1


class _Span:
    """Context manager for one complete ('X') event."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._now_us()
        ev = {"name": self._name, "ph": "X", "ts": self._t0,
              "dur": max(0, t1 - self._t0), "pid": _PID, "tid": _TID,
              "cat": "engine"}
        if self._args:
            ev["args"] = dict(self._args)
        self._tracer.events.append(ev)
        return False


class _NoopSpan:
    """The one reusable do-nothing span (allocation-free hot path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NoopTracer:
    """Tracer-shaped sink: every method is a no-op returning singletons."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, args: Optional[dict] = None) -> _NoopSpan:
        return _NOOP_SPAN

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        return None


_NOOP_SPAN = _NoopSpan()
NOOP = _NoopTracer()


class Tracer:
    """Collects trace events; see the module docstring for the format."""

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self.events: List[Dict] = []

    def _now_us(self) -> int:
        return int((self._clock() - self._t0) * 1e6)

    def span(self, name: str, args: Optional[dict] = None) -> _Span:
        return _Span(self, name, args)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "i", "ts": self._now_us(), "pid": _PID,
              "tid": _TID, "cat": "engine", "s": "g"}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    def to_json(self) -> Dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)


_ACTIVE: Optional[Tracer] = None


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-wide collector (until ``uninstall``)."""
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Tracer]:
    """The installed tracer, or None — for callers that branch."""
    return _ACTIVE


def current():
    """The installed tracer, or the no-op singleton — never None."""
    return _ACTIVE if _ACTIVE is not None else NOOP


class trace_to:
    """``with trace_to("run.trace.json") as tr:`` — install a fresh
    tracer, export to ``path`` on exit (even on error), then uninstall."""

    def __init__(self, path: str,
                 clock: Optional[Callable[[], float]] = None):
        self.path = path
        self.tracer = Tracer(clock=clock)

    def __enter__(self) -> Tracer:
        return install(self.tracer)

    def __exit__(self, *exc):
        uninstall()
        self.tracer.export(self.path)
        return False


# -- schema validation (CI gate for the exported artifact) --------------------

_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def span_overlaps(doc: Dict, a: str, b: str) -> bool:
    """True when some complete ('X') span named ``a`` overlaps in wall
    time with some span named ``b`` — the async-pipelining witness: an
    in-flight ``decode`` span must cover the next step's host-side
    ``prefill_chunk``/``sample``/``admit`` spans.  Two intervals overlap
    when each starts strictly before the other ends."""
    ev = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    spans = {a: [], b: []}
    for e in ev:
        if (isinstance(e, dict) and e.get("ph") == "X"
                and e.get("name") in spans):
            t0 = e.get("ts", 0)
            spans[e["name"]].append((t0, t0 + e.get("dur", 0)))
    return any(a0 < b1 and b0 < a1
               for a0, a1 in spans[a] for b0, b1 in spans[b])


def validate_trace(doc: Dict, require_names: tuple = (),
                   require_overlap: tuple = ()) -> List[str]:
    """Chrome trace-event schema check.  Returns problem strings
    (empty list = valid, non-empty trace).  ``require_names`` lists
    event names that must appear at least once (coverage assertions for
    known spans, e.g. ``graph.program`` in a compiled serving trace).
    ``require_overlap`` lists ``(a, b)`` span-name pairs that must
    overlap in time somewhere in the trace — how CI proves the async
    engine actually pipelines (device decode vs next-step host work)
    rather than merely reordering."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"trace document is {type(doc).__name__}, not an object"]
    ev = doc.get("traceEvents")
    if not isinstance(ev, list):
        return ["traceEvents missing or not a list"]
    if not ev:
        return ["traceEvents is empty"]
    seen = set()
    for i, e in enumerate(ev):
        if not isinstance(e, dict):
            errs.append(f"event {i} is not an object")
            continue
        seen.add(e.get("name"))
        for key in _REQUIRED:
            if key not in e:
                errs.append(f"event {i} ({e.get('name', '?')}) missing "
                            f"{key!r}")
        if e.get("ph") == "X" and "dur" not in e:
            errs.append(f"event {i} ({e.get('name', '?')}): complete "
                        f"event without dur")
        if not isinstance(e.get("ts", 0), int):
            errs.append(f"event {i}: ts must be integer microseconds")
        if "args" in e and not isinstance(e["args"], dict):
            errs.append(f"event {i} ({e.get('name', '?')}): args must "
                        f"be an object")
        if errs and len(errs) > 20:
            errs.append("... (truncated)")
            break
    for name in require_names:
        if name not in seen:
            errs.append(f"required event {name!r} never appears")
    for a, b in require_overlap:
        if not span_overlaps(doc, a, b):
            errs.append(f"required overlap {a!r} x {b!r} never occurs")
    return errs


def validate_trace_file(path: str, require_names: tuple = (),
                        require_overlap: tuple = ()) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable trace {path}: {e}"]
    return validate_trace(doc, require_names=require_names,
                          require_overlap=require_overlap)
