"""Per-request results and the request-error taxonomy (the part of
``repro/serving/resilience.py`` the port runs).

:class:`Response` is what ``ServingEngine.run()`` returns per request: the
generated tokens (it subclasses ``list``) plus a structured ``status``,
``error`` and ``metrics``.  Every abnormal ending has a
:class:`RequestError` subclass with a stable ``code``.

Queued (ROADMAP A6): ``FaultInjector`` and ``serve_with_recovery``.
"""
from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["RequestError", "DeadlineExceeded", "Shed", "PoisonedOutput",
           "CapacityExceeded", "Response"]


class RequestError(RuntimeError):
    """A request ended abnormally; ``code`` is its :class:`Response`
    status string."""

    code = "error"

    def __init__(self, message: str = "", *, rid: Optional[int] = None):
        super().__init__(message or self.__class__.__name__)
        self.rid = rid


class DeadlineExceeded(RequestError):
    code = "deadline"


class Shed(RequestError):
    code = "shed"


class PoisonedOutput(RequestError):
    """The request's logits went NaN/inf; its slot was quarantined."""

    code = "poisoned"


class CapacityExceeded(RequestError):
    """The request can never be admitted (pool or token budget too small
    for it alone)."""

    code = "capacity"


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
