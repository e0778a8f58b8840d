"""Fault tolerance and straggler tooling (a copy of the stdlib-only
``repro/distributed/fault.py``; the port imports nothing of the JAX
package).

The failure model: a host dies (checkpoint, restart), a step stalls (a
straggler: the watchdog fires before a hung step holds the job forever),
or the coordinator dies (the supervisor restarts the job from LATEST).
The pieces the launcher composes:

- ``StepWatchdog``: detects hung or straggling steps by a wall-clock
  deadline and raises ``StragglerError`` at the next ``check()``, so the
  supervisor can restart; a deployment points ``on_timeout`` at its
  cluster manager.
- ``Heartbeat``: a periodic liveness file for external orchestrators.
- ``supervise()``: runs a training function with restart-on-failure,
  each attempt resuming from the latest checkpoint, up to
  ``max_restarts``.  The port trains on one device (no elastic mesh to
  rebuild: ROADMAP A12).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

__all__ = ["StragglerError", "StepWatchdog", "Heartbeat", "supervise"]


class StragglerError(RuntimeError):
    """A step exceeded its deadline — node straggling or collective hang."""


class StepWatchdog:
    """Arm before each step; disarm after.  Fires ``on_timeout`` (default:
    raises StragglerError in the main thread via a flag the next ``check()``
    observes — safe with steps that cannot be interrupted mid-call)."""

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._deadline: Optional[float] = None
        self._fired = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._stop = threading.Event()
        self._thread.start()

    def arm(self):
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
            self._fired = False

    def disarm(self):
        with self._lock:
            self._deadline = None

    def check(self):
        if self._fired:
            raise StragglerError(
                f"step exceeded {self.timeout_s}s deadline")

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(0.5):
            with self._lock:
                expired = (self._deadline is not None
                           and time.monotonic() > self._deadline)
                if expired:
                    self._deadline = None
                    self._fired = True
            if expired and self.on_timeout is not None:
                self.on_timeout()


class Heartbeat:
    """Touches ``path`` every ``interval_s`` while alive."""

    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def beat(self):
        """Write one liveness stamp, atomically: an external prober that
        races the write must see either the previous stamp or the new
        one, never a truncated file — so the stamp goes to a temp file in
        the same directory and ``os.replace`` swaps it in."""
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, self.path)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self):
        self._stop.set()


def supervise(run_fn: Callable[[int], None], *, max_restarts: int = 10,
              backoff_s: float = 5.0, log=print,
              on_give_up: Optional[Callable[[Exception], None]] = None
              ) -> int:
    """Run ``run_fn(attempt)`` with restart-on-failure.

    ``run_fn`` is expected to resume from the latest checkpoint itself
    (see ``repro_torch/launch/train.py``).  Returns the number of
    restarts consumed.

    When the restart budget is exhausted, ``on_give_up`` (if given) is
    called with the last exception — a deployment points it at its
    alerting/drain path — and that exception is re-raised; without the
    hook a ``RuntimeError`` summarising the budget is raised instead.
    """
    last: Optional[Exception] = None
    for attempt in range(max_restarts + 1):
        try:
            run_fn(attempt)
            return attempt
        except StragglerError as e:
            last = e
            log(f"[supervise] straggler on attempt {attempt}: {e}; "
                f"restarting from latest checkpoint")
        except Exception as e:  # noqa: BLE001 — any failure → restart
            last = e
            log(f"[supervise] failure on attempt {attempt}: "
                f"{type(e).__name__}: {e}; restarting")
        time.sleep(backoff_s)
    if on_give_up is not None:
        on_give_up(last)
        raise last
    raise RuntimeError(f"exceeded {max_restarts} restarts") from last
