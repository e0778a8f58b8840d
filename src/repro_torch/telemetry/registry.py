"""Process-global metrics registry: counters, gauges, histograms (the
port of ``repro/telemetry/registry.py``, the same code).

Pure host-side Python (stdlib only).  Metric names are dotted lowercase
``subsystem.metric[_unit]`` strings; the registry enforces one *type*
per name so two subsystems cannot register ``serving.ttft_s`` as both a
gauge and a histogram.  Histograms use **fixed bucket edges** chosen at
creation (the cumulative-bucket export is scrape-friendly) and
additionally retain raw samples so exact percentiles are available for
BENCH rows and per-request summaries — observation volume here is
per-request / per-host-sync, never per device op.
"""
from __future__ import annotations

import bisect
import random
import threading
import zlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "reset_registry", "publish",
           "DEFAULT_LATENCY_EDGES_S", "DEFAULT_MAX_SAMPLES"]

# Prometheus-style latency edges, in seconds: sub-ms decode steps up to
# multi-second stalls.  Values past the last edge land in +Inf.
DEFAULT_LATENCY_EDGES_S: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Retained-sample cap per histogram.  Below the cap percentiles are
# exact; past it a uniform reservoir (Algorithm R) bounds memory for
# long-lived serving processes while keeping percentiles an unbiased
# estimate.  Bucket counts, count and sum always stay exact.
DEFAULT_MAX_SAMPLES: int = 4096


class Counter:
    """Monotonic counter: ``inc`` only (decrements are a bug, not an API)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram + retained-sample reservoir for percentiles.

    ``bucket_counts()`` returns *cumulative* counts per edge (count of
    samples ``<= edge``) plus the +Inf total, the standard export shape.
    At most ``max_samples`` raw observations are retained: below the cap
    percentiles are exact; past it Algorithm R keeps a uniform reservoir
    (seeded per metric name, so runs are reproducible) and percentiles
    become unbiased estimates.  ``count``/``total``/buckets stay exact.
    """

    __slots__ = ("name", "edges", "count", "total", "max_samples",
                 "_bucket", "_samples", "_sorted", "_rng")

    def __init__(self, name: str,
                 edges: Sequence[float] = DEFAULT_LATENCY_EDGES_S,
                 max_samples: int = DEFAULT_MAX_SAMPLES):
        if not edges or list(edges) != sorted(float(e) for e in edges):
            raise ValueError(f"histogram {name}: edges must be a "
                             f"non-empty ascending sequence, got {edges!r}")
        if max_samples < 1:
            raise ValueError(f"histogram {name}: max_samples must be "
                             f">= 1, got {max_samples}")
        self.name = name
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.count = 0
        self.total = 0.0
        self.max_samples = int(max_samples)
        self._bucket = [0] * (len(self.edges) + 1)   # last = +Inf
        self._samples: List[float] = []
        self._sorted = True
        self._rng = random.Random(zlib.crc32(name.encode("utf-8")))

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self._bucket[bisect.bisect_left(self.edges, v)] += 1
        if len(self._samples) < self.max_samples:
            if self._samples and v < self._samples[-1]:
                self._sorted = False
            self._samples.append(v)
        else:
            # Algorithm R: sample i (0-based) replaces a reservoir slot
            # with probability max_samples / (i + 1).
            j = self._rng.randrange(self.count)
            if j < self.max_samples:
                self._samples[j] = v
                self._sorted = False

    @property
    def retained(self) -> int:
        """Raw observations currently held (<= ``max_samples``)."""
        return len(self._samples)

    def bucket_counts(self) -> List[Tuple[float, int]]:
        out, cum = [], 0
        for edge, n in zip(self.edges, self._bucket):
            cum += n
            out.append((edge, cum))
        out.append((float("inf"), self.count))
        return out

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Exact percentile from retained samples (0 <= p <= 100)."""
        if not self._samples:
            return 0.0
        if not self._sorted:
            self._samples.sort()
            self._sorted = True
        idx = min(len(self._samples) - 1,
                  max(0, int(round(p / 100.0 * (len(self._samples) - 1)))))
        return self._samples[idx]


class MetricsRegistry:
    """Name -> metric map with one-type-per-name enforcement."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_make(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_make(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_make(name, Gauge)

    def histogram(self, name: str,
                  edges: Sequence[float] = DEFAULT_LATENCY_EDGES_S,
                  max_samples: int = DEFAULT_MAX_SAMPLES) -> Histogram:
        return self._get_or_make(name, Histogram, edges, max_samples)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def as_dict(self) -> Dict[str, object]:
        """Flat scrape: counters/gauges -> value; histograms -> summary."""
        out: Dict[str, object] = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[name] = {"count": m.count, "sum": m.total,
                             "mean": m.mean,
                             "p50": m.percentile(50),
                             "p99": m.percentile(99)}
            else:
                out[name] = m.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_GLOBAL = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry (what the serving stack publishes to)."""
    return _GLOBAL


def reset_registry() -> None:
    """Clear the global registry (test / bench-section isolation)."""
    _GLOBAL.reset()


def publish(prefix: str, values: Mapping[str, object]) -> None:
    """Mirror an ad-hoc metrics dict into ``{prefix}.{key}`` gauges.

    Non-numeric values (format names, paths) are skipped — the legacy
    dict keeps them; the registry carries the numbers.  This is how the
    pre-telemetry ``metrics()`` surfaces stay authoritative while the
    registry becomes the machine-readable view of the same facts.
    """
    for key, val in values.items():
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        _GLOBAL.gauge(f"{prefix}.{key}").set(val)
