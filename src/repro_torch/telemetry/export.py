"""Metrics exposition: Prometheus text format + a structured health snapshot
(the port of ``repro/telemetry/export.py``).

Two consumers, one registry:

- :func:`render_prometheus` renders every registry metric in the
  Prometheus text exposition format (``# TYPE`` headers; histograms as
  cumulative ``_bucket{le="..."}`` series plus ``_sum``/``_count``) —
  what ``launch/serve.py --prom PATH`` writes.
  :func:`parse_prometheus` reads the same format back
  (round-trip tested), so the dump is machine-checkable without a
  Prometheus server in the container.
- :func:`health` assembles the single structured JSON snapshot the
  ``--status-json`` flag serves: registry scrape + KV-pool occupancy +
  scheduler depth + plan-cache and graph-program stats + SLO verdicts +
  profiler calibration summary.  :func:`validate_health` is the schema
  gate CI runs against the artifact.

Stdlib only; every collector input is an optional host-side object
(engine, profiler, SLO report) so the snapshot degrades to
``None``-valued sections rather than importing serving machinery it
does not need.
"""
from __future__ import annotations

import json
import math
import re
import time
from typing import Dict, List, Optional

# Import names straight from the submodule: the package re-exports a
# ``registry()`` *function* that shadows the submodule attribute.
from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry,
                                      registry as _global_registry)

__all__ = ["sanitize_metric_name", "render_prometheus", "parse_prometheus",
           "write_prometheus", "health", "validate_health", "write_health",
           "HEALTH_SCHEMA_VERSION"]

HEALTH_SCHEMA_VERSION = 1

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Dotted registry names -> Prometheus-legal ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = _NAME_BAD.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(reg: Optional[MetricsRegistry] = None) -> str:
    """The whole registry in Prometheus text exposition format."""
    reg = reg if reg is not None else _global_registry()
    lines: List[str] = []
    for name in reg.names():
        m = reg.get(name)
        pname = sanitize_metric_name(name)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_fmt_value(m.value)}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt_value(m.value)}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            for edge, cum in m.bucket_counts():
                lines.append(f'{pname}_bucket{{le="{_fmt_value(edge)}"}} '
                             f"{cum}")
            lines.append(f"{pname}_sum {_fmt_value(m.total)}")
            lines.append(f"{pname}_count {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{le="(?P<le>[^"]*)"\})?\s+(?P<value>\S+)$')


def parse_prometheus(text: str) -> Dict[str, Dict[str, object]]:
    """Parse exposition text back into ``{name: {type, value | buckets,
    sum, count}}`` (names in sanitized form).  Inverse of
    :func:`render_prometheus` for the metric shapes it emits."""
    out: Dict[str, Dict[str, object]] = {}
    types: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {raw!r}")
        name, le, value = m.group("name"), m.group("le"), float(
            m.group("value"))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types \
                    and types[name[:-len(suffix)]] == "histogram":
                base = name[:-len(suffix)]
                break
        mtype = types.get(base, "untyped")
        entry = out.setdefault(base, {"type": mtype})
        if mtype == "histogram" and base != name:
            if name.endswith("_bucket"):
                entry.setdefault("buckets", []).append((
                    float(le) if le not in (None, "+Inf") else float("inf"),
                    int(value)))
            elif name.endswith("_sum"):
                entry["sum"] = value
            else:
                entry["count"] = int(value)
        else:
            entry["value"] = value
    return out


def write_prometheus(path: str,
                     reg: Optional[MetricsRegistry] = None) -> str:
    text = render_prometheus(reg)
    with open(path, "w") as f:
        f.write(text)
    return text


# -- structured health snapshot ------------------------------------------------
def health(*, engine=None, profiler=None, slo_report=None,
           reg: Optional[MetricsRegistry] = None,
           timestamp: Optional[float] = None) -> Dict[str, object]:
    """One structured snapshot of everything observable.

    ``engine`` (a serving Engine) supplies the kv/scheduler sections;
    ``profiler`` (a :class:`DispatchProfiler`) the calibration summary;
    ``slo_report`` (an :class:`SloReport` or its ``as_dict()``) the SLO
    verdicts.  Absent collectors yield ``None`` sections, so the schema
    is stable regardless of what is running.
    """
    reg = reg if reg is not None else _global_registry()
    from repro_torch.core import autotune
    from repro_torch.graph import schedule as graph_schedule
    cs = autotune.cache_stats()
    ps = graph_schedule.program_stats()
    kv = scheduler = None
    if engine is not None:
        pool = engine.sched.pool
        kv = dict(pool.describe())
        scheduler = {
            "waiting": len(engine.sched.waiting),
            "active": sum(1 for r in engine.slot_req if r is not None),
            "slots": engine.slots,
            "step": engine.step_idx,
            "steps_in_flight": int(getattr(engine, "steps_in_flight", 0)),
        }
        if scheduler["steps_in_flight"] > 0:
            # Async pipelining: completion counters and token tallies
            # describe the last *delivered* step, not the launches still
            # on device — say so instead of reporting them finished.
            scheduler["staleness"] = (
                f"{scheduler['steps_in_flight']} step(s) in flight; "
                f"counters lag delivery by up to that many steps")
    slo = None
    if slo_report is not None:
        slo = slo_report.as_dict() if hasattr(slo_report, "as_dict") \
            else dict(slo_report)
    calibration = profiler.summary() if profiler is not None else None
    return {
        "version": HEALTH_SCHEMA_VERSION,
        "generated_unix_s": (time.time() if timestamp is None
                             else float(timestamp)),
        "registry": reg.as_dict(),
        "kv": kv,
        "scheduler": scheduler,
        "plan_cache": {
            "plans": len(autotune.plan_cache()._plans),
            "hits": cs.hits, "misses": cs.misses,
            "solver_calls": cs.solver_calls,
            "measured": cs.measured,
            "measure_failed": cs.measure_failed,
        },
        "graph_programs": {
            "compiles": ps.get("compiles", 0),
            "hits": ps.get("hits", 0),
            "programs": len(graph_schedule.compiled_programs()),
        },
        "slo": slo,
        "calibration": calibration,
    }


_TOP_KEYS = ("version", "generated_unix_s", "registry", "kv", "scheduler",
             "plan_cache", "graph_programs", "slo", "calibration")


def validate_health(doc) -> List[str]:
    """Schema check for a :func:`health` snapshot; returns error strings
    (empty list == valid).  This is what CI runs on the ``--status-json``
    artifact."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"health snapshot must be a dict, got {type(doc).__name__}"]
    for key in _TOP_KEYS:
        if key not in doc:
            errs.append(f"missing top-level key {key!r}")
    if errs:
        return errs
    if doc["version"] != HEALTH_SCHEMA_VERSION:
        errs.append(f"version must be {HEALTH_SCHEMA_VERSION}, "
                    f"got {doc['version']!r}")
    if not isinstance(doc["registry"], dict):
        errs.append("registry must be a dict")
    if not isinstance(doc["generated_unix_s"], (int, float)):
        errs.append("generated_unix_s must be numeric")
    for section, fields in (("plan_cache", ("plans", "hits", "misses",
                                            "solver_calls")),
                            ("graph_programs", ("compiles", "hits",
                                                "programs"))):
        sec = doc[section]
        if not isinstance(sec, dict):
            errs.append(f"{section} must be a dict")
            continue
        for f in fields:
            if not isinstance(sec.get(f), int):
                errs.append(f"{section}.{f} must be an int, "
                            f"got {sec.get(f)!r}")
    if doc["kv"] is not None:
        if not isinstance(doc["kv"], dict):
            errs.append("kv must be a dict or null")
        else:
            for f in ("num_pages", "free_pages", "used_pages"):
                if not isinstance(doc["kv"].get(f), int):
                    errs.append(f"kv.{f} must be an int")
    if doc["scheduler"] is not None:
        if not isinstance(doc["scheduler"], dict):
            errs.append("scheduler must be a dict or null")
        else:
            for f in ("waiting", "active", "slots"):
                if not isinstance(doc["scheduler"].get(f), int):
                    errs.append(f"scheduler.{f} must be an int")
            sif = doc["scheduler"].get("steps_in_flight")
            if sif is not None and not isinstance(sif, int):
                errs.append("scheduler.steps_in_flight must be an int")
            if (isinstance(sif, int) and sif > 0
                    and not isinstance(doc["scheduler"].get("staleness"),
                                       str)):
                errs.append("scheduler.staleness note required when "
                            "steps are in flight")
    if doc["slo"] is not None:
        slo = doc["slo"]
        if not isinstance(slo, dict) or not isinstance(
                slo.get("statuses"), list):
            errs.append("slo must be null or a dict with a statuses list")
        else:
            for i, s in enumerate(slo["statuses"]):
                if not isinstance(s, dict) or "name" not in s \
                        or not isinstance(s.get("ok"), bool):
                    errs.append(f"slo.statuses[{i}] needs name + bool ok")
    if doc["calibration"] is not None:
        cal = doc["calibration"]
        if not isinstance(cal, dict) or not isinstance(
                cal.get("rows"), list):
            errs.append("calibration must be null or a dict with rows")
        else:
            for i, row in enumerate(cal["rows"]):
                if not isinstance(row, dict):
                    errs.append(f"calibration.rows[{i}] must be a dict")
                    continue
                for f in ("shape_class", "fmt", "plan_source",
                          "dispatches", "error_ratio"):
                    if f not in row:
                        errs.append(f"calibration.rows[{i}] missing {f!r}")
                if row.get("sampled", 0):
                    err = row.get("error_ratio")
                    if not isinstance(err, (int, float)) \
                            or err != err or math.isinf(err):
                        errs.append(f"calibration.rows[{i}].error_ratio "
                                    f"must be finite for sampled rows, "
                                    f"got {err!r}")
    return errs


def write_health(path: str, **kwargs) -> Dict[str, object]:
    """Write a validated :func:`health` snapshot as JSON; raises
    ``ValueError`` (and writes nothing) if the snapshot fails its own
    schema — a malformed status file is worse than none."""
    doc = health(**kwargs)
    errs = validate_health(doc)
    if errs:
        raise ValueError(f"health snapshot failed validation: {errs}")
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc
