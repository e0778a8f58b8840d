"""repro_torch.telemetry — the instrumentation floor of the serving stack
(the port of ``repro/telemetry``, the same modules and exports).

Three stdlib-only modules, loadable from any layer without cycles; they
read the host clock only and never wait for the device, so a span or a
record adds no sync to the engine's async pipeline:

- :mod:`repro_torch.telemetry.registry` — a process-global metrics
  registry of counters, gauges and fixed-bucket histograms.  **Naming a
  metric**: dotted lowercase ``subsystem.metric[_unit]`` —
  ``serving.ttft_s``, ``serving.decode_tokens``,
  ``autotune.plan_cache_hits``.  ``registry()`` returns the global
  instance; ``publish(prefix, mapping)`` mirrors an ad-hoc metrics dict
  into gauges.
- :mod:`repro_torch.telemetry.tracing` — a span tracer with a
  **zero-overhead no-op default**: ``tracing.current()`` returns a
  process-wide singleton whose ``span()`` returns one reusable no-op
  context manager, so hot loops may be instrumented unconditionally.
  ``Tracer.export()`` writes Chrome/Perfetto trace-event JSON (spans as
  phase-``X`` events, lifecycle marks as phase-``i`` instants).
- :mod:`repro_torch.telemetry.gemm_account` — per-GEMM dispatch
  accounting at the seams ``repro_torch.graph.trace.trace_gemms()``
  hooks (``dispatch.mte_gemm``, ``kernels/ops.py``, compiled-program
  nodes): signature, format, the paper's M/N/K shape class, plan source
  and modelled time.  A record is a dispatch as the host issues it: an
  eager call or a CUDA-graph capture, never a replay.

Three analysis modules turn those streams into answers (they import the
planner lazily inside functions):

- :mod:`repro_torch.telemetry.profiler` — :class:`DispatchProfiler`
  times each distinct dispatch signature's plan (CUDA events on the
  card), joins it against the planner's price into a per-(shape_class,
  fmt, plan_source) **calibration table**, and runs the **plan-regret
  audit** (granted plan vs analytic runner-up).
- :mod:`repro_torch.telemetry.slo` — declarative objectives over the
  registry evaluated as multi-window burn rates; :class:`SloMonitor`
  hooks the engine step.
- :mod:`repro_torch.telemetry.export` — Prometheus text exposition of
  the registry plus the structured :func:`health` JSON snapshot
  (``launch/serve.py --prom`` / ``--status-json``).
"""
from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            MetricsRegistry, publish,
                                            registry, reset_registry)
from repro_torch.telemetry.tracing import Tracer, validate_trace
from repro_torch.telemetry.gemm_account import (GemmAccountant, GemmRecord,
                                                account_gemms, shape_class)
from repro_torch.telemetry.profiler import DispatchProfiler, profile_records
from repro_torch.telemetry.slo import (Slo, SloMonitor, SloReport,
                                       SloStatus, default_slos)
from repro_torch.telemetry.export import (health, parse_prometheus,
                                          render_prometheus,
                                          validate_health)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "publish",
           "registry", "reset_registry", "Tracer", "validate_trace",
           "GemmAccountant", "GemmRecord", "account_gemms", "shape_class",
           "DispatchProfiler", "profile_records",
           "Slo", "SloMonitor", "SloReport", "SloStatus", "default_slos",
           "health", "parse_prometheus", "render_prometheus",
           "validate_health"]
