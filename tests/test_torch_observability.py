"""The port's observability layer (``repro_torch.telemetry``: profiler,
slo, export) against the JAX package's, case for case with
``tests/test_observability.py``, plus parity on the same inputs: the
Prometheus text of equal registries byte for byte, health snapshots each
package's validator accepts, SLO reports under an injected clock, and
greedy streams with the whole stack on equal to those with it off and to
the JAX engine's, synchronous and async."""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.telemetry import export as jexport
from repro.telemetry import slo as jslo
from repro.telemetry.registry import MetricsRegistry as JMetricsRegistry

from torch_lazy import LazyModule, torch
from torch_parity import jax_cfg, jax_params, torch_cfg, torch_model

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tdispatch = LazyModule("repro_torch.core.dispatch")
tperfmodel = LazyModule("repro_torch.core.perfmodel")
tengine = LazyModule("repro_torch.serving.engine")
tfuse = LazyModule("repro_torch.graph.fuse")
tgraph = LazyModule("repro_torch.graph")
tir = LazyModule("repro_torch.graph.ir")
tschedule = LazyModule("repro_torch.graph.schedule")
texport = LazyModule("repro_torch.telemetry.export")
tacct = LazyModule("repro_torch.telemetry.gemm_account")
tprofiler = LazyModule("repro_torch.telemetry.profiler")
treg = LazyModule("repro_torch.telemetry.registry")
tslo = LazyModule("repro_torch.telemetry.slo")
ttracing = LazyModule("repro_torch.telemetry.tracing")

RNG = np.random.default_rng(23)


def _reset():
    tautotune.reset_cache()
    tschedule.reset_programs()
    treg.reset_registry()
    ttracing.uninstall()
    tacct.uninstall()
    tperfmodel.clear_calibration()


@pytest.fixture(autouse=True)
def clean_telemetry():
    _reset()
    yield
    _reset()


def _arr(*shape):
    return torch.as_tensor(RNG.standard_normal(shape).astype(np.float32))


def _profiler(acct):
    return tprofiler.DispatchProfiler(acct, iters=1, device="cpu")


# -- histogram reservoir ------------------------------------------------------


def test_histogram_reservoir_bounds_memory():
    h = treg.Histogram("r.lat_s", edges=(0.5,), max_samples=64)
    for i in range(1000):
        h.observe(float(i))
    assert h.retained == 64
    assert h.count == 1000
    assert h.total == sum(range(1000))
    assert h.bucket_counts() == [(0.5, 1), (float("inf"), 1000)]
    assert 100.0 < h.percentile(50) < 900.0


def test_histogram_exact_below_cap_and_default_cap():
    h = treg.Histogram("r.small_s", edges=(1.0,), max_samples=8)
    for v in (5.0, 1.0, 3.0):
        h.observe(v)
    assert h.retained == 3
    assert h.percentile(0) == 1.0 and h.percentile(100) == 5.0
    assert treg.Histogram("r.dflt_s").max_samples == treg.DEFAULT_MAX_SAMPLES
    with pytest.raises(ValueError):
        treg.Histogram("r.bad_s", max_samples=0)
    reg = treg.MetricsRegistry()
    assert reg.histogram("x.h", max_samples=16).max_samples == 16


def test_histogram_reservoir_deterministic_per_name():
    def fill(name):
        h = treg.Histogram(name, edges=(0.5,), max_samples=16)
        for i in range(200):
            h.observe(float(i))
        return list(h._samples)
    assert fill("a.h_s") == fill("a.h_s")


# -- prometheus exposition ----------------------------------------------------


def _fill(reg):
    reg.counter("serving.tokens_total").inc(41)
    reg.gauge("kv.free_pages").set(12.5)
    reg.gauge("serving.steps_in_flight").set(2)
    h = reg.histogram("serving.ttft_s", edges=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, float("inf")):
        h.observe(v)
    reg.histogram("serving.e2e_s").observe(0.123456789)
    return h


def test_prometheus_round_trips_every_metric_type():
    reg = treg.MetricsRegistry()
    h = _fill(reg)
    text = texport.render_prometheus(reg)
    parsed = texport.parse_prometheus(text)
    c = parsed[texport.sanitize_metric_name("serving.tokens_total")]
    assert c["type"] == "counter" and c["value"] == 41
    g = parsed[texport.sanitize_metric_name("kv.free_pages")]
    assert g["type"] == "gauge" and g["value"] == 12.5
    hp = parsed[texport.sanitize_metric_name("serving.ttft_s")]
    assert hp["type"] == "histogram"
    assert hp["count"] == h.count
    assert hp["sum"] == pytest.approx(h.total)
    assert hp["buckets"] == [(e, c) for e, c in h.bucket_counts()]
    assert len(parsed) == len(reg.names())
    # Equal registries render byte for byte as the JAX package's, and
    # each package parses the other's text alike.
    ref = JMetricsRegistry()
    _fill(ref)
    assert text == jexport.render_prometheus(ref)
    assert jexport.parse_prometheus(text) == parsed


def test_prometheus_name_sanitization():
    assert texport.sanitize_metric_name("a.b-c d") == "a_b_c_d"
    assert texport.sanitize_metric_name("9lives") == "_9lives"
    for name in ("slo.ttft_p99.ok", "kv.free_pages", "x y.z", "0a"):
        assert texport.sanitize_metric_name(name) == \
            jexport.sanitize_metric_name(name)
    with pytest.raises(ValueError):
        texport.parse_prometheus("not a metric line at all!!")


# -- the calibration join -----------------------------------------------------


def _grouped_program():
    m, d, n = 8, 64, 48
    b = tgraph.GraphBuilder()
    x = b.input((m, d), "float32")
    ws = [b.input((d, n), "float32") for _ in range(3)]
    b.output(*(b.gemm(x, w, fmt="fp32") for w in ws))
    grouped = tfuse.fuse(b.build(), rules=(tfuse.group_siblings,))
    assert any(isinstance(nd, tir.GroupNode) for nd in grouped.nodes)
    args = (_arr(m, d), _arr(d, n), _arr(d, n), _arr(d, n))
    return grouped, args


def test_calibration_join_counts_grouped_dispatch_once():
    grouped, args = _grouped_program()
    with tacct.account_gemms() as acct:
        prog = tgraph.compile_graph(grouped, fuse=False)
        prog(*args)
    assert len(acct.records) == 1
    prof = _profiler(acct)
    assert prof.sample() == 1
    (row,) = prof.calibration_table()
    assert row.dispatches == 1 and row.grouped == 1
    assert row.plan_source == "program"
    assert row.signatures == 1 and row.sampled == 1
    assert row.measured_s > 0 and row.modeled_s > 0
    assert row.error_ratio == row.error_ratio
    assert row.time_share == pytest.approx(1.0)


def test_calibration_covers_planned_and_unplanned_traffic():
    a, b = _arr(16, 64), _arr(64, 32)
    with tacct.account_gemms() as acct:
        tdispatch.mte_gemm(a, b, backend="kernels")
        tdispatch.mte_gemm(a, b, backend="kernels")
        tdispatch.mte_gemm(a, b, backend="torch")
    prof = _profiler(acct)
    assert prof.sample() == 2
    srcs = {r.plan_source for r in prof.calibration_table()}
    assert {"unplanned", "analytic", "cache-hit"} <= srcs
    torch_rec = [r for r in acct.records if r.backend == "torch"]
    assert torch_rec and torch_rec[0].modeled_s > 0
    assert sum(r.time_share for r in prof.calibration_table()) == \
        pytest.approx(1.0)
    assert len(acct.records) == 3
    # The planner-bypassing key is timed on route "torch".
    key = (16, 32, 64, "fp32", "mte", "torch", 1)
    assert prof._plan_for(key).route == "torch"


def test_install_calibration_feeds_perfmodel():
    a, b = _arr(16, 64), _arr(64, 32)
    with tacct.account_gemms() as acct:
        tdispatch.mte_gemm(a, b, backend="torch")
    prof = _profiler(acct)
    prof.sample()
    assert prof.install_calibration() >= 1
    cal = tperfmodel.calibration()
    assert cal and all(v > 0 for v in cal.values())
    base = tperfmodel.analytic_seconds(16, 32, 64)
    scaled = tperfmodel.calibrated_seconds(base, "tall_skinny", "fp32")
    assert scaled == pytest.approx(base * cal["tall_skinny/fp32"])
    with pytest.raises(ValueError):
        tperfmodel.set_calibration("square", "fp32", float("inf"))
    tperfmodel.clear_calibration()
    assert tperfmodel.calibration() == {}


# -- plan-regret audit + recalibrate ------------------------------------------


def test_runner_up_differs_from_grant():
    a, b = _arr(64, 64), _arr(64, 48)
    tdispatch.mte_gemm(a, b, backend="kernels")
    cache = tautotune.plan_cache()
    (sig,) = list(cache._plans)
    granted = cache._plans[sig]
    runner = cache.runner_up(sig)
    assert runner is not None
    assert (runner.geometry != granted.geometry
            or runner.route != granted.route)
    assert cache.runner_up(dataclasses.replace(sig, m=999)) is None
    ranked = cache.analytic_candidates(sig)
    assert ranked[0].geometry == granted.geometry
    assert [p.predicted_s for p in ranked] == sorted(
        p.predicted_s for p in ranked)


def test_regret_audit_and_recalibrate():
    a, b = _arr(64, 64), _arr(64, 48)
    with tacct.account_gemms() as acct:
        tdispatch.mte_gemm(a, b, backend="kernels")
        tdispatch.mte_gemm(a, b, backend="kernels")
    prof = _profiler(acct)
    prof.sample()
    audit = prof.regret_audit(top_k=2)
    assert len(audit) == 1
    (e,) = audit
    assert e["dispatches"] == 2
    assert e["granted_s"] > 0 and e["runner_s"] > 0
    assert isinstance(e["flagged"], bool)
    cache = tautotune.plan_cache()
    (sig,) = list(cache._plans)
    new = cache.recalibrate(sig, device="cpu")
    assert new.source == "measured" and new.measured_s is not None
    assert cache._plans[sig] is new
    summary = prof.summary()
    assert summary["regret"]["audited"] == 1
    assert summary["sampled"] >= 1


# -- SLO monitor --------------------------------------------------------------


def test_slo_vacuous_when_unobserved():
    mon = tslo.SloMonitor(tslo.default_slos())
    rep = mon.observe(step=1)
    assert rep.ok and not rep.breaching
    assert all(not s.observed for s in rep.statuses)


def _burn_script(slo_mod, reg):
    """The JAX test's burn-window script against ``reg`` → its reports."""
    reg.gauge("q.depth").set(50.0)
    t = [0.0]
    mon = slo_mod.SloMonitor(
        (slo_mod.Slo("depth", "q.depth", "max", 10.0),
         slo_mod.Slo("lat", "q.lat_s", "max", 0.2, percentile=99)),
        windows=(slo_mod.Window("short", 1.0), slo_mod.Window("long", 10.0)),
        budget_frac=0.5, clock=lambda: t[0], registry=reg)
    reports = [mon.observe(step=1)]
    reg.gauge("q.depth").set(1.0)
    for v in (0.1, 0.3, 0.05):
        reg.histogram("q.lat_s").observe(v)
    t[0] = 2.0
    reports.append(mon.observe(step=2))
    t[0] = 2.5
    reports.append(mon.observe(step=3))
    return reports


def test_slo_violation_breaching_and_burn_windows():
    reg = treg.registry()
    r1, r2, _ = _burn_script(tslo, reg)
    s1 = r1.statuses[0]
    assert not s1.ok and s1.observed and s1.value == 50.0
    assert s1.burn_rates == {"short": 2.0, "long": 2.0}
    assert s1.breaching and r1.breaching == ("depth",)
    s2 = r2.statuses[0]
    assert s2.ok and not s2.breaching
    assert s2.burn_rates["short"] == 0.0
    assert s2.burn_rates["long"] == 1.0
    assert reg.get("slo.depth.ok").value == 1.0
    assert reg.get("slo.evaluations").value == 3.0
    # Under the same injected clock the JAX package's monitor gives the
    # same reports, and its registry the same verdict gauges.
    ref_reg = JMetricsRegistry()
    ref = _burn_script(jslo, ref_reg)
    assert [r.as_dict() for r in _burn_script(tslo, treg.MetricsRegistry())
            ] == [r.as_dict() for r in ref]
    assert [r.format_report() for r in (r1, r2)] == \
        [r.format_report() for r in ref[:2]]
    assert reg.as_dict() == ref_reg.as_dict()


def test_slo_ratio_and_min_objectives():
    reg = treg.registry()
    reg.gauge("s.err").set(3.0)
    reg.gauge("s.total").set(100.0)
    reg.gauge("s.free").set(1.0)
    reg.gauge("s.cap").set(100.0)
    mon = tslo.SloMonitor((
        tslo.Slo("err_rate", "s.err", "max", 0.05, total="s.total"),
        tslo.Slo("headroom", "s.free", "min", 0.10, total="s.cap"),
    ))
    rep = mon.observe()
    by = {s.name: s for s in rep.statuses}
    assert by["err_rate"].ok and by["err_rate"].value == pytest.approx(0.03)
    assert not by["headroom"].ok
    assert by["headroom"].value == pytest.approx(0.01)
    reg.gauge("s.total").set(0.0)
    rep2 = mon.observe()
    assert {s.name: s.observed for s in rep2.statuses}["err_rate"] is False
    d = rep2.as_dict()
    assert isinstance(d["statuses"], list) and "ok" in d
    with pytest.raises(ValueError):
        tslo.Slo("bad", "x", "between", 1.0)
    with pytest.raises(ValueError):
        tslo.SloMonitor((tslo.Slo("a", "x", "max", 1.0),
                         tslo.Slo("a", "y", "max", 1.0)))
    assert [s.describe() for s in tslo.default_slos()] == \
        [s.describe() for s in jslo.default_slos()]


# -- health snapshot ----------------------------------------------------------


def test_health_schema_and_validation():
    doc = texport.health(timestamp=123.0)
    assert texport.validate_health(doc) == []
    assert jexport.validate_health(doc) == []
    assert doc["kv"] is None and doc["slo"] is None
    assert doc["generated_unix_s"] == 123.0
    assert {"measured", "measure_failed"} <= set(doc["plan_cache"])
    bad = dict(doc, version=99)
    assert any("version" in e for e in texport.validate_health(bad))
    bad2 = dict(doc, calibration={"rows": [
        {"shape_class": "square", "fmt": "fp32", "plan_source": "x",
         "dispatches": 1, "sampled": 1, "error_ratio": float("nan")}]})
    assert any("error_ratio" in e for e in texport.validate_health(bad2))
    assert texport.validate_health([]) != []
    for d in (doc, bad, bad2, [], {}):
        assert texport.validate_health(d) == jexport.validate_health(d)


def test_write_health_refuses_invalid(tmp_path, monkeypatch):
    path = tmp_path / "h.json"
    doc = texport.write_health(str(path), timestamp=1.0)
    assert path.exists() and doc["version"] == 1
    broken = dict(doc)
    del broken["registry"]
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.telemetry.export"), "health", lambda **kw: broken)
    with pytest.raises(ValueError):
        texport.write_health(str(tmp_path / "h2.json"), timestamp=1.0)
    assert not (tmp_path / "h2.json").exists()


# -- graph.program spans ------------------------------------------------------


def test_graph_program_span_emitted_with_args():
    grouped, args = _grouped_program()
    prog = tgraph.compile_graph(grouped, fuse=False)
    tr = ttracing.install(ttracing.Tracer())
    try:
        prog(*args)
    finally:
        ttracing.uninstall()
    spans = [e for e in tr.events if e["name"] == "graph.program"]
    assert len(spans) == 1
    a = spans[0]["args"]
    assert a["signature"] == prog.signature
    assert a["nodes"] == len(prog.graph.nodes)
    assert a["grouped"] == 1
    assert a["dispatches"] == prog.n_dispatches
    assert ttracing.validate_trace(tr.to_json(),
                                   require_names=("graph.program",)) == []
    errs = ttracing.validate_trace(tr.to_json(),
                                   require_names=("nonexistent.span",))
    assert any("nonexistent.span" in e for e in errs)


def test_validate_trace_rejects_non_dict_args():
    doc = {"traceEvents": [{"name": "a", "ph": "i", "ts": 0, "pid": 1,
                            "tid": 1, "args": "oops"}]}
    assert any("args" in e for e in ttracing.validate_trace(doc))


# -- engine integration -------------------------------------------------------


_KW = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
           prefill_chunk=16)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    head = rng.integers(0, vocab, 24, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, n,
                                               dtype=np.int32)])
            for n in (8, 8, 3)]


def _serve(eng, request_cls, prompts, max_tokens=6):
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=p, max_tokens=max_tokens))
    return {rid: list(v) for rid, v in eng.run().items()}


def test_engine_publishes_kv_gauges_each_step():
    cfg = torch_cfg()
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    eng = tengine.ServingEngine(params, cfg, device="cpu", **_KW)
    _serve(eng, tengine.Request, _prompts(cfg.vocab)[:1])
    reg = treg.registry()
    desc = eng.sched.pool.describe()
    for key in desc:
        g = reg.get(f"kv.{key}")
        assert g is not None, key
        assert g.value == desc[key]
    assert reg.get("serving.queue_depth").value == 0.0
    assert reg.get("serving.active_slots").value == 0.0
    assert reg.get("serving.finished_requests").value == 1


@functools.lru_cache(maxsize=None)
def _jax_streams():
    """The JAX engine's greedy streams (synchronous, ungrouped q/k/v,
    eager kernel path; positions copied before each launch, see
    test_torch_serving._jax_engine)."""
    jcfg = jax_cfg()
    jp, _ = jax_params(jcfg)
    eng = JEngine(jp, jcfg, grouped_qkv=False, async_steps=False, **_KW)
    make_batch = eng._make_batch
    eng._make_batch = lambda tokens, **arrays: make_batch(tokens, **{
        k: np.array(v) if isinstance(v, np.ndarray) else v
        for k, v in arrays.items()})
    return _serve(eng, JRequest, _prompts(jcfg.vocab))


@pytest.mark.parametrize("async_steps", [False, True],
                         ids=["sync", "async"])
def test_engine_outputs_bit_identical_with_observability_stack(async_steps):
    """The whole stack — accountant, tracer, registry, SLO monitor, then
    profiler, regret audit, exporters — changes no greedy token: the port
    with it equals the port without it and the JAX engine, with and
    without speculation."""
    _, tp = jax_params(jax_cfg())
    cfg = torch_cfg()
    prompts = _prompts(cfg.vocab)

    def run(**kw):
        eng = tengine.ServingEngine(tp, cfg, device="cpu",
                                    async_steps=async_steps, **_KW, **kw)
        return eng, _serve(eng, tengine.Request, prompts)

    _, base = run()
    _, spec_base = run(spec_k=3)
    _reset()
    tracer = ttracing.install(ttracing.Tracer())
    acct = tacct.install(tacct.GemmAccountant())
    mon = tslo.SloMonitor(tslo.default_slos(ttft_p99_s=300.0,
                                            error_rate=0.9,
                                            min_free_page_frac=0.0))
    try:
        eng, observed = run(slo_monitor=mon)
        prof = _profiler(acct)
        prof.sample()
        prof.regret_audit(top_k=2)
        text = texport.render_prometheus()
        doc = texport.health(engine=eng, profiler=prof,
                             slo_report=mon.last_report)
        _, spec_observed = run(spec_k=3)
    finally:
        ttracing.uninstall()
        tacct.uninstall()
    assert observed == base == _jax_streams()
    assert spec_observed == spec_base == base
    assert mon.evaluations == eng.step_idx
    assert mon.last_report is not None and mon.last_report.ok
    assert texport.validate_health(doc) == []
    assert jexport.validate_health(doc) == []
    assert doc["slo"]["ok"] is True
    assert doc["calibration"]["sampled"] >= 1
    assert doc["kv"]["num_pages"] == eng.sched.pool.num_pages
    assert doc["scheduler"]["slots"] == 2
    parsed = texport.parse_prometheus(text)
    assert any(k.startswith("kv_") for k in parsed)
    assert any(k.startswith("slo_") for k in parsed)
    names = {e["name"] for e in tracer.events}
    assert {"draft", "verify", "sample", "request.first_token"} <= names
    assert ttracing.validate_trace(tracer.to_json()) == []
