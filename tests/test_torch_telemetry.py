"""The port's telemetry floor (``repro_torch.telemetry``: registry, tracing,
gemm_account) against the JAX package's, case for case with
``tests/test_telemetry.py``, plus parity on the same inputs: histogram
snapshots sample for sample, traces each package's validator accepts,
``shape_class`` on a grid, the traffic table's text, and the multiset of
dispatch keys (m, n, k, fmt, policy, group) of a reduced gemma_2b forward
and the set of an engine run, and the ``fault.<kind>`` instant of a fault
firing."""
import collections
import dataclasses
import functools
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import model as jax_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.telemetry import gemm_account as jacct
from repro.telemetry import tracing as jtracing
from repro.telemetry.registry import Histogram as JHistogram

from torch_lazy import LazyModule, torch
from torch_parity import jax_cfg, jax_params, torch_cfg, torch_model

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tdispatch = LazyModule("repro_torch.core.dispatch")
tformats = LazyModule("repro_torch.core.formats")
tengine = LazyModule("repro_torch.serving.engine")
tkv = LazyModule("repro_torch.serving.kv_cache")
tfuse = LazyModule("repro_torch.graph.fuse")
tgraph = LazyModule("repro_torch.graph")
tir = LazyModule("repro_torch.graph.ir")
tops = LazyModule("repro_torch.kernels.ops")
tschedule = LazyModule("repro_torch.graph.schedule")
tacct = LazyModule("repro_torch.telemetry.gemm_account")
treg = LazyModule("repro_torch.telemetry.registry")
ttracing = LazyModule("repro_torch.telemetry.tracing")

RNG = np.random.default_rng(11)


def _reset_port():
    tautotune.reset_cache()
    tschedule.reset_programs()
    treg.reset_registry()
    ttracing.uninstall()
    tacct.uninstall()


@pytest.fixture(autouse=True)
def clean_telemetry():
    """Telemetry is process-global state in both packages: every test
    starts and ends with nothing installed and empty caches."""
    _reset_port()
    jtracing.uninstall()
    jacct.uninstall()
    yield
    _reset_port()
    jtracing.uninstall()
    jacct.uninstall()


def _arr(*shape):
    return torch.as_tensor(RNG.standard_normal(shape).astype(np.float32))


# -- metrics registry ---------------------------------------------------------


def test_counter_monotonic_and_gauge():
    reg = treg.MetricsRegistry()
    c = reg.counter("a.b_total")
    c.inc()
    c.inc(3)
    assert c.value == 4
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("a.g")
    g.set(2.5)
    g.set(1.5)
    assert g.value == 1.5


def test_histogram_buckets_mean_percentile():
    h = treg.Histogram("lat_s", edges=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.005, 0.05, 0.5):
        h.observe(v)
    assert h.count == 4
    assert h.mean == pytest.approx((0.0005 + 0.005 + 0.05 + 0.5) / 4)
    assert h.bucket_counts() == [(0.001, 1), (0.01, 2), (0.1, 3),
                                 (float("inf"), 4)]
    assert h.percentile(0) == 0.0005
    assert h.percentile(100) == 0.5
    assert h.percentile(50) in (0.005, 0.05)
    h.observe(0.0001)
    assert h.percentile(0) == 0.0001
    with pytest.raises(ValueError):
        treg.Histogram("bad", edges=(0.1, 0.01))


@pytest.mark.parametrize("name,cap,n", [("serving.ttft_s", 4096, 300),
                                        ("serving.inter_token_s", 64, 1000),
                                        ("kv.lat_ms", 16, 257)])
def test_histogram_snapshots_equal_jax(name, cap, n):
    """The same observations give the same snapshot in both packages:
    buckets, count, sum, mean, percentiles and, past the cap, the seeded
    reservoir sample for sample."""
    values = np.random.default_rng(n).exponential(0.05, n).tolist()
    hists = [cls(name, max_samples=cap) for cls in (treg.Histogram,
                                                    JHistogram)]
    for v in values:
        for h in hists:
            h.observe(v)
    port, ref = hists
    assert port._samples == ref._samples
    assert port.retained == ref.retained == min(cap, n)
    assert port.bucket_counts() == ref.bucket_counts()
    assert (port.count, port.total, port.mean) == (ref.count, ref.total,
                                                   ref.mean)
    for p in (0, 1, 50, 90, 99, 100):
        assert port.percentile(p) == ref.percentile(p)


def test_registry_one_type_per_name_and_reset():
    reg = treg.MetricsRegistry()
    reg.counter("x.n")
    assert reg.counter("x.n") is reg.get("x.n")
    with pytest.raises(TypeError):
        reg.histogram("x.n")
    reg.histogram("x.h").observe(0.2)
    d = reg.as_dict()
    assert d["x.n"] == 0.0
    assert d["x.h"]["count"] == 1
    assert reg.names() == ["x.h", "x.n"]
    reg.reset()
    assert reg.names() == []


def test_publish_mirrors_numbers_skips_rest():
    treg.publish("sub", {"a": 3, "b": 2.5, "fmt": "int8pt", "flag": True})
    reg = treg.registry()
    assert reg.get("sub.a").value == 3
    assert reg.get("sub.b").value == 2.5
    assert reg.get("sub.fmt") is None
    assert reg.get("sub.flag") is None


# -- span tracer + trace-event JSON -------------------------------------------


def test_noop_tracer_is_allocation_free_singleton():
    assert ttracing.active() is None
    assert ttracing.current() is ttracing.NOOP
    assert ttracing.NOOP.span("a") is ttracing.NOOP.span("b")
    with ttracing.NOOP.span("decode"):
        pass
    assert ttracing.NOOP.instant("x", args={"k": 1}) is None


def _ms_clock():
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]
    return clock


def _nest(mod):
    """The nesting script of the JAX test through ``mod``'s tracer."""
    tr = mod.Tracer(clock=_ms_clock())
    mod.install(tr)
    with mod.current().span("parent"):
        with mod.current().span("child", args={"slot": 3}):
            pass
        tr.instant("request.first_token", args={"rid": 0})
    mod.uninstall()
    return tr


def test_span_nesting_and_schema(tmp_path):
    tr = _nest(ttracing)
    assert ttracing.current() is ttracing.NOOP
    by_name = {e["name"]: e for e in tr.events}
    child, parent = by_name["child"], by_name["parent"]
    assert tr.events[0]["name"] == "child"
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
    assert child["args"] == {"slot": 3}
    inst = by_name["request.first_token"]
    assert inst["ph"] == "i" and inst["s"] == "g"
    assert all(isinstance(e["ts"], int) for e in tr.events)
    doc = tr.to_json()
    assert doc["displayTimeUnit"] == "ms"
    assert ttracing.validate_trace(doc) == []
    path = tmp_path / "t.trace.json"
    tr.export(str(path))
    assert ttracing.validate_trace_file(str(path)) == []
    assert json.load(open(path))["traceEvents"] == tr.events
    # The same script under the same clock: the same document, which
    # each package's validator accepts.
    ref = _nest(jtracing).to_json()
    assert doc == ref
    assert jtracing.validate_trace(doc) == []
    assert ttracing.validate_trace(ref) == []


_BAD_TRACES = [[], {}, {"traceEvents": []},
               {"traceEvents": [{"name": "x", "ph": "X", "ts": 1.5,
                                 "pid": 1, "tid": 1}]},
               {"traceEvents": [{"name": "a", "ph": "i", "ts": 0,
                                 "pid": 1, "tid": 1, "args": "oops"}]}]


def test_validate_trace_rejects_bad_documents(tmp_path):
    assert ttracing.validate_trace([]) != []
    assert ttracing.validate_trace({}) != []
    assert ttracing.validate_trace({"traceEvents": []}) != []
    errs = ttracing.validate_trace(_BAD_TRACES[3])
    assert any("dur" in e for e in errs)
    assert any("integer" in e for e in errs)
    assert ttracing.validate_trace_file(str(tmp_path / "absent.json")) != []
    for doc in _BAD_TRACES:
        assert ttracing.validate_trace(doc) == jtracing.validate_trace(doc)


def test_trace_to_exports_even_on_error(tmp_path):
    path = tmp_path / "run.trace.json"
    with pytest.raises(RuntimeError):
        with ttracing.trace_to(str(path)) as tr:
            assert ttracing.current() is tr
            with tr.span("phase"):
                pass
            raise RuntimeError("boom")
    assert ttracing.active() is None
    assert ttracing.validate_trace_file(str(path)) == []
    assert jtracing.validate_trace_file(str(path)) == []


# -- per-GEMM dispatch accounting ---------------------------------------------


def test_shape_class_families():
    assert tacct.shape_class(1, 2048, 2048) == "tall_skinny"
    assert tacct.shape_class(2048, 16, 2048) == "tall_skinny"
    assert tacct.shape_class(8, 8, 8) == "small"
    assert tacct.shape_class(256, 256, 256) == "square"
    assert tacct.shape_class(64, 8192, 64) == "rect"
    grid = (1, 4, 16, 32, 33, 64, 128, 512, 2048, 16384)
    for m in grid:
        for n in grid:
            for k in grid:
                assert tacct.shape_class(m, n, k) == \
                    jacct.shape_class(m, n, k), (m, n, k)


def test_kernels_gemm_one_record_with_plan_provenance():
    a, b = _arr(8, 64), _arr(64, 48)
    with tacct.account_gemms() as acct:
        tops.mte_gemm(a, b)
        tops.mte_gemm(a, b)
    assert len(acct.records) == 2
    first, second = acct.records
    assert (first.m, first.n, first.k) == (8, 48, 64)
    assert first.backend == "kernels"
    assert first.plan_source == "analytic"
    assert first.modeled_s is not None and first.modeled_s > 0
    assert second.plan_source == "cache-hit"


def test_dispatch_torch_gemm_exactly_one_record():
    """dispatch.mte_gemm records itself and suppresses the inner
    formats.torch_gemm — one dispatch, one record."""
    a, b = _arr(4, 64), _arr(64, 96)
    with tacct.account_gemms() as acct:
        tdispatch.mte_gemm(a, b, backend="torch")
        tdispatch.mte_gemm(a, b, backend="reference")
    assert [r.backend for r in acct.records] == ["torch", "reference"]
    for r in acct.records:
        assert r.policy == "mte" and r.shape_class == "tall_skinny"
        assert r.plan_source == "unplanned" and r.modeled_s > 0


def test_formats_fallback_records_unplanned_and_suppressible():
    fmt = tformats.FORMATS["fp32"]
    a, b = _arr(4, 64), _arr(64, 32)
    with tacct.account_gemms() as acct:
        tformats.torch_gemm(a, b, fmt)
        with tacct.suppress():
            tformats.torch_gemm(a, b, fmt)
        tformats.torch_grouped(_arr(3, 4, 64), _arr(3, 64, 32), fmt)
    assert len(acct.records) == 2
    r, g = acct.records
    assert r.policy == "torch" and r.plan_source == "unplanned"
    assert (g.kind, g.group) == ("grouped", 3)
    assert tacct.active() is None


def test_grouped_siblings_are_one_record():
    """Three sibling GEMMs sharing a left operand, group-fused: ONE
    grouped launch, ONE record with group=3."""
    m, d, n = 8, 64, 48
    b = tgraph.GraphBuilder()
    x = b.input((m, d), "float32")
    ws = [b.input((d, n), "float32") for _ in range(3)]
    b.output(*(b.gemm(x, w, fmt="fp32") for w in ws))
    grouped = tfuse.fuse(b.build(), rules=(tfuse.group_siblings,))
    assert any(isinstance(nd, tir.GroupNode) for nd in grouped.nodes)
    args = (_arr(m, d), _arr(d, n), _arr(d, n), _arr(d, n))
    with tacct.account_gemms() as acct:
        prog = tgraph.compile_graph(grouped, fuse=False)
        outs = prog(*args)
    assert len(outs) == 3
    assert len(acct.records) == 1
    (r,) = acct.records
    assert r.kind == "grouped" and r.group == 3
    assert r.plan_source == "program"
    table = acct.table()
    assert len(table) == 1 and table[0]["grouped"] == 1
    assert "g3" in table[0]["example"]
    assert "grouped" in acct.format_table()


def test_format_table_empty_and_aggregation():
    acct = tacct.GemmAccountant()
    ref = jacct.GemmAccountant()
    assert "no dispatches" in acct.format_table()
    for a in (acct, ref):
        a.record_gemm(1, 256, 256, fmt="fp32", policy="mte", backend="x")
        a.record_gemm(1, 256, 256, fmt="fp32", policy="mte", backend="x")
        a.record_gemm(128, 128, 128, fmt="int8", policy="mte", backend="x",
                      plan_source="program", modeled_s=2e-6)
        a.record_grouped(3, 4, 2048, 2048, fmt="bf16", policy="mte",
                         backend="x")
    rows = acct.table()
    assert [r["shape_class"] for r in rows] == ["tall_skinny",
                                                "tall_skinny", "square"]
    assert rows[1]["dispatches"] == 2
    assert "4 distinct compiled" in acct.format_table()
    assert acct.format_table() == ref.format_table()


def test_fault_firing_emits_trace_instant():
    """A firing marks the installed trace with a ``fault.<kind>`` instant,
    as the JAX injector's does; without a tracer it is still logged."""
    tres = importlib.import_module("repro_torch.serving.resilience")
    jres = importlib.import_module("repro.serving.resilience")
    events = {}
    for name, tracing_mod, res in (("torch", ttracing, tres),
                                   ("jax", jtracing, jres)):
        tr = tracing_mod.install(tracing_mod.Tracer())
        inj = res.FaultInjector([res.Fault("poison_logits", rid=0, step=1)])
        assert inj.poison_value(0, 0) is None     # before step: no firing
        assert inj.poison_value(1, 0) is not None
        tracing_mod.uninstall()
        assert [e["name"] for e in tr.events] == ["fault.poison_logits"]
        assert tr.events[0]["args"]["step"] == 1
        events[name] = [(e["name"], e["ph"], e["args"]) for e in tr.events]
        inj2 = res.FaultInjector([res.Fault("poison_logits", rid=0, step=1)])
        assert inj2.poison_value(1, 0) is not None
        assert inj2.fired == [(1, "poison_logits", 0)]
    assert events["torch"] == events["jax"]


def test_pool_describe_structured_and_string():
    pool = tkv.KVPagePool(num_pages=8, page_size=4)
    assert pool.ensure(1, 10)
    d = pool.describe()
    for key in ("num_pages", "page_size", "free_pages", "used_pages",
                "sequences", "shared_pages", "cached_pages",
                "prefix_hit_pages", "prefix_queries", "cow_copies"):
        assert key in d, key
    assert d["num_pages"] == 8 and d["sequences"] == 1
    assert d["used_pages"] == 3
    assert d["used_pages"] + d["free_pages"] == d["num_pages"] - 1
    s = pool.describe_str()
    assert "KVPagePool" in s and "8 pages x 4" in s


# -- dispatch keys against the JAX package ------------------------------------


def _keys(records):
    return collections.Counter((r.m, r.n, r.k, r.fmt, r.policy, r.group)
                               for r in records)


@pytest.mark.parametrize("use_graph", [False, True],
                         ids=["eager", "graph"])
def test_forward_dispatch_keys_equal_jax(use_graph):
    """A reduced gemma_2b forward dispatches the same multiset of GEMM
    keys in both packages (each GEMM, or grouped sibling set, once).  One
    layer: JAX scans its layers and records the scanned body once."""
    jcfg = dataclasses.replace(jax_cfg(), use_graph=use_graph, n_layers=1)
    tcfg = torch_cfg(use_graph=use_graph, n_layers=1)
    jp, tp = jax_params(jcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 16))
    with jacct.account_gemms() as jrec:
        jax_model.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          jcfg)
    with tacct.account_gemms() as trec:
        torch_model.forward(tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    assert trec.records and _keys(trec.records) == _keys(jrec.records)


_KW = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
           prefill_chunk=16)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    head = rng.integers(0, vocab, 24, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, 8,
                                               dtype=np.int32)])
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_engine_run():
    """The JAX engine (synchronous, ungrouped q/k/v, eager kernel path)
    on the reduced stream, its accountant installed: → (streams, the set
    of dispatch keys).  Positions are copied before each launch (see
    test_torch_serving._jax_engine)."""
    jcfg = jax_cfg()
    jp, _ = jax_params(jcfg)
    eng = JEngine(jp, jcfg, grouped_qkv=False, async_steps=False, **_KW)
    make_batch = eng._make_batch
    eng._make_batch = lambda tokens, **arrays: make_batch(tokens, **{
        k: np.array(v) if isinstance(v, np.ndarray) else v
        for k, v in arrays.items()})
    with jacct.account_gemms() as rec:
        for rid, p in enumerate(_prompts(jcfg.vocab)):
            eng.submit(JRequest(rid=rid, prompt=p, max_tokens=6))
        out = eng.run()
    return ({rid: list(v) for rid, v in out.items()},
            frozenset(_keys(rec.records)))


def test_engine_dispatch_keys_equal_jax():
    """An engine run dispatches the same set of GEMM keys in both
    packages (JAX records once per jit trace, the port's CPU engine at
    every eager call: the sets, not the counts, compare), and with its
    accountant and tracer installed the port's streams equal JAX's."""
    jstreams, jkeys = _jax_engine_run()
    _, tp = jax_params(jax_cfg())
    eng = tengine.ServingEngine(tp, torch_cfg(), device="cpu",
                                async_steps=False, **_KW)
    ttracing.install(ttracing.Tracer())
    with tacct.account_gemms() as rec:
        for rid, p in enumerate(_prompts(eng.cfg.vocab)):
            eng.submit(tengine.Request(rid=rid, prompt=p, max_tokens=6))
        out = eng.run()
    ttracing.uninstall()
    assert {rid: list(v) for rid, v in out.items()} == jstreams
    assert frozenset(_keys(rec.records)) == jkeys


# -- the engine under telemetry: observation changes nothing ------------------


def _tiny_cfg(**kw):
    return dataclasses.replace(torch_cfg(), n_layers=2, **kw)


def _run_engine(params, cfg, prompts, max_tokens=5, **kw):
    engine = tengine.ServingEngine(params, cfg, slots=2, cache_len=64,
                                   prefill_len=16, device="cpu", **kw)
    for rid, p in enumerate(prompts):
        engine.submit(tengine.Request(rid=rid, prompt=p,
                                      max_tokens=max_tokens))
    return engine, engine.run()


def test_engine_outputs_bit_identical_with_telemetry_on():
    cfg = _tiny_cfg(use_graph=True)
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
               for n in (5, 9, 13)]
    _, base = _run_engine(params, cfg, prompts)

    treg.reset_registry()
    tracer = ttracing.install(ttracing.Tracer())
    acct = tacct.install(tacct.GemmAccountant())
    try:
        engine, traced = _run_engine(params, cfg, prompts)
        metrics = engine.metrics()
    finally:
        ttracing.uninstall()
        tacct.uninstall()
    assert {r: list(v) for r, v in traced.items()} == \
        {r: list(v) for r, v in base.items()}
    for resp in traced.values():
        assert resp.status == "ok"
        assert resp.metrics["tokens"] == len(resp)
        assert resp.metrics["ttft_s"] >= 0.0
        assert resp.metrics["e2e_s"] >= resp.metrics["ttft_s"]
        assert "itl_p50_s" in resp.metrics and "queue_wait_s" in resp.metrics
    doc = tracer.to_json()
    assert ttracing.validate_trace(doc) == []
    assert jtracing.validate_trace(doc) == []
    names = {e["name"] for e in tracer.events}
    assert {"admit", "prefill_chunk", "decode", "sample",
            "graph.program"} <= names
    assert {"request.submit", "request.admit", "request.first_token",
            "request.finish"} <= names
    firsts = [e for e in tracer.events
              if e["name"] == "request.first_token"]
    assert len(firsts) == len(prompts)
    # The async engine's decode span stays open across the next step's
    # host work.
    assert ttracing.span_overlaps(doc, "decode", "prefill_chunk") or \
        ttracing.span_overlaps(doc, "decode", "admit")
    reg = treg.registry()
    assert reg.get("serving.ttft_s").count == len(prompts)
    assert reg.get("serving.e2e_s").count == len(prompts)
    assert reg.get("serving.queue_wait_s").count == len(prompts)
    assert reg.get("serving.inter_token_s").count > 0
    assert reg.get("serving.steps_in_flight").value >= 0
    assert reg.get("serving.results_stale_steps") is not None
    for key in ("plan_cache_hits", "plan_cache_misses",
                "graph_programs_compiled", "graph_program_hits"):
        assert key in metrics, key
        assert reg.get(f"serving.{key}").value == metrics[key]
    assert acct.records
    assert "tall_skinny" in {r.shape_class for r in acct.records}
    # The grouped decode q/k/v (2 slots) is one record, never three.
    decode = [r for r in acct.records if r.m == 2]
    assert any(r.kind == "grouped" and r.group == 3 for r in decode)
    kv_width = cfg.n_kv_heads * cfg.hd
    assert not any(r.kind == "gemm" and r.n == kv_width for r in decode)
    assert "dispatches" in acct.format_table()
