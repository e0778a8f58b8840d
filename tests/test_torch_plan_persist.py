"""The port's plan cache (``repro_torch.core.autotune``) against the JAX
package's, case for case with ``tests/test_autotune.py`` — memoization,
routing, measured refinement (``measure=True`` on the CPU's host clock),
the JSON warm start — plus what the telemetry slice adds: each package
refuses the other's plan file, a file of another substrate is refused,
the engine warm-starts from ``plan_cache_path`` with no solver call and
the same streams, accepts ``slo_monitor`` and serves with every
resilience option, and the serving launcher (``repro_torch.launch.serve``)
writes artifacts both packages' validators accept and serves with the
resilience flags.  Plus the training side of plan persistence: the
snapshot in a checkpoint (``plan_cache_snapshot``,
``CheckpointManager.save(gemm_plans=)``, ``restore_plans``) held to
``tests/test_formats.py``'s contract."""
import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import autotune as jautotune
from repro.telemetry import export as jexport
from repro.telemetry import tracing as jtracing

from torch_lazy import LazyModule, torch
from torch_parity import torch_cfg, torch_model

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tdispatch = LazyModule("repro_torch.core.dispatch")
tepilogue = LazyModule("repro_torch.core.epilogue")
tengine = LazyModule("repro_torch.serving.engine")
tref = LazyModule("repro_torch.kernels.ref")
tschedule = LazyModule("repro_torch.graph.schedule")
tserve = LazyModule("repro_torch.launch.serve")
texport = LazyModule("repro_torch.telemetry.export")
tres = LazyModule("repro_torch.serving.resilience")
tacct = LazyModule("repro_torch.telemetry.gemm_account")
treg = LazyModule("repro_torch.telemetry.registry")
ttracing = LazyModule("repro_torch.telemetry.tracing")

RNG = np.random.default_rng(7)


@pytest.fixture(autouse=True)
def fresh_cache():
    def reset():
        tautotune.reset_cache()
        tschedule.reset_programs()
        treg.reset_registry()
        ttracing.uninstall()
        tacct.uninstall()
    reset()
    jautotune.reset_cache()
    yield
    reset()
    jautotune.reset_cache()


def _mats(m, n, k):
    return (torch.as_tensor(RNG.standard_normal((m, k)).astype(np.float32)),
            torch.as_tensor(RNG.standard_normal((k, n)).astype(np.float32)))


def _plan(m, n, k, dtype=None, **kw):
    return tautotune.get_plan(m, n, k, dtype or torch.float32, **kw)


# -- memoization --------------------------------------------------------------


def test_same_signature_hits_cache_and_solver_runs_once(monkeypatch):
    mod = importlib.import_module("repro_torch.core.autotune")
    calls = {"n": 0}
    real = mod.solve_block_geometry

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(mod, "solve_block_geometry", counting)
    for _ in range(5):
        _plan(256, 512, 1024, epilogue=tepilogue.Epilogue(
            activation="gelu"))
    assert calls["n"] == 1
    st = tautotune.cache_stats()
    assert st.misses == 1 and st.hits == 4 and st.solver_calls == 1
    assert st.measured == st.measure_failed == 0


def test_dispatch_repeat_calls_hit_cache():
    a, b = _mats(64, 128, 96)
    for _ in range(3):
        tdispatch.mte_gemm(a, b, backend="kernels")
    st = tautotune.cache_stats()
    assert st.solver_calls == st.misses == 1
    assert st.hits >= 2


def test_measure_upgrades_analytic_hit():
    p1 = _plan(8, 256, 512)
    assert p1.measured_s is None
    p2 = _plan(8, 256, 512, measure=True, device="cpu")
    assert p2.source == "measured" and p2.measured_s is not None
    assert _plan(8, 256, 512) is p2


def test_distinct_epilogues_and_dtypes_get_distinct_plans():
    _plan(64, 64, 64, epilogue=tepilogue.Epilogue())
    _plan(64, 64, 64, epilogue=tepilogue.Epilogue(activation="relu"))
    _plan(64, 64, 64, torch.bfloat16, dtype_out=torch.float32,
          epilogue=tepilogue.Epilogue())
    st = tautotune.cache_stats()
    assert st.misses == 3 and len(tautotune.plan_cache()) == 3


def test_lru_eviction():
    cache = tautotune.reset_cache(maxsize=2)
    for n in (128, 256, 384):
        _plan(64, n, 64)
    assert len(cache) == 2
    _plan(64, 128, 64)
    assert cache.stats.misses == 4


# -- routing ------------------------------------------------------------------


def test_tall_skinny_routes_to_splitk():
    plan = _plan(16, 256, 4096)
    assert plan.route == "splitk" and plan.n_split > 1
    assert plan.predicted_s > 0


def test_dispatch_launches_splitk_kernel(monkeypatch):
    mod = importlib.import_module("repro_torch.kernels.splitk_gemm")
    launches = {"n": 0}
    real = mod.mte_gemm_splitk_kernel

    def counting(*a, **kw):
        launches["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(mod, "mte_gemm_splitk_kernel", counting)
    a, b = _mats(16, 256, 4096)
    out = tdispatch.mte_gemm(a, b, backend="kernels")
    assert launches["n"] == 1
    np.testing.assert_allclose(out.numpy(), tref.mte_gemm(a, b).numpy(),
                               rtol=3e-4, atol=3e-4)


def test_large_square_does_not_split():
    plan = _plan(1024, 1024, 512)
    assert plan.route == "mte" and plan.n_split == 1


def test_amx_policy_is_rigid_and_unsearched():
    plan = _plan(16, 256, 4096, policy="amx")
    assert plan.route == "rigid"
    assert (plan.geometry.bm, plan.geometry.bn) == (128, 128)


def test_grouped_signature_routes_grouped():
    assert _plan(40, 96, 64, group=4).route == "grouped"


def test_autotuned_never_predicted_slower_than_analytic():
    for m, n, k in [(1, 4096, 4096), (16, 256, 4096), (512, 512, 512),
                    (33, 257, 65), (8, 2048, 8)]:
        sig = tautotune.GemmSignature.make(m, n, k, "float32", "float32")
        cands = tautotune.enumerate_candidates(sig)
        analytic_s = tautotune.score_geometry(sig, cands[0])
        assert _plan(m, n, k).predicted_s <= analytic_s * (1 + 1e-9)


# -- measured refinement --------------------------------------------------------


def test_measured_refinement_picks_a_candidate():
    plan = _plan(8, 256, 512, measure=True, device="cpu")
    assert plan.source == "measured" and plan.measured_s is not None
    st = tautotune.cache_stats()
    assert st.measured >= 2
    if plan.route == "torch":
        assert "library product" in plan.describe()


def test_measure_refuses_nothing_silently(monkeypatch):
    """A candidate that cannot execute (ValueError/NotImplementedError)
    counts as measure_failed and cannot win; the "torch" route races only
    kernel candidates that ran, so a signature no kernel can run raises
    instead of falling to the library; any other error propagates; the
    plain mte signature races the "torch" route, a grouped one does
    not."""
    mod = importlib.import_module("repro_torch.core.autotune")
    real = mod.execute_plan
    seen = []

    def picky(plan, *a, **kw):
        seen.append(plan.route)
        if plan.route != "torch":
            raise ValueError("no such tile")
        return real(plan, *a, **kw)

    monkeypatch.setattr(mod, "execute_plan", picky)
    with pytest.raises(ValueError, match="no kernel candidate"):
        _plan(8, 256, 512, measure=True, device="cpu")
    st = tautotune.cache_stats()
    assert "torch" not in seen and len(seen) >= 2
    assert st.measured == 0 and st.measure_failed == len(seen)
    seen.clear()
    with pytest.raises(ValueError, match="no kernel candidate"):
        _plan(8, 96, 64, group=3, measure=True, device="cpu")
    assert seen and "torch" not in seen

    runs = []

    def one_kernel(plan, *a, **kw):
        if plan.route != "torch":
            if not runs:
                runs.append(plan)
            if plan is not runs[0]:
                seen.append(plan.route)
                raise ValueError("no such tile")
        return real(plan, *a, **kw)

    tautotune.reset_cache()
    seen.clear()
    monkeypatch.setattr(mod, "execute_plan", one_kernel)
    plan = _plan(8, 256, 512, measure=True, device="cpu")
    st = tautotune.cache_stats()
    assert plan.source == "measured" and plan.route in ("torch",
                                                        runs[0].route)
    assert st.measured == 2 and st.measure_failed == len(seen) >= 1

    def broken(plan, *a, **kw):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(mod, "execute_plan", broken)
    with pytest.raises(RuntimeError):
        _plan(8, 512, 512, measure=True, device="cpu")


@pytest.mark.parametrize("dtype_in,fmt", [("float32", "fp32"),
                                          ("bfloat16", "bf16"),
                                          ("bfloat16", "bf16acc")])
def test_torch_route_is_the_product_at_the_accumulator(dtype_in, fmt):
    """Route "torch" on the CPU: the operands' product at the policy's
    accumulator with the epilogue fused after it, as ``formats.torch_gemm``
    and the epilogue compute it."""
    from repro_torch.core import formats
    epi = tepilogue.Epilogue(activation="gelu", bias_axis="row", alpha=0.5)
    sig = tautotune.GemmSignature.for_format(
        8, 48, 64, formats.FORMATS[fmt], "float32", epi)
    plan = dataclasses.replace(tautotune.plan_cache().plan(sig),
                               route="torch")
    a, b = _mats(8, 48, 64)
    dt = formats.to_torch_dtype(dtype_in)
    a, b = a.to(dt), b.to(dt)
    bias = torch.as_tensor(RNG.standard_normal(48).astype(np.float32))
    got = tautotune.execute_plan(plan, a, b, None, bias)
    acc = formats.torch_gemm(a, b, formats.FORMATS[fmt])
    want = epi.apply(acc, c_in=None, bias=bias).to(torch.float32)
    assert got.dtype == torch.float32 and got.shape == (8, 48)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert "library product" in plan.describe()


def test_torch_route_refuses_an_int8_epilogue():
    """An int8 signature with an epilogue cannot run on route "torch"
    (nor on the s8 kernels): it raises, so a measured refinement counts
    it as measure_failed instead of dropping the epilogue; the identity
    gives the exact int32 product."""
    from repro_torch.core import formats
    a = torch.as_tensor(RNG.integers(-64, 64, (32, 64)), dtype=torch.int8)
    b = torch.as_tensor(RNG.integers(-64, 64, (64, 48)), dtype=torch.int8)
    for epi, ok in ((tepilogue.Epilogue(), True),
                    (tepilogue.Epilogue(activation="gelu"), False)):
        sig = tautotune.GemmSignature.make(32, 48, 64, "int8", "int32",
                                           epilogue=epi)
        plan = dataclasses.replace(tautotune.plan_cache().plan(sig),
                                   route="torch")
        if ok:
            got = tautotune.execute_plan(plan, a, b)
            assert torch.equal(got, formats.int_matmul(a, b))
        else:
            with pytest.raises(ValueError, match="epilogue"):
                tautotune.execute_plan(plan, a, b)


def test_measure_plan_times_every_route_on_the_cpu():
    for sig_kw in (dict(m=4, n=96, k=64), dict(m=16, n=256, k=4096),
                   dict(m=8, n=96, k=64, group=3)):
        sig = tautotune.GemmSignature.make(dtype_in="float32",
                                           dtype_out="float32", **sig_kw)
        for plan in tautotune.plan_cache().analytic_candidates(sig)[:2]:
            t = tautotune.measure_plan(plan, iters=2, device="cpu")
            assert 0 < t < 10


# -- persistence --------------------------------------------------------------


def test_json_roundtrip_warm_start(tmp_path):
    path = str(tmp_path / "plans.json")
    p1 = _plan(16, 256, 4096, epilogue=tepilogue.Epilogue(has_bias=True))
    p2 = _plan(64, 64, 64, torch.bfloat16, dtype_out=torch.float32)
    p3 = _plan(8, 256, 512, measure=True, device="cpu")
    tautotune.save_plans(path, device="cpu")
    doc = json.load(open(path))
    assert doc["substrate"] == "cpu" and doc["version"] == "repro_torch/1"
    tautotune.reset_cache()
    assert tautotune.load_plans(path, device="cpu") == 3
    w1 = _plan(16, 256, 4096, epilogue=tepilogue.Epilogue(has_bias=True))
    w2 = _plan(64, 64, 64, torch.bfloat16, dtype_out=torch.float32)
    w3 = _plan(8, 256, 512)
    st = tautotune.cache_stats()
    assert st.solver_calls == 0 and st.hits == 3
    assert {w.source for w in (w1, w2, w3)} == {"warmstart"}
    assert (w1.geometry, w1.route) == (p1.geometry, p1.route)
    assert w2.geometry == p2.geometry
    assert (w3.route, w3.measured_s) == (p3.route, p3.measured_s)


def test_each_package_refuses_the_others_plan_file(tmp_path):
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jautotune.get_plan(16, 256, 4096, jnp.float32)
    jautotune.save_plans(jpath)
    _plan(16, 256, 4096)
    tautotune.save_plans(tpath, device="cpu")
    with pytest.raises(ValueError, match="version"):
        tautotune.load_plans(jpath, device="cpu")
    with pytest.raises(ValueError, match="version"):
        jautotune.load_plans(tpath)
    assert len(jautotune.plan_cache()) == 1


def test_plan_file_of_another_substrate_is_refused(tmp_path):
    _plan(16, 256, 4096)
    doc = tautotune.plan_cache().to_json(device="cpu")
    cache = tautotune.PlanCache()
    for substrate in ("NVIDIA H100 80GB HBM3 sm_90", "NVIDIA A100 sm_80"):
        with pytest.raises(ValueError, match="substrate"):
            cache.load_json(dict(doc, substrate=substrate), device="cpu")
    with pytest.raises(ValueError, match="profile"):
        cache.load_json(dict(doc, profile="tpu_v5e"), device="cpu")
    assert len(cache) == 0
    assert tautotune._substrate("cpu") == "cpu"


# -- the engine: warm start, SLO monitor, A6 refusals -------------------------


_KW = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
           prefill_chunk=16, device="cpu")


def _serve(eng, n=3, max_tokens=5):
    rng = np.random.default_rng(1)
    for rid in range(n):
        eng.submit(tengine.Request(
            rid=rid, prompt=rng.integers(0, eng.cfg.vocab, 20 + 5 * rid,
                                         dtype=np.int32),
            max_tokens=max_tokens))
    return {rid: list(v) for rid, v in eng.run().items()}


def test_serving_engine_warm_start(tmp_path, capsys):
    """Plans saved after a run warm-start a new engine: the same streams
    with no solver call; a foreign file is skipped, not fatal."""
    path = str(tmp_path / "serving_plans.json")
    cfg = torch_cfg(use_graph=True)
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    eng = tengine.ServingEngine(params, cfg, plan_cache_path=path, **_KW)
    cold = _serve(eng)
    assert tautotune.cache_stats().solver_calls > 0
    eng.save_plan_cache()
    n_plans = len(tautotune.plan_cache())
    tautotune.reset_cache()
    tschedule.reset_programs()
    eng = tengine.ServingEngine(params, cfg, plan_cache_path=path, **_KW)
    assert len(tautotune.plan_cache()) == n_plans
    assert _serve(eng) == cold
    assert tautotune.cache_stats().solver_calls == 0
    jpath = str(tmp_path / "jax.json")
    jautotune.get_plan(1, 64, 64, jnp.float32)
    jautotune.save_plans(jpath)
    tautotune.reset_cache()
    tengine.ServingEngine(params, cfg, plan_cache_path=jpath, **_KW)
    assert "plan-cache warm start skipped" in capsys.readouterr().out
    assert len(tautotune.plan_cache()) == 0


def test_engine_takes_an_slo_monitor():
    slo = importlib.import_module("repro_torch.telemetry.slo")
    cfg = torch_cfg()
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    mon = slo.SloMonitor(slo.default_slos(ttft_p99_s=300.0))
    eng = tengine.ServingEngine(params, cfg, slo_monitor=mon, **_KW)
    _serve(eng, n=2)
    assert mon.evaluations == eng.step_idx > 0
    assert mon.last_report.ok


@pytest.mark.parametrize("kw", [dict(fault="poison_logits:rid=0,step=1"),
                                dict(deadline_ms=5.0),
                                dict(shed_queue_depth=1),
                                dict(shed_token_watermark=64),
                                dict(watchdog_s=1.0),
                                dict(prefix_index_path="index.json")],
                         ids=lambda kw: next(iter(kw)))
def test_engine_serves_with_every_a6_option(kw, tmp_path):
    """Each resilience option of the engine on the CPU, under a tracer,
    against a run without it: a poisoned request ends ``"poisoned"`` with
    a ``fault.poison_logits`` instant; an engine-wide deadline of 5 ms on
    a clock that advances 1 ms a read cancels requests with a prefix of
    their output; shedding by queue depth or token watermark rejects the
    later submits with ``request.shed`` instants; the watchdog changes no
    token; the prefix index is written at the end of ``run()`` and warms
    a second engine.  Unaffected requests equal the run without it."""
    cfg = torch_cfg()
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 20 + 5 * rid, dtype=np.int32)
               for rid in range(3)]

    def serve(**opts):
        eng = tengine.ServingEngine(params, cfg, debug_audit=True, **_KW,
                                    **opts)
        shed = []
        for rid, p in enumerate(prompts):
            try:
                eng.submit(tengine.Request(rid=rid, prompt=p, max_tokens=5))
            except tres.Shed:
                shed.append(rid)
        out = eng.run()
        eng.sched.pool.audit()
        return eng, out, shed

    _, base, _ = serve()
    name, value = next(iter(kw.items()))
    if name == "fault":
        value = tres.FaultInjector.from_spec(value)
    elif name == "prefix_index_path":
        value = str(tmp_path / value)
    clock = iter(np.arange(1, 10_000) * 1e-3)
    opts = {name: value}
    if name == "deadline_ms":
        opts["clock"] = lambda: float(next(clock))
    tracer = ttracing.install(ttracing.Tracer())
    try:
        eng, out, shed = serve(**opts)
    finally:
        ttracing.uninstall()
    names = [e["name"] for e in tracer.events]
    status = {rid: r.status for rid, r in out.items()}
    hit = {"fault": {0}, "deadline_ms": {0, 1, 2}, "shed_queue_depth": {1, 2},
           "shed_token_watermark": {1, 2}}.get(name, set())
    want = {"fault": "poisoned", "deadline_ms": "deadline",
            "shed_queue_depth": "shed", "shed_token_watermark": "shed"}
    assert status == {rid: want[name] if rid in hit else "ok"
                      for rid in range(3)}
    for rid in range(3):
        got = list(out[rid])
        assert got == base[rid] if rid not in hit \
            else got == base[rid][:len(got)] and len(got) < 5
    if name == "fault":
        assert value.fired == [(1, "poison_logits", 0)]
        assert names.count("fault.poison_logits") == 1
    if name.startswith("shed"):
        assert shed == [1, 2] and names.count("request.shed") == 2
        assert eng.metrics()["shed_requests"] == 2
    if name == "deadline_ms":
        assert eng.metrics()["cancelled_requests"] == 3
    if name == "watchdog_s":
        assert eng._watchdog is not None and not eng._watchdog._fired
    if name == "prefix_index_path":
        doc = json.load(open(value))
        assert doc["registrations"] and doc["page_size"] == _KW["page_size"]
        again = tengine.ServingEngine(params, cfg, prefix_index_path=value,
                                      **_KW)
        assert again.sched.pool.cached_pages == len(doc["registrations"])
    assert eng.metrics()["free_pages"] == eng.metrics()["num_pages"] - 1


# -- the serving launcher -----------------------------------------------------


def test_launcher_writes_artifacts_both_packages_accept(tmp_path, capsys):
    """``launch.serve.main`` on a reduced config on the CPU with the whole
    stack: health JSON, Prometheus text and trace pass both packages'
    validators; a second run warm-starts from the saved plan file and
    serves the same tokens; the resilience flags reach the engine and
    serve as they say."""
    files = {k: str(tmp_path / k) for k in ("h.json", "p.txt", "t.json",
                                            "plans.json")}
    base = ["--arch", "gemma_2b", "--reduced", "--device", "cpu",
            "--requests", "3", "--max-tokens", "4", "--prefill-len", "16",
            "--cache-len", "48"]
    out = tserve.main(base + [
        "--watch", "3", "--gemm-table", "--status-json", files["h.json"],
        "--prom", files["p.txt"], "--trace", files["t.json"],
        "--plan-cache", files["plans.json"]])
    text = capsys.readouterr().out
    assert "[watch]" in text and "slo=OK" in text
    assert "dispatches" in text and "signatures measured" in text
    assert len(out) == 3 and all(r.ok and len(r) == 4 for r in out.values())
    health = json.load(open(files["h.json"]))
    assert texport.validate_health(health) == []
    assert jexport.validate_health(health) == []
    assert health["slo"]["ok"] and health["calibration"]["sampled"] >= 1
    prom = open(files["p.txt"]).read()
    assert texport.parse_prometheus(prom) == jexport.parse_prometheus(prom)
    assert len(texport.parse_prometheus(prom)) == \
        len(treg.registry().names())
    need = ("admit", "prefill_chunk", "decode", "sample", "graph.program",
            "request.first_token")
    assert ttracing.validate_trace_file(files["t.json"], need) == []
    assert jtracing.validate_trace_file(files["t.json"], need) == []
    tautotune.reset_cache()
    tschedule.reset_programs()
    again = tserve.main(base + ["--plan-cache", files["plans.json"]])
    assert {r: list(v) for r, v in again.items()} == \
        {r: list(v) for r, v in out.items()}
    assert tautotune.cache_stats().solver_calls == 0
    # The resilience flags reach the engine: request 0 is poisoned, the
    # 4th and 5th submits are shed, the rest finish within the deadline
    # under the watchdog, and the prefix index is written.
    index = str(tmp_path / "index.json")
    res = tserve.main([*base[:6], "5", *base[7:], "--fault-plan",
                       "poison_logits:rid=0,step=2", "--deadline-ms",
                       "600000", "--shed-queue-depth", "3", "--watchdog-s",
                       "60", "--prefix-index", index, "--debug-audit"])
    text = capsys.readouterr().out
    assert {r: v.status for r, v in res.items()} == {
        0: "poisoned", 1: "ok", 2: "ok", 3: "shed", 4: "shed"}
    assert "req 3 shed at submit" in text and "[poisoned]" in text
    assert [list(res[r]) for r in (1, 2)] == [out[r] for r in (1, 2)]
    assert json.load(open(index))["page_size"] == 16
    args = tserve.parse_args(["--arch", "gemma_2b", "--no-graph"])
    assert (args.device, args.slots, args.page_size, args.cache_len,
            args.slo, args.profile) == ("cuda", 4, 16, 128, False, False)


# -- training-side plan persistence -------------------------------------------


def test_plan_snapshot_roundtrip_through_checkpoint(tmp_path, capsys):
    """``tests/test_formats.py``'s contract: an empty cache snapshots to
    None; two plans survive a checkpoint (``save`` and ``save_async``) and
    ``reset_cache`` and are restored as hits; ``restore`` hands the
    manifest back with them; a corrupt snapshot, the JAX package's and
    one of another substrate restore 0 plans with a message."""
    ttrainer = importlib.import_module("repro_torch.training.trainer")
    tckpt = importlib.import_module("repro_torch.checkpoint.manager")
    jtrainer = importlib.import_module("repro.training.trainer")
    assert ttrainer.plan_cache_snapshot("cpu") is None
    _plan(8, 128, 256, fmt="fp32")
    tautotune.get_plan(8, 128, 256, torch.int8, torch.int32, fmt="int8")
    snap = ttrainer.plan_cache_snapshot("cpu")
    assert snap and len(snap["plans"]) == 2

    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    params = {"w": torch.ones(2, 2)}
    opt = {"m": torch.zeros(2, 2)}
    mgr.save(3, params, opt, extra={"data": {"pos": 1}}, gemm_plans=snap)
    mgr.save_async(4, params, opt, gemm_plans=snap)
    mgr.wait()
    for step in (3, None):
        tautotune.reset_cache()
        assert len(tautotune.plan_cache()) == 0
        assert mgr.restore_plans(step, device="cpu") == 2
    cache = tautotune.plan_cache()
    tautotune.get_plan(8, 128, 256, torch.int8, torch.int32, fmt="int8")
    assert cache.stats.hits == 1 and cache.stats.misses == 0
    _, _, manifest = mgr.restore(None, (params, opt))
    assert manifest["gemm_plans"]["version"] == "repro_torch/1"
    assert manifest["step"] == 4

    jautotune.get_plan(8, 128, 256, jnp.float32, fmt="fp32")
    jsnap = jtrainer.plan_cache_snapshot()
    card = dict(snap, substrate="NVIDIA H100 80GB HBM3 sm_90")
    capsys.readouterr()
    for doc in (jsnap, card, {"version": 99}):
        tautotune.reset_cache()
        assert ttrainer.restore_plan_cache(doc, "cpu") == 0
        assert "plan-cache restore skipped" in capsys.readouterr().out
        assert len(tautotune.plan_cache()) == 0
    assert ttrainer.restore_plan_cache(None, "cpu") == 0
    assert jtrainer.restore_plan_cache(snap) == 0   # and the other way
    mgr.save(5, params, opt)                        # a checkpoint without
    assert mgr.restore_plans(device="cpu") == 0


def test_train_loop_resumes_with_the_checkpoint_plans(tmp_path):
    """``launch.train.train_loop`` saves the plan snapshot with each
    checkpoint and a resumed run restores it before its first step, so
    that step solves no plan."""
    tlaunch = importlib.import_module("repro_torch.launch.train")
    cfg = dataclasses.replace(torch_cfg(), n_layers=2, d_model=64, d_ff=128,
                              vocab=128, n_heads=2, n_kv_heads=1,
                              head_dim=32)
    kw = dict(batch=2, seq=16, ckpt_dir=str(tmp_path / "ck"), ckpt_every=1,
              device="cpu")
    tlaunch.train_loop(cfg, steps=2, log=lambda *a: None, **kw)
    n_plans = len(tautotune.plan_cache())
    assert n_plans > 0
    tautotune.reset_cache()
    tschedule.reset_programs()
    logs = []
    tlaunch.train_loop(cfg, steps=3, log=logs.append, **kw)
    assert f"[train] restored step 2, {n_plans} warm GEMM plans" in logs
    assert tautotune.cache_stats().solver_calls == 0
