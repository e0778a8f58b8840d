"""The port's serving resilience (``repro_torch.serving.resilience`` and the
engine's fault hooks, deadlines, load shedding, watchdog, snapshot/restore
and prefix-index file), case for case with ``tests/test_resilience.py`` at
that file's reduced config (gemma_2b cut to 2 layers, d_model 64), on the
CPU.

Engine-level fault runs are held to the port's own fault-free run, as the
JAX suite holds JAX's: under each fault class every unaffected request is
bit-identical to the fault-free run, every affected one ends with a
structured status, and ``KVPagePool.audit()`` holds after every step.
Host-only decisions are held to the JAX package: fault plans drawn from a
seed and parsed from a spec, the error codes, the snapshot's keys and
geometry, and the shed decisions.  Plus what the port adds: an exception
other than a ``RequestError`` in a prefill chunk propagates, a crashed
engine is dropped before the next is built, a restore refuses a cache
once a graph was captured, and the poison of a speculative window."""
import dataclasses
import gc
import itertools
import os
import weakref

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.serving import resilience as jres
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine

from torch_lazy import LazyModule

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tengine = LazyModule("repro_torch.serving.engine")
tfault = LazyModule("repro_torch.distributed.fault")
tkv = LazyModule("repro_torch.serving.kv_cache")
tmodel = LazyModule("repro_torch.models.model")
tres = LazyModule("repro_torch.serving.resilience")

_SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2,
              n_kv_heads=1, head_dim=32)


def _cfg():
    return dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                               **_SMALL)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
               for n in (5, 9, 13, 7)]
    return cfg, params, prompts


def _engine(params, cfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("cache_len", 64)
    kw.setdefault("prefill_len", 16)
    kw.setdefault("debug_audit", True)
    return tengine.ServingEngine(params, cfg, device="cpu", **kw)


def _serve(params, cfg, prompts, *, max_tokens=6, engine_kw=None):
    eng = _engine(params, cfg, **(engine_kw or {}))
    for rid, p in enumerate(prompts):
        eng.submit(tengine.Request(rid=rid, prompt=p, max_tokens=max_tokens))
    out = eng.run()
    eng.sched.pool.audit()
    return eng, out


def _reqs(prompts, max_tokens):
    return [tengine.Request(rid=i, prompt=p, max_tokens=max_tokens)
            for i, p in enumerate(prompts)]


# -- Response / taxonomy ------------------------------------------------------


def test_response_is_backward_compatible_list():
    r = tres.Response([3, 1, 4], rid=7)
    assert r == [3, 1, 4] and len(r) == 3 and r[:2] == [3, 1]
    assert r.ok and r.status == "ok" and r.rid == 7
    bad = tres.Response([], rid=0, status="poisoned",
                        error=tres.PoisonedOutput("x", rid=0))
    assert not bad.ok and bad.error.code == "poisoned"


def test_error_taxonomy_codes():
    names = ("RequestError", "DeadlineExceeded", "Shed", "PoisonedOutput",
             "CapacityExceeded")
    assert {n: getattr(tres, n).code for n in names} == \
        {n: getattr(jres, n).code for n in names}
    assert tres.DeadlineExceeded.code == "deadline"
    assert tres.Shed.code == "shed"
    assert tres.PoisonedOutput.code == "poisoned"
    assert tres.CapacityExceeded.code == "capacity"
    for name in names[1:]:
        assert issubclass(getattr(tres, name), tres.RequestError)
        assert issubclass(getattr(tres, name), RuntimeError)
    assert tres.FAULT_KINDS == jres.FAULT_KINDS
    assert not issubclass(tres.EngineCrash, tres.RequestError)


# -- FaultInjector determinism ------------------------------------------------


def _plan(inj):
    return [repr(f) for f in inj.faults]


def test_fault_plan_determinism_same_seed():
    a = tres.FaultInjector.random_plan(7)
    b = tres.FaultInjector.random_plan(7)
    c = tres.FaultInjector.random_plan(8)
    assert _plan(a) == _plan(b)
    assert _plan(a) != _plan(c)
    # One seed draws one plan in both packages.
    for seed in range(12):
        kw = dict(n_faults=2 + seed % 4, max_step=8 + seed,
                  rids=tuple(range(1 + seed % 5)))
        assert _plan(tres.FaultInjector.random_plan(seed, **kw)) == \
            _plan(jres.FaultInjector.random_plan(seed, **kw)), seed


def test_fault_spec_parser():
    spec = ("poison_logits:rid=1,step=3;alloc_fail:step=2,count=2;"
            "straggle:delay_s=0.5")
    inj = tres.FaultInjector.from_spec(spec)
    assert [f.kind for f in inj.faults] == ["poison_logits", "alloc_fail",
                                            "straggle"]
    assert inj.faults[0].rid == 1 and inj.faults[0].step == 3
    assert inj.faults[1].count == 2
    assert inj.faults[2].delay_s == 0.5
    for s in (spec, "crash:step=8", "chunk_exception:rid=2,chunk=1;"
              "poison_logits:rid=0,step=4,value=inf", " ; crash ;"):
        assert _plan(tres.FaultInjector.from_spec(s)) == \
            _plan(jres.FaultInjector.from_spec(s)), s
    for bad in ("meteor_strike:step=1", "poison_logits:severity=9"):
        with pytest.raises(ValueError):
            tres.FaultInjector.from_spec(bad)
        with pytest.raises(ValueError):
            jres.FaultInjector.from_spec(bad)


def test_same_fault_plan_same_outputs(setup):
    """Same plan → same fired log → same outputs."""
    cfg, params, prompts = setup
    plan = "poison_logits:rid=1,step=4;alloc_fail:step=3"
    runs = []
    for _ in range(2):
        inj = tres.FaultInjector.from_spec(plan)
        _, out = _serve(params, cfg, prompts[:3],
                        engine_kw={"fault": inj})
        runs.append((inj.fired, out))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 2
    assert runs[0][1] == runs[1][1]
    assert {rid: r.status for rid, r in runs[0][1].items()} \
        == {rid: r.status for rid, r in runs[1][1].items()}


# -- containment: each fault class --------------------------------------------


def test_poisoned_slot_is_quarantined_others_bit_identical(setup):
    cfg, params, prompts = setup
    _, base = _serve(params, cfg, prompts[:3])
    inj = tres.FaultInjector([tres.Fault("poison_logits", rid=1, step=4)])
    eng, out = _serve(params, cfg, prompts[:3], engine_kw={"fault": inj})
    assert out[1].status == "poisoned" and len(out[1]) < len(base[1])
    assert isinstance(out[1].error, tres.PoisonedOutput)
    assert list(out[1]) == list(base[1])[:len(out[1])]
    for rid in (0, 2):
        assert out[rid].status == "ok" and list(out[rid]) == list(base[rid])
    assert eng.metrics()["cancelled_requests"] == 1
    assert eng.metrics()["free_pages"] == eng.metrics()["num_pages"] - 1
    # Armed, the pipeline runs at depth 1.
    assert eng.steps_in_flight_max == 1


def test_poisoned_slot_on_stateful_arch(setup):
    """Quarantine + row-valid masks on an arch with ring/recurrent
    per-slot state: the poisoned slot cancels, survivors bit-identical."""
    cfg = dataclasses.replace(
        tconfigs.get_config("recurrentgemma_9b").reduced(), vocab=128)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    _, _, prompts = setup
    _, base = _serve(params, cfg, prompts[:3])
    inj = tres.FaultInjector([tres.Fault("poison_logits", rid=0, step=5)])
    _, out = _serve(params, cfg, prompts[:3], engine_kw={"fault": inj})
    assert out[0].status == "poisoned"
    for rid in (1, 2):
        assert out[rid].status == "ok" and list(out[rid]) == list(base[rid])


def test_unquarantined_poison_carries_the_host_token(setup):
    """``quarantine=False``: the poisoned row's token is sampled on the
    host from the constant row (argmax 0, as the device's sampler gives a
    NaN row) and carried into the next decode step on the device; the seed
    of a request is poisoned the same way.  The others stay
    bit-identical."""
    cfg, params, prompts = setup
    _, base = _serve(params, cfg, prompts[:3])
    inj = tres.FaultInjector([tres.Fault("poison_logits", rid=1, step=4),
                              tres.Fault("poison_logits", rid=2, step=3)])
    _, out = _serve(params, cfg, prompts[:3],
                    engine_kw={"fault": inj, "quarantine": False})
    # rid 2 is admitted at step 6: its seed is the first row poisoned.
    assert [(s, rid) for s, _, rid in inj.fired] == [(4, 1), (6, 2)]
    assert out[2][0] == 0 and out[1][4] == 0
    for rid in (1, 2):
        assert out[rid].status == "ok" and len(out[rid]) == 6
        assert list(out[rid]) != list(base[rid])
    assert out[1][:4] == base[1][:4]
    assert out[0].status == "ok" and list(out[0]) == list(base[0])
    # The token after the poisoned one is what the model gives after a 0:
    # the carried buffer held the host's token.
    eng = _engine(params, cfg)
    for rid, i in ((1, 4), (2, 0)):
        assert _next_greedy(eng, prompts[rid], out[rid][:i + 1]) \
            == out[rid][i + 1], rid


def _next_greedy(eng, prompt, tokens):
    """The greedy token after ``prompt`` (prefilled as the engine's
    left-padded window) and ``tokens`` (decoded one by one), through the
    model on the engine's serving parameters."""
    import torch
    cfg, n = eng.cfg, eng.prefill_len
    cache = tmodel.init_paged_cache(cfg, 1, 64, num_pages=9, page_size=16,
                                    device="cpu")
    table = torch.arange(1, 5, dtype=torch.int32)[None]
    window = np.pad(np.asarray(prompt, np.int64), (n - len(prompt), 0))
    logits, cache = tmodel.prefill_chunk(
        eng.params, {"tokens": torch.as_tensor(window)[None],
                     "page_table": table}, cache, cfg, pos0=0)
    for i, tok in enumerate(tokens):
        logits, cache = tmodel.decode(
            eng.params, {"tokens": torch.tensor([[int(tok)]]),
                         "pos": torch.tensor([n + i]), "page_table": table},
            cache, cfg)
    return int(logits[0].argmax())


def test_poison_in_a_speculative_window(setup):
    cfg, params, prompts = setup
    kw = {"spec_k": 3, "prefill_len": 16, "cache_len": 64}
    _, base = _serve(params, cfg, prompts[:3], engine_kw=kw)
    inj = tres.FaultInjector([tres.Fault("poison_logits", rid=0, step=4)])
    eng, out = _serve(params, cfg, prompts[:3],
                      engine_kw={**kw, "fault": inj})
    assert eng.spec_k_hist and inj.fired == [(4, "poison_logits", 0)]
    assert out[0].status == "poisoned"
    for rid in (1, 2):
        assert out[rid].status == "ok" and list(out[rid]) == list(base[rid])
    # Unquarantined, on sampled rows (the host's draws) the poison never
    # fails the step: a NaN decode row emits the device sampler's token
    # for such a row, 0; a NaN window runs the rejection sampler on it.
    for spec_k in (0, 3):
        inj = tres.FaultInjector([tres.Fault("poison_logits", rid=0,
                                             step=2)])
        eng = _engine(params, cfg, spec_k=spec_k, quarantine=False,
                      fault=inj)
        for rid, p in enumerate(prompts[:3]):
            eng.submit(tengine.Request(rid=rid, prompt=p, max_tokens=6,
                                       temperature=0.7))
        out = eng.run()
        assert [k for _, k, _ in inj.fired] == ["poison_logits"]
        assert all(r.status == "ok" and len(r) == 6 for r in out.values())
        assert spec_k or 0 in list(out[0])


def test_chunk_exception_contained_to_one_request(setup):
    cfg, params, prompts = setup
    _, base = _serve(params, cfg, prompts[:3])
    inj = tres.FaultInjector([tres.Fault("chunk_exception", rid=2)])
    eng, out = _serve(params, cfg, prompts[:3], engine_kw={"fault": inj})
    assert out[2].status == "error" and list(out[2]) == []
    assert out[2].error.rid == 2
    for rid in (0, 1):
        assert out[rid].status == "ok" and list(out[rid]) == list(base[rid])
    eng.sched.pool.audit()


def test_non_request_error_in_a_chunk_propagates(setup, monkeypatch):
    import importlib
    """Only a RequestError is contained to its request: any other
    exception of a chunk (on the card, a kernel that fails to build or
    launch, or a sticky CUDA error) fails the run.  The JAX engine wraps
    it as a RequestError instead."""
    cfg, params, prompts = setup
    model_mod = importlib.import_module("repro_torch.models.model")
    real = model_mod.prefill_chunk
    calls = {"n": 0}

    def failing(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(*a, **kw)

    monkeypatch.setattr(model_mod, "prefill_chunk", failing)
    eng = _engine(params, cfg)
    for req in _reqs(prompts[:3], 4):
        eng.submit(req)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.run()
    assert calls["n"] == 2 and not eng._responses


def test_alloc_failure_defers_without_corruption(setup):
    """An injected page-allocation failure exercises the deferral /
    eviction path; every request still completes and never-preempted
    requests are bit-identical to the fault-free run."""
    cfg, params, prompts = setup
    _, base = _serve(params, cfg, prompts[:3], max_tokens=8)
    inj = tres.FaultInjector([tres.Fault("alloc_fail", step=2, count=3)])
    eng, out = _serve(params, cfg, prompts[:3], max_tokens=8,
                      engine_kw={"fault": inj})
    assert any(k == "alloc_fail" for _, k, _ in inj.fired)
    assert eng.sched.pool.injected_alloc_failures >= 1
    preempted = {rid for kind, rid in eng.sched.events if kind == "preempt"}
    for rid in range(3):
        assert out[rid].status == "ok" and len(out[rid]) == 8
        if rid not in preempted:
            assert list(out[rid]) == list(base[rid])


def test_straggler_watchdog_triggers_supervised_restart(setup):
    """The straggle out-sleeps the watchdog's deadline by more than its
    0.5 s poll; the deadline is well above a healthy step's."""
    cfg, params, prompts = setup
    inj = tres.FaultInjector([tres.Fault("straggle", step=2, delay_s=2.5)])
    engines = []

    def make_engine():
        engines.append(_engine(params, cfg, fault=inj, watchdog_s=1.5))
        return engines[-1]

    out = tres.serve_with_recovery(make_engine, _reqs(prompts[:2], 4),
                                   max_restarts=2, backoff_s=0.0,
                                   log=lambda *a: None)
    assert [k for _, k, _ in inj.fired] == ["straggle"]
    assert len(engines) == 2, "exactly one restart"
    assert all(out[i].status == "ok" and len(out[i]) == 4 for i in range(2))


def test_crash_snapshot_restore_completes_everything(setup):
    """Mid-run crash: completed-before-crash and not-yet-admitted
    requests end bit-identical to a fault-free run; mid-flight requests
    re-admit through the prefix re-attachment path and finish with full
    token counts and ok status.  The crash comes after two requests
    finished, so the untouched set is not empty."""
    cfg, params, prompts = setup
    _, base = _serve(params, cfg, prompts, max_tokens=6)
    inj = tres.FaultInjector([tres.Fault("crash", step=6)])
    engines = []

    def make_engine():
        eng = _engine(params, cfg, fault=inj)
        engines.append(eng)
        return eng

    out = tres.serve_with_recovery(make_engine, _reqs(prompts, 6),
                                   max_restarts=2, backoff_s=0.0,
                                   log=lambda *a: None)
    assert len(engines) == 2, "exactly one restart"
    crashed, resumed = engines
    assert any(k == "crash" for _, k, _ in inj.fired)
    for rid in range(4):
        assert out[rid].status == "ok" and len(out[rid]) == 6
    mid_flight = {r.rid for r in crashed.slot_req if r is not None} \
        | {e.rid for e in crashed.sched.waiting} \
        | {e.rid for e in crashed.sched.active.values()}
    untouched = set(range(4)) - mid_flight
    assert untouched
    for rid in untouched:
        assert list(out[rid]) == list(base[rid])
    # Mid-flight requests kept their pre-crash tokens as a prefix.
    snap = crashed.snapshot()
    assert snap["requests"]
    for rd in snap["requests"]:
        assert list(out[rd["rid"]])[:len(rd["output"])] == rd["output"]
    assert resumed.cache is crashed.cache
    resumed.sched.pool.audit()


def test_crashed_engine_is_dropped_before_the_next_is_built(setup):
    """Only the dying engine's cache survives a restart: its weights and
    (on the card) its graph pools are freed before the next engine is
    built, with no cycle left for the collector, and its watchdog's
    thread stops."""
    cfg, params, prompts = setup
    inj = tres.FaultInjector([tres.Fault("crash", step=3)])
    refs, alive_at_make, watchdogs = [], [], []

    def make_engine():
        alive_at_make.append([r() is not None for r in refs])
        eng = _engine(params, cfg, fault=inj, watchdog_s=30.0)
        refs.append(weakref.ref(eng))
        watchdogs.append(eng._watchdog)
        return eng

    out = tres.serve_with_recovery(make_engine, _reqs(prompts[:3], 5),
                                   max_restarts=1, log=lambda *a: None)
    assert alive_at_make == [[], [False]]
    assert all(r.status == "ok" and len(r) == 5 for r in out.values())
    assert watchdogs[0]._stop.is_set()
    gc.collect()
    assert refs[1]() is None and watchdogs[1]._stop.is_set()


def test_failed_responses_do_not_keep_the_engine_alive(setup):
    """A shed request's and a failed chunk's Response keep their error
    but not its traceback, whose frames would hold the engine (on the
    card its weights and graph pools) for as long as the caller keeps the
    responses."""
    cfg, params, prompts = setup
    inj = tres.FaultInjector([tres.Fault("chunk_exception", rid=1)])
    eng = _engine(params, cfg, fault=inj, shed_queue_depth=2)
    shed = []
    for req in _reqs(prompts, 4):
        try:
            eng.submit(req)
        except tres.Shed as e:
            shed.append(e)
    out = eng.run()
    assert [r.status for r in out.values()].count("shed") == 2
    assert out[1].status == "error" and out[1].error.rid == 1
    assert all(r.error is None or r.error.__traceback__ is None
               for r in out.values())
    ref = weakref.ref(eng)
    del eng, shed
    assert ref() is None and out[2].status == "shed"


def test_restarts_past_the_budget_raise(setup):
    cfg, params, prompts = setup
    # Every attempt crashes at its first step.
    inj = tres.FaultInjector([tres.Fault("crash", step=1, count=3)])
    with pytest.raises(RuntimeError, match="exceeded 1 restarts"):
        tres.serve_with_recovery(lambda: _engine(params, cfg, fault=inj),
                                 _reqs(prompts[:2], 4), max_restarts=1,
                                 log=lambda *a: None)
    assert len(inj.fired) == 2


def test_snapshot_restore_reattaches_published_pages(setup):
    """With the device cache carried across the restart, the snapshot's
    page registrations are restored into the fresh pool, so a restored
    request whose prefill window is unchanged (a waiting request sharing
    the crashed request's prompt) aliases the published KV."""
    cfg, params, prompts = setup
    kw = dict(slots=1, prefill_chunk=8, page_size=8)
    eng = _engine(params, cfg, **kw)
    eng.submit(tengine.Request(rid=0, prompt=prompts[0], max_tokens=6))
    eng.submit(tengine.Request(rid=1, prompt=prompts[0], max_tokens=6))
    for _ in range(2):   # rid 0 prefills both chunks, publishing page 0
        eng._admit()
        eng.step()
    snap = eng.snapshot()
    assert snap["requests"] and snap["published"]
    eng2 = _engine(params, cfg, **kw)
    eng2.restore(snap, cache=eng.cache)
    out = eng2.run()
    eng2.sched.pool.audit()
    assert all(out[i].status == "ok" and len(out[i]) == 6 for i in range(2))
    assert eng2.sched.pool.prefix_hit_pages > 0, \
        "restore must re-attach published pages through the prefix cache"


def test_restore_rejects_mismatched_geometry(setup):
    cfg, params, prompts = setup
    eng = _engine(params, cfg)
    snap = eng.snapshot()
    other = _engine(params, cfg, page_size=8)
    with pytest.raises(ValueError, match="geometry"):
        other.restore(snap)


def test_restore_refuses_a_cache_after_a_capture(setup):
    """A captured graph holds its cache's addresses: adopting another
    cache after a capture is refused (the card's case, faked here)."""
    cfg, params, prompts = setup
    eng, old = _engine(params, cfg), _engine(params, cfg)
    eng.decode_step.graphs[False] = ("graph", None, {})
    with pytest.raises(RuntimeError, match="captured"):
        eng.restore(old.snapshot(), cache=old.cache)
    fresh = _engine(params, cfg)
    fresh.restore(old.snapshot(), cache=old.cache)
    assert fresh.cache is old.cache


def test_snapshot_and_shed_decisions_equal_jax(setup):
    """Host-only decisions against the JAX engine on the same submits
    (no step runs): which submits are shed, by queue depth and by the
    token watermark, the snapshot's keys, its requests and its
    geometry."""
    cfg, params, prompts = setup
    jcfg = dataclasses.replace(jax_get_config("gemma_2b").reduced(),
                               **_SMALL)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    for kw in (dict(shed_queue_depth=3), dict(shed_token_watermark=50),
               dict(shed_token_watermark=70, deadline_ms=5000.0)):
        shed = {}
        engines = (JEngine(jparams, jcfg, slots=2, cache_len=64,
                           prefill_len=16, clock=lambda: 1.0, **kw),
                   _engine(params, cfg, clock=lambda: 1.0, **kw))
        for name, eng, req_cls, err_cls in (
                ("jax", engines[0], JRequest, jres.Shed),
                ("torch", engines[1], tengine.Request, tres.Shed)):
            shed[name] = []
            for rid, p in enumerate(prompts):
                try:
                    eng.submit(req_cls(rid=rid, prompt=p, max_tokens=6))
                except err_cls as e:
                    shed[name].append((rid, str(e)))
        assert shed["torch"] == shed["jax"] and shed["torch"], kw
        jsnap, tsnap = (e.snapshot() for e in engines)
        assert tsnap == jsnap, kw
        assert engines[1]._geometry() == engines[0]._geometry()


# -- deadlines / shedding -----------------------------------------------------


class _FakeClock:
    """Monotonic fake: every read advances 10 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.01
        return self.t


def test_deadline_cancels_late_request_with_partial_output(setup):
    cfg, params, prompts = setup
    _, base = _serve(params, cfg, prompts[:3], max_tokens=12)
    eng = _engine(params, cfg, clock=_FakeClock())
    eng.submit(tengine.Request(rid=0, prompt=prompts[0], max_tokens=12,
                               deadline_ms=150.0))
    for rid in (1, 2):
        eng.submit(tengine.Request(rid=rid, prompt=prompts[rid],
                                   max_tokens=12))
    out = eng.run()
    eng.sched.pool.audit()
    assert out[0].status == "deadline" and 0 < len(out[0]) < 12
    assert isinstance(out[0].error, tres.DeadlineExceeded)
    assert list(out[0]) == list(base[0])[:len(out[0])]
    for rid in (1, 2):
        assert out[rid].status == "ok" and list(out[rid]) == list(base[rid])
    assert eng.metrics()["free_pages"] == eng.metrics()["num_pages"] - 1
    assert not eng._deadline_at


def test_shed_bounded_queue_depth(setup):
    cfg, params, prompts = setup
    eng = _engine(params, cfg, shed_queue_depth=3)
    for rid in range(3):
        eng.submit(tengine.Request(rid=rid, prompt=prompts[rid],
                                   max_tokens=4))
    with pytest.raises(tres.Shed):  # the 4th submit sees queue depth 3
        eng.submit(tengine.Request(rid=3, prompt=prompts[3], max_tokens=4))
    out = eng.run()
    assert out[3].status == "shed" and list(out[3]) == []
    assert all(out[i].status == "ok" and len(out[i]) == 4 for i in range(3))
    assert eng.metrics()["shed_requests"] == 1


def test_shed_token_watermark(setup):
    cfg, params, prompts = setup
    # each request commits prefill_len (16) + max_tokens (6) = 22 slots
    eng = _engine(params, cfg, shed_token_watermark=50)
    eng.submit(tengine.Request(rid=0, prompt=prompts[0], max_tokens=6))
    eng.submit(tengine.Request(rid=1, prompt=prompts[1], max_tokens=6))
    with pytest.raises(tres.Shed, match="watermark"):
        eng.submit(tengine.Request(rid=2, prompt=prompts[2], max_tokens=6))
    out = eng.run()
    assert out[2].status == "shed"
    assert all(out[i].status == "ok" for i in range(2))


# -- the prefix-index file ----------------------------------------------------


def test_prefix_index_warm_starts_second_engine(tmp_path):
    """Engine 1 publishes its prefill pages and saves the index at the end
    of run(); engine 2 (same geometry, handed the surviving device cache)
    reloads it at start and aliases the shared prefix instead of
    recomputing it: outputs identical."""
    cfg = _cfg()
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    path = str(tmp_path / "prefix.json")
    prompt = np.random.default_rng(9).integers(0, 128, 32, dtype=np.int32)
    kw = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
              prefill_chunk=8, prefix_index_path=path)
    eng1 = _engine(params, cfg, **kw)
    eng1.submit(tengine.Request(rid=0, prompt=prompt, max_tokens=8))
    out1 = eng1.run()
    assert os.path.exists(path)
    eng2 = _engine(params, cfg, **kw)
    assert eng2.sched.pool.cached_pages > 0
    eng2.cache = eng1.cache      # the device pages survive the restart
    eng2.submit(tengine.Request(rid=1, prompt=prompt, max_tokens=8))
    out2 = eng2.run()
    assert list(out2[1]) == list(out1[0])
    assert eng2.sched.pool.prefix_hit_pages > 0, \
        "second engine must alias the reloaded prefix pages"
    # Another pool's file is skipped with a message: a cold start.
    eng3 = _engine(params, cfg, **dict(kw, page_size=16, prefill_chunk=16))
    assert eng3.sched.pool.cached_pages == 0


# -- KVPagePool chaos ---------------------------------------------------------


def test_pool_audit_catches_corruption():
    pool = tkv.KVPagePool(num_pages=8, page_size=4)
    pool.audit()
    assert pool.ensure(1, 8)
    pool.audit()
    pool._ref[pool.pages_of(1)[0]] += 1  # refcount drift
    with pytest.raises(tkv.AuditError, match="refcount"):
        pool.audit()


def test_pool_chaos_stress_audit_after_every_op():
    """Seeded random alias/evict/CoW/resume traffic; every operation
    leaves the pool audit-clean."""
    rng = np.random.default_rng(42)
    pool = tkv.KVPagePool(num_pages=24, page_size=4)
    keys = itertools.count(1)
    live = {}
    registered = []
    for step in range(500):
        op = rng.choice(["new", "grow", "release", "register", "admit",
                         "cow", "inject", "lookup"])
        if op == "new":
            key, tok = next(keys), int(rng.integers(1, 33))
            if pool.ensure(key, tok):
                live[key] = tok
        elif op == "grow" and live:
            key = int(rng.choice(list(live)))
            tok = live[key] + int(rng.integers(1, 17))
            if pool.ensure(key, tok):
                live[key] = tok
        elif op == "release" and live:
            key = int(rng.choice(list(live)))
            pool.release(key)
            del live[key]
        elif op == "register" and live:
            key = int(rng.choice(list(live)))
            idx = int(rng.integers(0, len(pool.pages_of(key))))
            h = f"h{key}:{idx}:{step}"
            if pool.register(key, idx, h):
                registered.append(h)
        elif op == "admit" and registered:
            n = int(rng.integers(1, 4))
            hashes = [h for h in registered if h in pool._page_of][:n]
            matched = pool.lookup_prefix(hashes)
            key = next(keys)
            tok = max(matched * pool.page_size, 1) + int(rng.integers(0, 9))
            if pool.admit_prefix(key, hashes, matched, tok):
                live[key] = tok
        elif op == "cow" and live:
            key = int(rng.choice(list(live)))
            pages = pool.pages_of(key)
            shared = [i for i, p in enumerate(pages) if pool.ref_of(p) > 1]
            if shared:
                try:
                    pool.make_private(key, shared[0])
                except RuntimeError:
                    pass  # pool dry: a legitimate refusal, state unchanged
        elif op == "inject":
            pool.inject_alloc_failures += 1
            key, before = next(keys), pool.free_pages
            assert not pool.ensure(key, 4)
            assert pool.free_pages == before and pool.pages_of(key) == []
        elif op == "lookup":
            pool.lookup_prefix([f"nope{step}", "nope2"])
        pool.audit()
    assert registered and live


def test_injected_alloc_failure_is_all_or_nothing():
    pool = tkv.KVPagePool(num_pages=8, page_size=4)
    pool.inject_alloc_failures = 1
    assert not pool.ensure(1, 8)
    pool.audit()
    assert pool.ensure(1, 8)   # consumed: the next grant succeeds
    pool.audit()
    assert pool.injected_alloc_failures == 1


# -- distributed/fault.py -----------------------------------------------------


def test_heartbeat_beat_is_atomic(tmp_path):
    path = str(tmp_path / "hb")
    hb = tfault.Heartbeat(path, interval_s=60.0)
    hb.stop()
    hb.beat()
    assert float(open(path).read()) > 0
    leftovers = [f for f in os.listdir(tmp_path) if f.startswith("hb.tmp")]
    assert not leftovers, "the temp file must be replaced, not left behind"


def test_supervise_on_give_up_hook():
    seen = []

    def run(attempt):
        raise tfault.StragglerError(f"hang {attempt}")

    with pytest.raises(tfault.StragglerError, match="hang 2"):
        tfault.supervise(run, max_restarts=2, backoff_s=0.0,
                         log=lambda *a: None, on_give_up=seen.append)
    assert len(seen) == 1 and isinstance(seen[0], tfault.StragglerError)
