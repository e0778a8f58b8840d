"""The port's async pipelined engine step, held to the contract of
``tests/test_async_engine.py`` on the CPU: ``async_steps=True`` (depth 2,
the default) changes when sampled tokens reach the host, never which
tokens a request receives — greedy streams bit-identical with async on
and off, under mid-run eviction too; the pipeline reaches depth 2 and is
empty after ``run()``; a finish is re-admitted in the step that delivers
it (work conservation).  The port in its defaults against the JAX engine
in its own (both async), request for request and page table for page
table.  Plus the pieces the pipeline stands on: the decode step's
all-inactive warm-up leaves every live cache row alone, the carried
token buffer is written in place, the sampler draws only when the host
says a row samples, host staging copies, and the launch counters of a
captured region.  The CUDA graph itself runs only on the card
(``tests/test_torch_cuda.py``)."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule, torch
from torch_parity import jax_cfg, jax_params, torch_cfg, torch_model
from test_torch_serving import _COUNTERS, _jax_engine

# The port, imported at first use (see torch_lazy).
tbuild = LazyModule("repro_torch.kernels.build")
tconfigs = LazyModule("repro_torch.configs")
tengine = LazyModule("repro_torch.serving.engine")


def _cfg(arch):
    """gemma_2b cut to 2 narrow layers (the JAX test's ``_cfg``), or
    recurrentgemma_9b.reduced()."""
    cfg = tconfigs.get_config(arch).reduced()
    if arch == "gemma_2b":
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=64, d_ff=128,
                                  vocab=128, n_heads=2, n_kv_heads=1,
                                  head_dim=32)
    return cfg


def _workload(vocab, n_req=5, lo=10, hi=16, base_tokens=6):
    """Staggered prompts and budgets: multi-chunk prefills and unequal
    finish steps, so admissions and chunks land while a decode is in
    flight."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(lo, hi)),
                            dtype=np.int32) for _ in range(n_req)]
    budgets = [base_tokens + (i % 3) * 2 for i in range(n_req)]
    return prompts, budgets


def _serve(params, cfg, prompts, budgets, **kw):
    eng = tengine.ServingEngine(params, cfg, slots=2, cache_len=64,
                                prefill_len=16, page_size=8,
                                prefill_chunk=8, device="cpu", **kw)
    for rid, p in enumerate(prompts):
        eng.submit(tengine.Request(rid=rid, prompt=p,
                                   max_tokens=budgets[rid]))
    out = eng.run()
    assert all(r.status == "ok" for r in out.values())
    return {rid: tuple(r) for rid, r in out.items()}, eng


@pytest.fixture(scope="module")
def gemma():
    cfg = _cfg("gemma_2b")
    return cfg, torch_model.init_params(cfg, seed=0, device="cpu")


# -- greedy bit-identity ------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
def test_greedy_bit_identity_async_on_off(arch):
    """A pure-attention arch and a hybrid one, whose per-slot ring and
    RG-LRU rows ride ``row_valid`` through the pipelined decode."""
    cfg = _cfg(arch)
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    prompts, budgets = _workload(cfg.vocab, n_req=4)
    sync_toks, _ = _serve(params, cfg, prompts, budgets, async_steps=False)
    async_toks, eng = _serve(params, cfg, prompts, budgets)
    assert eng.async_steps and eng.pipeline_depth == 2
    assert async_toks == sync_toks
    assert all(len(t) > 0 for t in async_toks.values())
    assert eng.metrics()["delivery_lag_mean"] > 0.0


def test_greedy_bit_identity_under_mid_run_eviction(gemma):
    """A pool small enough to preempt mid-run: the eviction boundary
    flushes the pipeline before the victim's output is requeued."""
    cfg, params = gemma
    prompts, budgets = _workload(cfg.vocab, n_req=3, base_tokens=10)
    sync_toks, sync_eng = _serve(params, cfg, prompts, budgets,
                                 async_steps=False, num_pages=7)
    async_toks, async_eng = _serve(params, cfg, prompts, budgets,
                                   num_pages=7)
    assert async_toks == sync_toks
    assert sync_eng.metrics()["preemptions"] >= 1
    assert async_eng.metrics()["preemptions"] >= 1


# -- pipeline depth and work conservation -------------------------------------


def test_pipeline_reaches_depth_two(gemma):
    cfg, params = gemma
    prompts, budgets = _workload(cfg.vocab)
    _, eng = _serve(params, cfg, prompts, budgets)
    assert eng.steps_in_flight_max >= 2
    assert eng.steps_in_flight == 0      # run()'s end is a flush boundary
    _, sync_eng = _serve(params, cfg, prompts, budgets, async_steps=False)
    assert sync_eng.steps_in_flight_max <= 1
    _, one = _serve(params, cfg, prompts, budgets, pipeline_depth=1)
    assert one.pipeline_depth == 1 and one.steps_in_flight_max <= 1


def test_work_conservation_vs_sync(gemma):
    """Finishes delivered by the retire are re-admitted in the same step,
    so async costs at most the trailing drain-only steps."""
    cfg, params = gemma
    prompts, budgets = _workload(cfg.vocab)
    _, sync_eng = _serve(params, cfg, prompts, budgets, async_steps=False)
    _, async_eng = _serve(params, cfg, prompts, budgets)
    assert async_eng.step_idx - sync_eng.step_idx <= 3
    assert async_eng.metrics()["delivery_lag_mean"] == pytest.approx(1.0)
    assert sync_eng.metrics()["delivery_lag_mean"] == 0.0


# -- the port in its defaults against the JAX engine in its own ---------------


def _record_tables(engine):
    """Wrap ``engine.step`` to log every active slot's page-table row
    after each step."""
    log, step = [], engine.step

    def logged():
        step()
        log.append([(slot, engine.sched.table_row(slot).tolist())
                    for slot in sorted(engine.sched.active)])

    engine.step = logged
    return log


def _jax_and_port(arch):
    if arch == "gemma_2b":
        jcfg = jax_cfg()
        tcfg = torch_cfg()
        kw = dict(grouped_qkv=False, num_pages=9, slots=2, cache_len=64,
                  prefill_len=32, page_size=8, prefill_chunk=16)
    else:
        jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                   gemm_backend="pallas")
        tcfg = tconfigs.get_config(arch).reduced()
        kw = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
                  prefill_chunk=16)
    return jcfg, tcfg, kw


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
def test_defaults_match_jax_engine(arch):
    """Both engines in their defaults (async, depth 2), the JAX one
    handed copies of its host arrays (``_jax_engine``): the same greedy
    streams, the same page tables after every step, the same step count,
    pipeline depth and delivery lag.  gemma_2b's pool of 9 pages
    preempts mid-run."""
    jcfg, tcfg, kw = _jax_and_port(arch)
    jp, tp = jax_params(jcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab, k, dtype=np.int32)
               for k in (20, 9, 30, 17)]
    jeng = _jax_engine(jp, jcfg, **kw)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", **kw)
    assert jeng.async_steps and teng.async_steps
    logs = []
    for eng, req in ((jeng, JRequest), (teng, tengine.Request)):
        logs.append(_record_tables(eng))
        for rid, p in enumerate(prompts):
            eng.submit(req(rid=rid, prompt=p, max_tokens=7))
    jout, tout = jeng.run(), teng.run()
    assert sorted(tout) == sorted(jout) == [0, 1, 2, 3]
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert tout[rid].status == jout[rid].status == "ok"
    assert logs[1] == logs[0]
    assert teng.step_idx == jeng.step_idx
    assert teng.steps_in_flight_max == jeng.steps_in_flight_max
    jm, tm = jeng.metrics(), teng.metrics()
    keys = _COUNTERS + ("delivery_lag_mean",)
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    if arch == "gemma_2b":
        assert tm["preemptions"] >= 1


# -- what the pipeline stands on ----------------------------------------------


def test_cuda_graph_on_the_cpu_raises(gemma):
    cfg, params = gemma
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        tengine.ServingEngine(params, cfg, device="cpu", cuda_graph=True)
    eng = tengine.ServingEngine(params, cfg, device="cpu")
    assert eng.decode_step.graph is False


def test_a_dropped_engine_is_freed_at_once(gemma):
    """The decode step refers to its engine through a weak proxy: an
    engine the caller drops frees its cache and weights at once, without
    the cycle collector."""
    import gc
    import weakref
    cfg, params = gemma
    gc.disable()
    try:
        eng = tengine.ServingEngine(params, cfg, device="cpu")
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


def _cache_leaves(cache):
    return [(i, name, leaf.clone())
            for i, layer in enumerate(cache["layers"])
            for name, leaf in layer.items()]


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
@pytest.mark.parametrize("sampled", [False, True])
def test_warm_up_leaves_every_live_row_alone(arch, sampled):
    """Mid-run (slots decoding, one prefilling), the decode step's
    all-inactive warm-up — the call made before a capture — changes no
    KV page but the null page 0, no ring or RG-LRU row and no carried
    token, and hands the staged inputs back as they were."""
    cfg = _cfg(arch)
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    prompts, budgets = _workload(cfg.vocab, n_req=3, base_tokens=12)
    eng = tengine.ServingEngine(params, cfg, slots=2, cache_len=64,
                                prefill_len=16, page_size=8,
                                prefill_chunk=8, device="cpu")
    for rid, p in enumerate(prompts):
        eng.submit(tengine.Request(rid=rid, prompt=p,
                                   max_tokens=budgets[rid]))
    eng._admit()
    for _ in range(4):
        eng.step()
    assert eng._decoding()
    step = eng.decode_step
    before = _cache_leaves(eng.cache)
    tokens = step.tokens.clone()
    step.warm_up(sampled)
    for i, name, old in before:
        new = eng.cache["layers"][i][name]
        if name.endswith("_pages") or name.endswith("_scale"):
            new, old = new[1:], old[1:]
        assert torch.equal(new, old), (i, name)
    assert torch.equal(step.tokens, tokens)
    assert not bool(step.active.any())
    assert bool((step.page_table == -1).all())


def test_decode_and_sample_writes_the_carried_buffer(gemma):
    cfg, params = gemma
    eng = tengine.ServingEngine(params, cfg, slots=3, cache_len=32,
                                prefill_len=16, page_size=8, device="cpu")
    carried = torch.tensor([[5], [6], [7]], dtype=torch.int32)
    table = torch.tensor([[1, 2, 3, 4], [-1] * 4, [5, 6, 7, 8]],
                         dtype=torch.int32)
    batch = {"tokens": carried, "pos": torch.tensor([3, 0, 9]),
             "page_table": table}
    active = torch.tensor([True, False, True])
    tok, finite, logits, nxt, _ = torch_model.decode_and_sample(
        eng.params, batch, eng.cache, eng.cfg, generator=None,
        temperatures=torch.zeros(3), active_rows=active, sampled=False)
    assert nxt is carried
    assert carried[:, 0].tolist() == [int(tok[0]), 6, int(tok[2])]
    assert torch.equal(tok, logits.argmax(-1).to(torch.int32))
    assert bool(finite.all())


def test_sample_token_draws_only_when_asked():
    """Greedy rows take the lowest-index f32 argmax; ``sampled=False``
    leaves the generator untouched even with a hot row's temperature;
    sampled rows draw from the tempered softmax."""
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, 0.0, 2.0, 0.0]])
    temps = torch.tensor([0.0, 1.0])
    tok, finite = torch_model.sample_token(logits, gen, temps,
                                           sampled=False)
    assert tok.tolist() == [1, 0] and tok.dtype == torch.int32
    assert torch.equal(gen.get_state(), state)
    counts = np.zeros(4, int)
    for _ in range(400):
        tok, _ = torch_model.sample_token(logits, gen, temps, sampled=True)
        assert int(tok[0]) == 1           # the greedy row never draws
        counts[int(tok[1])] += 1
    assert not torch.equal(gen.get_state(), state)
    # Row 1: p = (e²/(2e²+2), ·, e²/(2e²+2), ·) ≈ (0.44, 0.06, 0.44, 0.06).
    assert counts[0] > 130 and counts[2] > 130 and counts[1] + counts[3] < 80
    bad = torch.tensor([[0.0, float("nan")], [1.0, 0.0]])
    assert torch_model.sample_token(bad, None, 0.0,
                                    sampled=False)[1].tolist() == [False,
                                                                   True]


def test_host_staging_copies_on_the_cpu():
    """On the CPU the staging copies at once: a later write to the host
    array never reaches the device tensor, and ``out`` is filled in
    place."""
    stage = tengine.HostStaging(torch.device("cpu"))
    assert not stage.pinned
    src = np.arange(6, dtype=np.int32).reshape(2, 3)
    got = stage.to_device(src)
    src[0, 0] = 99
    assert got.tolist() == [[0, 1, 2], [3, 4, 5]]
    out = torch.zeros(2, 3, dtype=torch.int32)
    assert stage.to_device(src, out=out) is out and int(out[0, 0]) == 99
    tok = torch.tensor([4, 5], dtype=torch.int32)
    handle = stage.fetch(tok, tok > 4)
    tok[0] = 0
    values, flags = stage.wait(handle)
    assert values.tolist() == [4, 5] and flags.tolist() == [False, True]


def test_capturing_hands_back_the_delta():
    """A captured region's launches leave the counters as they were and
    come back as its delta; each replay adds the delta."""
    tbuild.reset_launch_counts()
    tbuild.count_launch("rglru_scan")
    with tbuild.capturing() as delta:
        tbuild.count_launch("splitk_gemm_cluster")
        tbuild.count_launch("splitk_gemm_cluster")
        tbuild.count_launch("flash_decode_mma")
    assert delta == {"splitk_gemm_cluster": 2, "flash_decode_mma": 1}
    counts = tbuild.launch_counts()
    assert counts["rglru_scan"] == 1 and counts["splitk_gemm_cluster"] == 0
    for _ in range(3):
        tbuild.add_launches(delta)
    counts = tbuild.launch_counts()
    assert counts["splitk_gemm_cluster"] == 6
    assert counts["flash_decode_mma"] == 3
    with pytest.raises(RuntimeError):
        with tbuild.capturing() as failed:
            tbuild.count_launch("mte_gemm")
            raise RuntimeError("capture failed")
    assert failed == {"mte_gemm": 1}
    assert tbuild.launch_counts()["mte_gemm"] == 0
    tbuild.reset_launch_counts()
