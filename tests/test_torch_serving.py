"""The port's serving stack against the JAX package's: prefix hashes string
for string, the scheduler's decisions on one request stream, and the
engine's greedy streams, statuses and counters on gemma_2b.reduced() in
fp32 (JAX: eager kernel path, synchronous steps, no grouped q/k/v), with
a shared prefix and a pool large enough that nothing is evicted.  Plus
the port's own contract: fp32 outputs bit-identical with the prefix cache
on and off."""
import numpy as np
import pytest

from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine

from torch_lazy import LazyModule, torch
from torch_parity import jax_cfg, jax_params, torch_cfg, torch_model

# The port, imported at first use (see torch_lazy).
tkv = LazyModule("repro_torch.serving.kv_cache")
tsched = LazyModule("repro_torch.serving.scheduler")
tengine = LazyModule("repro_torch.serving.engine")


@pytest.mark.parametrize("page,salt", [(8, "gemma_2b|None|None"),
                                       (16, "gemma_2b|bf16|int8pt"),
                                       (3, "")])
def test_page_prefix_hashes_equal_string_for_string(page, salt):
    rng = np.random.default_rng(page)
    for n_tok in (0, 7, 32, 101):
        toks = rng.integers(0, 50000, n_tok).astype(np.int32)
        assert (tkv.page_prefix_hashes(toks, page, salt)
                == jkv.page_prefix_hashes(toks, page, salt))


class _Req:
    def __init__(self, rid, max_tokens):
        self.rid = rid
        self.max_tokens = max_tokens


def _drive(mod, hashes_of):
    """One scripted request stream through a scheduler module: prefix
    admissions, page publication, decode growth under pool pressure
    (eviction included: host bookkeeping only), finishes.  Returns every
    decision it made."""
    s = mod.ContinuousBatchingScheduler(slots=3, max_seq_len=48, page_size=8,
                                        num_pages=14, prefill_chunk=8)
    log = []
    for rid in range(6):
        s.submit(_Req(rid, 8 + 4 * (rid % 3)))
    hasher = lambda e: hashes_of[e.rid]  # noqa: E731
    for step in range(40):
        while True:
            got = s.pop_admit(24, hasher)
            if got is None:
                break
            slot, entry, cached = got
            log.append(("admit", slot, entry.rid, cached))
            for j in range(3):
                s.register_prefix(slot, j, hashes_of[entry.rid][j])
        for slot in sorted(s.active):
            entry = s.active.get(slot)
            if entry is None:
                continue
            want = 24 + step % 5 + 1
            for vslot, ventry in s.ensure_decode(slot, want):
                log.append(("evict", vslot, ventry.rid))
            log.append(("table", slot, s.table_row(slot).tolist()))
        done = [sl for sl, e in s.active.items()
                if (step + e.rid) % 7 == 6]
        for sl in done:
            s.release(sl, finished=True)
        s.note_step(len(s.active))
        log.append(("pool", s.pool.describe()))
        s.pool.audit()
        if not s.has_work:
            break
    log.append(("events", list(s.events)))
    log.append(("metrics", s.metrics()))
    return log


def test_scheduler_makes_the_same_decisions():
    rng = np.random.default_rng(3)
    head = rng.integers(0, 100, 24).astype(np.int32)
    windows = {rid: (head if rid % 2 == 0 else
                     np.concatenate([head[:16],
                                     rng.integers(0, 100, 8).astype(
                                         np.int32)]))
               for rid in range(6)}
    hashes = {rid: jkv.page_prefix_hashes(w, 8, "s")
              for rid, w in windows.items()}
    assert _drive(tsched, hashes) == _drive(jsched, hashes)


def _prompts(vocab, n=3, shared=24, tail=8):
    rng = np.random.default_rng(0)
    head = rng.integers(0, vocab, shared, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, tail,
                                               dtype=np.int32)])
            for _ in range(n)]


def _serve(engine, request_cls, prompts, max_tokens=6):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_tokens=max_tokens))
    return engine.run()


_KW = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
           prefill_chunk=16)
_COUNTERS = ("prefill_tokens", "decode_tokens", "prefix_hit_pages",
             "cow_copies", "free_pages", "cached_prefill_tokens",
             "completed_requests", "decode_steps", "preemptions")


def _jax_engine(params, cfg, **kw):
    """The JAX engine, handed copies of the host arrays it batches.  Its
    ``_make_batch`` wraps ``self.slot_pos`` with ``jnp.asarray`` and the
    engine increments ``slot_pos`` in place right after the launch; on the
    CPU backend the launched step can read the incremented positions, so
    about one run in twelve decodes at wrong positions.  The copy pins the
    positions the engine meant."""
    eng = JEngine(params, cfg, **kw)
    make_batch = eng._make_batch

    def copied(tokens, **arrays):
        return make_batch(tokens, **{k: np.array(v) if isinstance(
            v, np.ndarray) else v for k, v in arrays.items()})

    eng._make_batch = copied
    return eng


def test_engine_matches_jax_engine():
    jcfg = jax_cfg()
    jp, tp = jax_params(jcfg)
    prompts = _prompts(jcfg.vocab)
    jeng = _jax_engine(jp, jcfg, grouped_qkv=False, async_steps=False,
                       **_KW)
    teng = tengine.ServingEngine(tp, torch_cfg(), device="cpu", **_KW)
    jout = _serve(jeng, JRequest, prompts)
    tout = _serve(teng, tengine.Request, prompts)
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert tout[rid].status == jout[rid].status == "ok"
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["prefix_hit_pages"] > 0
    assert {k: tm[k] for k in _COUNTERS} == {k: jm[k] for k in _COUNTERS}
    teng.sched.pool.audit()


def test_prefix_cache_fp32_bit_identical_on_and_off():
    cfg = torch_cfg()
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    prompts = _prompts(cfg.vocab)

    def run(prefix_cache):
        eng = tengine.ServingEngine(params, cfg, kv_format="fp32",
                                    prefix_cache=prefix_cache, device="cpu",
                                    **_KW)
        return eng, _serve(eng, tengine.Request, prompts)

    eng_on, out_on = run(True)
    eng_off, out_off = run(False)
    assert out_on == out_off
    assert eng_on.metrics()["prefix_hit_pages"] > 0
    assert eng_off.metrics()["prefix_hit_pages"] == 0
    assert eng_on.sched.prefill_tokens < eng_off.sched.prefill_tokens


@pytest.mark.parametrize("kw", [dict(plan_cache_path="plans.json"),
                                dict(deadline_ms=5.0),
                                dict(watchdog_s=1.0),
                                dict(shed_queue_depth=1)])
def test_engine_refuses_unported_options(kw):
    cfg = torch_cfg()
    params = torch_model.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tengine.ServingEngine(params, cfg, device="cpu", **kw)


def test_engine_without_a_card_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = torch_cfg()
    params = torch_model.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.ServingEngine(params, cfg)
