"""The port's engine with its defaults — graph programs and the grouped
decode q/k/v, the JAX package's default kernel configuration — against the
JAX engine on its pallas backend with graph and grouped q/k/v on, and the
same pair under the rigid ``gemm_policy="amx"``, on gemma_2b.reduced() in
fp32: equal greedy tokens per request, equal page tables after every step,
equal prefix-hash registrations and equal scheduler counters.  The JAX
engine runs synchronous steps and is handed copies of its host arrays
(see test_torch_serving.py)."""
import dataclasses

import pytest

from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule
from torch_parity import jax_cfg, jax_params, torch_cfg
from test_torch_serving import _COUNTERS, _KW, _jax_engine, _prompts

# The port, imported at first use (see torch_lazy).
tengine = LazyModule("repro_torch.serving.engine")
tschedule = LazyModule("repro_torch.graph.schedule")


def _record_tables(engine):
    """Wrap ``engine.step`` to log every active slot's page-table row
    after each step, and return the log."""
    log = []
    step = engine.step

    def logged():
        step()
        sched = engine.sched
        log.append([(slot, sched.table_row(slot).tolist())
                    for slot in sorted(sched.active)])

    engine.step = logged
    return log


def _serve(engine, request_cls, prompts, max_tokens=6):
    tables = _record_tables(engine)
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_tokens=max_tokens))
    return engine.run(), tables


@pytest.mark.parametrize("policy", ["mte", "amx"])
def test_default_engine_matches_jax_graph_engine(policy):
    jcfg = dataclasses.replace(jax_cfg(), use_graph=True,
                               gemm_policy=policy)
    jp, tp = jax_params(jcfg)
    prompts = _prompts(jcfg.vocab)
    jeng = _jax_engine(jp, jcfg, async_steps=False, **_KW)
    tcfg = torch_cfg(use_graph=True, gemm_policy=policy)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", async_steps=False,
                                 **_KW)
    assert jeng.cfg.decode_qkv_grouped and teng.cfg.decode_qkv_grouped
    assert ("qkv" in teng.params["layers"][0]["mixer"]) == (policy == "mte")
    jout, jtables = _serve(jeng, JRequest, prompts)
    tout, ttables = _serve(teng, tengine.Request, prompts)
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert tout[rid].status == jout[rid].status == "ok"
    assert ttables == jtables
    assert (teng.sched.pool.registrations()
            == jeng.sched.pool.registrations())
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["prefix_hit_pages"] > 0
    assert {k: tm[k] for k in _COUNTERS} == {k: jm[k] for k in _COUNTERS}
    assert tm["graph_programs_compiled"] > 0
    assert tm["graph_program_hits"] > 0
    teng.sched.pool.audit()


def test_decode_step_uses_one_grouped_program():
    """The engine's decode steps run the q/k/v as the one-node grouped
    program, and the MLP and prefill q/k/v as compiled programs."""
    cfg = torch_cfg(use_graph=True)
    _, tp = jax_params(jax_cfg())
    tschedule.reset_programs()
    eng = tengine.ServingEngine(tp, cfg, device="cpu", **_KW)
    out, _ = _serve(eng, tengine.Request, _prompts(cfg.vocab)[:1])
    assert out[0].status == "ok"
    progs = tschedule.compiled_programs()
    decode_qkv = [p for p in progs if p.n_source_dispatches == 1]
    assert len(decode_qkv) == 1 and decode_qkv[0].grouped
    assert decode_qkv[0].plans and all(
        pl.route == "grouped" for pl in decode_qkv[0].plans.values())
    assert len(progs) >= 3
