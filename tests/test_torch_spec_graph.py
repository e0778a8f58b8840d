"""The speculative step on static buffers (``serving.engine.SpecStep``) on
the CPU, where it runs eagerly (``graph=False``): greedy streams and
speculative counts equal to the JAX speculative engine's for both archs
in their served configuration; the device-side greedy acceptance
(argmax, finite flags, ``greedy_accepted``) against ``_accept`` on fetched
logits, row by row and through the engine under a poisoned window;
recurrentgemma's window running each projection once, as many GEMM calls
as a decode step; speculation under ``gemm_policy="amx"`` equal to
vanilla; ``cuda_graph=True`` refused on the CPU.  The card's half
(replays bit-equal to eager calls, captures, counters) is in
``tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule, torch
from torch_parity import jax_params, torch_model
from test_torch_serving import _jax_engine

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tengine = LazyModule("repro_torch.serving.engine")
tresilience = LazyModule("repro_torch.serving.resilience")

ARCHS = ["gemma_2b", "recurrentgemma_9b"]
# The speculative counters both engines keep.
SPEC_COUNTERS = ("spec_steps", "spec_drafted", "spec_accepted",
                 "spec_emitted", "decode_tokens", "spec_k_mean")
_KW = dict(slots=2, cache_len=96, prefill_len=32, page_size=16, spec_k=4)


def _tiny(cfg):
    """Two layer periods at narrow widths (the speculative tests' size)."""
    return dataclasses.replace(cfg, n_layers=2 * cfg.period, d_model=64,
                               d_ff=128, vocab=128, n_heads=2, n_kv_heads=1,
                               head_dim=32)


def _submit(engine, vocab, request_cls, n=3, max_tokens=10, temperature=0.0):
    """``n`` requests sharing 20 prompt tokens, each with a tail of its
    own; more requests than slots, so one is admitted mid-run."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, 20, dtype=np.int32)
    for rid in range(n):
        tail = rng.integers(0, vocab, 4 + 2 * rid, dtype=np.int32)
        engine.submit(request_cls(rid=rid,
                                  prompt=np.concatenate([shared, tail]),
                                  max_tokens=max_tokens,
                                  temperature=temperature))


@pytest.fixture(scope="module")
def tiny_params():
    return {arch: torch_model.init_params(
        _tiny(tconfigs.get_config(arch).reduced()), seed=0, device="cpu")
        for arch in ARCHS}


def _serve(params, cfg, engine_cls=None, **kw):
    eng = (engine_cls or tengine.ServingEngine)(
        params, cfg, device="cpu", debug_audit=True, **dict(_KW, **kw))
    _submit(eng, cfg.vocab, tengine.Request)
    out = eng.run(max_steps=300)
    return out, eng


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_step_equals_the_jax_speculative_engine(arch):
    """The served configuration (graph programs, the grouped decode q/k/v)
    on both sides, ``spec_k=4``: the port's speculative step runs on its
    static buffers, eagerly (no graph on the CPU), and gives the JAX
    engine's greedy streams and its speculative steps, drafts and
    accepted drafts — with rejections (recurrentgemma's restores and
    replay windows among them)."""
    jcfg = _tiny(dataclasses.replace(jget_config(arch).reduced(),
                                     gemm_backend="pallas"))
    tcfg = _tiny(tconfigs.get_config(arch).reduced())
    jp, tp = jax_params(jcfg)
    jeng = _jax_engine(jp, jcfg, **_KW)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", **_KW)
    assert isinstance(teng.spec_step, tengine.SpecStep)
    assert not teng.spec_step.graph
    _submit(jeng, jcfg.vocab, JRequest)
    _submit(teng, jcfg.vocab, tengine.Request)
    jout, tout = jeng.run(max_steps=300), teng.run(max_steps=300)
    assert sorted(tout) == sorted(jout) == [0, 1, 2]
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
    jm, tm = jeng.metrics(), teng.metrics()
    assert {k: tm[k] for k in SPEC_COUNTERS} == {k: jm[k]
                                                 for k in SPEC_COUNTERS}
    assert 0.0 < tm["acceptance_rate"] < 1.0
    assert teng.spec_step.graphs == {}


def _fetched_acceptance(eng, logits, proposals):
    """What the host makes of fetched (B, k, V) logits: per row the finite
    flag and ``_accept``'s (emit, j) for a greedy request."""
    req = tengine.Request(rid=0, prompt=np.zeros(1, np.int32))
    out = []
    for row, props in zip(logits, proposals):
        out.append((bool(np.isfinite(row).all()),
                    eng._accept(row, list(props), None, req)))
    return out


def test_device_greedy_acceptance_equals_accept_on_fetched_logits(
        tiny_params):
    """Rows that agree with none, some and all of their proposals, an
    argmax tie (the lowest index wins on both sides) and a row with a NaN
    and one with an inf: the verify window's argmax, finite flags and
    ``greedy_accepted`` give ``_accept``'s emits and j, and the finite
    flags the quarantine's verdict on the fetched logits."""
    cfg = _tiny(tconfigs.get_config("gemma_2b").reduced())
    eng = tengine.ServingEngine(tiny_params["gemma_2b"], cfg, device="cpu",
                                **_KW)
    rng = np.random.default_rng(11)
    b, k, vocab = 7, 5, 32
    logits = rng.standard_normal((b, k, vocab)).astype(np.float32)
    best = logits.argmax(-1)
    proposals = (best[:, :-1] + 1) % vocab            # disagree everywhere
    for row, agree in enumerate((0, 1, 2, 4, 3, 2, 4)):
        proposals[row, :agree] = best[row, :agree]
    logits[3, 1, [5, 9]] = logits[3, 1].max() + 1.0   # a tie: 5 wins
    proposals[3, 1] = 5
    logits[5, 2, 7] = np.nan
    logits[6, 0, 3] = np.inf
    tl = torch.as_tensor(logits)
    argmax = tl.argmax(dim=-1)
    accepted = tengine.greedy_accepted(argmax, torch.as_tensor(proposals))
    finite = torch.isfinite(tl).all(dim=-1).all(dim=-1)
    want = _fetched_acceptance(eng, logits, proposals)
    for row, (ok, (emit, j)) in enumerate(want):
        assert bool(finite[row]) == ok, row
        if not ok:
            continue
        assert int(accepted[row]) == j, row
        assert argmax[row, :j + 1].tolist() == emit, row
    assert [j for _, (_, j) in want[:5]] == [0, 1, 2, 4, 3]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_steps_cancel_and_emit_as_the_host_path(arch, tiny_params,
                                                       monkeypatch):
    """One engine takes the all-greedy variant (proposals chained on the
    device, one fetch of argmax, flags and j), the other the host path of
    sampled steps with every request greedy (draft and target logits
    fetched, ``_accept`` and the quarantine on them).  Slot 0's window
    logits turn non-finite at the third speculative step: both cancel
    the same request with ``PoisonedOutput`` and give the others the same
    tokens, steps, drafts and accepted drafts."""
    cfg = _tiny(tconfigs.get_config(arch).reduced())
    real = torch_model.verify_chunk
    calls = {}

    def poisoned(params, batch, cache, cfg_, *, last_only=False):
        logits, cache = real(params, batch, cache, cfg_, last_only=last_only)
        if not last_only and cfg_ is calls["cfg"]:
            calls["n"] += 1
            if calls["n"] == 3:
                logits = logits.clone()
                logits[0, 1, 0] = float("nan")
        return logits, cache

    monkeypatch.setattr("repro_torch.models.model.verify_chunk", poisoned)

    class HostPath(tengine.ServingEngine):
        def _spec_sampled(self, decoding):
            return True

    runs = []
    for engine_cls in (tengine.ServingEngine, HostPath):
        calls["n"] = 0
        eng = engine_cls(tiny_params[arch], cfg, device="cpu", **_KW)
        calls["cfg"] = eng.cfg
        _submit(eng, cfg.vocab, tengine.Request)
        out = eng.run(max_steps=300)
        runs.append((out, eng.metrics()))
    (greedy, gm), (host, hm) = runs
    assert calls["n"] >= 3
    poisoned_rids = [rid for rid, r in greedy.items()
                     if r.status != "ok"]
    assert len(poisoned_rids) == 1
    assert isinstance(greedy[poisoned_rids[0]].error,
                      tresilience.PoisonedOutput)
    assert {rid: (r.status, list(r)) for rid, r in greedy.items()} == \
        {rid: (r.status, list(r)) for rid, r in host.items()}
    assert {k: gm[k] for k in SPEC_COUNTERS} == {k: hm[k]
                                                 for k in SPEC_COUNTERS}


class _CountingOps:
    """Counts the GEMM wrappers' calls (``ops.mte_gemm``: B1, B2 or B8 by
    plan; ``ops.grouped_gemm``: B3) while installed."""

    def __init__(self, monkeypatch):
        from repro_torch.kernels import ops
        self.calls = {"mte_gemm": 0, "grouped_gemm": 0}
        for name in self.calls:
            real = getattr(ops, name)

            def counted(*args, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*args, **kw)

            monkeypatch.setattr(ops, name, counted)

    def take(self):
        out = dict(self.calls)
        for name in self.calls:
            self.calls[name] = 0
        return out


def test_recurrent_window_projects_once(monkeypatch):
    """recurrentgemma's served configuration (bf16, graph programs, the
    grouped decode q/k/v), 2 slots: a 4-token verify window calls the GEMM
    wrappers as often as one decode step (every ring and RG-LRU
    projection runs once over the B·K rows), B3 among them, at least once
    per local layer (its q/k/v)."""
    cfg = dataclasses.replace(
        tconfigs.get_config("recurrentgemma_9b").reduced(),
        format_policy="bf16", compute_dtype="bfloat16",
        decode_qkv_grouped=True)
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    slots, page, maxp = 2, 8, 8
    cache = torch_model.init_paged_cache(cfg, slots, page * maxp,
                                         num_pages=slots * maxp + 1,
                                         page_size=page, device="cpu")
    table = torch.as_tensor((1 + np.arange(slots * maxp, dtype=np.int32))
                            .reshape(slots, maxp))
    pos = torch.tensor([12, 9])
    valid = torch.ones(slots, dtype=torch.bool)
    window = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (slots, 4)))
    counting = _CountingOps(monkeypatch)
    torch_model.decode(params, {"tokens": window[:, :1], "pos": pos,
                                "page_table": table, "row_valid": valid},
                       cache, cfg)
    step = counting.take()
    torch_model.verify_chunk(params, {"tokens": window, "pos": pos,
                                      "page_table": table,
                                      "row_valid": valid}, cache, cfg)
    assert counting.take() == step
    kinds = [mixer for mixer, _ in cfg.layer_kinds]
    assert step["grouped_gemm"] >= kinds.count("local") > 0


def test_speculation_under_amx_equals_vanilla(tiny_params):
    """``gemm_policy="amx"`` (every projection on the rigid baseline, B8):
    speculative greedy streams equal vanilla's under the same policy,
    with rejections."""
    cfg = dataclasses.replace(_tiny(tconfigs.get_config("gemma_2b")
                                    .reduced()), gemm_policy="amx")
    params = tiny_params["gemma_2b"]
    vanilla, _ = _serve(params, cfg, spec_k=0)
    spec, eng = _serve(params, cfg)
    assert {rid: list(r) for rid, r in spec.items()} == \
        {rid: list(r) for rid, r in vanilla.items()}
    assert all(r.status == "ok" for r in spec.values())
    m = eng.metrics()
    assert m["spec_steps"] > 0 and 0.0 < m["acceptance_rate"] < 1.0


def test_sampled_spec_steps_run_on_the_static_buffers(tiny_params):
    """Sampled requests take the host path through the same shapes:
    every request finishes with its tokens, and the step ran catch-up,
    draft and verify calls."""
    cfg = _tiny(tconfigs.get_config("recurrentgemma_9b").reduced())
    calls = []

    class Recorded(tengine.SpecStep):
        def __call__(self, family, n):
            calls.append((family, n))
            return super().__call__(family, n)

    class Engine(tengine.ServingEngine):
        spec_step_cls = Recorded

    eng = Engine(tiny_params["recurrentgemma_9b"], cfg, device="cpu",
                 **_KW)
    _submit(eng, cfg.vocab, tengine.Request, temperature=0.8)
    out = eng.run(max_steps=300)
    assert all(r.status == "ok" and len(r) == 10 for r in out.values())
    families = {family for family, _ in calls}
    assert {"catchup", "draft", "verify"} <= families
    assert eng.metrics()["spec_steps"] > 0


def test_cuda_graph_on_the_cpu_raises_for_a_speculative_engine(
        tiny_params):
    """``cuda_graph=True`` asks for captured graphs, which the CPU has
    none of: refused, speculation or not; the CPU's default is eager."""
    cfg = _tiny(tconfigs.get_config("gemma_2b").reduced())
    params = tiny_params["gemma_2b"]
    with pytest.raises(ValueError, match="CUDA graph"):
        tengine.ServingEngine(params, cfg, device="cpu", cuda_graph=True,
                              **_KW)
    eng = tengine.ServingEngine(params, cfg, device="cpu", **_KW)
    assert not eng.spec_step.graph and not eng.decode_step.graph
    with pytest.raises(ValueError, match="CUDA graph"):
        tengine.SpecStep(eng, graph=True)
