"""gemma2_27b.reduced() through the port against the JAX package, on the
CPU: local (ring) and global (paged) layers in one model, GQA 2:1, the
attention and final softcaps, the query scale 144^-0.5 and the post-norms.
The JAX side runs its pallas backend in interpret mode with parameters
carried across by ``repro_torch.convert.params_from_jax``; the port runs
its plain versions.  Compared: the config field for field, the parameter
tree, ``prefill_chunk``, ``decode`` and ``verify_chunk`` logits within
fp32's ``TOL`` across the 16-slot ring's wrap, the serving engine's greedy
streams, and speculative serving (``tests/test_speculative.py:54-187`` of
the JAX package): streams equal to ``spec_k=0``'s and to the JAX
speculative engine's with its ``spec_k_hist`` and counts, a full-depth
draft accepted every time, and after every speculative step the rings of
the decoding slots equal to those a prefill of the same tokens leaves."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import model as jax_model
from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule, torch
from torch_parity import TOL, jax_params, n, torch_model
from test_torch_serving import _COUNTERS, _jax_engine

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tengine = LazyModule("repro_torch.serving.engine")

ARCH = "gemma2_27b"
PAGE, SLOTS, CACHE_LEN, PROMPT = 8, 2, 64, 24
MAXP = CACHE_LEN // PAGE
_SPEC_KEYS = ("spec_steps", "spec_drafted", "spec_accepted", "spec_emitted",
              "decode_tokens", "spec_k_mean")


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               gemm_backend="pallas", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    """Every field equal, full width and ``reduced()`` (4 layers, 2 kv
    heads, window 16), but the kernel backend's name."""
    j, t = jget_config(ARCH), tconfigs.get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
        assert (t.n_layers, t.n_kv_heads, t.window) == (4, 2, 16)
    names = {f.name for f in dataclasses.fields(j)}
    assert names == {f.name for f in dataclasses.fields(t)}
    assert {k for k in names if getattr(j, k) != getattr(t, k)} == {
        "gemm_backend"}
    assert t.layer_kinds[:2] == (("local", "mlp"), ("attn", "mlp"))
    assert (t.attn_softcap, t.final_softcap, t.post_norms) == (50.0, 30.0,
                                                              True)


def test_params_carry_the_post_norms():
    """``params_from_jax`` carries ``post_norm1`` and ``post_norm2`` of
    every layer through the unstacking; ``init_params`` makes them; the
    port's ``param_count`` equals the element count of JAX's tree."""
    jcfg, tcfg = _cfgs()
    jp, tp = jax_params(jcfg)
    jtree = jax.tree.map(np.asarray, jax.device_get(jp))
    for i, lp in enumerate(tp["layers"]):
        g, j = divmod(i, jcfg.period)
        for name in ("post_norm1", "post_norm2"):
            np.testing.assert_array_equal(
                n(lp[name]["scale"]), jtree["groups"][j][name]["scale"][g])
    mine = torch_model.init_params(tcfg, seed=0, device="cpu")
    assert all({"post_norm1", "post_norm2"} <= lp.keys()
               for lp in mine["layers"])
    count = sum(int(np.size(a)) for a in jax.tree.leaves(jtree))
    assert torch_model.param_count(tp) == torch_model.param_count(
        mine) == count


@functools.lru_cache(maxsize=None)
def _jitted(chunk_len):
    jcfg, _ = _cfgs()
    chunk = {p0: jax.jit(lambda p, b, c, _p0=p0: jax_model.prefill_chunk(
        p, b, c, jcfg, pos0=_p0)) for p0 in range(0, PROMPT, chunk_len)}
    dec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, jcfg))
    verify = jax.jit(lambda p, b, c: jax_model.verify_chunk(p, b, c, jcfg))
    return jcfg, chunk, dec, verify


@pytest.mark.parametrize("chunk_len", [12, 24])
def test_model_logits_match_jax(chunk_len):
    """A 24-token prompt, longer than the 16-slot window, into slot 1 in
    one chunk or two (the second wraps the ring and reads the first's
    pages), three greedy decode steps with slot 0 idle (``row_valid``
    False), then a 3-token verify window: logits of every call within
    ``TOL["fp32"]``.  Slot 0's ring rows stay zero."""
    jcfg, jchunk, jdec, jverify = _jitted(chunk_len)
    _, tcfg = _cfgs()
    jp, tp = jax_params(jcfg)
    kw = dict(num_pages=SLOTS * MAXP + 1, page_size=PAGE)
    jcache = jax_model.init_paged_cache(jcfg, SLOTS, CACHE_LEN, **kw)
    tcache = torch_model.init_paged_cache(tcfg, SLOTS, CACHE_LEN,
                                          device="cpu", **kw)
    table = np.full((SLOTS, MAXP), -1, np.int32)
    table[1] = 1 + np.arange(MAXP, dtype=np.int32)
    prompt = np.random.default_rng(7).integers(
        0, jcfg.vocab, PROMPT).astype(np.int32)
    tol = TOL["fp32"]
    for p0 in range(0, PROMPT, chunk_len):
        toks = prompt[None, p0:p0 + chunk_len]
        jl, jcache = jchunk[p0](jp, {"tokens": jnp.asarray(toks),
                                     "page_table": jnp.asarray(table[1:]),
                                     "slot": jnp.int32(1)}, jcache)
        tl, tcache = torch_model.prefill_chunk(
            tp, {"tokens": torch.as_tensor(toks),
                 "page_table": torch.as_tensor(table[1:]), "slot": 1},
            tcache, tcfg, pos0=p0)
        np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                                   err_msg=f"chunk at {p0}")
    tok = int(np.argmax(np.asarray(jl)[0]))
    valid = np.array([False, True])
    for i in range(3):
        batch = dict(tokens=np.array([[0], [tok]], np.int32),
                     pos=np.array([0, PROMPT + i], np.int32),
                     page_table=table, row_valid=valid)
        jl, jcache = jdec(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          jcache)
        tl, tcache = torch_model.decode(
            tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tcache,
            tcfg)
        np.testing.assert_allclose(n(tl[1]), n(jl[1]), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        tok = int(np.argmax(np.asarray(jl)[1]))
    window = np.array([[0, 0, 0], [tok, 5, 9]], np.int32)
    batch = dict(tokens=window, pos=np.array([0, PROMPT + 3], np.int32),
                 page_table=table, row_valid=valid)
    jl, _ = jverify(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                    jcache)
    tl, tcache = torch_model.verify_chunk(
        tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tcache, tcfg)
    assert tl.shape == (SLOTS, 3, tcfg.vocab)
    np.testing.assert_allclose(n(tl[1]), n(jl[1]), rtol=tol, atol=tol,
                               err_msg="verify window")
    for layer, (mixer, _) in zip(tcache["layers"], tcfg.layer_kinds):
        if mixer == "local":
            assert all(torch.count_nonzero(leaf[0]) == 0
                       for leaf in layer.values())


_KW = dict(slots=2, cache_len=64, prefill_len=32, page_size=8)


def _prompts(vocab, count=3):
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab, k, dtype=np.int32)
            for k in (30, 21, 17, 26)[:count]]


def _serve(engine, request_cls, prompts, max_tokens=8):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_tokens=max_tokens))
    return engine.run(max_steps=300)


def test_engine_matches_jax_engine():
    """3 requests on 2 slots with prompts longer than the window (the
    rings wrap in prefill and decode), the third prefilling while the
    others decode; the default configuration on both sides (graph
    programs, grouped decode q/k/v).  The rings make the engine pass
    ``row_valid``; the prefix cache stays off (not all layers global)."""
    jcfg, tcfg = _cfgs()
    jp, tp = jax_params(jcfg)
    prompts = _prompts(jcfg.vocab)
    jeng = _jax_engine(jp, jcfg, async_steps=False, prefill_chunk=16,
                       **_KW)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", prefill_chunk=16,
                                 **_KW)
    assert teng._stateful_rows and not teng._prefix_active
    assert "qkv" in teng.params["layers"][0]["mixer"]
    jout = _serve(jeng, JRequest, prompts)
    tout = _serve(teng, tengine.Request, prompts)
    assert sorted(tout) == sorted(jout) == [0, 1, 2]
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert tout[rid].status == jout[rid].status == "ok"
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["prefix_cache"] == 0
    assert {k: tm[k] for k in _COUNTERS} == {k: jm[k] for k in _COUNTERS}


def _ring_checked_engine():
    """The engine with a check after every speculative step: each
    decoding slot's ring rows (every local layer, k and v) equal, within
    fp32's tolerance, those a one-chunk prefill of the slot's fed tokens
    leaves in a fresh cache — a run without speculation.  Rejected
    proposals wrote their K/V into the ring; the rollback must have
    restored it and replayed the accepted prefix."""

    class Checked(tengine.ServingEngine):
        checked = 0

        def _spec_step(self, decoding, k):
            super()._spec_step(decoding, k)
            for slot in decoding:
                if self.slot_req[slot] is None:
                    continue
                fed = self._known_tokens(slot)[:int(self.slot_pos[slot])]
                cache = torch_model.init_paged_cache(
                    self.cfg, 1, self.cache_len, num_pages=MAXP + 1,
                    page_size=self.page_size, device="cpu")
                table = torch.arange(1, MAXP + 1, dtype=torch.int32)[None]
                _, cache = torch_model.prefill_chunk(
                    self.params, {"tokens": torch.as_tensor(fed)[None],
                                  "page_table": table}, cache, self.cfg,
                    pos0=0)
                for i, (mixer, _) in enumerate(self.cfg.layer_kinds):
                    if mixer != "local":
                        continue
                    for name in ("k", "v"):
                        np.testing.assert_allclose(
                            n(self.cache["layers"][i][name][slot]),
                            n(cache["layers"][i][name][0]),
                            rtol=TOL["fp32"], atol=TOL["fp32"],
                            err_msg=f"slot {slot} layer {i} {name}")
                self.checked += 1

    return Checked


def _spec_engines(tcfg, tp, prompts, groups):
    """The port's speculative engine (``spec_k=4``, weight-shared draft of
    ``groups`` periods, rings checked after every speculative step) and
    its vanilla engine, each serving ``prompts``; → (spec streams,
    vanilla streams, spec engine)."""
    kw = dict(_KW, spec_k=4, draft_groups=groups, grouped_qkv=False)
    teng = _ring_checked_engine()(tp, tcfg, device="cpu", **kw)
    vanilla = tengine.ServingEngine(tp, tcfg, device="cpu",
                                    **dict(kw, spec_k=0))
    assert teng.draft_cfg.layer_kinds == tcfg.layer_kinds[:2 * groups]
    tout = _serve(teng, tengine.Request, prompts, max_tokens=10)
    vout = _serve(vanilla, tengine.Request, prompts, max_tokens=10)
    assert sorted(tout) == sorted(vout)
    for rid in vout:
        assert list(tout[rid]) == list(vout[rid]), rid
    assert teng.metrics()["spec_steps"] > 0 and teng.checked > 0
    teng.sched.pool.audit()
    return tout, teng


def test_speculative_streams_match_vanilla_and_jax():
    """``spec_k=4`` with the weight-shared draft of one period (a local
    and a global layer): greedy streams equal to ``spec_k=0``'s and to
    the JAX speculative engine's, with its ``spec_k_hist`` and counts;
    the draft is rejected at some positions; after every speculative
    step the rings equal a run without speculation."""
    jcfg, tcfg = _cfgs(use_graph=False)
    jp, tp = jax_params(jcfg)
    prompts = _prompts(jcfg.vocab)
    tout, teng = _spec_engines(tcfg, tp, prompts, 1)
    jeng = _jax_engine(jp, jcfg, async_steps=False, spec_k=4,
                       draft_groups=1, grouped_qkv=False, **_KW)
    jout = _serve(jeng, JRequest, prompts, max_tokens=10)
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
    assert teng.spec_k_hist == jeng.spec_k_hist
    jm, tm = jeng.metrics(), teng.metrics()
    assert {k: tm[k] for k in _SPEC_KEYS} == {k: jm[k] for k in _SPEC_KEYS}
    assert 0.0 < tm["acceptance_rate"] < 1.0


def test_full_depth_draft_accepts_every_proposal():
    """The draft of both periods is the target: greedy streams equal to
    ``spec_k=0``'s, every proposal accepted, rings checked after every
    speculative step."""
    jcfg, tcfg = _cfgs(use_graph=False)
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    _, teng = _spec_engines(tcfg, params, _prompts(jcfg.vocab), 2)
    assert teng.metrics()["acceptance_rate"] == 1.0


def test_full_width_decode_gemms_plan_on_b2s_cluster_engine():
    """gemma2_27b's decode GEMMs at 4 slots (bf16): o, gate, up and down
    are all planned split (route ``splitk``) and so run on B2's cluster
    engine -- gate and up too, whose 288 128-column tiles already fill
    the card: the cluster engine takes one slice there, where an unsplit
    plan would run B1's tile loop.  The prefill chunk's projections
    (M = 512) stay on B1's wgmma engine, and an fp32 GEMM of the same
    shape keeps the grid rule (no split past the SM count)."""
    from repro_torch.core import autotune
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.core.geometry import splitk_cluster_split

    cache = autotune.PlanCache()

    def plan(m, n, k, dt="bfloat16", act="none"):
        sig = autotune.GemmSignature.make(m, n, k, dt, dt,
                                          Epilogue(activation=act), fmt=dt
                                          if dt == "float32" else "bf16")
        p = cache.plan(sig)
        return p.route, autotune.plan_engine(sig, p.geometry)

    for n, k, act in ((4608, 4096, "none"), (36864, 4608, "gelu"),
                      (36864, 4608, "none"), (4608, 36864, "none")):
        assert plan(4, n, k, act=act) == ("splitk", "cluster"), (n, k)
        assert plan(512, n, k, act=act) == ("mte", "wgmma"), (n, k)
    assert splitk_cluster_split(36864 // 128, 4608, 4) == (1, 4608)
    assert plan(4, 36864, 4608, "float32") == ("mte", "tile")
