"""recurrentgemma_9b.reduced() through the port against the JAX package, on
the CPU: ring-cache decode attention across a wrap (B6's plain version
against ``flash_decode_pallas`` in interpret mode), the ring prefill
chunk, and the serving engine's greedy streams in the default
configuration (graph programs + the grouped decode q/k/v on the local
layers).  Plus the port's own contracts: multi-chunk prefill equals
single-chunk prefill token for token, a decode step leaves the ring rows
of slots that are not decoding untouched, and the engine serves from
parameters whose RG-LRU leaves are not dense dicts.  The model's entry
points are held against JAX in ``test_torch_ring_model.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule, torch
from torch_parity import TOL, jax_params, n, t, torch_model
from test_torch_serving import _COUNTERS, _jax_engine

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tattn = LazyModule("repro_torch.models.attention")
tengine = LazyModule("repro_torch.serving.engine")

ARCH = "recurrentgemma_9b"


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               gemm_backend="pallas", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw)
    return jcfg, tcfg


def _attn_params(jcfg):
    from repro_torch.tree import tree_map
    jp = jattn.init_attention(jax.random.PRNGKey(4), jcfg)
    return jp, tree_map(t, jax.tree.map(np.asarray, jax.device_get(jp)))


def test_decode_attention_matches_jax_across_a_ring_wrap():
    jcfg, tcfg = _cfgs()
    jp, tp = _attn_params(jcfg)
    w = jcfg.window
    jcache = jattn.init_attn_cache(jcfg, 2, 64, w, jnp.float32)
    tcache = tattn.init_attn_cache(tcfg, 2, 64, w, torch.float32)
    assert tcache["k"].shape == (2, w, 1, 32)
    step = jax.jit(lambda x, c, pos: jattn.decode_attention(
        x, jp, jcfg, c, pos, window=w))
    rng = np.random.default_rng(5)
    for i in range(22):                       # row 1 wraps at step 11
        pos = np.array([i, i + 5], np.int32)
        x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jout, jcache = step(jnp.asarray(x), jcache, jnp.asarray(pos))
        tout, tcache = tattn.decode_attention(t(x), tp, tcfg, tcache,
                                              t(pos), window=w)
        np.testing.assert_allclose(n(tout), n(jout), rtol=TOL["fp32"],
                                   atol=TOL["fp32"], err_msg=str(i))
    for name in ("k", "v"):
        np.testing.assert_allclose(n(tcache[name]), n(jcache[name]),
                                   rtol=TOL["fp32"], atol=TOL["fp32"])
    # A row marked not valid keeps its ring exactly.
    before = {k: v.clone() for k, v in tcache.items()}
    tattn.decode_attention(t(x), tp, tcfg, tcache, t(pos + 1), window=w,
                           row_valid=torch.tensor([True, False]))
    for name in ("k", "v"):
        assert torch.equal(tcache[name][1], before[name][1])
        assert not torch.equal(tcache[name][0], before[name][0])


def test_ring_chunk_attention_matches_jax_across_a_wrap():
    jcfg, tcfg = _cfgs()
    jp, tp = _attn_params(jcfg)
    w, c = jcfg.window, 8
    jcache = jattn.init_attn_cache(jcfg, 1, 64, w, jnp.float32)
    tcache = tattn.init_attn_cache(tcfg, 1, 64, w, torch.float32)
    rng = np.random.default_rng(6)
    for pos0 in range(0, 40, c):              # the ring wraps at 16 and 32
        x = rng.standard_normal((1, c, jcfg.d_model)).astype(np.float32)
        positions = (pos0 + np.arange(c, dtype=np.int32))[None]
        jout, jcache = jattn.ring_chunk_attention(
            jnp.asarray(x), jp, jcfg, jcache, jnp.asarray(positions),
            pos0=pos0, window=w)
        tout, tcache = tattn.ring_chunk_attention(
            t(x), tp, tcfg, tcache, t(positions).long(), pos0=pos0,
            window=w)
        np.testing.assert_allclose(n(tout), n(jout), rtol=TOL["fp32"],
                                   atol=TOL["fp32"], err_msg=str(pos0))
        for name in ("k", "v"):
            np.testing.assert_allclose(n(tcache[name]), n(jcache[name]),
                                       rtol=TOL["fp32"], atol=TOL["fp32"])


# -- the serving engine ---------------------------------------------------------

_KW = dict(slots=2, cache_len=64, prefill_len=32, page_size=8)


def _prompts(vocab):
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab, k, dtype=np.int32) for k in (9, 30, 17)]


def _serve(engine, request_cls, prompts, max_tokens=5):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_tokens=max_tokens))
    return engine.run()


def test_engine_matches_jax_engine():
    """3 requests on 2 slots, so the third prefills while the others
    decode; default configuration on both sides."""
    jcfg, tcfg = _cfgs()
    jp, tp = jax_params(jcfg)
    prompts = _prompts(jcfg.vocab)
    jeng = _jax_engine(jp, jcfg, async_steps=False, prefill_chunk=16,
                       **_KW)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", prefill_chunk=16,
                                 **_KW)
    assert jeng.cfg.decode_qkv_grouped and teng.cfg.decode_qkv_grouped
    assert "qkv" in teng.params["layers"][2]["mixer"]
    jout = _serve(jeng, JRequest, prompts)
    tout = _serve(teng, tengine.Request, prompts)
    assert sorted(tout) == sorted(jout) == [0, 1, 2]
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert tout[rid].status == jout[rid].status == "ok"
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["prefix_cache"] == 0
    assert {k: tm[k] for k in _COUNTERS} == {k: jm[k] for k in _COUNTERS}


def test_multi_chunk_prefill_equals_single_chunk():
    _, tcfg = _cfgs()
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    prompts = _prompts(tcfg.vocab)

    def run(chunk):
        eng = tengine.ServingEngine(params, tcfg, device="cpu",
                                    prefill_chunk=chunk, **_KW)
        return _serve(eng, tengine.Request, prompts)

    assert run(32) == run(8)


def test_serving_params_passes_rglru_leaves_through():
    """The engine builds on reduced recurrentgemma under the bf16 format:
    dense weights cast to bf16, the RG-LRU mixer's bare tensors (conv_w,
    conv_b, lam) kept as they are."""
    _, tcfg = _cfgs(format_policy="bf16")
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    eng = tengine.ServingEngine(params, tcfg, device="cpu", prefill_chunk=8,
                                **_KW)
    mixer = eng.params["layers"][0]["mixer"]
    assert mixer["gate_proj"]["w"].dtype == torch.bfloat16
    assert mixer["wa"]["b"].dtype == torch.float32
    for name in ("conv_w", "conv_b", "lam"):
        assert mixer[name] is params["layers"][0]["mixer"][name]
    out = _serve(eng, tengine.Request, _prompts(tcfg.vocab)[:2])
    assert all(r.status == "ok" and len(r) == 5 for r in out.values())
