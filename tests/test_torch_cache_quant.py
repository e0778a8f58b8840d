"""int8 model-level decode caches (``cfg.cache_quant``) of the port against
the JAX package, on the CPU: int8 values with f32 scales, one per (slot,
head), quantized when written and dequantized whole before each read.

The quantizer is held exactly: ``prefill_cache`` of the same K/V gives
JAX's int8 values, scales within 1e-7, for flat (gemma_2b) and ring
(starcoder2_7b) caches, and each decode step writes JAX's quantization of
the K/V it computed.  Logits are held to JAX's ``cache_quant`` path at
``MODEL_TOL["fp32"]`` on both backends (the kernels against JAX's
``pallas`` in interpret mode, ``"torch"`` against ``xla``), and the port
alone to the reference's ``test_int8_kv_cache_decode_close_to_fp`` and
``test_cache_quant_defaults_to_int8pt`` contracts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import model as jax_model

from torch_lazy import LazyModule, torch
from torch_parity import MODEL_TOL, n, t
from test_torch_model_level import _jax_layers
from test_torch_starcoder2 import _perturb

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tmodel = LazyModule("repro_torch.models.model")
tattn = LazyModule("repro_torch.models.attention")
tengine = LazyModule("repro_torch.serving.engine")

B, S, EXTRA = 2, 24, 3
JAX_BACKEND = {"kernels": "pallas", "torch": "xla"}


def _cfgs(arch, backend="torch", **kw):
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               gemm_backend=JAX_BACKEND[backend], **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               gemm_backend=backend, **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=2):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    _perturb(tree, np.random.default_rng(seed + 1))
    return (jax.tree.map(jnp.asarray, tree),
            tconvert.params_from_jax(tree, tcfg, device="cpu"))


def _assert_quantized_equal(mine, theirs, what):
    assert set(mine) == set(theirs) == {"k", "k_scale", "v", "v_scale"}
    for name in ("k", "v"):
        assert mine[name].dtype == torch.int8, (what, name)
        np.testing.assert_array_equal(mine[name].numpy(),
                                      np.asarray(theirs[name]),
                                      err_msg=f"{what} {name}")
        np.testing.assert_allclose(n(mine[f"{name}_scale"]),
                                   n(theirs[f"{name}_scale"]), rtol=1e-7,
                                   atol=0, err_msg=f"{what} {name}_scale")


@pytest.mark.parametrize("arch,seq_len,s", [
    ("gemma_2b", 31, 24),          # flat, the slots past 24 zero
    ("starcoder2_7b", 31, 24),     # a 16-slot ring, wrapped
    ("starcoder2_7b", 31, 10)])    # a ring not yet full
def test_prefill_cache_int8_values_equal_jax(arch, seq_len, s):
    """The same K/V (B, S, Hkv, D) through both packages'
    ``prefill_cache``: int8 values equal, scales within 1e-7."""
    jcfg, tcfg = _cfgs(arch, cache_quant=True)
    rng = np.random.default_rng(4)
    shape = (B, s, tcfg.n_kv_heads, tcfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    k[0, 1] = 0.0                  # a zero row: scale 1, as JAX sets it
    window = tcfg.window
    mine = tattn.prefill_cache(t(k), t(v), tcfg, seq_len, window,
                               torch.float32)
    theirs = jattn.prefill_cache(jnp.asarray(k), jnp.asarray(v), jcfg,
                                 seq_len, window, jnp.float32)
    _assert_quantized_equal(mine, theirs, arch)
    assert mine["k"].shape[1] == (min(window, seq_len) if window
                                  else seq_len)


@pytest.mark.parametrize("arch", ["gemma_2b", "starcoder2_7b"])
def test_init_cache_is_int8_with_scales(arch):
    _, tcfg = _cfgs(arch, cache_quant=True)
    cache = tmodel.init_cache(tcfg, B, 40, device="cpu")
    for layer in cache["layers"]:
        assert layer["k"].dtype == layer["v"].dtype == torch.int8
        assert layer["k_scale"].dtype == torch.float32
        assert layer["k_scale"].shape == (*layer["k"].shape[:3], 1)


@pytest.mark.parametrize("arch,backend", [("gemma_2b", "torch"),
                                          ("starcoder2_7b", "torch"),
                                          ("gemma_2b", "kernels")])
def test_cache_quant_decode_matches_jax(arch, backend):
    """``prefill`` of 24 tokens into int8 caches of 31 slots, then 3
    ``decode`` steps: logits within ``MODEL_TOL["fp32"]`` of JAX's
    ``cache_quant`` path (``xla`` for ``"torch"``, ``pallas`` in
    interpret mode for the kernels); the caches' dequantized values
    within one quantization step of JAX's; and each step's written slot
    holds, exactly, JAX's quantization of the K/V the port's step
    computed."""
    jcfg, tcfg = _cfgs(arch, backend, cache_quant=True,
                       **({"use_graph": False} if backend == "kernels"
                          else {}))
    jp, tp = _params(jcfg, tcfg)
    tol = MODEL_TOL["fp32"]
    data = np.random.default_rng(5).integers(
        0, tcfg.vocab, (B, S + EXTRA)).astype(np.int32)
    jpre = jax.jit(lambda p, b: jax_model.prefill(p, b, jcfg,
                                                  cache_len=S + EXTRA + 4))
    jdec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, jcfg))
    jl, jcache = jpre(jp, {"tokens": jnp.asarray(data[:, :S])})
    tl, tcache = tmodel.prefill(tp, {"tokens": torch.as_tensor(data[:, :S])},
                                tcfg, cache_len=S + EXTRA + 4)
    np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol)

    def dequantized(layer, name):
        return n(layer[name]) * n(layer[f"{name}_scale"])

    for mine, theirs in zip(tcache["layers"], _jax_layers(jcache, jcfg)):
        for name in ("k", "v"):
            step = np.maximum(n(mine[f"{name}_scale"]),
                              n(theirs[f"{name}_scale"]))
            assert np.all(np.abs(dequantized(mine, name)
                                 - dequantized(theirs, name))
                          <= step * 1.001 + 1e-7)
    for i in range(EXTRA):
        pos = S + i
        tok = data[:, pos:pos + 1]
        jl, jcache = jdec(jp, {"tokens": jnp.asarray(tok),
                               "pos": jnp.int32(pos)}, jcache)
        expected = _step_kv(tp, tcfg, tcache, tok, pos)
        tl, tcache = tmodel.decode(tp, {"tokens": torch.as_tensor(tok),
                                        "pos": np.int32(pos)}, tcache, tcfg)
        np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        for layer, (k, v) in zip(tcache["layers"], expected):
            slot = pos % layer["k"].shape[1]
            for name, x in (("k", k), ("v", v)):
                q, s = jattn._quantize_kv(jnp.asarray(x.numpy()))
                np.testing.assert_array_equal(
                    layer[name][:, slot].numpy(), np.asarray(q))
                np.testing.assert_allclose(
                    n(layer[f"{name}_scale"][:, slot]), n(s), rtol=1e-7,
                    atol=0)


def _step_kv(params, cfg, cache, tok, pos):
    """The K/V (B, Hkv, D) each layer of a decode step at ``pos`` writes,
    computed by running the step on a copy of the cache and recording the
    layers' projections."""
    from repro_torch.models import attention as attn_mod
    seen = []
    real = attn_mod._project_qkv_decode

    def spy(*args, **kw):
        q, k, v = real(*args, **kw)
        seen.append((k[:, 0].clone(), v[:, 0].clone()))
        return q, k, v

    copy = {"layers": [{k: v.clone() for k, v in layer.items()}
                       for layer in cache["layers"]]}
    attn_mod._project_qkv_decode = spy
    try:
        tmodel.decode(params, {"tokens": torch.as_tensor(tok),
                               "pos": np.int32(pos)}, copy, cfg)
    finally:
        attn_mod._project_qkv_decode = real
    return seen


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_int8_kv_cache_decode_close_to_fp(backend):
    """``tests/test_decode_consistency.py``'s
    ``test_int8_kv_cache_decode_close_to_fp`` on the port: a decode step
    over int8 caches within 5% of the float caches' logit span, the same
    argmax, and the caches below 0.7 x twice their bytes."""
    _, cfg = _cfgs("gemma_2b", backend)
    cfg_q = dataclasses.replace(cfg, cache_quant=True)
    params = tmodel.init_params(cfg, seed=5, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S + 1)))
    _, cache = tmodel.prefill(params, {"tokens": tokens[:, :S]}, cfg,
                              cache_len=S + 4)
    _, cache_q = tmodel.prefill(params, {"tokens": tokens[:, :S]}, cfg_q,
                                cache_len=S + 4)
    assert cache_q["layers"][0]["k"].dtype == torch.int8
    batch = {"tokens": tokens[:, S:], "pos": np.int32(S)}
    d_fp, _ = tmodel.decode(params, batch, cache, cfg)
    d_q, cache_q2 = tmodel.decode(params, batch, cache_q, cfg_q)
    err = float((d_q - d_fp).abs().max())
    assert err / (float(d_fp.abs().max()) + 1e-6) < 0.05, err
    assert torch.equal(d_q.argmax(-1), d_fp.argmax(-1))

    def nbytes(c):
        return sum(x.numel() * x.element_size() for layer in c["layers"]
                   for x in layer.values() if x.ndim >= 4)

    assert nbytes(cache_q2) < 0.7 * nbytes(cache) * 2


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_cache_quant_defaults_to_int8pt(backend):
    """``tests/test_paged_serving.py``'s ``test_cache_quant_defaults_to_
    int8pt`` on the port: an engine given a ``cache_quant`` config serves
    int8pt pages (int8 values, f32 scales), with ``cache_quant`` off in
    its own config, and every request gets its 6 tokens."""
    _, cfg = _cfgs("gemma_2b", backend, cache_quant=True)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    eng = tengine.ServingEngine(params, cfg, device="cpu", slots=2,
                                cache_len=64, prefill_len=32, page_size=8,
                                prefill_chunk=16, async_steps=False)
    for rid in range(2):
        eng.submit(tengine.Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, 20, dtype=np.int32), max_tokens=6))
    out = eng.run()
    assert eng.cfg.kv_cache_format == "int8pt"
    assert eng.cfg.cache_quant is False
    leaf = eng.cache["layers"][0]
    assert leaf["k_pages"].dtype == torch.int8 and "k_scale" in leaf
    assert all(len(v) == 6 for v in out.values())
