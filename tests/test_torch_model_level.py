"""The model-level path of the port against the JAX package, on the CPU:
``forward`` (the training forward), ``prefill`` (which builds contiguous
decode caches: flat for global layers, rings for local ones, RG-LRU rows)
and ``decode`` over those caches, for every ported architecture at its
``reduced()`` size in fp32, on JAX's own parameters carried across by
``repro_torch.convert.params_from_jax`` (biases drawn non-zero and norm
parameters away from one and zero).  The JAX side runs its pallas backend
in interpret mode; the port runs its plain versions.  The counterpart of
``tests/test_decode_consistency.py``, with the port held to JAX's
numbers instead of to its own forward."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import model as jax_model

from torch_lazy import LazyModule, torch
from torch_parity import MODEL_TOL, n, torch_model
from test_torch_starcoder2 import _perturb

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")

ARCHS = ["gemma_2b", "recurrentgemma_9b", "gemma2_27b", "qwen15_4b",
         "starcoder2_7b", "musicgen_medium"]
B, S, EXTRA = 2, 24, 3


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               gemm_backend="pallas", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=2):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    _perturb(tree, np.random.default_rng(seed + 1))
    return (jax.tree.map(jnp.asarray, tree),
            tconvert.params_from_jax(tree, tcfg, device="cpu"))


def _inputs(cfg, total, seed=5):
    """Tokens (B, total), or frame embeddings (B, total, d_model) under
    the frontend stub, from a numpy seed."""
    rng = np.random.default_rng(seed)
    if cfg.frontend_stub:
        return (0.5 * rng.standard_normal((B, total, cfg.d_model))).astype(
            np.float32)
    return rng.integers(0, cfg.vocab, (B, total)).astype(np.int32)


def _batch(cfg, data, lo, hi, lib, **extra):
    key = "embeddings" if cfg.frontend_stub else "tokens"
    arr = jnp.asarray if lib == "jax" else torch.as_tensor
    return {key: arr(data[:, lo:hi]),
            **{k: arr(v) for k, v in extra.items()}}


def _jax_layers(cache, cfg):
    """JAX's scanned cache tree as the port's per-layer list: layer
    g * period + j is ``groups[j]`` at index g, then the tail."""
    layers = []
    groups = cache.get("groups")
    if groups is not None:
        n_groups = cfg.n_layers // cfg.period
        for g in range(n_groups):
            for j in range(cfg.period):
                layers.append({k: np.asarray(v[g])
                               for k, v in groups[j].items()})
    layers += [{k: np.asarray(v) for k, v in c.items()}
               for c in cache.get("tail", [])]
    return layers


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    jcfg, _ = _cfgs(arch)
    fwd = jax.jit(lambda p, b: jax_model.forward(p, b, jcfg)[0])
    pre = jax.jit(lambda p, b: jax_model.prefill(p, b, jcfg,
                                                 cache_len=S + EXTRA + 4))
    dec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, jcfg))
    return fwd, pre, dec


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """Two sequences of 27 positions: ``forward`` over all of them,
    ``prefill`` over the first 24 into caches of 31 slots (the local
    layers' 16-slot rings already wrapped), the caches leaf for leaf,
    then three ``decode`` steps at a scalar position: every logit within
    ``MODEL_TOL["fp32"]`` of JAX's, and the port's own prefill and decode
    logits within it of its forward's."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    jfwd, jpre, jdec = _jitted(arch)
    tol = MODEL_TOL["fp32"]
    total = S + EXTRA
    data = _inputs(jcfg, total)

    want = jfwd(jp, _batch(jcfg, data, 0, total, "jax"))
    got, aux = torch_model.forward(tp, _batch(tcfg, data, 0, total, "torch"),
                                   tcfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert got.shape == (B, total, tcfg.vocab)
    np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol,
                               err_msg="forward")

    jl, jcache = jpre(jp, _batch(jcfg, data, 0, S, "jax"))
    tl, tcache = torch_model.prefill(tp, _batch(tcfg, data, 0, S, "torch"),
                                     tcfg, cache_len=total + 4)
    np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                               err_msg="prefill")
    np.testing.assert_allclose(n(tl), n(got[:, S - 1]), rtol=tol, atol=tol)
    want_layers = _jax_layers(jcache, jcfg)
    assert len(tcache["layers"]) == len(want_layers) == tcfg.n_layers
    for i, (mine, theirs) in enumerate(zip(tcache["layers"], want_layers)):
        assert set(mine) == set(theirs), i
        for name, leaf in mine.items():
            assert tuple(leaf.shape) == theirs[name].shape, (i, name)
            np.testing.assert_allclose(n(leaf), n(theirs[name]), rtol=tol,
                                       atol=tol, err_msg=f"{i} {name}")

    for i in range(EXTRA):
        pos = np.int32(S + i)
        jl, jcache = jdec(jp, _batch(jcfg, data, S + i, S + i + 1, "jax",
                                     pos=pos), jcache)
        tl, tcache = torch_model.decode(
            tp, _batch(tcfg, data, S + i, S + i + 1, "torch", pos=pos),
            tcache, tcfg)
        np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        np.testing.assert_allclose(n(tl), n(got[:, S + i]), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("arch", ["gemma_2b", "musicgen_medium"])
def test_vectorized_positions_match_scalar(arch):
    """A decode step at a scalar position and at a (B,) vector of it over
    copies of one prefilled cache: the same logits and caches, bit for
    bit (``tests/test_decode_consistency.py:48-62``)."""
    _, tcfg = _cfgs(arch)
    params = torch_model.init_params(tcfg, seed=3, device="cpu")
    data = _inputs(tcfg, S + 1, seed=3)
    _, cache1 = torch_model.prefill(params, _batch(tcfg, data, 0, S,
                                                   "torch"), tcfg,
                                    cache_len=S + 4)
    cache2 = {"layers": [{k: v.clone() for k, v in layer.items()}
                         for layer in cache1["layers"]]}
    d1, cache1 = torch_model.decode(
        params, _batch(tcfg, data, S, S + 1, "torch", pos=np.int32(S)),
        cache1, tcfg)
    d2, cache2 = torch_model.decode(
        params, _batch(tcfg, data, S, S + 1, "torch",
                       pos=np.full(B, S, np.int32)), cache2, tcfg)
    assert torch.equal(d1, d2)
    for a, b in zip(cache1["layers"], cache2["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("arch", ["starcoder2_7b", "gemma2_27b"])
def test_prefill_ring_equals_the_serving_ring(arch):
    """A 24-token prompt past the 16-slot window: the ring ``prefill``
    builds for each local layer (the last 16 positions at their slots,
    position mod 16) holds what ``prefill_chunk`` leaves in the serving
    cache's ring for the same prompt, and a decode step over each gives
    the same logits, within ``MODEL_TOL["fp32"]`` (B5 over the whole
    prompt there, the plain ring-chunk attention here)."""
    jcfg, tcfg = _cfgs(arch)
    _, params = _params(jcfg, tcfg)
    tokens = torch.as_tensor(_inputs(tcfg, S + 1, seed=8)[:1])
    tol = MODEL_TOL["fp32"]
    _, flat = torch_model.prefill(params, {"tokens": tokens[:, :S]}, tcfg,
                                  cache_len=64)
    paged = torch_model.init_paged_cache(tcfg, 1, 64, num_pages=9,
                                         page_size=8, device="cpu")
    table = torch.arange(1, 9, dtype=torch.int32)[None]
    _, paged = torch_model.prefill_chunk(
        params, {"tokens": tokens[:, :S], "page_table": table}, paged,
        tcfg, pos0=0)
    kinds = [mixer for mixer, _ in tcfg.layer_kinds]
    assert "local" in kinds
    for kind, mine, served in zip(kinds, flat["layers"], paged["layers"]):
        if kind != "local":
            assert mine["k"].shape == (1, 64, tcfg.n_kv_heads, tcfg.hd)
            continue
        assert mine["k"].shape == served["k"].shape == (
            1, tcfg.window, tcfg.n_kv_heads, tcfg.hd)
        for name in ("k", "v"):
            np.testing.assert_allclose(n(mine[name]), n(served[name]),
                                       rtol=tol, atol=tol, err_msg=name)
    step = {"tokens": tokens[:, S:], "pos": torch.tensor([S])}
    got, _ = torch_model.decode(params, step, flat, tcfg)
    want, _ = torch_model.decode(params, {**step, "page_table": table},
                                 paged, tcfg)
    np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol)
