"""chameleon_34b through the port against the JAX package, on the CPU: the
config field for field, ``params_from_jax`` with the untied LM head and
QK-norm's ``q_norm``/``k_norm``, the model-level ``forward``, ``prefill``
and ``decode`` over frame embeddings (the VQ tokenizer is a stub in both
packages), the serving engine's refusal of the stub, and the full-width
plans of its model-level path.  JAX runs its pallas backend in interpret
mode, the port its plain versions, on JAX's parameters (norm scales
drawn away from one, so QK-norm's scales show).

Tolerances (rtol = atol): 1e-5 in fp32 for the logits of every call;
5e-2 under the bf16 compute dtype (``MODEL_TOL["bf16acc"]``, the bf16
tolerance of recurrentgemma's model test).  In bf16 each package rounds
every GEMM's output, the norms' outputs (QK-norm's too) and the
attention's inputs to bf16, on kernels that sum in different orders, so
a bf16 rounding (2^-8 relative) can fall the other way on either side;
through two layers and the untied head the logits, up to |x| ≈ 5 here,
then differ by 0.029-0.035 x (1 + |ref|) (three seeds), past the 2e-2 of
``MODEL_TOL["bf16"]``."""
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
tautotune = LazyModule("repro_torch.core.autotune")
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tengine = LazyModule("repro_torch.serving.engine")
tgeometry = LazyModule("repro_torch.core.geometry")
tschedule = LazyModule("repro_torch.graph.schedule")

ARCH = "chameleon_34b"
TOL = {"fp32": 1e-5, "bf16": MODEL_TOL["bf16acc"]}
B, S, EXTRA = 2, 20, 3


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               gemm_backend="pallas", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=2):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    _perturb(tree, np.random.default_rng(seed + 1))
    return (jax.tree.map(jnp.asarray, tree), tree,
            tconvert.params_from_jax(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    """Every field equal, full width and ``reduced()``, but the kernel
    backend's name; the published widths (48 layers, d_model 8192, 64
    heads on 8 kv heads of 128, d_ff 22016, vocab 65536), SwiGLU,
    RMSNorm, QK-norm, an untied head and the frontend stub; JAX's
    ``n_params``, 34.29 B (68.6 GB in bf16)."""
    j, tc = jget_config(ARCH), tconfigs.get_config(ARCH)
    assert ARCH in tconfigs.PORTED_ARCHS
    assert (tc.n_layers, tc.d_model, tc.n_heads, tc.n_kv_heads, tc.hd,
            tc.d_ff, tc.vocab) == (48, 8192, 64, 8, 128, 22016, 65536)
    assert (tc.norm_type, tc.mlp_type, tc.qk_norm, tc.tied_embeddings,
            tc.frontend_stub, tc.qkv_bias) == (
        "rmsnorm", "swiglu", True, False, True, False)
    assert set(tc.layer_kinds) == {("attn", "mlp")}
    assert tc.n_params() == j.n_params() == 34292637696
    if reduced:
        j, tc = j.reduced(), tc.reduced()
        assert (tc.n_layers, tc.n_heads, tc.n_kv_heads, tc.hd) == (
            2, 4, 1, 32)
    names = {f.name for f in dataclasses.fields(j)}
    assert names == {f.name for f in dataclasses.fields(tc)}
    assert {k for k in names if getattr(j, k) != getattr(tc, k)} == {
        "gemm_backend"}


def test_params_from_jax_carry_head_and_qk_norm():
    """The untied head (d_model, vocab) and every layer's ``q_norm`` and
    ``k_norm`` scales come across as JAX holds them; the port's
    ``init_params`` makes a tree of the same leaves and shapes, and the
    same ``param_count``."""
    jcfg, tcfg = _cfgs()
    _, tree, tp = _params(jcfg, tcfg)
    mine = torch_model.init_params(tcfg, seed=0, device="cpu")
    count = sum(int(np.size(a)) for a in jax.tree.leaves(tree))
    assert torch_model.param_count(tp) == torch_model.param_count(
        mine) == count
    assert set(tp["embedding"]) == set(mine["embedding"]) == {"table",
                                                               "head"}
    assert tp["embedding"]["head"].shape == (tcfg.d_model, tcfg.vocab)
    np.testing.assert_array_equal(n(tp["embedding"]["head"]),
                                  tree["embedding"]["head"])
    for i, (a, b) in enumerate(zip(tp["layers"], mine["layers"])):
        assert set(a) == set(b) == {"norm1", "mixer", "norm2", "ffn"}
        assert jax.tree.map(lambda x: tuple(x.shape), a) == \
            jax.tree.map(lambda x: tuple(x.shape), b)
        for name in ("q_norm", "k_norm"):
            assert a["mixer"][name]["scale"].shape == (tcfg.hd,)
            np.testing.assert_array_equal(
                n(a["mixer"][name]["scale"]),
                tree["groups"][0]["mixer"][name]["scale"][i])


_FMT = {"fp32": {}, "bf16": dict(compute_dtype="bfloat16")}


@functools.lru_cache(maxsize=None)
def _jitted(fmt):
    jcfg, _ = _cfgs(**_FMT[fmt])
    fwd = jax.jit(lambda p, b: jax_model.forward(p, b, jcfg)[0])
    pre = jax.jit(lambda p, b: jax_model.prefill(p, b, jcfg,
                                                 cache_len=S + EXTRA + 1))
    dec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, jcfg))
    return fwd, pre, dec


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
def test_forward_prefill_decode_match_jax(fmt):
    """Two sequences of 23 frame embeddings: ``forward`` over all of them,
    ``prefill`` over the first 20 into flat caches of 24 slots (the
    caches leaf for leaf), then three ``decode`` steps: every logit within
    ``TOL[fmt]`` of JAX's."""
    jcfg, tcfg = _cfgs(**_FMT[fmt])
    jp, _, tp = _params(jcfg, tcfg)
    jfwd, jpre, jdec = _jitted(fmt)
    tol = TOL[fmt]
    total = S + EXTRA
    emb = (0.5 * np.random.default_rng(5).standard_normal(
        (B, total, tcfg.d_model))).astype(np.float32)

    def close(got, want, what):
        np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol,
                                   err_msg=what)

    want = jfwd(jp, {"embeddings": jnp.asarray(emb)})
    with torch.no_grad():
        got, _ = torch_model.forward(
            tp, {"embeddings": torch.as_tensor(emb)}, tcfg)
        assert got.dtype == torch.float32
        assert got.shape == (B, total, tcfg.vocab)
        close(got, want, "forward")
        jl, jcache = jpre(jp, {"embeddings": jnp.asarray(emb[:, :S])})
        tl, tcache = torch_model.prefill(
            tp, {"embeddings": torch.as_tensor(emb[:, :S])}, tcfg,
            cache_len=total + 1)
        close(tl, jl, "prefill")
        jlayers = jcache["groups"][0]
        for i, layer in enumerate(tcache["layers"]):
            for name in ("k", "v"):
                close(layer[name], np.asarray(jlayers[name][i]),
                      f"cache {i} {name}")
        for i in range(EXTRA):
            pos = np.int32(S + i)
            step = emb[:, S + i:S + i + 1]
            jl, jcache = jdec(jp, {"embeddings": jnp.asarray(step),
                                   "pos": jnp.asarray(pos)}, jcache)
            tl, tcache = torch_model.decode(
                tp, {"embeddings": torch.as_tensor(step), "pos": int(pos)},
                tcache, tcfg)
            close(tl, jl, f"decode step {i}")


def test_engine_refuses_the_frontend_stub():
    """The serving engine builds token batches only (as the JAX engine
    does), so chameleon runs on the model-level path."""
    tcfg = tconfigs.get_config(ARCH).reduced()
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="frontend_stub"):
        tengine.ServingEngine(params, tcfg, device="cpu", slots=2,
                              cache_len=64, prefill_len=32, page_size=8)


def test_full_width_plans():
    """chameleon_34b at 4 sequences (bf16): the decode step's q
    (8192 x 8192), k and v (1024 x 8192), o, gate (+ silu), up
    (22016 x 8192) and down (8192 x 22016) plan split onto B2's cluster
    engine, the prefill's (M = 4096) and the forward's (M = 4352) onto
    B1's wgmma engine; the q/k/v and MLP programs at those rows are
    ungrouped GemmNodes, none on B3 (so a forward and a prefill launch B1
    7 x 48 times, a decode step B2 7 x 48 times); B6's flat-cache decode
    at G = 8, D = 128 on its mma engine, 8 KV slices per row over 1088
    slots; B5 at D = 128 on its wgmma engine."""
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.graph.trace import GraphBuilder

    tautotune.reset_cache()
    tschedule.reset_programs()
    d, f, kv, bf16 = 8192, 22016, 1024, torch.bfloat16
    cfg = tconfigs.get_config(ARCH)
    assert not cfg.decode_qkv_grouped
    assert (cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd) == (d, kv)
    shapes = ((d, d, "none"), (kv, d, "none"), (f, d, "silu"),
              (f, d, "none"), (d, f, "none"))
    for n_out, k_in, act in shapes:
        epi = Epilogue(activation=act)
        plan = tautotune.get_plan(4, n_out, k_in, bf16, bf16, epilogue=epi,
                                  fmt="bf16")
        assert plan.route == "splitk", (n_out, k_in)
        assert tautotune.plan_engine(plan.signature,
                                     plan.geometry) == "cluster"
        for m in (4096, 4352):
            plan = tautotune.get_plan(m, n_out, k_in, bf16, bf16,
                                      epilogue=epi, fmt="bf16")
            assert tautotune.plan_engine(plan.signature,
                                         plan.geometry) == "wgmma"
    for m, engine in ((4, "cluster"), (4096, "wgmma"), (4352, "wgmma")):
        b = GraphBuilder()
        xv = b.input((m, d), bf16, "x")
        outs = [b.gemm(xv, b.input((d, width), bf16, f"w_{name}"),
                       epilogue=Epilogue(), fmt="bf16", out_dtype=bf16,
                       policy="mte", name=name)
                for name, width in (("q", d), ("k", kv), ("v", kv))]
        b.output(*outs)
        qkv = tschedule.compile_graph(b.build())
        b = GraphBuilder()
        xv = b.input((m, d), bf16, "x")
        gate = b.gemm(xv, b.input((d, f), bf16, "w_gate"),
                      epilogue=Epilogue(activation="silu"), fmt="bf16",
                      out_dtype=bf16, policy="mte", name="gate")
        up = b.gemm(xv, b.input((d, f), bf16, "w_up"), fmt="bf16",
                    out_dtype=bf16, policy="mte", name="up")
        b.output(b.gemm(b.mul(gate, up), b.input((f, d), bf16, "w_down"),
                        fmt="bf16", out_dtype=bf16, policy="mte",
                        name="down"))
        mlp = tschedule.compile_graph(b.build())
        for prog in (qkv, mlp):
            assert not prog.grouped, m
            assert {tautotune.plan_engine(p.signature, p.geometry)
                    for p in prog.plans.values()} == {engine}
            assert len(prog.plans) == 3
    assert tgeometry.flat_decode_engine(bf16, bf16, 8, 128, True) == "mma"
    assert tgeometry.decode_kv_split(4 * 8, 1088 // 16) == 8
    assert tgeometry.attention_engine(bf16, 128) == "wgmma"
