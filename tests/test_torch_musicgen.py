"""musicgen_medium through the port against the JAX package, on the CPU:
the config field for field, the parameter tree and its count, the stubbed
frontend (precomputed frame embeddings in place of tokens), the serving
engine's refusal (the engine serves token batches only, as JAX's does),
and the full-width plans of its model-level path: the decode step's
q/k/v, o, up and down on B2's cluster engine, its flat-cache decode at
G = 1, D = 64 on B6's mma engine, the prefill's attention at D = 64 on
B5's wgmma engine and its q/k/v program off B3's tile loop.  Its logits
are held to JAX's in ``tests/test_torch_model_level.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import model as jax_model

from torch_lazy import LazyModule, torch
from torch_parity import n, torch_model

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tengine = LazyModule("repro_torch.serving.engine")
tgeometry = LazyModule("repro_torch.core.geometry")
tschedule = LazyModule("repro_torch.graph.schedule")

ARCH = "musicgen_medium"


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    """Every field equal, full width and ``reduced()``, but the kernel
    backend's name; the published widths (48 layers, d_model 1536, 24
    heads on 24 kv heads of 64, d_ff 6144, vocab 2048), every layer
    global, LayerNorm, the plain GELU MLP with biases, QKV biases, an
    untied head and the frontend stub; ~1.365 B parameters."""
    j, tc = jget_config(ARCH), tconfigs.get_config(ARCH)
    assert ARCH in tconfigs.PORTED_ARCHS
    assert (tc.n_layers, tc.d_model, tc.n_heads, tc.n_kv_heads, tc.hd,
            tc.d_ff, tc.vocab) == (48, 1536, 24, 24, 64, 6144, 2048)
    assert (tc.norm_type, tc.mlp_type, tc.mlp_bias, tc.qkv_bias,
            tc.tied_embeddings, tc.frontend_stub, tc.embed_scale) == (
        "layernorm", "gelu", True, True, False, True, False)
    assert set(tc.layer_kinds) == {("attn", "mlp")}
    assert tc.n_params() == j.n_params() == 1365247488
    if reduced:
        j, tc = j.reduced(), tc.reduced()
        assert (tc.n_layers, tc.n_heads, tc.n_kv_heads, tc.hd) == (
            2, 4, 4, 32)
    names = {f.name for f in dataclasses.fields(j)}
    assert names == {f.name for f in dataclasses.fields(tc)}
    assert {k for k in names if getattr(j, k) != getattr(tc, k)} == {
        "gemm_backend"}


def test_params_and_count_match_jax():
    """``params_from_jax`` carries JAX's tree as it is (the embedding
    table too, which the stub never reads), with no special case; the
    port's ``init_params`` makes a tree of the same leaves and shapes;
    both ``param_count``s equal the element count of JAX's tree."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               gemm_backend="pallas")
    tcfg = tconfigs.get_config(ARCH).reduced()
    jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    tp = tconvert.params_from_jax(tree, tcfg, device="cpu")
    mine = torch_model.init_params(tcfg, seed=0, device="cpu")
    count = sum(int(np.size(a)) for a in jax.tree.leaves(tree))
    assert torch_model.param_count(tp) == torch_model.param_count(
        mine) == count
    assert set(tp["embedding"]) == set(mine["embedding"]) == {"table",
                                                               "head"}
    np.testing.assert_array_equal(n(tp["embedding"]["head"]),
                                  tree["embedding"]["head"])
    for a, b in zip(tp["layers"], mine["layers"]):
        for part in ("norm1", "mixer", "norm2", "ffn"):
            assert jax.tree.map(lambda x: tuple(x.shape), a[part]) == \
                jax.tree.map(lambda x: tuple(x.shape), b[part])
    np.testing.assert_array_equal(
        n(tp["layers"][1]["mixer"]["v"]["b"]),
        tree["groups"][0]["mixer"]["v"]["b"][1])


@pytest.mark.parametrize("embed_scale", [False, True])
def test_inputs_to_x_matches_jax(embed_scale):
    """Under the stub the stack's input is ``batch["embeddings"]`` cast to
    the compute dtype (bf16 here) and, with ``embed_scale``, times
    √d_model rounded to it: equal to JAX's ``_inputs_to_x`` bit for bit;
    tokens are not read."""
    kw = dict(compute_dtype="bfloat16", embed_scale=embed_scale)
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw)
    emb = np.random.default_rng(1).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32)
    want, _, _ = jax_model._inputs_to_x({"embeddings": jnp.asarray(emb)},
                                        None, jcfg)
    got = torch_model._inputs_to_x({"embeddings": torch.as_tensor(emb)},
                                   None, tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5, tcfg.d_model)
    np.testing.assert_array_equal(n(got), n(want))


def test_engine_refuses_the_frontend_stub():
    """The serving engine builds token batches only (as the JAX engine
    does), so it refuses a config with a stubbed frontend, naming why."""
    tcfg = tconfigs.get_config(ARCH).reduced()
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="frontend_stub"):
        tengine.ServingEngine(params, tcfg, device="cpu", slots=2,
                              cache_len=64, prefill_len=32, page_size=8)


def test_full_width_plans():
    """musicgen_medium at 4 sequences (bf16): the decode step's q, k, v
    (+ bias), o, up (+ bias + gelu) and down (+ bias) plan split onto B2's
    cluster engine, the prefill's (M = 4096) and the forward's (M = 4352)
    onto B1's wgmma engine; the decode step's q/k/v program (the
    model-level decode is ungrouped, ``decode_qkv_grouped`` False) and
    the prefill's and the forward's are three ungrouped GemmNodes, none on
    B3's tile loop; B6's flat-cache decode at G = 1, D = 64 on its mma
    engine, 2 KV slices per row over 2048 slots; B5 at D = 64 on its
    wgmma engine."""
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.graph.trace import GraphBuilder

    tautotune.reset_cache()
    tschedule.reset_programs()
    d, f, bf16 = 1536, 6144, torch.bfloat16
    assert not tconfigs.get_config(ARCH).decode_qkv_grouped
    for n_out, k_in, act, bias in ((d, d, "none", True),
                                   (d, d, "none", False),
                                   (f, d, "gelu", True),
                                   (d, f, "none", True)):
        epi = Epilogue(has_bias=bias, activation=act)
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
        outs = [b.gemm(xv, b.input((d, d), bf16, f"w_{name}"),
                       bias=b.input((d,), "float32", f"b_{name}"),
                       epilogue=Epilogue(has_bias=True), fmt="bf16",
                       out_dtype=bf16, policy="mte", name=name)
                for name in ("q", "k", "v")]
        b.output(*outs)
        prog = tschedule.compile_graph(b.build())
        assert not prog.grouped, m
        assert {tautotune.plan_engine(p.signature, p.geometry)
                for p in prog.plans.values()} == {engine}
    assert tgeometry.flat_decode_engine(bf16, bf16, 1, 64, True) == "mma"
    assert tgeometry.decode_kv_split(4 * 24, 2048 // 16) == 2
    assert tgeometry.attention_engine(bf16, 64) == "wgmma"
