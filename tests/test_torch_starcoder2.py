"""starcoder2_7b.reduced() through the port against the JAX package, on
the CPU: LayerNorm with a bias, the plain (non-gated) GELU MLP with
biases, every layer sliding-window (16-slot rings), GQA 4:1, QKV biases
and an untied LM head.  Biases are drawn non-zero and the LayerNorm
parameters away from one and zero, and carried across by
``repro_torch.convert.params_from_jax``.  The JAX side runs its pallas
backend in interpret mode; the port runs its plain versions.  Compared:
the config field for field; ``layernorm`` in f32 and bf16; the plain MLP,
eager and compiled; ``prefill_chunk``, ``decode`` and ``verify_chunk``
logits within fp32's ``TOL`` across the ring's wrap; the serving engine's
greedy streams; speculation with the weight-shared one-layer draft equal
to ``spec_k=0``, whose verify rows equal decode rows bit for bit; and the
full-width plans: decode o, up and down on B2's cluster engine, the
decode q/k/v group on B3's split-K engine, the ring decode at G = 9 on
B6's mma engine, and the prefill chunk's q/k/v program off B3."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule, torch
from torch_parity import TOL, n, t, torch_model
from test_torch_serving import _COUNTERS, _jax_engine

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tengine = LazyModule("repro_torch.serving.engine")
tgeometry = LazyModule("repro_torch.core.geometry")
tlayers = LazyModule("repro_torch.models.layers")
tschedule = LazyModule("repro_torch.graph.schedule")

ARCH = "starcoder2_7b"
PAGE, SLOTS, CACHE_LEN, PROMPT = 8, 2, 64, 24
MAXP = CACHE_LEN // PAGE


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               gemm_backend="pallas", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw)
    return jcfg, tcfg


def _perturb(tree, rng):
    """Every bias (``b`` of a projection, ``bias`` of a norm) drawn from
    0.5 x N(0, 1), every norm scale from 1 + 0.3 x N(0, 1), in place."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _perturb(leaf, rng)
        elif key in ("b", "bias"):
            tree[key] = (0.5 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)
        elif key == "scale":
            tree[key] = (1 + 0.3 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)


def _params(jcfg, tcfg, seed=0):
    """JAX ``init_params`` with biases and norms perturbed (``_perturb``),
    and the port's conversion of the same tree."""
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    _perturb(tree, np.random.default_rng(seed + 1))
    return (jax.tree.map(jnp.asarray, tree),
            tconvert.params_from_jax(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    """Every field equal, full width and ``reduced()`` (2 layers, 4 heads
    on 1 kv head, window 16), but the kernel backend's name; the published
    widths (32 layers, d_model 4608, 36 heads on 4 kv heads of 128, d_ff
    18432, vocab 49152, window 4096), LayerNorm, the plain GELU MLP with
    biases, QKV biases, an untied head, rope θ 1e6."""
    j, tc = jget_config(ARCH), tconfigs.get_config(ARCH)
    assert ARCH in tconfigs.PORTED_ARCHS
    assert (tc.n_layers, tc.d_model, tc.n_heads, tc.n_kv_heads, tc.hd,
            tc.d_ff, tc.vocab, tc.window) == (32, 4608, 36, 4, 128, 18432,
                                              49152, 4096)
    assert (tc.norm_type, tc.mlp_type, tc.mlp_bias, tc.qkv_bias,
            tc.tied_embeddings, tc.rope_theta) == ("layernorm", "gelu", True,
                                                   True, False, 1e6)
    assert set(tc.layer_kinds) == {("local", "mlp")}
    if reduced:
        j, tc = j.reduced(), tc.reduced()
        assert (tc.n_layers, tc.n_heads, tc.n_kv_heads, tc.window) == (
            2, 4, 1, 16)
    names = {f.name for f in dataclasses.fields(j)}
    assert names == {f.name for f in dataclasses.fields(tc)}
    assert {k for k in names if getattr(j, k) != getattr(tc, k)} == {
        "gemm_backend"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """``layernorm`` against JAX's on rows of offset, scaled inputs, with a
    perturbed scale and bias: within 1e-6 in f32; in bf16 (f32 inside,
    the result cast back) within one bf16 step of the value.  A row's bits
    do not depend on the rows beside it."""
    rng = np.random.default_rng(3)
    x = (3.0 + 2.0 * rng.standard_normal((5, 7, 96))).astype(np.float32)
    p = {"scale": (1 + 0.3 * rng.standard_normal(96)).astype(np.float32),
         "bias": (0.5 * rng.standard_normal(96)).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    want = jax_layers.layernorm(jnp.asarray(x).astype(jdt),
                                {k: jnp.asarray(v) for k, v in p.items()})
    xt = t(jnp.asarray(x).astype(jdt))
    got = tlayers.layernorm(xt, {k: torch.as_tensor(v)
                                 for k, v in p.items()})
    assert got.dtype == xt.dtype
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol)
    assert torch.equal(tlayers.layernorm(xt[2:3, 4:5], {
        k: torch.as_tensor(v) for k, v in p.items()})[0, 0], got[2, 4])
    assert torch.equal(tlayers.norm(xt, {k: torch.as_tensor(v)
                                         for k, v in p.items()},
                                    "layernorm"), got)
    assert set(tlayers.init_norm(96, "layernorm")) == {"scale", "bias"}
    assert set(tlayers.init_norm(96, "rmsnorm")) == {"scale"}


@pytest.mark.parametrize("use_graph", [False, True])
def test_plain_mlp_matches_jax(use_graph):
    """The plain MLP (``up`` with bias and the fused tanh-GELU, ``down``
    with bias), eager and as one compiled program of two GemmNodes,
    against JAX's ``mlp`` within fp32's ``TOL``; the compiled program
    carries no gate and launches no grouped GEMM."""
    jcfg, tcfg = _cfgs(use_graph=use_graph)
    jp, tp = _params(jcfg, tcfg)
    jffn = jax.tree.map(lambda a: a[0], jp["groups"][0]["ffn"])
    tffn = tp["layers"][0]["ffn"]
    assert set(tffn) == {"up", "down"}
    assert set(tffn["up"]) == {"w", "b"}
    x = np.random.default_rng(4).standard_normal((3, 5, 128)).astype(
        np.float32)
    want = jax.jit(lambda a, q: jax_layers.mlp(a, q, jcfg))(
        jnp.asarray(x), jffn)
    tschedule.reset_programs()
    got = tlayers.mlp(torch.as_tensor(x), tffn, tcfg)
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])
    progs = tschedule.compiled_programs()
    if use_graph:
        assert len(progs) == 1 and not progs[0].grouped
        assert len(progs[0].plans) == 2
    else:
        assert not progs


def test_params_carry_norm_and_mlp_biases():
    """``params_from_jax`` carries the LayerNorm biases, the MLP biases and
    the untied head; ``init_params`` makes the same tree (no gate); the
    port's ``param_count`` equals the element count of JAX's tree; the
    engine's tree keeps the biases and norms as they were and the stacked
    decode q/k/v of (3, D, D); a weight-shared draft shares them."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    jtree = jax.tree.map(np.asarray, jax.device_get(jp))
    for i, lp in enumerate(tp["layers"]):
        for name in ("norm1", "norm2"):
            np.testing.assert_array_equal(
                n(lp[name]["bias"]), jtree["groups"][0][name]["bias"][i])
        np.testing.assert_array_equal(
            n(lp["ffn"]["up"]["b"]), jtree["groups"][0]["ffn"]["up"]["b"][i])
    np.testing.assert_array_equal(n(tp["final_norm"]["bias"]),
                                  jtree["final_norm"]["bias"])
    mine = torch_model.init_params(tcfg, seed=0, device="cpu")
    assert set(mine["layers"][0]["ffn"]) == {"up", "down"}
    assert set(mine["final_norm"]) == {"scale", "bias"}
    count = sum(int(np.size(a)) for a in jax.tree.leaves(jtree))
    assert torch_model.param_count(tp) == torch_model.param_count(
        mine) == count
    eng = tengine.ServingEngine(tp, tcfg, device="cpu", slots=2,
                                cache_len=64, prefill_len=32, page_size=8)
    served = eng.params
    lp = served["layers"][1]
    assert lp["norm2"]["bias"] is tp["layers"][1]["norm2"]["bias"]
    assert lp["ffn"]["down"]["b"] is tp["layers"][1]["ffn"]["down"]["b"]
    assert lp["mixer"]["qkv"].shape == (3, tcfg.d_model, tcfg.d_model)
    draft = torch_model.draft_from(served, tcfg, groups=1)
    assert draft["final_norm"] is served["final_norm"]
    assert draft["layers"][0] is served["layers"][0]
    assert draft["embedding"]["unembed"] is served["embedding"]["unembed"]


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
    one chunk or two (the second wraps the ring), three greedy decode
    steps with slot 0 idle (``row_valid`` False; the grouped decode q/k/v
    with the biases added after the group), then a 3-token verify window:
    logits of every call within ``TOL["fp32"]``.  Slot 0's rings stay
    zero."""
    jcfg, jchunk, jdec, jverify = _jitted(chunk_len)
    _, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
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
    for layer in tcache["layers"]:
        assert all(torch.count_nonzero(leaf[0]) == 0
                   for leaf in layer.values())


_KW = dict(slots=2, cache_len=64, prefill_len=32, page_size=8)


def _prompts(vocab):
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab, k, dtype=np.int32) for k in (30, 21, 17)]


def _serve(engine, request_cls, prompts, max_tokens=8):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_tokens=max_tokens))
    return engine.run(max_steps=300)


def test_engine_matches_jax_engine():
    """3 requests on 2 slots with prompts longer than the window (the
    rings wrap in prefill and decode), the third prefilling while the
    others decode; the default configuration on both sides (graph
    programs, grouped decode q/k/v): equal greedy streams and counters.
    The rings make the engine pass ``row_valid``; the prefix cache stays
    off."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    prompts = _prompts(jcfg.vocab)
    jeng = _jax_engine(jp, jcfg, async_steps=False, prefill_chunk=16,
                       **_KW)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", prefill_chunk=16,
                                 **_KW)
    assert teng._stateful_rows and not teng._prefix_active
    jout = _serve(jeng, JRequest, prompts)
    tout = _serve(teng, tengine.Request, prompts)
    assert sorted(tout) == sorted(jout) == [0, 1, 2]
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert tout[rid].status == jout[rid].status == "ok"
    jm, tm = jeng.metrics(), teng.metrics()
    assert {k: tm[k] for k in _COUNTERS} == {k: jm[k] for k in _COUNTERS}


def test_speculative_draft1_equals_vanilla():
    """``spec_k=4`` with the weight-shared one-layer draft (its norms,
    biases and head the target's): greedy streams equal to
    ``spec_k=0``'s, some proposals rejected, the pool intact."""
    _, tcfg = _cfgs()
    _, params = _params(*_cfgs())
    prompts = _prompts(tcfg.vocab)
    kw = dict(_KW, prefill_chunk=16)
    spec = tengine.ServingEngine(params, tcfg, device="cpu", spec_k=4,
                                 draft_groups=1, **kw)
    vanilla = tengine.ServingEngine(params, tcfg, device="cpu", **kw)
    assert spec.draft_params["final_norm"] is spec.params["final_norm"]
    sout = _serve(spec, tengine.Request, prompts, max_tokens=10)
    vout = _serve(vanilla, tengine.Request, prompts, max_tokens=10)
    assert sorted(sout) == sorted(vout) == [0, 1, 2]
    for rid in vout:
        assert list(sout[rid]) == list(vout[rid]), rid
        assert sout[rid].status == "ok"
    m = spec.metrics()
    assert m["spec_steps"] > 0 and 0.0 < m["acceptance_rate"] < 1.0
    spec.sched.pool.audit()


def test_verify_rows_equal_decode_steps():
    """The served configuration (graph programs, grouped decode q/k/v),
    three slots past the ring's wrap: a 4-token window's logits row i
    equals a decode step's at pos + i bit for bit, and the rings after it
    the rings after the four steps -- LayerNorm, the MLP and every
    projection give a row the same bits whatever rows ride with it."""
    slots, k = 3, 4
    _, cfg = _cfgs(decode_qkv_grouped=True)
    _, params = _params(*_cfgs())
    cache = torch_model.init_paged_cache(cfg, slots, CACHE_LEN,
                                         num_pages=slots * MAXP + 1,
                                         page_size=PAGE, device="cpu")
    table = torch.as_tensor((1 + np.arange(slots * MAXP, dtype=np.int32))
                            .reshape(slots, MAXP))
    rng = np.random.default_rng(k)
    for s in range(slots):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 20)))
        torch_model.prefill_chunk(params, {"tokens": toks,
                                           "page_table": table[s:s + 1],
                                           "slot": s}, cache, cfg, pos0=0)
    window = torch.as_tensor(rng.integers(0, cfg.vocab, (slots, k)))
    pos = torch.tensor([20, 20, 20])
    start = {"layers": [{name: leaf.clone() for name, leaf in layer.items()}
                        for layer in cache["layers"]]}
    steps = []
    for i in range(k):
        logits, cache = torch_model.decode(
            params, {"tokens": window[:, i:i + 1], "pos": pos + i,
                     "page_table": table}, cache, cfg)
        steps.append(logits)
    logits, after = torch_model.verify_chunk(
        params, {"tokens": window, "pos": pos, "page_table": table},
        start, cfg)
    for i in range(k):
        assert torch.equal(logits[:, i], steps[i]), i
    for a, b in zip(after["layers"], cache["layers"]):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_full_width_plans():
    """starcoder2_7b at 4 slots (bf16): the decode o, up (bias + gelu) and
    down (bias) plan split and run on B2's cluster engine (window chunks:
    16 rows for o, 14 for up and down, whose K slices hold 4608 rows);
    the decode q/k/v group (3 x 4 x 4608, k/v 512 wide) on B3's split-K
    engine; the ring decode at G = 9, D = 128 on B6's mma engine; the
    prefill chunk's (M = 512) q/k/v program ungrouped (k and v would pay
    9x padding: off B3's tile loop) and its MLP on B1's wgmma engine."""
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.graph.trace import GraphBuilder

    tautotune.reset_cache()
    tschedule.reset_programs()
    d, f, kv, bf16 = 4608, 18432, 512, torch.bfloat16
    for n_out, k_in, act, bias, rows in ((d, d, "none", False, 16),
                                         (f, d, "gelu", True, 14),
                                         (d, f, "none", True, 14)):
        epi = Epilogue(has_bias=bias, activation=act)
        plan = tautotune.get_plan(4, n_out, k_in, bf16, bf16, epilogue=epi,
                                  fmt="bf16")
        assert plan.route == "splitk", (n_out, k_in)
        assert tautotune.plan_engine(plan.signature,
                                     plan.geometry) == "cluster"
        depth = tgeometry.splitk_cluster_split(n_out // 128, k_in, 4)[1]
        assert tgeometry.window_rows("cluster", 4, depth) == rows
        plan = tautotune.get_plan(512, n_out, k_in, bf16, bf16,
                                  epilogue=epi, fmt="bf16")
        assert tautotune.plan_engine(plan.signature,
                                     plan.geometry) == "wgmma"
    plan = tautotune.get_plan(4, d, d, bf16, bf16, group=3, fmt="bf16")
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "splitk"
    assert tgeometry.flat_decode_engine(bf16, bf16, 36 // 4, 128,
                                        True) == "mma"
    b = GraphBuilder()
    xv = b.input((512, d), bf16, "x")
    outs = [b.gemm(xv, b.input((d, w), bf16, f"w_{name}"),
                   bias=b.input((w,), "float32", f"b_{name}"),
                   epilogue=Epilogue(has_bias=True), fmt="bf16",
                   out_dtype=bf16, policy="mte", name=name)
            for name, w in (("q", d), ("k", kv), ("v", kv))]
    b.output(*outs)
    prog = tschedule.compile_graph(b.build())
    assert not prog.grouped
    assert {tautotune.plan_engine(p.signature, p.geometry)
            for p in prog.plans.values()} == {"wgmma"}
