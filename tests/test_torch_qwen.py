"""qwen15_4b.reduced() through the port against the JAX package, on the
CPU: MHA (4 query on 4 kv heads), QKV biases (drawn non-zero here, so the
bias is exercised) and an untied LM head, carried across by
``repro_torch.convert.params_from_jax``.  The JAX side runs its pallas
backend in interpret mode; the port runs its plain versions.  Compared:
the config field for field; the parameter tree with the head;
``prefill_chunk``, ``decode`` (the grouped decode q/k/v, bias added after
the group) and ``verify_chunk`` logits within fp32's ``TOL`` (1e-5), and
under the published ``bf16acc`` format with a bf16 compute dtype within
the bf16acc model tolerance (5e-2); the serving engine's greedy streams
with a shared prefix against the JAX engine's; speculation with the
weight-shared one-layer draft equal to ``spec_k=0``, in fp32 and under
bf16acc, whose verify rows equal decode rows bit for bit; and the
full-width plans: decode GEMMs on B2's and B3's cluster split-K engines
under bf16acc, prefill projections on B1's wgmma engine."""
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
from torch_parity import MODEL_TOL, TOL, n, torch_model
from test_torch_serving import _COUNTERS, _jax_engine

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tengine = LazyModule("repro_torch.serving.engine")
tgeometry = LazyModule("repro_torch.core.geometry")
tschedule = LazyModule("repro_torch.graph.schedule")

ARCH = "qwen15_4b"
PAGE, SLOTS, CACHE_LEN, PROMPT = 8, 2, 64, 24
MAXP = CACHE_LEN // PAGE
# fp32, and the published format at a bf16 compute dtype.
_FMT = {"fp32": {}, "bf16acc": dict(format_policy="bf16acc",
                                    compute_dtype="bfloat16")}
_TOL = {"fp32": TOL["fp32"], "bf16acc": MODEL_TOL["bf16acc"]}


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               gemm_backend="pallas", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    """JAX ``init_params`` with the q/k/v biases redrawn from a seeded
    normal (``init_params`` makes them zero), and the port's conversion
    of the same tree."""
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    rng = np.random.default_rng(seed + 1)
    for group in tree["groups"]:
        for name in ("q", "k", "v"):
            leaf = group["mixer"][name]
            leaf["b"] = (0.5 * rng.standard_normal(leaf["b"].shape)
                         ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return jp, tconvert.params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    """Every field equal, full width and ``reduced()``, but the kernel
    backend's name; the published widths (40 layers, d_model 2560, 20
    heads on 20 kv heads of 128, d_ff 6912, vocab 151936), QKV bias,
    rope θ 1e6, an untied head and ``bf16acc``."""
    j, t = jget_config(ARCH), tconfigs.get_config(ARCH)
    assert ARCH in tconfigs.PORTED_ARCHS
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.hd, t.d_ff,
            t.vocab) == (40, 2560, 20, 20, 128, 6912, 151936)
    assert (t.qkv_bias, t.tied_embeddings, t.rope_theta, t.format_policy,
            t.mlp_type) == (True, False, 1e6, "bf16acc", "swiglu")
    if reduced:
        j, t = j.reduced(), t.reduced()
        assert (t.n_layers, t.n_heads, t.n_kv_heads) == (2, 4, 4)
    names = {f.name for f in dataclasses.fields(j)}
    assert names == {f.name for f in dataclasses.fields(t)}
    assert {k for k in names if getattr(j, k) != getattr(t, k)} == {
        "gemm_backend"}


def test_params_carry_the_untied_head():
    """``params_from_jax`` carries the head, (d_model, vocab), and the
    biases; ``init_params`` makes a head of JAX's layout and scale; the
    port's ``param_count`` equals the element count of JAX's tree; the
    engine's tree holds the head rounded and widened as ``unembed`` in
    its own layout and drops the head; a weight-shared draft shares it."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    jtree = jax.tree.map(np.asarray, jax.device_get(jp))
    head = tp["embedding"]["head"]
    assert head.shape == (tcfg.d_model, tcfg.vocab)
    np.testing.assert_array_equal(n(head), jtree["embedding"]["head"])
    np.testing.assert_array_equal(
        n(tp["layers"][1]["mixer"]["k"]["b"]),
        jtree["groups"][0]["mixer"]["k"]["b"][1])
    mine = torch_model.init_params(tcfg, seed=0, device="cpu")
    mhead = mine["embedding"]["head"]
    assert mhead.shape == (tcfg.d_model, tcfg.vocab)
    assert abs(float(mhead.std()) - tcfg.d_model ** -0.5) < 0.01
    count = sum(int(np.size(a)) for a in jax.tree.leaves(jtree))
    assert torch_model.param_count(tp) == torch_model.param_count(
        mine) == count
    bcfg = dataclasses.replace(tcfg, **_FMT["bf16acc"])
    served = tengine.serving_params(tp, bcfg)
    assert "head" not in served["embedding"] and "head" in tp["embedding"]
    assert torch.equal(served["embedding"]["unembed"],
                       head.to(torch.bfloat16).float())
    draft = torch_model.draft_from(served, bcfg, groups=1)
    assert draft["embedding"]["unembed"] is served["embedding"]["unembed"]


@functools.lru_cache(maxsize=None)
def _jitted(fmt):
    jcfg, _ = _cfgs(decode_qkv_grouped=True, **_FMT[fmt])
    chunk = {p0: jax.jit(lambda p, b, c, _p0=p0: jax_model.prefill_chunk(
        p, b, c, jcfg, pos0=_p0)) for p0 in range(0, PROMPT, 12)}
    dec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, jcfg))
    verify = jax.jit(lambda p, b, c: jax_model.verify_chunk(p, b, c, jcfg))
    return jcfg, chunk, dec, verify


@pytest.mark.parametrize("fmt", ["fp32", "bf16acc"])
def test_model_logits_match_jax(fmt):
    """A 24-token prompt into slot 1 in two chunks (the second reads the
    first's pages), three greedy decode steps with slot 0 idle (the
    grouped decode q/k/v, the bias added after the group), then a
    3-token verify window: logits of every call within ``TOL["fp32"]``,
    or the bf16acc model tolerance under ``bf16acc`` with a bf16 compute
    dtype (the decode GEMMs on the split-K engines' contract, slice by
    slice, where JAX's plans differ)."""
    jcfg, jchunk, jdec, jverify = _jitted(fmt)
    _, tcfg = _cfgs(decode_qkv_grouped=True, **_FMT[fmt])
    jp, tp = _params(jcfg, tcfg)
    kw = dict(num_pages=SLOTS * MAXP + 1, page_size=PAGE)
    jcache = jax_model.init_paged_cache(jcfg, SLOTS, CACHE_LEN, **kw)
    tcache = torch_model.init_paged_cache(tcfg, SLOTS, CACHE_LEN,
                                          device="cpu", **kw)
    table = np.full((SLOTS, MAXP), -1, np.int32)
    table[1] = 1 + np.arange(MAXP, dtype=np.int32)
    prompt = np.random.default_rng(7).integers(
        0, jcfg.vocab, PROMPT).astype(np.int32)
    tol = _TOL[fmt]
    for p0 in range(0, PROMPT, 12):
        toks = prompt[None, p0:p0 + 12]
        jl, jcache = jchunk[p0](jp, {"tokens": jnp.asarray(toks),
                                     "page_table": jnp.asarray(table[1:])},
                                jcache)
        tl, tcache = torch_model.prefill_chunk(
            tp, {"tokens": torch.as_tensor(toks),
                 "page_table": torch.as_tensor(table[1:])},
            tcache, tcfg, pos0=p0)
        np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                                   err_msg=f"chunk at {p0}")
    tok = int(np.argmax(np.asarray(jl)[0]))
    for i in range(3):
        batch = dict(tokens=np.array([[0], [tok]], np.int32),
                     pos=np.array([0, PROMPT + i], np.int32),
                     page_table=table)
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
                 page_table=table)
    jl, _ = jverify(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                    jcache)
    tl, _ = torch_model.verify_chunk(
        tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tcache, tcfg)
    assert tl.shape == (SLOTS, 3, tcfg.vocab)
    np.testing.assert_allclose(n(tl[1]), n(jl[1]), rtol=tol, atol=tol,
                               err_msg="verify window")


_KW = dict(slots=2, cache_len=64, prefill_len=32, page_size=8)


def _prompts(vocab, shared=24):
    """Three prompts of ``prefill_len`` (32) tokens, the first and the
    third sharing their first ``shared`` (three whole pages: the prefix
    cache serves them to the third, admitted once a slot frees)."""
    rng = np.random.default_rng(6)
    head = rng.integers(0, vocab, shared, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, 32 - shared,
                                               dtype=np.int32)]),
            rng.integers(0, vocab, 32, dtype=np.int32),
            np.concatenate([head, rng.integers(0, vocab, 32 - shared,
                                               dtype=np.int32)])]


def _serve(engine, request_cls, prompts, max_tokens=8):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_tokens=max_tokens))
    return engine.run(max_steps=300)


def test_engine_matches_jax_engine():
    """3 requests on 2 slots, the third prefilling while the others
    decode and served three pages from the prefix cache; the
    default configuration on both sides (graph programs, grouped decode
    q/k/v with the prestacked (3, D, D) leaf): equal greedy streams and
    counters."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    prompts = _prompts(jcfg.vocab)
    jeng = _jax_engine(jp, jcfg, async_steps=False, prefill_chunk=16,
                       **_KW)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", prefill_chunk=16,
                                 **_KW)
    assert teng._prefix_active and not teng._stateful_rows
    assert teng.params["layers"][0]["mixer"]["qkv"].shape == (
        3, tcfg.d_model, tcfg.n_heads * tcfg.hd)
    jout = _serve(jeng, JRequest, prompts)
    tout = _serve(teng, tengine.Request, prompts)
    assert sorted(tout) == sorted(jout) == [0, 1, 2]
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert tout[rid].status == jout[rid].status == "ok"
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["prefix_hit_pages"] > 0
    assert {k: tm[k] for k in _COUNTERS} == {k: jm[k] for k in _COUNTERS}
    teng.sched.pool.audit()


@pytest.mark.parametrize("fmt", ["fp32", "bf16acc"])
def test_speculative_draft1_equals_vanilla(fmt):
    """``spec_k=4`` with the weight-shared one-layer draft (its head the
    target's): greedy streams equal to ``spec_k=0``'s, in fp32 and under
    bf16acc (verify rows on the decode step's split-K contract), with
    some proposals rejected and the pool intact."""
    _, tcfg = _cfgs(**_FMT[fmt])
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    prompts = _prompts(tcfg.vocab)
    kw = dict(_KW, prefill_chunk=16)
    spec = tengine.ServingEngine(params, tcfg, device="cpu", spec_k=4,
                                 draft_groups=1, **kw)
    vanilla = tengine.ServingEngine(params, tcfg, device="cpu", **kw)
    assert spec.draft_params["embedding"] is spec.params["embedding"]
    sout = _serve(spec, tengine.Request, prompts, max_tokens=10)
    vout = _serve(vanilla, tengine.Request, prompts, max_tokens=10)
    assert sorted(sout) == sorted(vout) == [0, 1, 2]
    for rid in vout:
        assert list(sout[rid]) == list(vout[rid]), rid
        assert sout[rid].status == "ok"
    m = spec.metrics()
    assert m["spec_steps"] > 0 and 0.0 < m["acceptance_rate"] < 1.0
    spec.sched.pool.audit()


def test_verify_rows_equal_decode_steps_under_bf16acc():
    """The served configuration (bf16acc, graph programs, grouped decode
    q/k/v), three slots: a 4-token window's logits row i equals a decode
    step's at pos + i bit for bit, and the cache after it the cache after
    the four steps -- the split-K engines round each row's running sum at
    the same K rows whatever rows ride with it."""
    slots, k = 3, 4
    _, cfg = _cfgs(decode_qkv_grouped=True, **_FMT["bf16acc"])
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    cache = torch_model.init_paged_cache(cfg, slots, CACHE_LEN,
                                         num_pages=slots * MAXP + 1,
                                         page_size=PAGE, device="cpu")
    table = torch.as_tensor((1 + np.arange(slots * MAXP, dtype=np.int32))
                            .reshape(slots, MAXP))
    rng = np.random.default_rng(k)
    for s in range(slots):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 16)))
        torch_model.prefill_chunk(params, {"tokens": toks,
                                           "page_table": table[s:s + 1]},
                                  cache, cfg, pos0=0)
    window = torch.as_tensor(rng.integers(0, cfg.vocab, (slots, k)))
    pos = torch.tensor([16, 13, 21])
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


def test_full_width_plans_run_the_cluster_engines():
    """qwen15_4b at 4 slots under bf16acc: the decode o, gate, up and down
    plan split and run on B2's cluster engine (one 16-row window chunk
    each), the decode q/k/v group (3 x 4 x 2560, no padding: MHA) on B3's
    split-K engine; the prefill chunk's (M = 512) q/k/v and MLP programs
    launch every projection on B1's wgmma engine, ungrouped."""
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.graph.trace import GraphBuilder

    tautotune.reset_cache()
    tschedule.reset_programs()
    d, f, fmt, bf16 = 2560, 6912, "bf16acc", torch.bfloat16
    for n_out, k_in, act in ((d, d, "none"), (f, d, "silu"), (f, d, "none"),
                             (d, f, "none")):
        plan = tautotune.get_plan(4, n_out, k_in, bf16, bf16,
                                  epilogue=Epilogue(activation=act), fmt=fmt)
        assert plan.route == "splitk", (n_out, k_in)
        assert tautotune.plan_engine(plan.signature,
                                     plan.geometry) == "cluster"
        depth = tgeometry.splitk_cluster_split(n_out // 128, k_in, 4)[1]
        assert tgeometry.window_rows("cluster", 4, depth) == 16
    plan = tautotune.get_plan(4, d, d, bf16, bf16, group=3, fmt=fmt)
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "splitk"
    assert tgeometry.grouped_split(3 * d // 128, d, 4) == (4, 640)
    for m in (512,):
        b = GraphBuilder()
        xv = b.input((m, d), bf16, "x")
        outs = [b.gemm(xv, b.input((d, d), bf16, f"w_{name}"),
                       bias=b.input((d,), "float32", f"b_{name}"),
                       epilogue=Epilogue(has_bias=True), fmt=fmt,
                       out_dtype=bf16, policy="mte", name=name)
                for name in ("q", "k", "v")]
        b.output(*outs)
        prog = tschedule.compile_graph(b.build())
        assert not prog.grouped
        assert {tautotune.plan_engine(p.signature, p.geometry)
                for p in prog.plans.values()} == {"wgmma"}
        b = GraphBuilder()
        xv = b.input((m, d), bf16, "x")
        gate = b.gemm(xv, b.input((d, f), bf16, "w_gate"),
                      epilogue=Epilogue(activation="silu"), fmt=fmt,
                      out_dtype=bf16, policy="mte", name="gate")
        up = b.gemm(xv, b.input((d, f), bf16, "w_up"), fmt=fmt,
                    out_dtype=bf16, policy="mte", name="up")
        b.output(b.gemm(b.mul(gate, up), b.input((f, d), bf16, "w_down"),
                        fmt=fmt, out_dtype=bf16, policy="mte", name="down"))
        prog = tschedule.compile_graph(b.build())
        assert not prog.grouped
        assert {tautotune.plan_engine(p.signature, p.geometry)
                for p in prog.plans.values()} == {"wgmma"}
