"""Speculative decoding in the port, held to the contract of
``tests/test_speculative.py`` on the CPU: ``verify_chunk`` against the JAX
package's (logits and cache leaves, fp32 and bf16, both archs); each
verify row equal bit for bit to a decode step at its position (k = 2, 3,
4), with no plan made at the window's rows; ``cfg.draft`` and
``draft_from`` against JAX's, the draft's tensors the target's; greedy
streams with speculation equal to those without it and to the JAX
speculative engine's; a full-depth draft accepting everything; the
rejection-sampling marginal; the eviction rewind; a full pool degrading
to k = 1 without evicting; k = 1 steps after speculative steps chaining
from the emitted tokens; ``merge_graphs`` against JAX's.  The card's half
is in ``tests/test_torch_cuda.py``.

Tolerances against JAX (rtol = atol): ``MODEL_TOL`` of torch_parity for
gemma_2b; recurrentgemma_9b's bf16 at 5e-2, as its model test
(``test_torch_ring_model.py``) states.  bf16 cache leaves take 2^-4 more
of absolute tolerance: 4 bf16 ulps at the leaves' magnitude (2 ≤ |x| <
4), the difference the two packages' prefills of the same slots already
leave in them (the window adds none)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.epilogue import Epilogue as JEpilogue
from repro.graph import GraphBuilder as JGraphBuilder
from repro.graph.trace import merge_graphs as jmerge_graphs
from repro.models import model as jax_model
from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule, torch
from torch_parity import MODEL_TOL, jax_params, n, torch_model
from test_torch_serving import _jax_engine

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tconfigs = LazyModule("repro_torch.configs")
tepilogue = LazyModule("repro_torch.core.epilogue")
tgraph = LazyModule("repro_torch.graph")
tops = LazyModule("repro_torch.kernels.ops")
tschedule = LazyModule("repro_torch.graph.schedule")
tsched = LazyModule("repro_torch.serving.scheduler")
ttrace = LazyModule("repro_torch.graph.trace")
tengine = LazyModule("repro_torch.serving.engine")
tconvert = LazyModule("repro_torch.convert")

ARCHS = ["gemma_2b", "recurrentgemma_9b"]
_FMT = {"fp32": {}, "bf16": dict(format_policy="bf16",
                                 compute_dtype="bfloat16")}
_TOL = {"gemma_2b": MODEL_TOL,
        "recurrentgemma_9b": dict(MODEL_TOL, bf16=5e-2)}
PAGE, SLOTS, CACHE_LEN, PROMPT = 8, 2, 64, 16
MAXP = CACHE_LEN // PAGE


def _tiny(arch, **kw):
    """The arch cut to two layer periods of narrow widths (the JAX test's
    ``_tiny``), in the port."""
    cfg = tconfigs.get_config(arch).reduced()
    return dataclasses.replace(cfg, n_layers=2 * cfg.period, d_model=64,
                               d_ff=128, vocab=128, n_heads=2, n_kv_heads=1,
                               head_dim=32, **kw)


def _table():
    return (1 + np.arange(SLOTS * MAXP, dtype=np.int32)).reshape(SLOTS, MAXP)


def _prompts(vocab):
    return np.random.default_rng(7).integers(
        0, vocab, (SLOTS, PROMPT)).astype(np.int32)


# -- verify_chunk against JAX -------------------------------------------------

def _cfgs(arch, fmt):
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               gemm_backend="pallas", **_FMT[fmt])
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               **_FMT[fmt])
    if arch == "gemma_2b":        # JAX's eager kernel path on both sides
        jcfg = dataclasses.replace(jcfg, use_graph=False)
        tcfg = dataclasses.replace(tcfg, use_graph=False)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jitted(arch, fmt):
    jcfg, _ = _cfgs(arch, fmt)
    chunk = jax.jit(lambda p, b, c: jax_model.prefill_chunk(p, b, c, jcfg,
                                                            pos0=0))
    verify = jax.jit(lambda p, b, c: jax_model.verify_chunk(p, b, c, jcfg))
    return jcfg, chunk, verify


def _jax_layer_caches(cache, cfg):
    """The JAX cache as one dict per layer, in layer order (a scanned
    group's leaves carry the group on their first axis)."""
    n_groups = cfg.n_layers // cfg.period
    out = []
    for g in range(n_groups):
        for j in range(cfg.period):
            out.append({k: np.asarray(v)[g]
                        for k, v in cache["groups"][j].items()})
    out.extend({k: np.asarray(v) for k, v in layer.items()}
               for layer in cache["tail"])
    return out


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_chunk_matches_jax(arch, fmt):
    """Both slots prefilled with 16 tokens (recurrentgemma's 16-slot ring
    full), then a 3-token window at position 16 in each: logits and every
    cache leaf within the stated tolerance (paged slabs past the null
    page; the rings wrap)."""
    jcfg, jchunk, jverify = _jitted(arch, fmt)
    _, tcfg = _cfgs(arch, fmt)
    jp, tp = jax_params(jcfg)
    kw = dict(num_pages=SLOTS * MAXP + 1, page_size=PAGE)
    jcache = jax_model.init_paged_cache(jcfg, SLOTS, CACHE_LEN, **kw)
    tcache = torch_model.init_paged_cache(tcfg, SLOTS, CACHE_LEN,
                                          device="cpu", **kw)
    table, prompts = _table(), _prompts(jcfg.vocab)
    for s in range(SLOTS):
        batch = dict(tokens=prompts[s:s + 1], page_table=table[s:s + 1])
        _, jcache = jchunk(jp, {**{k: jnp.asarray(v)
                                   for k, v in batch.items()},
                                "slot": jnp.int32(s)}, jcache)
        torch_model.prefill_chunk(
            tp, {**{k: torch.as_tensor(v) for k, v in batch.items()},
                 "slot": s}, tcache, tcfg, pos0=0)
    window = np.random.default_rng(8).integers(
        0, jcfg.vocab, (SLOTS, 3)).astype(np.int32)
    batch = dict(tokens=window, pos=np.full(SLOTS, PROMPT, np.int32),
                 page_table=table, row_valid=np.ones(SLOTS, bool))
    jl, jcache = jverify(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                         jcache)
    tl, tcache = torch_model.verify_chunk(
        tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tcache, tcfg)
    tol = _TOL[arch][fmt]
    assert tl.shape == (SLOTS, 3, jcfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol)
    leaf_tol = tol + (2.0 ** -4 if fmt == "bf16" else 0.0)
    for i, (jlayer, tlayer) in enumerate(zip(_jax_layer_caches(jcache, jcfg),
                                             tcache["layers"])):
        assert sorted(jlayer) == sorted(tlayer), i
        for name, leaf in tlayer.items():
            want = jlayer[name].astype(np.float32)
            got = n(leaf)
            if name.endswith("_pages"):
                want, got = want[1:], got[1:]
            np.testing.assert_allclose(got, want, rtol=tol, atol=leaf_tol,
                                       err_msg=f"layer {i} {name}")


# -- verify rows are decode steps, bit for bit --------------------------------

def _clone(cache):
    return {"layers": [{k: v.clone() for k, v in layer.items()}
                       for layer in cache["layers"]]}


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_rows_equal_decode_steps(arch, k):
    """The served configuration (bf16, graph programs, grouped decode
    q/k/v), three slots, the middle one masked (``row_valid`` False): the
    window's logits row i equals a decode step's at pos + i, and the cache
    after the window equals the cache after the k steps, bit for bit;
    the window made no plan at its B·k rows (it runs on the decode step's
    B-row plans)."""
    slots = 3
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              decode_qkv_grouped=True, **_FMT["bf16"])
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    cache = torch_model.init_paged_cache(cfg, slots, CACHE_LEN,
                                         num_pages=slots * MAXP + 1,
                                         page_size=PAGE, device="cpu")
    table = torch.as_tensor((1 + np.arange(slots * MAXP, dtype=np.int32))
                            .reshape(slots, MAXP))
    rng = np.random.default_rng(k)
    for s in range(slots):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, PROMPT)))
        torch_model.prefill_chunk(params, {"tokens": toks,
                                           "page_table": table[s:s + 1],
                                           "slot": s}, cache, cfg, pos0=0)
    window = torch.as_tensor(rng.integers(0, cfg.vocab, (slots, k)))
    pos = torch.tensor([PROMPT, PROMPT - 3, PROMPT + 5])
    valid = torch.tensor([True, False, True])
    start = _clone(cache)
    steps = []
    for i in range(k):
        logits, cache = torch_model.decode(
            params, {"tokens": window[:, i:i + 1], "pos": pos + i,
                     "page_table": table, "row_valid": valid}, cache, cfg)
        steps.append(logits)
    tautotune.reset_cache()
    tschedule.reset_programs()
    logits, after = torch_model.verify_chunk(
        params, {"tokens": window, "pos": pos, "page_table": table,
                 "row_valid": valid}, _clone(start), cfg)
    for i in range(k):
        assert torch.equal(logits[:, i], steps[i]), i
    for a, b in zip(after["layers"], cache["layers"]):
        for name in a:
            assert torch.equal(a[name], b[name]), name
    rows = {sig.m for sig in tautotune.plan_cache()._plans}
    assert rows == {slots}, rows
    last, _ = torch_model.verify_chunk(
        params, {"tokens": window, "pos": pos, "page_table": table,
                 "row_valid": valid}, _clone(start), cfg, last_only=True)
    assert torch.equal(last[:, 0], steps[-1])


@pytest.mark.parametrize("rows", [12, 20])
@pytest.mark.parametrize("grouped", [False, True])
def test_plan_rows_gives_the_rows_of_the_planned_gemm(grouped, rows):
    """``plan_rows``: 12 or 20 rows (past 16: run in chunks) planned as 4
    (a split plan at 4 rows) come out as 4-row GEMMs would, bit for bit,
    and only the 4-row signature is planned."""
    rng = np.random.default_rng(0)
    k_dim, n_dim = 512, 256
    a = torch.as_tensor(rng.standard_normal((rows, k_dim))
                        .astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((k_dim, n_dim))
                        .astype(np.float32))
    tautotune.reset_cache()
    if grouped:
        ws = torch.stack([w, w.flip(0)])

        def run(x, **kw):
            return tops.grouped_gemm(x[None].expand(2, *x.shape), ws, **kw)
    else:
        def run(x, **kw):
            return tops.mte_gemm(x, w, **kw)
    whole = run(a, plan_rows=4)
    parts = torch.cat([run(a[i:i + 4]) for i in range(0, rows, 4)],
                      dim=-2)
    assert torch.equal(whole, parts)
    plans = list(tautotune.plan_cache()._plans.values())
    assert {p.signature.m for p in plans} == {4}
    if not grouped:
        assert plans[0].route == "splitk"


def test_window_rows_at_the_served_decode_gemms():
    """``geometry.window_rows``, the rows per launch of a verify window's
    GEMM on the decode step's plan (4 slots): every decode GEMM of
    gemma_2b and recurrentgemma_9b takes 16 rows in one launch (their
    4 x 4 windows stay one launch per GEMM); gemma2_27b's gate and up
    (K 4608 in one 4608-deep slice) take 14 and its down (4 slices of
    9216) 7, whose x slices fill the split-K engine's shared memory, and
    its o and q/k/v group 16; the tile loops take 16; past 16 slots a
    chunk is the slots' rows."""
    from repro_torch.core import geometry as geo
    bf16 = torch.bfloat16

    def b2(n_out, k):
        assert geo.splitk_engine(bf16, 4, n_out, k) == "cluster"
        depth = geo.splitk_cluster_split(geo.cdiv(n_out, 128), k, 4)[1]
        assert depth <= geo.grouped_max_depth(4)
        return geo.window_rows("cluster", 4, depth)

    for d, ff, q in ((2048, 16384, 2048), (4096, 12288, 4096)):
        assert {b2(d, q), b2(ff, d), b2(d, ff)} == {16}
    assert (b2(4608, 4096), b2(36864, 4608), b2(4608, 36864)) == (16, 14, 7)
    qkv_depth = geo.grouped_split(32 + 16 + 16, 4608, 4)[1]
    assert geo.window_rows("splitk", 4, qkv_depth) == 16
    assert geo.window_rows("tile", 4) == 16
    assert geo.window_rows("cluster", 20, 9216) == 20
    assert geo.grouped_max_depth(14) >= 4608 > geo.grouped_max_depth(15)
    assert geo.grouped_max_depth(7) >= 9216 > geo.grouped_max_depth(8)


# -- the draft ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_draft_config_and_params_match_jax(arch):
    """``cfg.draft(g)``: the JAX package's name, depth, pattern and widths;
    the same refusals.  ``draft_from``: the first g periods of layers with
    the target's embedding and final norm — the target's tensors
    themselves (no copy), as many layers as JAX's scanned slice holds —
    and inside the engine, the served (cast, qkv-stacked) ones."""
    jfull, tfull = jget_config(arch), tconfigs.get_config(arch)
    for groups in (1, 2):
        jd, td = jfull.draft(groups), tfull.draft(groups)
        assert (td.name, td.n_layers, td.layer_kinds, td.d_model,
                td.format_policy) == (jd.name, jd.n_layers, jd.layer_kinds,
                                      jd.d_model, jd.format_policy)
    assert tfull.draft(1, format_policy="int8").format_policy == "int8"
    n_groups = tfull.n_layers // tfull.period
    for bad in (0, n_groups + 1):
        with pytest.raises(ValueError, match="scanned groups"):
            jfull.draft(bad)
        with pytest.raises(ValueError, match="scanned groups"):
            tfull.draft(bad)
    cfg = tconfigs.get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    jdraft = jax_model.draft_from(jax_model.init_params(
        jax.random.PRNGKey(0), jcfg), jcfg, groups=1)
    draft = torch_model.draft_from(params, cfg, groups=1)
    jdepth = jax.tree.leaves(jdraft["groups"])[0].shape[0] * jcfg.period
    assert len(draft["layers"]) == jdepth == cfg.period
    assert draft["embedding"] is params["embedding"]
    assert draft["final_norm"] is params["final_norm"]
    for got, want in zip(draft["layers"], params["layers"]):
        for group in ("mixer", "ffn"):
            for name, leaf in got[group].items():
                leaf = leaf["w"] if isinstance(leaf, dict) else leaf
                other = want[group][name]
                other = other["w"] if isinstance(other, dict) else other
                assert leaf.data_ptr() == other.data_ptr(), name
    for bad in (0, 3):
        with pytest.raises(ValueError, match="groups must be in"):
            torch_model.draft_from(params, cfg, groups=bad)
        with pytest.raises(ValueError, match="groups must be in"):
            jax_model.draft_from(jax_model.init_params(
                jax.random.PRNGKey(0), jcfg), jcfg, groups=bad)
    eng = tengine.ServingEngine(params, cfg, slots=2, cache_len=64,
                                prefill_len=32, page_size=8, spec_k=3,
                                device="cpu")
    assert eng.draft_cfg.name == f"{cfg.name}_draft1"
    for got, want in zip(eng.draft_params["layers"], eng.params["layers"]):
        assert got is want


# -- the engine ---------------------------------------------------------------

def _submit_shared(engine, vocab, request_cls, n=3, seed=5, max_tokens=12):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 20, dtype=np.int32)
    for rid in range(n):
        tail = rng.integers(0, vocab, 4 + 2 * rid, dtype=np.int32)
        engine.submit(request_cls(rid=rid,
                                  prompt=np.concatenate([shared, tail]),
                                  max_tokens=max_tokens))


def _run(params, cfg, spec_k, engine=None, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("cache_len", 96)
    kw.setdefault("prefill_len", 32)
    kw.setdefault("page_size", 16)
    eng = (engine or tengine.ServingEngine)(
        params, cfg, spec_k=spec_k, debug_audit=True, device="cpu", **kw)
    _submit_shared(eng, cfg.vocab, tengine.Request)
    out = eng.run(max_steps=300)
    assert all(r.status == "ok" for r in out.values())
    return {rid: list(r) for rid, r in out.items()}, eng


@pytest.fixture(scope="module")
def tiny_params():
    return {arch: torch_model.init_params(_tiny(arch), seed=0, device="cpu")
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_bit_identical_to_vanilla(arch, tiny_params):
    """The acceptance bar: speculative greedy streams are vanilla's, with
    rejections exercised (gemma's paged rewind, recurrentgemma's ring and
    RG-LRU restore and replay)."""
    cfg, params = _tiny(arch), tiny_params[arch]
    vanilla, _ = _run(params, cfg, 0)
    spec, eng = _run(params, cfg, 4)
    assert spec == vanilla
    m = eng.metrics()
    assert m["spec_steps"] > 0 and m["spec_on"] == 1
    assert 0.0 < m["acceptance_rate"] < 1.0
    assert 2.0 <= m["spec_k_mean"] <= 4.0
    eng.sched.pool.audit()


def test_full_depth_draft_accepts_every_proposal(tiny_params):
    """draft_groups = every group: the draft is the target, so each
    verify row agrees with the draft's decode row and every proposal is
    accepted."""
    cfg, params = _tiny("gemma_2b"), tiny_params["gemma_2b"]
    vanilla, _ = _run(params, cfg, 0)
    spec, eng = _run(params, cfg, 4, draft_groups=2)
    assert spec == vanilla
    m = eng.metrics()
    assert m["acceptance_rate"] == 1.0
    assert m["accepted_per_step"] >= 3.0


def test_greedy_equals_the_jax_speculative_engine():
    """The JAX engine with ``spec_k=4`` (handed copies of its host arrays,
    see ``_jax_engine``) and the port's on the same converted parameters:
    the same greedy streams, the same number of speculative steps, drafts
    and accepted drafts."""
    jcfg = dataclasses.replace(
        jget_config("gemma_2b").reduced(), gemm_backend="pallas",
        use_graph=False, n_layers=2, d_model=64, d_ff=128, vocab=128,
        n_heads=2, n_kv_heads=1, head_dim=32)
    tcfg = _tiny("gemma_2b", use_graph=False)
    jp, tp = jax_params(jcfg)
    kw = dict(slots=2, cache_len=96, prefill_len=32, page_size=16,
              spec_k=4, grouped_qkv=False)
    jeng = _jax_engine(jp, jcfg, **kw)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", **kw)
    _submit_shared(jeng, jcfg.vocab, JRequest)
    _submit_shared(teng, jcfg.vocab, tengine.Request)
    jout, tout = jeng.run(max_steps=300), teng.run(max_steps=300)
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
    jm, tm = jeng.metrics(), teng.metrics()
    keys = ("spec_steps", "spec_drafted", "spec_accepted", "spec_emitted",
            "decode_tokens", "spec_k_mean")
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    assert 0.0 < tm["acceptance_rate"] < 1.0


@pytest.mark.parametrize("option", ["draft_params", "draft_format_policy"])
def test_draft_options_match_the_jax_speculative_engine(option):
    """The JAX engine and the port's with the same draft option:
    ``draft_config`` with ``draft_params`` of its own (independent
    weights, converted from JAX's), or ``draft_format_policy="bf16"`` over
    an fp32 target.  The same greedy streams as each other and as the
    port's vanilla engine, the same speculative steps, drafts and
    accepted drafts, and rejections."""
    jcfg = dataclasses.replace(
        jget_config("gemma_2b").reduced(), gemm_backend="pallas",
        use_graph=False, n_layers=2, d_model=64, d_ff=128, vocab=128,
        n_heads=2, n_kv_heads=1, head_dim=32)
    tcfg = _tiny("gemma_2b", use_graph=False)
    jp, tp = jax_params(jcfg)
    kw = dict(slots=2, cache_len=96, prefill_len=32, page_size=16,
              spec_k=4, grouped_qkv=False)
    if option == "draft_params":
        jdcfg, tdcfg = jcfg.draft(1), tcfg.draft(1)
        jdp = jax_model.init_params(jax.random.PRNGKey(1), jdcfg)
        tdp = tconvert.params_from_jax(jax.tree.map(np.asarray, jdp), tdcfg,
                              device="cpu")
        jkw = dict(kw, draft_config=jdcfg, draft_params=jdp)
        tkw = dict(kw, draft_config=tdcfg, draft_params=tdp)
    else:
        jkw = tkw = dict(kw, draft_format_policy="bf16")
    jeng = _jax_engine(jp, jcfg, **jkw)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", **tkw)
    if option == "draft_params":
        assert teng.draft_params["layers"][0] is not teng.params["layers"][0]
    else:
        assert teng.draft_cfg.format_policy == "bf16"
        assert teng.draft_params["layers"][0] is teng.params["layers"][0]
    vanilla = tengine.ServingEngine(tp, tcfg, device="cpu",
                                    **dict(kw, spec_k=0))
    for eng, req in ((jeng, JRequest), (teng, tengine.Request),
                     (vanilla, tengine.Request)):
        _submit_shared(eng, jcfg.vocab, req)
    jout, tout = jeng.run(max_steps=300), teng.run(max_steps=300)
    vout = vanilla.run(max_steps=300)
    assert sorted(tout) == sorted(jout) == sorted(vout)
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]) == list(vout[rid]), rid
    jm, tm = jeng.metrics(), teng.metrics()
    keys = ("spec_steps", "spec_drafted", "spec_accepted", "spec_emitted",
            "decode_tokens", "spec_k_mean")
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    assert tm["acceptance_rate"] < 1.0


def test_draft_config_without_params_must_truncate_the_target():
    """Without ``draft_params`` the draft is the target's own first
    layers: a ``draft_config`` of other widths or another pattern is
    refused; a truncation of the target is the ``draft_groups`` draft."""
    cfg = _tiny("gemma_2b")
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    kw = dict(slots=2, cache_len=64, prefill_len=32, page_size=8,
              spec_k=3, device="cpu")
    for bad in (dataclasses.replace(cfg.draft(1), d_ff=256),
                dataclasses.replace(cfg.draft(1), vocab=64),
                dataclasses.replace(cfg.draft(1), pattern=(("local",
                                                            "mlp"),),
                                    window=8)):
        with pytest.raises(ValueError, match="draft_config"):
            tengine.ServingEngine(params, cfg, draft_config=bad, **kw)
    eng = tengine.ServingEngine(params, cfg, draft_config=cfg.draft(2), **kw)
    assert eng.draft_cfg.n_layers == 2
    for got, want in zip(eng.draft_params["layers"], eng.params["layers"]):
        assert got is want


@pytest.mark.parametrize("slots,spec_k", [(5, 4), (12, 2)])
def test_windows_past_sixteen_rows(slots, spec_k):
    """Verify windows of slots·k = 20 and 24 rows: k is not clamped below
    the JAX engine's (no 16-row limit, and more than 8 slots speculate),
    the window's GEMMs run in row chunks on the decode step's plans (no
    plan at the window's rows), and greedy streams equal those of
    ``spec_k=0`` and of the JAX speculative engine, with the JAX engine's
    ``spec_k_hist`` and counts."""
    jcfg = dataclasses.replace(
        jget_config("gemma_2b").reduced(), gemm_backend="pallas",
        use_graph=False, n_layers=2, d_model=64, d_ff=128, vocab=128,
        n_heads=2, n_kv_heads=1, head_dim=32)
    tcfg = _tiny("gemma_2b", use_graph=False)
    jp, tp = jax_params(jcfg)
    kw = dict(slots=slots, cache_len=96, prefill_len=32, page_size=16,
              spec_k=spec_k, grouped_qkv=False)
    tautotune.reset_cache()
    jeng = _jax_engine(jp, jcfg, **kw)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", **kw)
    vanilla = tengine.ServingEngine(tp, tcfg, device="cpu",
                                    **dict(kw, spec_k=0))
    for eng, req in ((jeng, JRequest), (teng, tengine.Request),
                     (vanilla, tengine.Request)):
        _submit_shared(eng, jcfg.vocab, req, n=slots)
    jout, tout = jeng.run(max_steps=300), teng.run(max_steps=300)
    vout = vanilla.run(max_steps=300)
    assert sorted(tout) == sorted(jout) == sorted(vout)
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]) == list(vout[rid]), rid
    assert teng.spec_k_hist == jeng.spec_k_hist
    assert max(teng.spec_k_hist) == spec_k
    assert max(teng.spec_k_hist) * slots > 16
    jm, tm = jeng.metrics(), teng.metrics()
    keys = ("spec_steps", "spec_drafted", "spec_accepted", "spec_emitted",
            "decode_tokens", "spec_k_mean")
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    rows = {sig.m for sig in tautotune.plan_cache()._plans}
    assert slots * spec_k not in rows, rows


def test_rejection_sampling_matches_target_marginal():
    """The first emitted token of a sampled speculative step follows the
    TARGET softmax whatever the draft proposes (accept with probability
    min(1, p_t/p_d), else draw the residual), for a close and a hostile
    draft; the draws come from the engine's host generator."""
    cfg = _tiny("gemma_2b")
    params = torch_model.init_params(cfg, seed=0, device="cpu")
    eng = tengine.ServingEngine(params, cfg, slots=1, cache_len=64,
                                prefill_len=32, seed=123, device="cpu")
    req = tengine.Request(rid=0, prompt=np.zeros(4, np.int32),
                          temperature=1.0)
    rng = np.random.default_rng(0)
    vocab, k = 8, 3
    t_logits = (rng.normal(size=vocab) * 2.0).astype(np.float32)
    p_t = np.exp(t_logits - t_logits.max())
    p_t /= p_t.sum()
    for d_logits in [t_logits + rng.normal(size=vocab).astype(np.float32)
                     * 0.5, -2.0 * t_logits]:
        trials = 4000
        counts = np.zeros(vocab)
        logits = np.tile(t_logits, (k, 1))
        dlog = np.tile(d_logits, (k, 1))
        for _ in range(trials):
            props = [eng._propose(d_logits, req) for _ in range(k - 1)]
            emit, _ = eng._accept(logits, props, dlog, req)
            counts[emit[0]] += 1
        np.testing.assert_allclose(counts / trials, p_t, atol=0.035)


def test_spec_outputs_survive_eviction_rewind(tiny_params):
    """An overcommitted pool: eviction fires while speculation runs, the
    evicted request resumes through re-prefill, and the greedy streams
    still match the uncontended vanilla run.  The draft's known tokens end
    at the target's position for every slot at every step, the resumed
    request's too (its window already holds its earlier output)."""
    cfg, params = _tiny("gemma_2b"), tiny_params["gemma_2b"]
    kw = dict(slots=2, cache_len=96, prefill_len=64, page_size=16)
    van, _ = _run(params, cfg, 0, **kw)

    class Checked(tengine.ServingEngine):
        def _known_tokens(self, slot):
            known = super()._known_tokens(slot)
            assert len(known) - 1 == int(self.slot_pos[slot])
            return known

    spec, eng = _run(params, cfg, 4, engine=Checked, num_pages=9, **kw)
    m = eng.metrics()
    assert m["preemptions"] > 0, "the pool must have been overcommitted"
    assert m["spec_steps"] > 0
    assert spec == van
    eng.sched.pool.audit()


def test_scheduler_spec_k_degrades_on_full_pool():
    """The policy hook returns depth 1 when the free list is empty."""
    sched = tsched.ContinuousBatchingScheduler(slots=2, max_seq_len=64,
                                               page_size=8, num_pages=8)
    assert sched.spec_k(0) is None
    assert sched.spec_k(1) > 1
    assert sched.pool.ensure(0, sched.pool.free_pages * 8)
    assert sched.pool.free_pages == 0
    assert sched.spec_k(1) == 1
    assert sched.spec_k(2) == 1


def test_full_pool_degrades_spec_without_evicting(tiny_params):
    """A pool whose free list runs dry as decodes grow: some steps degrade
    to k = 1 (vanilla decode launches, replayed on a card), none evicts,
    and those k = 1 steps chain from the tokens speculation emitted."""
    cfg, params = _tiny("gemma_2b"), tiny_params["gemma_2b"]
    kw = dict(slots=2, cache_len=64, prefill_len=32, page_size=16,
              num_pages=7)
    van, _ = _run(params, cfg, 0, **kw)
    spec, eng = _run(params, cfg, 4, **kw)
    assert spec == van
    m = eng.metrics()
    assert m["preemptions"] == 0
    assert 0 < m["spec_steps"] < m["decode_steps"]


@pytest.mark.parametrize("arch", ARCHS)
def test_k1_steps_after_spec_steps_chain_from_the_emitted_token(
        arch, tiny_params):
    """Speculative and k = 1 steps alternate: after each speculative step
    the carried token buffer (the decode step's input, which a graph
    replay reads) holds each surviving slot's last emitted token, and the
    streams equal vanilla's."""
    cfg, params = _tiny(arch), tiny_params[arch]
    vanilla, _ = _run(params, cfg, 0)

    class Alternating(tengine.ServingEngine):
        def _spec_depth(self, decoding):
            k = super()._spec_depth(decoding)
            return k if self.step_idx % 2 else 1

        def _spec_step(self, decoding, k):
            super()._spec_step(decoding, k)
            for s in self._decoding():
                assert int(self._last_tok[s, 0]) == \
                    self.slot_req[s].output[-1]
            self.spec_checked = getattr(self, "spec_checked", 0) + 1

    spec, eng = _run(params, cfg, 4, engine=Alternating)
    assert spec == vanilla
    m = eng.metrics()
    assert eng.spec_checked > 0 and m["spec_steps"] < m["decode_steps"]


# -- merge_graphs -------------------------------------------------------------

def _spec_graphs(builder, epi_cls):
    """A grouped decode q/k/v and an epilogue-fused GEMM: the parts of a
    speculative step's program."""
    b = builder()
    x = b.input((4, 64), "bfloat16", "x")
    w = b.input((3, 64, 96), "bfloat16", "qkv")
    b.output(*b.group(x, stacked=w, widths=(96, 32, 32), fmt="bf16",
                      out_dtype="bfloat16"))
    first = b.build()
    b = builder()
    h = b.input((16, 64), "bfloat16", "h")
    w = b.input((64, 128), "bfloat16", "w")
    bias = b.input((128,), "float32", "bias")
    y = b.gemm(h, w, bias=bias, epilogue=epi_cls(has_bias=True,
                                                 activation="gelu"),
               fmt="bf16", out_dtype="float32")
    b.output(y, h)
    return first, b.build()


def test_merge_graphs_matches_jax():
    """Value ids of the second graph shift by the first's value count,
    inputs and outputs concatenate in order, and the merged program hashes
    as JAX's does."""
    tparts = _spec_graphs(ttrace.GraphBuilder, tepilogue.Epilogue)
    jparts = _spec_graphs(JGraphBuilder, JEpilogue)
    merged = ttrace.merge_graphs(*tparts)
    jmerged = jmerge_graphs(*jparts)
    off = len(tparts[0].values)
    assert merged.inputs == tparts[0].inputs + tuple(
        v + off for v in tparts[1].inputs)
    assert merged.outputs == tparts[0].outputs + tuple(
        v + off for v in tparts[1].outputs)
    assert len(merged.nodes) == len(tparts[0].nodes) + len(tparts[1].nodes)
    gemm = merged.nodes[-1]
    src = tparts[1].nodes[-1]
    assert (gemm.a, gemm.b, gemm.bias, gemm.out) == (
        src.a + off, src.b + off, src.bias + off, src.out + off)
    assert merged.nodes[0] == tparts[0].nodes[0]
    assert merged.signature() == jmerged.signature()
    assert merged.signature() != ttrace.merge_graphs(*tparts[::-1]).signature()
    assert tgraph.merge_graphs is ttrace.merge_graphs
