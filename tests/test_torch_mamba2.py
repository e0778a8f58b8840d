"""mamba2_130m through the port against the JAX package, on the CPU: the
SSD mixer (``models/ssm.py``, layer kind ``("ssd", "none")``) in the
model stack and the serving engine.  JAX runs its pallas backend (the
SSD block is plain jnp there: no Pallas kernel runs on it), the port its
plain PyTorch; parameters are carried across by
``repro_torch.convert.params_from_jax``, with the SSD's ``conv_b``,
``dt_bias``, ``D`` and ``norm_scale`` drawn away from their zero and one
initial values so that every term shows.

Compared: the config field for field and its parameter count;
``_ssd_chunked`` (S not a multiple of the chunk, from a zero and a
non-zero state) within 1e-5 in fp32; ``ssd_forward`` with its returned
cache, and resumed over calls (conv ring and state) against one call and
against JAX; the model-level ``forward``, ``prefill`` and ``decode``
logits within 1e-4 (``MODEL_TOL``), decode against forward's logits
(``tests/test_decode_consistency.py``) and a cache whose size does not
grow; the engine's greedy streams, multi-chunk against single-chunk
(``tests/test_serving.py:311-334``) and against JAX's engine, with and
without speculation (``spec_k_hist`` too); the loss and its gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import model as jax_model
from repro.models import ssm as jssm
from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule, torch
from torch_parity import MODEL_TOL, TOL, n, t, torch_model
from test_torch_serving import _COUNTERS, _jax_engine

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tengine = LazyModule("repro_torch.serving.engine")
tssm = LazyModule("repro_torch.models.ssm")
ttrainer = LazyModule("repro_torch.training.trainer")
ttree = LazyModule("repro_torch.tree")

ARCH = "mamba2_130m"
TOL_F = MODEL_TOL["fp32"]


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               gemm_backend="pallas", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw)
    return jcfg, tcfg


def _perturb(tree, rng):
    """The SSD leaves that start at 0 or 1 drawn away from them, in
    place: ``conv_b`` and ``dt_bias`` from 0.3 x N(0, 1), ``D`` and
    ``norm_scale`` from 1 + 0.3 x N(0, 1), and the RMSNorm scales."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _perturb(leaf, rng)
        elif key in ("conv_b", "dt_bias"):
            tree[key] = (0.3 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)
        elif key in ("D", "norm_scale", "scale"):
            tree[key] = (1 + 0.3 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)


def _params(jcfg, tcfg, seed=0):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    _perturb(tree, np.random.default_rng(seed + 1))
    return (jax.tree.map(jnp.asarray, tree),
            tconvert.params_from_jax(tree, tcfg, device="cpu"))


def _close(got, want, tol=TOL_F, what=""):
    np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    """Every field equal, full width and ``reduced()`` (the SSM config by
    value), but the kernel backend's name; the published widths (24
    layers, d_model 768, vocab 50280, tied embeddings, every layer
    ``("ssd", "none")``, d_state 128, head_dim 64, expand 2, conv width
    4, chunk 256); ``n_params`` JAX's, 128.7 M."""
    j, tc = jget_config(ARCH), tconfigs.get_config(ARCH)
    assert ARCH in tconfigs.PORTED_ARCHS
    assert (tc.n_layers, tc.d_model, tc.vocab, tc.tied_embeddings) == (
        24, 768, 50280, True)
    assert set(tc.layer_kinds) == {("ssd", "none")}
    assert dataclasses.astuple(tc.ssm) == (128, 64, 2, 4, 256)
    assert tc.n_params() == j.n_params() == 128711424
    if reduced:
        j, tc = j.reduced(), tc.reduced()
        assert dataclasses.astuple(tc.ssm) == (16, 16, 2, 4, 8)
        assert tc.n_params() == j.n_params()
    names = {f.name for f in dataclasses.fields(j)}
    assert names == {f.name for f in dataclasses.fields(tc)}
    assert dataclasses.asdict(j.ssm) == dataclasses.asdict(tc.ssm)
    assert {k for k in names - {"ssm"}
            if getattr(j, k) != getattr(tc, k)} == {"gemm_backend"}


def test_params_match_jax():
    """An SSD layer holds ``norm1`` and the mixer only (no ``norm2``, no
    ``ffn``), leaves named as JAX names them; the port's ``init_params``
    makes the tree ``params_from_jax`` carries, leaf for leaf, with
    JAX's ``A_log`` and initial values; ``param_count`` equals the
    element count of JAX's tree."""
    jcfg, tcfg = _cfgs()
    jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    tp = tconvert.params_from_jax(tree, tcfg, device="cpu")
    mine = torch_model.init_params(tcfg, seed=0, device="cpu")
    count = sum(int(np.size(a)) for a in jax.tree.leaves(tree))
    assert torch_model.param_count(tp) == torch_model.param_count(
        mine) == count
    shapes = ttree.tree_map(lambda x: tuple(x.shape), mine)
    assert shapes == ttree.tree_map(lambda x: tuple(x.shape), tp)
    for lp in mine["layers"]:
        assert set(lp) == {"norm1", "mixer"}
        assert set(lp["mixer"]) == {"in_proj", "conv_w", "conv_b", "A_log",
                                    "D", "dt_bias", "norm_scale", "out_proj"}
    m, jm = mine["layers"][0]["mixer"], tree["groups"][0]["mixer"]
    for key in ("A_log", "D", "dt_bias", "conv_b", "norm_scale"):
        np.testing.assert_allclose(n(m[key]), jm[key][0], rtol=1e-6,
                                   atol=0, err_msg=key)


def _ssd_inputs(seed, b=2, s=21, h=4, p=8, nst=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            (0.5 * np.abs(rng.standard_normal((b, s, h)))).astype(
                np.float32),
            rng.standard_normal(h).astype(np.float32),
            rng.standard_normal((b, s, nst)).astype(np.float32),
            rng.standard_normal((b, s, nst)).astype(np.float32),
            rng.standard_normal((b, h, p, nst)).astype(np.float32))


@pytest.mark.parametrize("s,chunk,from_h0", [(21, 8, False), (21, 8, True),
                                             (5, 8, True), (24, 8, False)])
def test_ssd_chunked_matches_jax(s, chunk, from_h0):
    """y and the final state within 1e-5 (fp32): S padded to a multiple
    of the chunk (21 in chunks of 8) or shorter than one (5), from zero
    or from a state h0; the exponent mask keeps every value finite."""
    x, dt, a_log, bm, cm, h0 = _ssd_inputs(3, s=s)
    jy, js = jssm._ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bm, cm)),
                               chunk, h0=jnp.asarray(h0) if from_h0 else None)
    ty, ts = tssm._ssd_chunked(*map(t, (x, dt, a_log, bm, cm)), chunk,
                               h0=t(h0) if from_h0 else None)
    assert ty.shape == (2, s, 4, 8) and ts.shape == (2, 4, 8, 16)
    assert torch.isfinite(ty).all()
    _close(ty, jy, TOL["fp32"])
    _close(ts, js, TOL["fp32"])


def test_ssd_chunked_backward_is_finite():
    """The exponent is masked before ``exp``: the gradient through the
    upper triangle is zero, not NaN."""
    x, dt, a_log, bm, cm, _ = _ssd_inputs(4)
    xt = t(x).requires_grad_()
    dtt = t(dt).requires_grad_()
    y, state = tssm._ssd_chunked(xt, dtt, t(a_log), t(bm), t(cm), 8)
    (y.sum() + state.sum()).backward()
    assert torch.isfinite(xt.grad).all() and torch.isfinite(dtt.grad).all()


def _mixer(jcfg, tcfg, seed=4):
    jp, tp = _params(jcfg, tcfg, seed)
    return (jax.tree.map(lambda a: a[0], jp["groups"][0]["mixer"]),
            tp["layers"][0]["mixer"])


@pytest.mark.parametrize("cuts", [(), (3,), (5, 13), (2, 3, 11)])
def test_ssd_forward_resumed_equals_one_call(cuts):
    """``ssd_forward`` over 19 tokens in one call and resumed over calls
    cut at ``cuts`` (one shorter than the conv width): outputs, the conv
    ring (the last 4 raw xBC rows) and the state within 1e-5 of one
    call's, and the one call's cache within 1e-5 of JAX's."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mixer(jcfg, tcfg)
    x = np.random.default_rng(6).standard_normal(
        (2, 19, tcfg.d_model)).astype(np.float32)
    jout, jcache = jssm.ssd_forward(jnp.asarray(x), jp, jcfg,
                                    return_cache=True)
    tout, tcache = tssm.ssd_forward(t(x), tp, tcfg, return_cache=True)
    _close(tout, jout, TOL["fp32"])
    for key in ("state", "conv"):
        assert tcache[key].shape == jcache[key].shape
        _close(tcache[key], jcache[key], TOL["fp32"], key)
    outs, cache = [], None
    for a, b in zip((0,) + cuts, cuts + (19,)):
        out, cache = tssm.ssd_forward(t(x[:, a:b]), tp, tcfg,
                                      return_cache=True, cache=cache)
        outs.append(out)
    _close(torch.cat(outs, dim=1), tout, TOL["fp32"])
    for key in ("state", "conv"):
        _close(cache[key], tcache[key], TOL["fp32"], key)
    # Fewer tokens than the conv width: the ring is left-padded with 0.
    _, short = tssm.ssd_forward(t(x[:, :2]), tp, tcfg, return_cache=True)
    assert torch.equal(short["conv"][:, :2], torch.zeros_like(
        short["conv"][:, :2]))


def test_ssd_decode_window_and_row_valid():
    """A 3-token window equals 3 one-token steps bit for bit (outputs,
    state, ring), and matches JAX's decode step by step; a row whose
    ``row_valid`` is False keeps its state and ring exactly, in place."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mixer(jcfg, tcfg)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    start = tssm.init_ssd_cache(tcfg, 2, torch.float32)
    start["state"].copy_(t(rng.standard_normal(start["state"].shape)
                           .astype(np.float32)))
    start["conv"].copy_(t(rng.standard_normal(start["conv"].shape)
                          .astype(np.float32)))

    def clone(c):
        return {k: v.clone() for k, v in c.items()}

    window, wcache = tssm.ssd_decode(t(x), tp, tcfg, clone(start))
    steps, scache = [], clone(start)
    jcache = {k: jnp.asarray(n(v).astype(np.float32))
              for k, v in start.items()}
    for i in range(3):
        out, scache = tssm.ssd_decode(t(x[:, i:i + 1]), tp, tcfg, scache)
        jout, jcache = jssm.ssd_decode(jnp.asarray(x[:, i:i + 1]), jp, jcfg,
                                       jcache)
        _close(out, jout, TOL["fp32"], str(i))
        steps.append(out)
    assert torch.equal(window, torch.cat(steps, dim=1))
    for key in ("state", "conv"):
        assert torch.equal(wcache[key], scache[key])
        _close(scache[key], jcache[key], TOL["fp32"], key)
    cache = clone(start)
    state_ptr = cache["state"].data_ptr()
    tssm.ssd_decode(t(x), tp, tcfg, cache,
                    row_valid=torch.tensor([True, False]))
    assert cache["state"].data_ptr() == state_ptr
    for key in ("state", "conv"):
        assert torch.equal(cache[key][1], start[key][1])
        assert torch.equal(cache[key][0], wcache[key][0])


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
def test_model_level_logits_match_jax(fmt):
    """``forward`` over 20 tokens, ``prefill`` over 12 and 8 ``decode``
    steps, against JAX's: within 1e-4 in fp32, 2e-2 under the bf16
    compute dtype (``MODEL_TOL``; bf16 rounds the projections' operands,
    the conv ring and the gated norm's output, in both packages alike,
    so the two differ by a few bf16 roundings).  Each decode step's
    logits equal forward's at its position within the same tolerance,
    and the cache keeps its size."""
    kw = {} if fmt == "fp32" else dict(compute_dtype="bfloat16")
    jcfg, tcfg = _cfgs(**kw)
    tol = MODEL_TOL[fmt]
    jp, tp = _params(jcfg, tcfg)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab, (2, 20)).astype(
        np.int32)
    jl, _ = jax_model.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        tl, _ = torch_model.forward(tp, {"tokens": t(toks)}, tcfg)
        _close(tl, jl, tol, "forward")
        jpl, jcache = jax_model.prefill(
            jp, {"tokens": jnp.asarray(toks[:, :12])}, jcfg)
        tpl, tcache = torch_model.prefill(tp, {"tokens": t(toks[:, :12])},
                                          tcfg)
        _close(tpl, jpl, tol, "prefill")
        _close(tpl, tl[:, 11], tol, "prefill vs forward")
        shapes = [{k: tuple(v.shape) for k, v in c.items()}
                  for c in tcache["layers"]]
        dec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, jcfg))
        for i in range(12, 20):
            jdl, jcache = dec(jp, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                                   "pos": jnp.asarray(i)}, jcache)
            tdl, tcache = torch_model.decode(
                tp, {"tokens": t(toks[:, i:i + 1]), "pos": i}, tcache, tcfg)
            _close(tdl, jdl, tol, f"decode {i}")
            _close(tdl, tl[:, i], tol, f"decode {i} vs forward")
        assert [{k: tuple(v.shape) for k, v in c.items()}
                for c in tcache["layers"]] == shapes
        s = tcfg.ssm
        assert shapes[0] == {"state": (2, 2 * 128 // s.head_dim, s.head_dim,
                                       s.d_state),
                             "conv": (2, s.conv_width,
                                      2 * 128 + 2 * s.d_state)}


# -- the serving engine -------------------------------------------------------

_KW = dict(slots=2, cache_len=64, prefill_len=32, page_size=8)


def _prompts(vocab):
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab, k, dtype=np.int32) for k in (30, 9, 25)]


def _serve(engine, request_cls, prompts, max_tokens=6):
    for rid, p in enumerate(prompts):
        engine.submit(request_cls(rid=rid, prompt=p, max_tokens=max_tokens))
    return engine.run(max_steps=300)


def test_engine_matches_jax_engine():
    """3 requests on 2 slots in 8-token chunks (the 30-token prompt spans
    4), so the third prefills while the others decode: the same greedy
    streams, statuses and counters as JAX's synchronous engine; no prefix
    cache (stateful layers), the SSD rows ``row_valid``-guarded."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    prompts = _prompts(jcfg.vocab)
    jeng = _jax_engine(jp, jcfg, async_steps=False, prefill_chunk=8, **_KW)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", prefill_chunk=8,
                                 **_KW)
    assert teng._stateful_rows and not teng._prefix_active
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
    """The contract of ``tests/test_serving.py:311-334``: prompts prefilled
    in 8-token chunks give the streams of one 32-token chunk."""
    _, tcfg = _cfgs()
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    prompts = _prompts(tcfg.vocab)

    def run(chunk):
        eng = tengine.ServingEngine(params, tcfg, device="cpu",
                                    prefill_chunk=chunk, **_KW)
        return {rid: list(r) for rid, r in _serve(
            eng, tengine.Request, prompts).items()}

    assert run(32) == run(8)


def test_speculative_matches_jax_engine():
    """``spec_k=4`` with the weight-shared one-layer draft, the port's
    engine against JAX's speculative engine on the same parameters: the
    same greedy streams (equal to vanilla's), speculative steps, drafts,
    accepted drafts and window histogram (``spec_k_hist``); the SSD rows
    of rejected suffixes restored and replayed."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    prompts = _prompts(jcfg.vocab)
    kw = dict(_KW, prefill_chunk=8, spec_k=4, async_steps=False)
    jeng = _jax_engine(jp, jcfg, **kw)
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", **kw)
    vanilla = tengine.ServingEngine(tp, tcfg, device="cpu",
                                    **dict(kw, spec_k=0))
    jout = _serve(jeng, JRequest, prompts, max_tokens=10)
    tout = _serve(teng, tengine.Request, prompts, max_tokens=10)
    vout = _serve(vanilla, tengine.Request, prompts, max_tokens=10)
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]) == list(vout[rid]), rid
    jm, tm = jeng.metrics(), teng.metrics()
    keys = ("spec_steps", "spec_drafted", "spec_accepted", "spec_emitted",
            "decode_tokens", "spec_k_mean")
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    assert tm["spec_steps"] > 0 and 0.0 < tm["acceptance_rate"] < 1.0
    assert teng.spec_k_hist == jeng.spec_k_hist
    # The rollback point of a row holds every SSD leaf of every layer.
    _, saved = teng._snapshot_rows(teng.cache, [0])
    layers = teng.cache["layers"]
    assert [leaf for leaf, _ in saved] == [layer[k] for layer in layers
                                            for k in ("state", "conv")]


def test_serving_params_pass_ssd_leaves_through():
    """Under the bf16 format the projections are cast to bf16 and the
    SSD's bare tensors kept as they are; the engine serves from them."""
    _, tcfg = _cfgs(format_policy="bf16")
    params = torch_model.init_params(tcfg, seed=0, device="cpu")
    eng = tengine.ServingEngine(params, tcfg, device="cpu", prefill_chunk=8,
                                **_KW)
    mixer = eng.params["layers"][0]["mixer"]
    assert mixer["in_proj"]["w"].dtype == torch.bfloat16
    assert set(eng.params["layers"][0]) == {"norm1", "mixer"}
    for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale"):
        assert mixer[name] is params["layers"][0]["mixer"][name]
    out = _serve(eng, tengine.Request, _prompts(tcfg.vocab)[:2])
    assert all(r.status == "ok" and len(r) == 6 for r in out.values())


def test_loss_and_grads_match_jax():
    """fp32 against JAX's plain path: the loss within 1e-5 relative, each
    gradient leaf (every SSD leaf among them) within 1e-4 relative
    Frobenius error; remat ``"full"`` on the port's side."""
    jcfg, tcfg = _cfgs(remat="none")
    jcfg = dataclasses.replace(jcfg, gemm_backend="xla")
    jp, tp = _params(jcfg, dataclasses.replace(tcfg, remat="full"))
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 16)).astype(
        np.int32)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, {"tokens": jnp.asarray(toks)}, jcfg),
        has_aux=True)(jp)
    tm, tgrads = ttrainer.loss_and_grads(
        tp, {"tokens": t(toks)}, dataclasses.replace(tcfg, remat="full"))
    assert abs(float(tm["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = tconvert.params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                                    device="cpu")
    gp, wp = ttree.paths(tgrads), ttree.paths(want)
    assert gp.keys() == wp.keys()
    assert any("A_log" in str(k) for k in gp)
    worst = {k: float(np.linalg.norm(n(gp[k]) - n(wp[k]))
                      / (np.linalg.norm(n(wp[k])) + 1e-30)) for k in gp}
    assert not {k: v for k, v in worst.items() if not v <= 1e-4}, worst
