"""The port's ``"torch"`` GEMM backend (the counterpart of JAX's ``"xla"``,
the reference's default) against the JAX package, on the CPU.

JAX runs its ``xla`` backend in fp32 (plain jnp); the port runs
``gemm_backend="torch"``: the library's products and the plain attention,
no kernel.  Both get JAX's parameters (``convert.params_from_jax``,
biases and norm parameters drawn away from zero and one) and the same
inputs from a numpy seed.  Tolerances (fixed before the runs):
``MODEL_TOL["fp32"]`` for logits; the loss within 1e-5 relative and each
gradient leaf within 1e-4 relative Frobenius error, as
``tests/test_torch_training.py`` holds the kernels' gradients; the
reference's own decode-consistency contract (3e-3, 8e-3) on the port
alone; the chunked attention within 1e-5 of JAX's and of the unchunked
form."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import model as jax_model

from torch_lazy import LazyModule, torch
from torch_parity import MODEL_TOL, n, t
from test_torch_starcoder2 import _perturb

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tmodel = LazyModule("repro_torch.models.model")
tattn = LazyModule("repro_torch.models.attention")
ttrainer = LazyModule("repro_torch.training.trainer")
topt = LazyModule("repro_torch.optim.optimizer")
tengine = LazyModule("repro_torch.serving.engine")
tlaunch = LazyModule("repro_torch.launch.train")
ttree = LazyModule("repro_torch.tree")

B, S, EXTRA = 2, 24, 3


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               gemm_backend="xla", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               gemm_backend="torch", **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=2):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    _perturb(tree, np.random.default_rng(seed + 1))
    return (jax.tree.map(jnp.asarray, tree),
            tconvert.params_from_jax(tree, tcfg, device="cpu"))


def _inputs(cfg, total, seed=5):
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


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_level_matches_jax_xla(arch):
    """``forward`` over 27 positions, ``prefill`` over 24 into caches of 31
    slots, then 3 ``decode`` steps: every logit within
    ``MODEL_TOL["fp32"]`` of JAX's ``xla`` backend."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    tol = MODEL_TOL["fp32"]
    total = S + EXTRA
    data = _inputs(jcfg, total)
    fwd = jax.jit(lambda p, b: jax_model.forward(p, b, jcfg)[0])
    pre = jax.jit(lambda p, b: jax_model.prefill(p, b, jcfg,
                                                 cache_len=total + 4))
    dec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, jcfg))
    want = fwd(jp, _batch(jcfg, data, 0, total, "jax"))
    got, _ = tmodel.forward(tp, _batch(tcfg, data, 0, total, "torch"), tcfg)
    np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol,
                               err_msg="forward")
    jl, jcache = pre(jp, _batch(jcfg, data, 0, S, "jax"))
    tl, tcache = tmodel.prefill(tp, _batch(tcfg, data, 0, S, "torch"), tcfg,
                                cache_len=total + 4)
    np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                               err_msg="prefill")
    for i in range(EXTRA):
        pos = np.int32(S + i)
        jl, jcache = dec(jp, _batch(jcfg, data, S + i, S + i + 1, "jax",
                                    pos=pos), jcache)
        tl, tcache = tmodel.decode(
            tp, _batch(tcfg, data, S + i, S + i + 1, "torch", pos=pos),
            tcache, tcfg)
        np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_consistency_contract_on_the_port(arch):
    """``tests/test_decode_consistency.py``'s contract on the port's
    ``"torch"`` backend alone: prefill's logits within 3e-3 of forward's
    at the last prompt position, each of 3 decode steps within 8e-3 of
    forward's at its position."""
    _, tcfg = _cfgs(arch)
    params = tmodel.init_params(tcfg, seed=2, device="cpu")
    total = S + EXTRA
    data = _inputs(tcfg, total, seed=2)
    full, _ = tmodel.forward(params, _batch(tcfg, data, 0, total, "torch"),
                             tcfg)
    logits, cache = tmodel.prefill(params, _batch(tcfg, data, 0, S, "torch"),
                                   tcfg, cache_len=total + 4)
    np.testing.assert_allclose(n(logits), n(full[:, S - 1]), rtol=3e-3,
                               atol=3e-3)
    for i in range(EXTRA):
        logits, cache = tmodel.decode(
            params, _batch(tcfg, data, S + i, S + i + 1, "torch",
                           pos=np.int32(S + i)), cache, tcfg)
        np.testing.assert_allclose(n(logits), n(full[:, S + i]), rtol=8e-3,
                                   atol=8e-3)


def _attention_inputs(sq, skv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 1, sq, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1, skv, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1, skv, 16)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window,softcap", [(None, None), (600, 30.0)])
def test_chunked_attention_matches_jax_and_the_unchunked_form(
        monkeypatch, window, softcap):
    """Past 2048 kv positions the plain attention scans chunks of
    ``attn_chunk`` (256 here, 2300 positions: the last chunk padded with
    masked positions): within 1e-5 of JAX's scan and of the unchunked
    form in fp32, the queries right-aligned (causal) and, for two
    queries, at explicit positions with keys masked out (−1)."""
    sq, skv = 40, 2300
    q, k, v = _attention_inputs(sq, skv)
    kw = dict(causal=True, window=window, softcap=softcap, scale=0.25)
    want = jattn._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), chunk=256, **kw)
    got = tattn._xla_attention(t(q), t(k), t(v), chunk=256, **kw)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
    kvp = np.arange(skv)[None].copy()
    kvp[0, ::7] = -1
    qp = np.array([[skv - 1, 1000]])
    pos = dict(kv_positions=kvp, q_positions=qp)
    want_p = jattn._xla_attention(
        jnp.asarray(q[:, :, :2]), jnp.asarray(k), jnp.asarray(v), chunk=256,
        **{k_: jnp.asarray(v_) for k_, v_ in pos.items()}, **kw)
    got_p = tattn._xla_attention(t(q[:, :, :2]), t(k), t(v), chunk=256,
                                 **{k_: t(v_) for k_, v_ in pos.items()},
                                 **kw)
    np.testing.assert_allclose(n(got_p), n(want_p), rtol=1e-5, atol=1e-5)
    monkeypatch.setattr("repro_torch.models.attention._CHUNK_THRESHOLD",
                        1 << 30)
    plain = tattn._xla_attention(t(q), t(k), t(v), chunk=256, **kw)
    np.testing.assert_allclose(n(got), n(plain), rtol=1e-5, atol=1e-5)


def test_chunked_attention_gradients_match_the_unchunked_form(monkeypatch):
    """Under autograd each chunk runs under ``torch.utils.checkpoint``: the
    gradients of q, k and v equal the unchunked form's within 1e-5."""
    q, k, v = (t(a).requires_grad_() for a in _attention_inputs(8, 2100, 3))
    kw = dict(causal=True, window=None, softcap=None, scale=0.25, chunk=512)
    grads = torch.autograd.grad(tattn._xla_attention(q, k, v, **kw).square()
                                .sum(), (q, k, v))
    monkeypatch.setattr("repro_torch.models.attention._CHUNK_THRESHOLD",
                        1 << 30)
    plain = torch.autograd.grad(tattn._xla_attention(q, k, v, **kw).square()
                                .sum(), (q, k, v))
    for got, want in zip(grads, plain):
        np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def test_attn_chunk_is_read(monkeypatch):
    """The model's attention passes ``cfg.attn_chunk`` to the scan."""
    seen = []
    real = tattn._chunked_attention

    def spy(*args, chunk, **kw):
        seen.append(chunk)
        return real(*args, chunk=chunk, **kw)

    monkeypatch.setattr("repro_torch.models.attention._chunked_attention",
                        spy)
    _, tcfg = _cfgs("gemma_2b", attn_chunk=512)
    tcfg = dataclasses.replace(tcfg, n_layers=1, vocab=64)
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    tmodel.forward(params, {"tokens": torch.zeros(1, 2100,
                                                  dtype=torch.int64)}, tcfg)
    assert seen == [512]


def _frobenius(got, want) -> float:
    got, want = n(got), n(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b",
                                  "granite_moe_1b"])
def test_loss_and_grads_match_jax_grad(arch):
    """``loss_fn`` and its gradients on the ``"torch"`` backend against
    ``jax.grad`` of JAX's ``xla`` backend (not the kernels'
    straight-through backward): the loss within 1e-5 relative, each
    gradient leaf within 1e-4 relative Frobenius error."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    data = _inputs(tcfg, S, seed=7)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, {"tokens": jnp.asarray(data)}, jcfg),
        has_aux=True))(jp)
    metrics, tgrads = ttrainer.loss_and_grads(
        tp, {"tokens": torch.as_tensor(data)}, tcfg)
    assert abs(float(metrics["loss"]) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    want = ttree.paths(tconvert.params_from_jax(
        jax.tree.map(np.asarray, jgrads), tcfg, device="cpu"))
    got = ttree.paths(tgrads)
    assert got.keys() == want.keys()
    worst = {k: _frobenius(got[k], want[k]) for k in got}
    assert max(worst.values()) <= 1e-4, worst


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_one_train_step_on_the_torch_backend(arch):
    """``tests/test_models_smoke.py``'s one-train-step contract on the
    ``"torch"`` backend: a finite loss between 0.5 and 3 × ln(vocab) at
    random init, parameters that change, the optimizer's step at 1."""
    _, tcfg = _cfgs(arch)
    params = tmodel.init_params(tcfg, seed=1, device="cpu")
    before = [p.clone() for p in ttree.leaves(params)]
    opt_state = topt.init_opt_state(params)
    step = ttrainer.make_train_step(tcfg, topt.AdamWConfig(lr=1e-3,
                                                           total_steps=10))
    rng = np.random.default_rng(1)
    if tcfg.frontend_stub:
        batch = {"embeddings": torch.as_tensor(0.1 * rng.standard_normal(
                     (B, 32, tcfg.d_model)).astype(np.float32)),
                 "targets": torch.as_tensor(rng.integers(
                     0, tcfg.vocab, (B, 32)))}
    else:
        batch = {"tokens": torch.as_tensor(rng.integers(0, tcfg.vocab,
                                                        (B, 32)))}
    params, opt_state, metrics = step(params, opt_state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    assert 0.5 * np.log(tcfg.vocab) < loss < 3.0 * np.log(tcfg.vocab)
    assert sum(float((a - b).abs().sum())
               for a, b in zip(ttree.leaves(params), before)) > 0
    assert int(opt_state["step"]) == 1


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 16, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, 8,
                                               dtype=np.int32)]),
            rng.integers(0, vocab, 20, dtype=np.int32),
            np.concatenate([head, rng.integers(0, vocab, 4,
                                               dtype=np.int32)])]


def _serve(tcfg, params, prompts, **kw):
    eng = tengine.ServingEngine(params, tcfg, device="cpu", slots=2,
                                cache_len=64, prefill_len=32, page_size=8,
                                prefill_chunk=16, **kw)
    for rid, p in enumerate(prompts):
        eng.submit(tengine.Request(rid=rid, prompt=p, max_tokens=6))
    out = eng.run()
    assert all(r.status == "ok" for r in out.values())
    return eng, {rid: list(r) for rid, r in out.items()}


def _greedy(params, tcfg, prompt, steps, window=32):
    """Greedy tokens of the model-level path: ``prefill`` then ``decode``
    over its flat caches, from the prompt left-padded to the engine's
    prefill window, as the engine reads it."""
    prompt = np.pad(prompt, (window - len(prompt), 0))
    logits, cache = tmodel.prefill(
        params, {"tokens": torch.as_tensor(prompt[None].astype(np.int64))},
        tcfg, cache_len=len(prompt) + steps)
    out = [int(logits[0].argmax())]
    for i in range(steps - 1):
        logits, cache = tmodel.decode(
            params, {"tokens": torch.tensor([[out[-1]]]),
                     "pos": np.int32(len(prompt) + i)}, cache, tcfg)
        out.append(int(logits[0].argmax()))
    return out


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
def test_engine_streams_equal_the_model_level_greedy_decode(arch):
    """The engine on the ``"torch"`` backend (no grouped q/k/v, no graph
    programs): greedy streams equal to the model-level path's for each
    prompt, and bit-identical with async steps on and off and with
    speculation (``spec_k=4``, a one-period draft) on and off."""
    _, tcfg = _cfgs(arch)
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    prompts = _prompts(tcfg.vocab)
    eng, sync = _serve(tcfg, params, prompts, async_steps=False)
    assert not eng.cfg.decode_qkv_grouped
    assert all("qkv" not in lp["mixer"] for lp in eng.params["layers"])
    for rid, p in enumerate(prompts):
        assert sync[rid] == _greedy(params, tcfg, p, 6), rid
    _, asyn = _serve(tcfg, params, prompts, async_steps=True)
    spec_eng, spec = _serve(tcfg, params, prompts, async_steps=False,
                            spec_k=4)
    assert spec_eng.metrics()["spec_steps"] > 0
    assert sync == asyn == spec


def test_torch_backend_calls_no_kernel(monkeypatch):
    """No call reaches ``kernels.ops`` on the ``"torch"`` backend: a
    forward and backward, prefill and decode, and an engine's run
    (gemma_2b and granite_moe_1b reduced), counted by wrapping every
    public function of the module."""
    calls = []
    ops = importlib.import_module("repro_torch.kernels.ops")
    for name in ops.__all__:
        fn = getattr(ops, name)
        if callable(fn):
            monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=fn, **k: (
                calls.append(_n), _f(*a, **k))[1])
    for arch in ("gemma_2b", "granite_moe_1b"):
        _, tcfg = _cfgs(arch)
        params = tmodel.init_params(tcfg, seed=0, device="cpu")
        data = torch.as_tensor(_inputs(tcfg, 12))
        ttrainer.loss_and_grads(params, {"tokens": data}, tcfg)
        _, cache = tmodel.prefill(params, {"tokens": data}, tcfg,
                                  cache_len=16)
        tmodel.decode(params, {"tokens": data[:, :1], "pos": np.int32(12)},
                      cache, tcfg)
        _serve(tcfg, params, _prompts(tcfg.vocab)[:2], async_steps=False)
    assert calls == []


def test_unknown_backend_raises():
    """The port's backends are ``"kernels"`` and ``"torch"``; JAX's names
    and any other raise ValueError."""
    for name in ("pallas", "xla", "bogus"):
        with pytest.raises(ValueError, match="gemm_backend"):
            dataclasses.replace(tconfigs.get_config("gemma_2b"),
                                gemm_backend=name)


def test_train_launcher_runs_the_torch_backend(capsys):
    """``launch/train.py --gemm-backend torch`` trains reduced gemma_2b
    for 2 steps on the CPU."""
    tlaunch.main(["--arch", "gemma_2b", "--reduced", "--steps", "2",
                  "--batch", "2", "--seq", "16", "--device", "cpu",
                  "--gemm-backend", "torch"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out and "[train] step 1 loss" in out


def test_the_accountant_records_each_library_product_unplanned():
    """Each product on the ``"torch"`` backend is one ``unplanned`` record
    with ``policy`` and ``backend`` ``"torch"`` (JAX records ``"xla"``),
    and no plan is consulted: a decode step of reduced gemma_2b records
    its 7 projections a layer, granite_moe_1b's its 4 and 3 grouped
    expert products, and the plan cache stays empty."""
    acct_mod = importlib.import_module("repro_torch.telemetry.gemm_account")
    autotune = importlib.import_module("repro_torch.core.autotune")
    for arch, dense_per_layer, grouped_per_layer in (
            ("gemma_2b", 7, 0), ("granite_moe_1b", 4, 3)):
        _, tcfg = _cfgs(arch)
        params = tmodel.init_params(tcfg, seed=0, device="cpu")
        data = torch.as_tensor(_inputs(tcfg, 8))
        _, cache = tmodel.prefill(params, {"tokens": data}, tcfg,
                                  cache_len=12)
        autotune.reset_cache()
        with acct_mod.account_gemms() as acct:
            tmodel.decode(params, {"tokens": data[:, :1],
                                   "pos": np.int32(8)}, cache, tcfg)
        assert len(autotune.plan_cache()._plans) == 0
        kinds = [r.kind for r in acct.records]
        assert kinds.count("gemm") == dense_per_layer * tcfg.n_layers
        assert kinds.count("grouped") == grouped_per_layer * tcfg.n_layers
        assert all(r.policy == "torch" and r.backend == "torch"
                   and r.plan_source == "unplanned" for r in acct.records)
