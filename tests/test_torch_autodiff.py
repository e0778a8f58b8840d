"""The port's autograd through its kernels (``repro_torch.kernels.autodiff``)
against the JAX package's custom VJPs (``repro.kernels.autodiff``), Pallas
in interpret mode: gradients of ``ops.mte_gemm`` in every format with a
full epilogue (α, β·C, bias, softcap, an activation) and on the split-K
route, of ``ops.grouped_gemm`` and of ``ops.flash_attention`` (causal,
window, softcap, GQA); the compiled MLP program's gradients against the
eager ones (``tests/test_graph.py:311-331`` in JAX); and the serving path
untouched by autograd.

Tolerance: the backward runs on the full-precision residuals in every
format (the straight-through estimator), so the gradients of both
packages are f32 products of the same operands: within
``GRAD_TOL`` = 1e-5 relative to the largest entry.  The forward outputs
keep each format's model tolerance (``MODEL_TOL``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import autotune as jautotune
from repro.core.epilogue import Epilogue as JEpilogue
from repro.kernels import ops as jops

from torch_lazy import LazyModule, torch
from torch_parity import MODEL_TOL, n, t

tautotune = LazyModule("repro_torch.core.autotune")
tepilogue = LazyModule("repro_torch.core.epilogue")
tconfigs = LazyModule("repro_torch.configs")
tautodiff = LazyModule("repro_torch.kernels.autodiff")
tops = LazyModule("repro_torch.kernels.ops")
tlayers = LazyModule("repro_torch.models.layers")
tmodel = LazyModule("repro_torch.models.model")
tschedule = LazyModule("repro_torch.graph.schedule")
ttree = LazyModule("repro_torch.tree")

GRAD_TOL = 1e-5
FORMATS = ("fp32", "bf16", "bf16acc", "int8")
EPI = dict(alpha=0.7, beta=0.5, has_bias=True, softcap=3.0,
           activation="gelu")


@pytest.fixture(autouse=True)
def fresh_caches():
    jautotune.reset_cache()
    tautotune.reset_cache()
    tschedule.reset_programs()
    yield
    jautotune.reset_cache()


def _arr(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _rel(got, want) -> float:
    got, want = n(got), n(want)
    return float(np.abs(got - want).max() / (1e-12 + np.abs(want).max()))


def _torch_grads(fn, *arrays):
    leaves = [t(a).requires_grad_() for a in arrays]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("m,n_,k", [(24, 40, 72), (4, 64, 1024)],
                         ids=["mte", "splitk"])
def test_mte_gemm_grads_match_jax(fmt, m, n_, k):
    """d(a, b, C, bias) of Σ ct · epilogue(a @ b, C, bias): (4, 64, 1024)
    is planned split-K in both packages."""
    rng = np.random.default_rng(1)
    a, b = _arr(rng, m, k, scale=k ** -0.5), _arr(rng, k, n_)
    c, bias, ct = _arr(rng, m, n_), _arr(rng, n_), _arr(rng, m, n_)
    jepi, tepi = JEpilogue(**EPI), tepilogue.Epilogue(**EPI)

    def jloss(a_, b_, c_, bias_):
        return jnp.sum(jops.mte_gemm(a_, b_, c_, bias_, epilogue=jepi,
                                     format_policy=fmt) * ct)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(a, b, c, bias)
    plan = tautotune.get_plan(m, n_, k, torch.float32, torch.float32)
    if k == 1024:
        assert plan.route == "splitk"

    def tloss(a_, b_, c_, bias_):
        return (tops.mte_gemm(a_, b_, c_, bias_, epilogue=tepi,
                              format_policy=fmt) * t(ct)).sum()

    out, tgrads = _torch_grads(tloss, a, b, c, bias)
    loss = float(out.detach())
    assert abs(loss - float(jloss(a, b, c, bias))) <= \
        MODEL_TOL[fmt] * (1 + abs(loss))
    for name, got, want in zip("a b c bias".split(), tgrads, jgrads):
        assert _rel(got, want) < GRAD_TOL, name


def test_mte_gemm_backward_gemms_plan_themselves():
    """The backward's GEMMs ask the plan cache for f32 plans of their own
    shapes: the recompute (M, N, K), dA (M, K, N) and dB (K, N, M); a
    linear epilogue launches no recompute."""
    m, n_, k = 24, 40, 72
    for epi, want in ((tepilogue.Epilogue(activation="gelu"), 3),
                      (tepilogue.Epilogue(has_bias=True), 2)):
        tautotune.reset_cache()
        a = torch.randn(m, k).to(torch.bfloat16).requires_grad_()
        b = torch.randn(k, n_, requires_grad=True)
        bias = torch.randn(n_, requires_grad=True)
        out = tops.mte_gemm(a, b, bias=bias if epi.has_bias else None,
                            epilogue=epi, format_policy="bf16")
        before = set(tautotune.plan_cache()._plans)
        torch.autograd.grad(out.float().sum(), [a, b])
        sigs = set(tautotune.plan_cache()._plans) - before
        shapes = {(s.m, s.n, s.k) for s in sigs}
        assert all(s.dtype_in == "float32" for s in sigs)
        assert {(m, k, n_), (k, n_, m)} <= shapes and len(shapes) == want


def test_grouped_gemm_grads_match_jax():
    rng = np.random.default_rng(2)
    x, w = _arr(rng, 3, 8, 40, scale=40 ** -0.5), _arr(rng, 3, 40, 24)
    ct = _arr(rng, 3, 8, 24)
    jepi = JEpilogue(activation="silu")

    def jloss(x_, w_):
        return jnp.sum(jops.grouped_gemm(x_, w_, epilogue=jepi) * ct)

    jgrads = jax.grad(jloss, argnums=(0, 1))(x, w)
    tepi = tepilogue.Epilogue(activation="silu")
    _, tgrads = _torch_grads(
        lambda x_, w_: (tops.grouped_gemm(x_, w_, epilogue=tepi)
                        * t(ct)).sum(), x, w)
    for got, want in zip(tgrads, jgrads):
        assert _rel(got, want) < GRAD_TOL


def test_grouped_gemm_grads_ignore_padded_columns():
    """Columns past a member's width come back as zeros whatever x and w
    hold: their cotangent reaches neither operand."""
    x = torch.randn(2, 4, 16, requires_grad=True)
    w = torch.randn(2, 16, 12, requires_grad=True)
    out = tops.grouped_gemm(x, w, widths=(12, 5))
    assert float(out[1, :, 5:].detach().abs().max()) == 0.0
    gx, gw = torch.autograd.grad(out.sum(), [x, w])
    live = torch.ones(2, 12)
    live[1, 5:] = 0
    wt = w.detach().transpose(1, 2)
    want_x = torch.ones(2, 4, 12) * live[:, None] @ wt
    torch.testing.assert_close(gx, want_x, rtol=1e-5, atol=1e-5)
    assert float(gw[1, :, 5:].abs().max()) == 0.0


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=5),
                                dict(causal=True, softcap=4.0),
                                dict(causal=False, window=None)],
                         ids=["causal", "window", "softcap", "full"])
def test_flash_attention_grads_match_jax(kw):
    """GQA 4/2 heads, 8 queries right-aligned to 16 keys."""
    rng = np.random.default_rng(3)
    q, k, v = (_arr(rng, 1, 4, 8, 32), _arr(rng, 1, 2, 16, 32),
               _arr(rng, 1, 2, 16, 32))
    ct = _arr(rng, 1, 4, 8, 32)

    def jloss(q_, k_, v_):
        return jnp.sum(jops.flash_attention(q_, k_, v_, **kw) * ct)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    _, tgrads = _torch_grads(
        lambda q_, k_, v_: (tops.flash_attention(q_, k_, v_, **kw)
                            * t(ct)).sum(), q, k, v)
    for got, want in zip(tgrads, jgrads):
        assert _rel(got, want) < GRAD_TOL


def _mlp_cfg(fmt):
    return dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                               format_policy=fmt)


@pytest.mark.parametrize("fmt", FORMATS + ("int8pt",))
def test_compiled_mlp_grads_match_eager(fmt):
    """The compiled MLP program (gate and up grouped into one B3 launch)
    differentiates to the eager path's gradients (JAX's
    ``test_compiled_mlp_grad_parity``; its tolerances)."""
    cfg = _mlp_cfg(fmt)
    gen = torch.Generator().manual_seed(0)
    p = tlayers.init_mlp(gen, cfg, device="cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=gen)
    ct = torch.randn(2, 8, cfg.d_model, generator=gen)

    def grads(cfg_):
        leaves = [x.clone().requires_grad_()] + [
            p[k]["w"].clone().requires_grad_() for k in ("gate", "up",
                                                         "down")]
        pp = {k: {"w": w} for k, w in zip(("gate", "up", "down"),
                                          leaves[1:])}
        out = tlayers.mlp(leaves[0], pp, cfg_)
        return torch.autograd.grad((out.float() * ct).sum(), leaves)

    eager = grads(dataclasses.replace(cfg, use_graph=False))
    compiled = grads(cfg)
    progs = tschedule.compiled_programs()
    assert progs and all(prog.grouped for prog in progs)
    tol = 0.05 if fmt == "bf16acc" else 2e-3
    for got, want in zip(compiled, eager):
        assert _rel(got, want) < tol


def test_serving_runs_no_autograd(monkeypatch):
    """With parameters that do not require grad (every serving path),
    ``ops`` never enters an autograd Function, grad mode on or off, and
    launches the same kernel calls in the same order."""
    calls = []
    for name in ("MteGemm", "GroupedGemm", "FlashAttention"):
        monkeypatch.setattr(getattr(tautodiff, name), "apply",
                            lambda *a, _n=name: calls.append(_n))
    from repro_torch.core import autotune as ta
    real = ta.execute_plan
    launched = []

    def record(plan, a, b, *rest, **kw):
        launched.append((plan.route, tuple(a.shape), tuple(b.shape)))
        return real(plan, a, b, *rest, **kw)

    monkeypatch.setattr(ta, "execute_plan", record)
    cfg = dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                              n_layers=2)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 8),
                           generator=torch.Generator().manual_seed(0))
    runs = []
    for grad in (True, False):
        launched.clear()
        with torch.set_grad_enabled(grad):
            logits, _ = tmodel.prefill(params, {"tokens": tokens}, cfg)
        runs.append((list(launched), logits))
    assert not calls
    assert runs[0][0] == runs[1][0] and runs[0][0]
    assert torch.equal(runs[0][1], runs[1][1])


def test_remat_recompute_is_bit_equal():
    """``remat="full"`` recomputes each layer in the backward on the same
    plans and programs: the gradients equal those of ``remat="none"`` bit
    for bit, and the recompute compiles no new program."""
    base = dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                               n_layers=2)
    params = tmodel.init_params(base, seed=0, device="cpu")
    tokens = torch.randint(0, base.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    out = []
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        leaves = [p.detach().requires_grad_()
                  for p in ttree.leaves(params)]
        it = iter(leaves)
        tree = ttree.tree_map(lambda _: next(it), params)
        loss, _ = tmodel.loss_fn(tree, {"tokens": tokens}, cfg)
        compiles = tschedule.program_stats()["compiles"]
        grads = torch.autograd.grad(loss, leaves)
        assert tschedule.program_stats()["compiles"] == compiles
        out.append((loss.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_remat_dots_is_refused():
    cfg = dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                              n_layers=1, remat="dots")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    leaf = params["final_norm"]["scale"].requires_grad_()
    with pytest.raises(NotImplementedError, match="A11"):
        tmodel.loss_fn(params, {"tokens": torch.zeros(1, 4,
                                                      dtype=torch.long)},
                       cfg)
    leaf.requires_grad_(False)
    # Without autograd no layer is differentiated, so remat is not read.
    with torch.no_grad():
        tmodel.loss_fn(params, {"tokens": torch.zeros(1, 4,
                                                      dtype=torch.long)},
                       cfg)

