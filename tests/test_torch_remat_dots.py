"""``remat="dots"`` on the port, on the CPU: each training layer keeps its
GEMMs' outputs and recomputes the rest in the backward, as JAX's
``jax.checkpoint_policies.checkpoint_dots`` does.

On the ``"torch"`` backend a selective-checkpoint policy keeps the
library's products; on the kernel backend, whose GEMMs launch inside
autograd Functions, a ``GemmStash`` per checkpointed layer call keeps
each Function's output and hands it back in the recompute without a
launch.  Held here: loss and gradients bit-equal to ``"full"``'s and
``"none"``'s on both backends (reduced gemma_2b, and granite_moe_1b for
the grouped expert GEMMs), as many backward GEMM launches as ``"none"``
(``"full"`` recomputes the forward's), JAX's ``remat="dots"`` gradients
at the training tolerances (the loss within 1e-5 relative, each leaf
within 1e-4 relative Frobenius error), and no stash left after a step."""
import dataclasses
import gc
import importlib
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import model as jax_model

from torch_lazy import LazyModule, torch
from torch_parity import n
from test_torch_starcoder2 import _perturb

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tmodel = LazyModule("repro_torch.models.model")
ttrainer = LazyModule("repro_torch.training.trainer")
topt = LazyModule("repro_torch.optim.optimizer")
ttree = LazyModule("repro_torch.tree")
tschedule = LazyModule("repro_torch.graph.schedule")

B, S = 2, 16


def _cfg(arch, backend, **kw):
    return dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               gemm_backend=backend, **kw)


def _tokens(cfg, seed=1):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)))


def _loss_and_grads(params, cfg, tokens):
    leaves = [p.detach().requires_grad_() for p in ttree.leaves(params)]
    it = iter(leaves)
    tree = ttree.tree_map(lambda _: next(it), params)
    loss, _ = tmodel.loss_fn(tree, {"tokens": tokens}, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch,backend", [("gemma_2b", "kernels"),
                                          ("gemma_2b", "torch"),
                                          ("granite_moe_1b", "kernels"),
                                          ("granite_moe_1b", "torch")])
def test_dots_is_bit_equal_to_full_and_none(arch, backend):
    """The loss and every gradient leaf under ``"dots"`` equal those under
    ``"full"`` and ``"none"`` bit for bit."""
    base = _cfg(arch, backend)
    params = tmodel.init_params(base, seed=0, device="cpu")
    tokens = _tokens(base)
    out = {remat: _loss_and_grads(params, dataclasses.replace(
        base, remat=remat), tokens) for remat in ("none", "full", "dots")}
    for remat in ("none", "full"):
        assert torch.equal(out["dots"][0], out[remat][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(out["dots"][1],
                                                     out[remat][1])), remat


@pytest.mark.parametrize("arch", ["gemma_2b", "granite_moe_1b"])
def test_dots_backward_launches_as_many_gemms_as_none(monkeypatch, arch):
    """On the kernel backend the backward of a ``"dots"`` step executes as
    many GEMM plans as one under ``"none"``, where ``"full"`` executes the
    forward's again: the recompute returns the kept outputs."""
    autotune = importlib.import_module("repro_torch.core.autotune")
    real = autotune.execute_plan
    seen = []

    def counted(*args, **kw):
        seen.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(autotune, "execute_plan", counted)
    base = _cfg(arch, "kernels")
    params = tmodel.init_params(base, seed=0, device="cpu")
    tokens = _tokens(base)
    backward = {}
    for remat in ("none", "full", "dots"):
        leaves = [p.detach().requires_grad_() for p in ttree.leaves(params)]
        it = iter(leaves)
        tree = ttree.tree_map(lambda _: next(it), params)
        loss, _ = tmodel.loss_fn(tree, {"tokens": tokens},
                                 dataclasses.replace(base, remat=remat))
        seen.clear()
        torch.autograd.grad(loss, leaves)
        backward[remat] = len(seen)
    assert backward["dots"] == backward["none"] > 0
    assert backward["full"] > backward["none"]


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_dots_grads_match_jax_dots(backend):
    """gemma_2b reduced in fp32 under ``remat="dots"`` against JAX's
    ``xla`` backend under its ``checkpoint_dots``: the loss within 1e-5
    relative, each gradient leaf within 1e-4 relative Frobenius error."""
    jcfg = dataclasses.replace(jget_config("gemma_2b").reduced(),
                               gemm_backend="xla", remat="dots")
    tcfg = _cfg("gemma_2b", backend, remat="dots")
    jp = jax_model.init_params(jax.random.PRNGKey(2), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    _perturb(tree, np.random.default_rng(3))
    tp = tconvert.params_from_jax(tree, tcfg, device="cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, {"tokens": jnp.asarray(tokens)},
                                    jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    tloss, tgrads = _loss_and_grads(tp, tcfg, torch.as_tensor(tokens))
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = ttree.paths(tconvert.params_from_jax(
        jax.tree.map(np.asarray, jgrads), tcfg, device="cpu"))
    it = iter(tgrads)
    got = ttree.paths(ttree.tree_map(lambda _: next(it), tp))
    assert got.keys() == want.keys()
    worst = {k: float(np.linalg.norm(n(got[k]) - n(want[k]))
                      / (np.linalg.norm(n(want[k])) + 1e-30)) for k in got}
    assert max(worst.values()) <= 1e-4, worst


def _stashes(monkeypatch):
    """Every ``GemmStash`` made from now on, weakly."""
    autodiff = importlib.import_module("repro_torch.kernels.autodiff")
    made = []
    init = autodiff.GemmStash.__init__

    def tracked(self):
        init(self)
        made.append(weakref.ref(self))

    monkeypatch.setattr(autodiff.GemmStash, "__init__", tracked)
    return autodiff, made


def test_no_stash_is_left_after_a_step(monkeypatch):
    """A ``"dots"`` train step on the kernel backend makes one stash per
    layer; after the step none is active, each was emptied by its
    recompute, and none outlives the step's graph."""
    autodiff, made = _stashes(monkeypatch)
    cfg = _cfg("gemma_2b", "kernels", remat="dots")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    step = ttrainer.make_train_step(cfg, topt.AdamWConfig(lr=1e-3))
    opt_state = topt.init_opt_state(params)
    params, opt_state, metrics = step(params, opt_state,
                                      {"tokens": _tokens(cfg)})
    assert np.isfinite(float(metrics["loss"]))
    assert len(made) == cfg.n_layers
    assert getattr(autodiff._STASH, "current", None) is None
    assert all(ref() is None or not ref().outs for ref in made)
    gc.collect()
    assert all(ref() is None for ref in made)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_the_stash_never_engages_outside_dots(monkeypatch, remat):
    """Under ``"full"`` and ``"none"``, and in serving, no stash is made:
    the GEMM Functions run exactly as before."""
    _, made = _stashes(monkeypatch)
    cfg = _cfg("gemma_2b", "kernels", remat=remat)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    _loss_and_grads(params, cfg, _tokens(cfg))
    with torch.no_grad():
        tmodel.prefill(params, {"tokens": _tokens(cfg)}, cfg)
    assert made == []


def test_a_stash_replays_in_order_and_checks_shapes():
    """A stash records on its first block and replays on its second,
    checking each output's shape and dtype; a recompute that asks for
    more outputs than were kept raises."""
    autodiff = importlib.import_module("repro_torch.kernels.autodiff")
    stash = autodiff.GemmStash()
    a, b = torch.ones(2, 3), torch.zeros(4)
    with stash.active():
        assert autodiff.stashed(lambda: a, ((2, 3), torch.float32)) is a
        autodiff.stashed(lambda: b, ((4,), torch.float32))
    launched = []
    with stash.active():
        got = autodiff.stashed(lambda: launched.append(1),
                               ((2, 3), torch.float32))
        assert torch.equal(got, a) and not launched
        with pytest.raises(RuntimeError, match="does not match"):
            autodiff.stashed(lambda: b, ((5,), torch.float32))
        with pytest.raises(RuntimeError, match="more GEMMs"):
            autodiff.stashed(lambda: b, ((4,), torch.float32))
    assert not stash.outs
    assert autodiff.stashed(lambda: b, ((4,), torch.float32)) is b
