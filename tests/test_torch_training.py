"""The port's training path against the JAX package, on the CPU: the loss
and its gradients for every ported architecture (``model.loss_fn``),
``adamw_update``, one and three train steps (``make_train_step``),
microbatching, the data stream, checkpoints, the watchdog and supervisor,
and ``train_loop``'s contracts (``tests/test_training_loop.py``).

JAX runs its ``xla`` backend (plain jnp) in fp32 where the point is the
arithmetic, and its ``pallas`` backend in interpret mode for gemma_2b's
kernel path; the port runs its kernels' plain versions.  Both get the
same parameters (``convert.params_from_jax``, biases and norm
parameters drawn away from zero and one) and the same inputs from a numpy
seed.  Tolerances (fixed before the runs): against ``xla`` the loss
within 1e-5 relative, each gradient leaf within 1e-4 relative Frobenius
error, the parameters after 3 AdamW steps within 1e-5 absolute,
``adamw_update`` within 1e-6; against ``pallas`` 2e-3 per leaf.

The reference's own ``train_loop`` fails in its mesh path on this CPU
(``ROADMAP.md`` §C), so the port's ``train_loop`` is held to the
contracts those tests assert, not to their verdicts."""
import dataclasses
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import model as jax_model
from repro.optim import optimizer as jopt
from repro.training.trainer import make_train_step as jmake_train_step

from torch_lazy import LazyModule, torch
from torch_parity import n, t
from test_torch_starcoder2 import _perturb

tconfigs = LazyModule("repro_torch.configs")
tconvert = LazyModule("repro_torch.convert")
tmodel = LazyModule("repro_torch.models.model")
topt = LazyModule("repro_torch.optim.optimizer")
ttrainer = LazyModule("repro_torch.training.trainer")
tdata = LazyModule("repro_torch.data.pipeline")
tckpt = LazyModule("repro_torch.checkpoint.manager")
tfault = LazyModule("repro_torch.distributed.fault")
tlaunch = LazyModule("repro_torch.launch.train")
ttree = LazyModule("repro_torch.tree")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["gemma_2b", "recurrentgemma_9b", "gemma2_27b", "qwen15_4b",
         "starcoder2_7b", "musicgen_medium"]
B, S = 2, 24


def _cfgs(arch, backend="xla", **kw):
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               gemm_backend=backend, **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(), **kw)
    return jcfg, tcfg


def _tiny(**kw):
    """The reference's ``_tiny_cfg`` (``tests/test_training_loop.py``)."""
    shape = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2,
                 n_kv_heads=1, head_dim=32)
    return (dataclasses.replace(jget_config("gemma_2b").reduced(), **shape),
            dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                                **shape, **kw))


def _params(jcfg, tcfg, seed=2):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    _perturb(tree, np.random.default_rng(seed + 1))
    return (jax.tree.map(jnp.asarray, tree),
            tconvert.params_from_jax(tree, tcfg, device="cpu"))


def _batch(cfg, seed=5, batch=B, seq=S):
    """numpy tokens, or frame embeddings and targets under the stub."""
    rng = np.random.default_rng(seed)
    if cfg.frontend_stub:
        return {"embeddings": (0.5 * rng.standard_normal(
                    (batch, seq, cfg.d_model))).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab, (batch, seq)
                                        ).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq)
                                   ).astype(np.int32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def _as_port(tree, tcfg):
    """A JAX params-shaped tree (grads, m, v) in the port's layout."""
    return tconvert.params_from_jax(jax.tree.map(np.asarray, tree), tcfg,
                                    device="cpu")


def _frobenius(got, want) -> float:
    got, want = n(got), n(want)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _assert_trees(got, want, tol, measure=_frobenius):
    gp, wp = ttree.paths(got), ttree.paths(want)
    assert gp.keys() == wp.keys()
    worst = {k: measure(gp[k], wp[k]) for k in gp}
    bad = {k: v for k, v in worst.items() if not v <= tol}
    assert not bad, bad


def _max_abs(got, want) -> float:
    return float(np.abs(n(got) - n(want)).max())


# -- the loss and its gradients ----------------------------------------------


def _loss_case(arch, backend, remat="none", seed=2):
    jcfg, tcfg = _cfgs(arch, backend)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    jp, tp = _params(jcfg, tcfg, seed)
    batch = _batch(tcfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, _jbatch(batch), jcfg),
        has_aux=True)(jp)
    tm, tgrads = ttrainer.loss_and_grads(tp, _tbatch(batch), tcfg)
    return (float(jloss), float(jm["tokens"]), _as_port(jgrads, tcfg),
            float(tm["loss"]), float(tm["tokens"]), tgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_xla(arch):
    """fp32: loss within 1e-5 relative, each gradient leaf within 1e-4
    relative Frobenius error (remat ``"full"`` for gemma_2b and
    recurrentgemma_9b: the recompute must not move them)."""
    remat = "full" if arch in ("gemma_2b", "recurrentgemma_9b") else "none"
    jl, jtok, jg, tl, ttok, tg = _loss_case(arch, "xla", remat)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert ttok == jtok
    _assert_trees(tg, jg, 1e-4)


def test_loss_and_grads_match_jax_pallas_gemma():
    """gemma_2b on JAX's kernel path (Pallas, interpret mode, its custom
    VJPs and compiled programs): 2e-3 per leaf."""
    jl, _, jg, tl, _, tg = _loss_case("gemma_2b", "pallas", "full")
    assert abs(tl - jl) <= 2e-3 * abs(jl)
    _assert_trees(tg, jg, 2e-3)


def test_loss_masks_the_last_position():
    """Position i predicts token i + 1 and the last position is out of
    the mean (``tokens`` counts B·(S−1)): the mean negative
    log-likelihood of ``log_softmax`` at the targets."""
    _, tcfg = _cfgs("gemma_2b")
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    batch = _tbatch(_batch(tcfg))
    with torch.no_grad():
        loss, m = tmodel.loss_fn(params, batch, tcfg)
        logits, _ = tmodel.forward(params, batch, tcfg)
    lp = torch.log_softmax(logits, -1)
    toks = batch["tokens"].long()
    want = -lp[:, :-1].gather(-1, toks[:, 1:, None]).mean()
    assert float(m["tokens"]) == B * (S - 1)
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)


# -- AdamW -------------------------------------------------------------------


def test_adamw_update_matches_jax():
    """Three updates of a tree with matrices (decayed) and vectors (not),
    the second clipped: params, m, v, grad norm and lr within 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "layers": [{"k": (4, 3, 2)}]}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5)
    jcfg, tcfg_ = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp)
    tp = ttree.tree_map(t, params)
    ts = topt.init_opt_state(tp)
    for i, scale in enumerate((0.1, 50.0, 1.0)):
        grads = jax.tree.map(lambda p: (scale * rng.standard_normal(
            p.shape)).astype(np.float32), params)
        jp, js, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                       js, jcfg)
        tp, ts, tm = topt.adamw_update(tp, ttree.tree_map(t, grads), ts,
                                       tcfg_)
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-6 * max(
                1.0, abs(float(jm[key])))
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            _assert_trees(got, jax.tree.map(np.asarray, want), 1e-6,
                          _max_abs)


# -- train steps -------------------------------------------------------------


def _steps_case(n_steps, microbatches=1):
    jcfg, tcfg = _tiny()
    jp, tp = _params(jcfg, tcfg, seed=0)
    opt = dict(lr=1e-3)
    jstep = jax.jit(jmake_train_step(jcfg, jopt.AdamWConfig(**opt),
                                     microbatches))
    tstep = ttrainer.make_train_step(tcfg, topt.AdamWConfig(**opt),
                                     microbatches)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    losses = []
    for i in range(n_steps):
        batch = _batch(tcfg, seed=10 + i, batch=8, seq=32)
        jp, js, jm = jstep(jp, js, _jbatch(batch))
        tp, ts, tm = tstep(tp, ts, _tbatch(batch))
        losses.append((float(tm["loss"]), float(jm["loss"]),
                       float(tm["grad_norm"]), float(jm["grad_norm"])))
    return losses, tp, _as_port(jp, tcfg)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(n_steps):
    """``make_train_step`` against JAX's (jitted, xla backend, fp32): each
    step's loss within 1e-5 relative, its grad norm within 1e-5, the
    parameters after the steps within 1e-5 absolute."""
    losses, tp, jp = _steps_case(n_steps)
    for tl, jl, tg, jg in losses:
        assert abs(tl - jl) <= 1e-5 * abs(jl)
        assert abs(tg - jg) <= 1e-5 * abs(jg)
    _assert_trees(tp, jp, 1e-5, _max_abs)


def test_microbatching_matches_full_batch():
    """Four microbatches (f32 gradient sums, divided once) against one
    batch: loss within 1e-4, params within 2e-3 (the reference's test);
    and against JAX's four microbatches at the step tolerances."""
    jcfg, tcfg = _tiny()
    _, tp = _params(jcfg, tcfg, seed=0)
    batch = _tbatch(_batch(tcfg, seed=4, batch=8, seq=32))
    opt = topt.AdamWConfig(lr=1e-3)
    runs = []
    for mb in (1, 4):
        p = topt.clone_tree(tp)
        p, _, m = ttrainer.make_train_step(tcfg, opt, mb)(
            p, topt.init_opt_state(p), batch)
        runs.append((float(m["loss"]), p))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-4 * abs(runs[0][0])
    _assert_trees(runs[1][1], runs[0][1], 2e-3, _max_abs)
    losses, p4, jp4 = _steps_case(1, microbatches=4)
    assert abs(losses[0][0] - losses[0][1]) <= 1e-5 * abs(losses[0][1])
    _assert_trees(p4, jp4, 1e-5, _max_abs)


def test_eval_step_is_the_loss_without_grad():
    jcfg, tcfg = _tiny()
    _, tp = _params(jcfg, tcfg)
    batch = _tbatch(_batch(tcfg))
    m = ttrainer.make_eval_step(tcfg)(tp, batch)
    loss, _ = tmodel.loss_fn(tp, batch, tcfg)
    assert float(m["loss"]) == float(loss)
    assert not m["loss"].requires_grad


# -- train_loop's contracts (tests/test_training_loop.py) ---------------------


def _quiet(*_):
    pass


def test_train_loop_loss_decreases():
    _, cfg = _tiny()
    _, losses = tlaunch.train_loop(cfg, steps=30, batch=4, seq=32, lr=3e-3,
                                   log=_quiet, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_train_loop_checkpoint_resume_is_exact(tmp_path):
    """6 steps, a restart from the checkpoint, 6 more: the parameters
    equal 12 straight steps bit for bit."""
    _, cfg = _tiny()
    kw = dict(batch=4, seq=32, lr=1e-3, log=_quiet, seed=3, device="cpu")
    straight, _ = tlaunch.train_loop(cfg, steps=12, **kw)
    d = str(tmp_path / "ck")
    tlaunch.train_loop(cfg, steps=6, ckpt_dir=d, ckpt_every=100, **kw)
    resumed, _ = tlaunch.train_loop(cfg, steps=12, ckpt_dir=d,
                                    ckpt_every=100, **kw)
    for a, b in zip(ttree.leaves(straight), ttree.leaves(resumed)):
        assert torch.equal(a, b)


def test_train_loop_nan_loss_raises_for_supervisor():
    _, cfg = _tiny()
    with pytest.raises(FloatingPointError):
        tlaunch.train_loop(cfg, steps=5, batch=4, seq=32, lr=1e6,
                           log=_quiet, device="cpu")


def test_train_launcher_cli(tmp_path):
    """``python -m repro_torch.launch.train`` on the CPU, with a
    checkpoint: the second run resumes at the first run's last step."""
    def run(steps):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "gemma_2b", "--reduced", "--steps", str(steps), "--batch",
               "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
               str(tmp_path), "--no-graph"]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        return subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=300)

    out = run(2)
    assert out.returncode == 0, out.stderr
    assert "[train] step 1 loss" in out.stdout
    out = run(3)
    assert out.returncode == 0, out.stderr
    assert "restored step 2" in out.stdout and "step 2 loss" in out.stdout


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab", [(0, 128), (3, 256000)])
def test_data_stream_equals_jax_bit_for_bit(seed, vocab):
    cfg = dict(vocab=vocab, seq_len=40, global_batch=4, seed=seed)
    j = JDataset(JDataConfig(**cfg))
    p = tdata.SyntheticDataset(tdata.DataConfig(**cfg))
    for step in (0, 1, 5, 2 ** 20):
        np.testing.assert_array_equal(
            p.batch(step)["tokens"].numpy(),
            np.asarray(j.batch(step)["tokens"]))
    for host in range(2):
        np.testing.assert_array_equal(
            p.batch_shard(5, host, 2)["tokens"].numpy(),
            np.asarray(j.batch_shard(5, host, 2)["tokens"]))


def test_data_state_restores_the_stream():
    cfg = tdata.DataConfig(vocab=128, seq_len=8, global_batch=2, seed=1)
    d = tdata.SyntheticDataset(cfg)
    first = [d.batch()["tokens"] for _ in range(3)]
    r = tdata.SyntheticDataset.restore(cfg, {"seed": 1, "step": 2})
    assert torch.equal(r.batch()["tokens"], first[2]) and r.step == 3
    with pytest.raises(ValueError, match="seed"):
        tdata.SyntheticDataset.restore(cfg, {"seed": 2, "step": 0})


# -- checkpoints --------------------------------------------------------------


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"layers": [{"w": torch.randn(3, 4, generator=gen)}],
              "half": torch.randn(5, generator=gen).to(torch.bfloat16)}
    return params, topt.init_opt_state(params)


def test_checkpoint_round_trip_retention_and_latest(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    saved = {}
    for step in (1, 2, 3):
        params, opt = _state(step)
        opt["step"] += step
        saved[step] = (topt.clone_tree(params), topt.clone_tree(opt))
        (mgr.save_async if step == 2 else mgr.save)(
            step, params, opt, extra={"data": {"seed": 0, "step": step}})
        # An async save copied to the host first: later writes to the
        # tensors do not reach the checkpoint.
        params["layers"][0]["w"].add_(1.0)
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    os.makedirs(tmp_path / "step_00000009.tmp")       # a crashed write
    assert mgr.latest_step() == 3 and 9 not in mgr.all_steps()
    like = _state(7)
    for step in (2, 3):
        params, opt, manifest = mgr.restore(step, like)
        assert manifest["step"] == step
        assert manifest["extra"]["data"]["step"] == step
        assert params["half"].dtype == torch.bfloat16
        for got, want in zip(ttree.leaves((params, opt)),
                             ttree.leaves(saved[step])):
            assert torch.equal(got, want)
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore(None, like)


# -- the watchdog and the supervisor ------------------------------------------


def test_watchdog_raises_straggler_after_deadline():
    dog = tfault.StepWatchdog(0.2)
    try:
        dog.arm()
        deadline = time.monotonic() + 5.0
        while not dog._fired and time.monotonic() < deadline:
            time.sleep(0.05)
        with pytest.raises(tfault.StragglerError):
            dog.check()
        dog.arm()
        dog.disarm()
        dog.check()
    finally:
        dog.stop()


def test_supervise_restarts_then_gives_up():
    attempts, logs = [], []

    def flaky(attempt):
        attempts.append(attempt)
        if attempt < 2:
            raise tfault.StragglerError("slow")

    assert tfault.supervise(flaky, backoff_s=0.0, log=logs.append) == 2
    assert attempts == [0, 1, 2] and len(logs) == 2
    seen = []

    def broken(attempt):
        raise RuntimeError(f"attempt {attempt}")

    with pytest.raises(RuntimeError, match="attempt 1"):
        tfault.supervise(broken, max_restarts=1, backoff_s=0.0,
                         log=_quiet, on_give_up=seen.append)
    assert len(seen) == 1


def test_heartbeat_writes_stamps(tmp_path):
    path = str(tmp_path / "alive")
    hb = tfault.Heartbeat(path, interval_s=0.05)
    try:
        hb.beat()
        first = float(open(path).read())
        deadline = time.monotonic() + 5.0
        while float(open(path).read()) == first and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert float(open(path).read()) > first
        assert threading.active_count() >= 1
    finally:
        hb.stop()
