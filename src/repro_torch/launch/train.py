"""Training launcher (the port of ``repro/launch/train.py``).

Composes: config → parameters from a seed (or a checkpoint's) → the train
step (:mod:`repro_torch.training.trainer`) → the data stream → async
checkpoints → the watchdog and, with ``--supervise``, restart on failure.
One device, no mesh: sharded training is ROADMAP A12.

Examples::

    # CPU-scale training of a reduced config:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu

    # gemma_2b at full width on the card, with checkpoints:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \\
        --steps 4 --batch 1 --seq 4096 --ckpt-dir ckpt

    # the same on the library's products (JAX's "xla" backend):
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \\
        --steps 4 --batch 1 --seq 4096 --gemm-backend torch
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticDataset
from repro_torch.distributed.fault import StepWatchdog, supervise
from repro_torch.models import model as model_lib
from repro_torch.optim.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.trainer import (make_train_step,
                                          plan_cache_snapshot,
                                          restore_plan_cache)

__all__ = ["train_loop", "main"]


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
               microbatches: int = 1, ckpt_dir=None, ckpt_every: int = 50,
               step_timeout_s: float = 600.0, log=print, seed: int = 0,
               device=None):
    """Train ``cfg`` for ``steps`` steps of ``batch`` × ``seq`` tokens
    from ``SyntheticDataset(seed)``: → (params, per-step losses).  With
    ``ckpt_dir`` it resumes from the latest checkpoint there (parameters,
    optimizer state, the data stream's step and the GEMM plans), saves
    every ``ckpt_every`` steps in the background and once at the end,
    each checkpoint with the plan cache's snapshot after the first step.
    A NaN loss raises ``FloatingPointError``; a step past
    ``step_timeout_s`` raises ``StragglerError`` at the next step's
    start."""
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                          seed=seed)
    data = SyntheticDataset(data_cfg, device=dev)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None

    params = model_lib.init_params(cfg, seed=seed, device=dev)
    opt_state = init_opt_state(params)
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        params, opt_state, manifest = ckpt.restore(None,
                                                   (params, opt_state))
        start_step = int(manifest["step"])
        data = SyntheticDataset.restore(
            data_cfg, manifest["extra"].get("data", data.state()),
            device=dev)
        n_plans = restore_plan_cache(manifest.get("gemm_plans"), dev)
        log(f"[train] restored step {start_step}"
            f"{f', {n_plans} warm GEMM plans' if n_plans else ''}")

    step_fn = make_train_step(cfg, opt_cfg, microbatches)
    watchdog = StepWatchdog(step_timeout_s)
    losses = []
    gemm_plans = None
    try:
        for step in range(start_step, steps):
            watchdog.check()
            watchdog.arm()
            batch_data = data.batch(step)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_data)
            loss = float(metrics["loss"])
            watchdog.disarm()
            losses.append(loss)
            if gemm_plans is None:
                # The first step planned every GEMM of the model: the
                # cache now holds the training plan set, saved with every
                # checkpoint.
                gemm_plans = plan_cache_snapshot(dev) or {}
            if step % 10 == 0 or step == steps - 1:
                log(f"[train] step {step} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"({time.time() - t0:.2f}s)")
            if math.isnan(loss):
                raise FloatingPointError(f"NaN loss at step {step}")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save_async(step + 1, params, opt_state,
                                extra={"data": data.state()},
                                gemm_plans=gemm_plans or None)
        if ckpt:
            ckpt.save(steps, params, opt_state, extra={"data": data.state()},
                      gemm_plans=gemm_plans or None)
            ckpt.wait()
    finally:
        watchdog.stop()
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a config of the port.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--gemm-backend", default=None,
                    choices=[None, "kernels", "torch"],
                    help="kernels (the default: the hand-written kernels) "
                         "or torch (the plain formulation on the library's "
                         "products)")
    ap.add_argument("--format-policy", default=None,
                    choices=[None, "fp32", "bf16", "bf16acc", "int8"])
    ap.add_argument("--no-graph", action="store_true",
                    help="eager per-GEMM dispatch instead of compiled "
                         "repro_torch.graph programs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.gemm_backend:
        cfg = dataclasses.replace(cfg, gemm_backend=args.gemm_backend)
    if args.format_policy:
        cfg = dataclasses.replace(cfg, format_policy=args.format_policy)
    if args.no_graph:
        cfg = dataclasses.replace(cfg, use_graph=False)

    def run(attempt: int):
        train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                   lr=args.lr, microbatches=args.microbatches,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   device=args.device)

    if args.supervise:
        supervise(run)
    else:
        run(0)


if __name__ == "__main__":
    main()
