"""The train step: loss → grads → clip → AdamW, with microbatching (the
port of ``repro/training/trainer.py``).

``make_train_step(cfg, opt_cfg, microbatches)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.
Every GEMM of the step, forward and backward, runs the port's kernels
through the plan cache (:mod:`repro_torch.kernels.autodiff`); the step
updates the parameters and the optimizer state in place
(:func:`repro_torch.optim.optimizer.adamw_update`) and returns them.
Metrics are 0-d device tensors: the step never waits for the card, the
caller reads what it needs.

With ``microbatches`` > 1 the batch splits along its first axis, each
microbatch's gradient is summed into f32 buffers, and the sum is divided
once (one deferred reduction, as JAX's ``lax.scan`` accumulates it).

Not ported: ``plan_cache_snapshot`` / ``restore_plan_cache``, which store
the plan cache's JSON in a checkpoint; the port's plan cache has no JSON
form yet (ROADMAP A4).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.optim.optimizer import AdamWConfig, adamw_update
from repro_torch.tree import leaves, tree_map

__all__ = ["make_train_step", "make_eval_step", "loss_and_grads"]


def _requiring_grad(params):
    """(a tree of params' structure whose leaves are detached aliases that
    require grad, those leaves in order): the step differentiates the
    aliases, so the caller's tensors never carry ``requires_grad``."""
    tree = tree_map(lambda p: p.detach().requires_grad_(), params)
    return tree, leaves(tree)


def loss_and_grads(params, batch, cfg) -> Tuple[Dict[str, Any], Any]:
    """(metrics of :func:`repro_torch.models.model.loss_fn`, grads): the
    gradient of the loss at ``params``, a tree of params' structure in
    the params' dtypes (a leaf the loss does not reach gets zeros, as
    JAX's gradient of an unused leaf)."""
    tree, flat = _requiring_grad(params)
    loss, metrics = model_lib.loss_fn(tree, batch, cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, grads)])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tree_map(lambda _: next(grads), params)


def _microbatch(batch, i: int, n: int):
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: AdamWConfig, microbatches: int = 1):
    def train_step(params, opt_state, batch):
        if microbatches > 1:
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            msum = None
            for i in range(microbatches):
                m, grads = loss_and_grads(
                    params, _microbatch(batch, i, microbatches), cfg)
                for s, g in zip(leaves(gsum), leaves(grads)):
                    s.add_(g)
                del grads
                msum = m if msum is None else {k: msum[k] + m[k]
                                               for k in msum}
            for s in leaves(gsum):
                s.div_(microbatches)
            grads = gsum
            metrics = {k: (v if k == "tokens" else v / microbatches)
                       for k, v in msum.items()}
        else:
            metrics, grads = loss_and_grads(params, batch, cfg)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_eval_step(cfg):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = model_lib.loss_fn(params, batch, cfg)
        return metrics
    return eval_step
