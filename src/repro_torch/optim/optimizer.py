"""AdamW and its schedule (the port of ``repro/optim/optimizer.py``).

The state mirrors the parameters: ``{"m": tree, "v": tree, "step": 0-d
int32 tensor}``, m and v in f32.  Global-norm clipping, bias correction
and decoupled weight decay on matrices only (ndim ≥ 2), as in JAX.

The update runs one leaf at a time with plain tensor operations, and
writes the new parameters, m and v **in place**: JAX's launcher donates
these buffers to its step (``donate_argnums``), and at full width a copy
of them (30 GB for gemma_2b's 2.5 B f32 parameters) would not fit beside
the originals.  Each leaf's temporaries are the size of that leaf.  A
caller that needs the old values keeps a copy (:func:`clone_tree`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update",
           "cosine_schedule", "global_norm", "clone_tree"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX holds the config's constants."""
    return float(torch.tensor(x, dtype=torch.float32))


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), f32: linear warm-up
    over ``warmup_steps``, then a cosine from ``lr`` down to
    ``min_lr_frac · lr`` at ``total_steps``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params) -> Dict[str, Any]:
    """Zero m and v in f32 beside each parameter, and step 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, in f32."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clone_tree(tree):
    """A copy of every tensor of ``tree`` (of an optimizer state too)."""
    return tree_map(torch.clone, tree)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place: → (params, state, metrics
    ``{"grad_norm", "lr"}``), the same params and state objects updated.
    ``grads`` is a tree of params' structure (f32 or the params' dtype)."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    c1, c2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state["m"]), leaves(state["v"])):
        gf = (g * scale.to(g.dtype)).float()
        m.mul_(b1).add_(gf * c1)
        v.mul_(b2).add_((gf * c2) * gf)
        del gf
        delta = m / b1c
        delta.div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if p.ndim >= 2:             # decay matrices only
            delta.add_(cfg.weight_decay * p.float())
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
