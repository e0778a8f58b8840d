"""Carry parameters across from the JAX package's tree (as numpy arrays).

The JAX stack stores the layers it scans as ``params["groups"]``: a list
of ``period`` layer dicts whose leaves are stacked over the scanned groups
(``repro/models/model.py:81-107``), plus an unrolled ``params["tail"]``.
:func:`params_from_jax` unstacks them into the port's per-layer list —
layer ``g * period + j`` is ``groups[j]`` at index ``g`` — and keeps the
tied embedding table.  The caller converts the JAX arrays to numpy first
(``jax.device_get``); this module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["params_from_jax"]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree_of_numpy: Any, cfg, device=None):
    """The port's parameter dict from a JAX ``init_params`` tree whose
    leaves are numpy arrays, on ``device`` (the card unless "cpu")."""
    dev = resolve_device(device)

    def to_t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32)).to(dev)

    layers = []
    groups = tree_of_numpy.get("groups")
    if groups is not None:
        period = len(groups)
        n_groups = len(next(iter(_leaves(groups[0]))))
        for g in range(n_groups):
            for j in range(period):
                layers.append(_map(groups[j], lambda a, g=g: to_t(a[g])))
    layers += [_map(lp, to_t) for lp in tree_of_numpy.get("tail", [])]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name!r} has {cfg.n_layers}")
    return {"embedding": _map(tree_of_numpy["embedding"], to_t),
            "layers": layers,
            "final_norm": _map(tree_of_numpy["final_norm"], to_t)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
