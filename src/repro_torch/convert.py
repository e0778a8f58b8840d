"""Carry parameters across from the JAX package's tree (as numpy arrays).

The JAX stack stores the layers it scans as ``params["groups"]``: a list
of ``period`` layer dicts whose leaves are stacked over the scanned groups
(``repro/models/model.py:81-107``), plus an unrolled ``params["tail"]``.
:func:`params_from_jax` unstacks them into the port's per-layer list —
layer ``g * period + j`` is ``groups[j]`` at index ``g`` — and keeps the
embedding table and, for an untied model, the LM head (``head``,
(d_model, vocab)).  Every leaf of a layer comes across as it is: a MoE
layer's bare ``router`` (d_model, E), ``gate``/``up`` (E, d_model, F) and
``down`` (E, F, d_model), and QK-norm's ``q_norm``/``k_norm`` scales.
The caller converts the JAX arrays to numpy first (``jax.device_get``);
this module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import leaves, tree_map

__all__ = ["params_from_jax"]


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
        n_groups = len(leaves(groups[0])[0])
        for g in range(n_groups):
            for j in range(period):
                layers.append(tree_map(lambda a, g=g: to_t(a[g]),
                                       groups[j]))
    layers += [tree_map(to_t, lp) for lp in tree_of_numpy.get("tail", [])]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name!r} has {cfg.n_layers}")
    return {"embedding": tree_map(to_t, tree_of_numpy["embedding"]),
            "layers": layers,
            "final_norm": tree_map(to_t, tree_of_numpy["final_norm"])}
