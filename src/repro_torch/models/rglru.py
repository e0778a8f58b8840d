"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427):
the port of ``repro/models/rglru.py``.

Two linear branches from the input: the gate branch through a GeLU, the
other through a short causal temporal conv and the Real-Gated Linear
Recurrent Unit; their product goes through an output projection::

    r_t = σ(W_a x_t + b_a)            # recurrence gate
    i_t = σ(W_x x_t + b_x)            # input gate
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t · h_{t-1} + sqrt(1 - a_t²) · (i_t · x_t)

Every projection runs through the kernel GEMMs (:func:`dense`).  A
prefill chunk evaluates the recurrence through B7 (``ops.rglru_scan``,
from the carried state), the training forward as a differentiable plain
scan (:func:`_plain_scan`), a decode step or a speculative window as one
element-wise update per position (plain PyTorch: it runs no kernel in
JAX either).  The serving cache of a layer
is ``{"h": (B, W) f32, "conv": (B, conv_width, W)}``: the state and the
raw-projection tail the conv of the next chunk or step needs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.formats import to_torch_dtype
from repro_torch.models.layers import (causal_conv, compute_dtype, dense,
                                       init_dense, keep_rows)

__all__ = ["init_rglru", "rglru_forward", "init_rglru_cache",
           "rglru_decode"]


def _width(cfg) -> int:
    return cfg.rglru.width or cfg.d_model


def init_rglru(gen: torch.Generator, cfg, device=None):
    """Random parameters with JAX's distributions (not its bits)."""
    d, w = cfg.d_model, _width(cfg)
    dt = to_torch_dtype(cfg.param_dtype)

    def lin(d_in, d_out, **kw):
        return init_dense(gen, d_in, d_out, dtype=dt, device=device, **kw)

    return {
        "gate_proj": lin(d, w),                    # GeLU branch
        "rec_proj": lin(d, w),                     # recurrent branch
        "conv_w": torch.randn(cfg.rglru.conv_width, w, generator=gen,
                              dtype=dt, device=device) * 0.1,
        "conv_b": torch.zeros(w, dtype=dt, device=device),
        "wa": lin(w, w, bias=True),
        "wx": lin(w, w, bias=True),
        "lam": torch.full((w,), 0.65, dtype=dt, device=device),
        "out_proj": lin(w, d, scale=w ** -0.5),
    }


def _gates(x, p, cfg, plan_rows=None):
    """log_a (B, S, W) and the gated input (B, S, W), both f32."""
    r = torch.sigmoid(dense(x, p["wa"], cfg, plan_rows=plan_rows).float())
    i = torch.sigmoid(dense(x, p["wx"], cfg, plan_rows=plan_rows).float())
    log_a = -cfg.rglru.c * F.softplus(p["lam"].float()) * r
    return log_a, i * x.float()


def _scan_inputs(log_a, gated):
    return (torch.exp(log_a),
            torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
            * gated)


def _plain_scan(a, b):
    """h_t = a_t·h_{t−1} + b_t along axis 1 from h_{−1} = 0, as log₂ S
    doubling steps of plain tensor operations that autograd
    differentiates: the counterpart of the training path's
    ``jax.lax.associative_scan`` (``rglru.py:98-108`` of the JAX
    package), which reaches no Pallas kernel either."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rglru_forward(x, p, cfg, *, cache: Optional[dict] = None,
                  train: bool = False):
    """One prefill chunk x (B, S, D) → (out (B, S, D), new cache).
    ``train`` (the training forward, from a zero state) runs the
    recurrence as :func:`_plain_scan`, differentiable, where serving runs
    B7, as JAX runs its Pallas scan only when a cache is returned.

    ``cache`` (the previous chunk's ``{"h", "conv"}``) resumes the
    recurrence mid-sequence: the conv sees the previous chunk's raw tail
    instead of zero padding, and the scan (B7) starts from the carried
    state h₀.  JAX scans from zero and folds the state in afterwards as
    ``h_t += exp(Σ_{k≤t} log a_k)·h₀`` (a cumulative sum of logs); the
    two agree within float32 rounding.  Scanned in several chunks, the
    same inputs give bit for bit the states of one scan.  The returned
    cache is new tensors; the caller stores it."""
    from repro_torch.kernels import ops
    gate = dense(x, p["gate_proj"], cfg, activation="gelu")
    u_raw = dense(x, p["rec_proj"], cfg)
    conv_in, hist = u_raw, 0
    if cache is not None:
        hist = cache["conv"].shape[1]
        conv_in = torch.cat([cache["conv"].to(u_raw.dtype), u_raw], dim=1)
    u = causal_conv(conv_in.float(), p["conv_w"].float(),
                    p["conv_b"].float())[:, hist:].to(u_raw.dtype)
    log_a, gated = _gates(u, p, cfg)
    if train:
        if cache is not None:
            raise ValueError("the training forward starts from a zero "
                             "state")
        h = _plain_scan(*_scan_inputs(log_a, gated))
    else:
        h = ops.rglru_scan(*_scan_inputs(log_a, gated),
                           None if cache is None else cache["h"])
    out = dense(gate * h.to(x.dtype), p["out_proj"], cfg)
    width = cfg.rglru.conv_width
    tail = conv_in[:, -width:]
    if tail.shape[1] < width:
        tail = F.pad(tail, (0, 0, width - tail.shape[1], 0))
    return out, {"h": h[:, -1], "conv": tail.to(compute_dtype(cfg))}


def init_rglru_cache(cfg, batch: int, dtype, device=None):
    w = _width(cfg)
    return {"h": torch.zeros(batch, w, device=device),
            "conv": torch.zeros(batch, cfg.rglru.conv_width, w, dtype=dtype,
                                device=device)}


def _stack(rows):
    """Per-position (B, ...) results as (B, K, ...)."""
    return torch.stack(rows, dim=1) if len(rows) > 1 else rows[0][:, None]


def rglru_decode(x, p, cfg, cache, *, row_valid=None):
    """Decode x (B, K, D) → (out, cache): one token, or a K-token
    speculative window computed as K decode steps.  The projections
    (``gate_proj``, ``rec_proj``, the gates' ``wa`` and ``wx``,
    ``out_proj``) run once over the B·K rows on the plans of the decode
    step's B rows (``plan_rows``), and the element-wise gates once; the
    conv and the recurrence a·h + b step per position.  So each row gets
    the bits of a decode step at its position.  The state of every row
    whose ``row_valid`` is True (all rows without it) ends where K steps
    leave it, in place; the others keep theirs, and each of their
    positions reads that kept state, as a masked decode step does."""
    b, klen, _ = x.shape
    gate = dense(x, p["gate_proj"], cfg, activation="gelu", plan_rows=b)
    u_raw = dense(x, p["rec_proj"], cfg, plan_rows=b)      # (B, K, W)

    conv_w, conv_b = p["conv_w"].float(), p["conv_b"].float()
    conv, us = cache["conv"], []
    for i in range(klen):
        step = torch.cat([conv[:, 1:], u_raw[:, i:i + 1].to(conv.dtype)],
                         dim=1)
        us.append(torch.einsum("bwc,wc->bc", step.float(), conv_w) + conv_b)
        conv = keep_rows(conv, step, row_valid)
    log_a, gated = _gates(_stack(us).to(x.dtype), p, cfg, plan_rows=b)
    a, bias = _scan_inputs(log_a, gated)
    h, hs = cache["h"], []
    for i in range(klen):
        step = a[:, i] * h + bias[:, i]
        hs.append(step)
        h = keep_rows(h, step, row_valid)
    out = dense(gate * _stack(hs).to(x.dtype), p["out_proj"], cfg,
                plan_rows=b)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv)
    return out, cache
