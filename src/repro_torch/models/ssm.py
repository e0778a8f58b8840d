"""Mamba2 SSD (state-space duality) mixer, arXiv:2405.21060: the port of
``repro/models/ssm.py``.

Chunked SSD: the sequence is split into chunks of length Q; the
intra-chunk term is a masked, decay-weighted attention-like product
(quadratic only within the chunk) and the inter-chunk term a recurrence
over per-chunk states.  A decode step keeps a (B, H, P, N) f32 state and
a (B, W, conv_dim) causal-conv ring, O(1) in the sequence length.

The JAX package computes the whole block in plain jnp, outside any Pallas
kernel, so its port is plain PyTorch: the projections are library
products, the scan a loop over chunks.  JAX projects with the compute
dtype's operands and an f32 output (``preferred_element_type``); a bf16
``torch.matmul`` would round its output to bf16, so :func:`_project`
takes the f32 product of operands already rounded to the compute dtype
(the package turns TF32 off, so that product is a true f32 one).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.formats import to_torch_dtype
from repro_torch.models.layers import (causal_conv, compute_dtype,
                                       init_dense, keep_rows)

__all__ = ["init_ssd", "ssd_forward", "init_ssd_cache", "ssd_decode"]


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def init_ssd(gen: torch.Generator, cfg, device=None):
    """Random parameters with JAX's distributions (not its bits), the
    leaves named as JAX names them (``ssm.py:34-51`` there)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.d_state + n_heads
    dt = to_torch_dtype(cfg.param_dtype)
    return {
        "in_proj": init_dense(gen, d, d_in_proj, dtype=dt, device=device),
        "conv_w": torch.randn(s.conv_width, conv_dim, generator=gen,
                              dtype=dt, device=device) * 0.1,
        "conv_b": torch.zeros(conv_dim, dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          device=device).to(dt)),
        "D": torch.ones(n_heads, dtype=dt, device=device),
        "dt_bias": torch.zeros(n_heads, dtype=dt, device=device),
        "norm_scale": torch.ones(d_inner, dtype=dt, device=device),
        "out_proj": init_dense(gen, d_inner, d, dtype=dt, device=device,
                               scale=d_inner ** -0.5),
    }


def _project(x, w, cfg):
    """x (..., d_in) @ w (d_in, d_out) → f32: both operands rounded to the
    compute dtype, their product in f32."""
    cdt = compute_dtype(cfg)
    return torch.matmul(x.to(cdt).float(), w.to(cdt).float())


def _gated_rmsnorm(y, z, scale, eps: float = 1e-6):
    """y·silu(z) normed over the last axis, in y's dtype (both in the
    compute dtype, as in JAX)."""
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _split_proj(zxbcdt, cfg):
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * s.d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * s.d_state:]
    return z, xbc, dt


def _ssd_chunked(x, dt, a_log, bmat, cmat, chunk: int,
                 h0: Optional[torch.Tensor] = None):
    """Chunked state-space duality (``ssm.py:81-146`` of the JAX package).

    x (B, S, H, P); dt (B, S, H); a_log (H,) (A = −exp(a_log)); bmat and
    cmat (B, S, N); h0 an optional (B, H, P, N) initial state (a prefill
    chunk resuming mid-sequence).  → (y (B, S, H, P) f32, the final state
    (B, H, P, N) f32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))

    xf = x.float().reshape(b, nc, q, h, p)
    dtc = dt.float().reshape(b, nc, q, h)
    bc = bmat.float().reshape(b, nc, q, n)
    cc = cmat.float().reshape(b, nc, q, n)
    a = -torch.exp(a_log.float())                        # (H,)
    da_cum = torch.cumsum(dtc * a, dim=2)                # (b, nc, q, h)

    # Intra-chunk: att[b,c,h,i,j] = (C_i·B_j) exp(cum_i − cum_j) dt_j for
    # i >= j.  The EXPONENT is masked: above the diagonal diff > 0, so exp
    # would overflow to inf there, and the backward would carry NaN.
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    diff = (da_cum[:, :, :, None, :] - da_cum[:, :, None, :, :]
            ).permute(0, 1, 4, 2, 3)                     # (b, c, h, i, j)
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~mask, float("-inf")))
    att = cb[:, :, None] * decay * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", att, xf)

    # Per-chunk states.
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)   # (b,c,q,h)
    weights = decay_to_end * dtc
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn", weights, bc, xf)

    # Inter-chunk recurrence, keeping the state before each chunk.
    chunk_decay = torch.exp(da_cum[:, :, -1, :])               # (b, c, h)
    carry = (h0.float() if h0 is not None
             else torch.zeros(b, h, p, n, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # (b,c,h,p,n)

    # Off-diagonal contribution.
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cc, prev_states,
                         torch.exp(da_cum))
    y = (y_diag + y_off).reshape(b, nc * q, h, p)
    return y[:, :s], carry


def ssd_forward(x, p, cfg, *, return_cache: bool = False,
                cache: Optional[dict] = None):
    """The Mamba2 block over x (B, S, D) → out (B, S, D) in x's dtype
    (``ssm.py:149-196`` of the JAX package), and with ``return_cache``
    the decode cache after the sequence.

    ``cache`` (``{"state", "conv"}``) resumes mid-sequence, a prefill
    chunk after the first: its conv rows replace the zero padding and the
    inter-chunk recurrence starts from its state.  The returned conv holds
    the last ``conv_width`` raw xBC projections in the compute dtype,
    left-padded with zeros when fewer were seen.  The returned cache is
    new tensors; the caller stores it."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    zxbcdt = _project(x, p["in_proj"]["w"], cfg)
    z, xbc_raw, dt = _split_proj(zxbcdt, cfg)
    conv_in, hist = xbc_raw, 0
    if cache is not None:
        hist = cache["conv"].shape[1]
        conv_in = torch.cat([cache["conv"].float(), xbc_raw], dim=1)
    xbc = F.silu(causal_conv(conv_in, p["conv_w"].float(),
                             p["conv_b"].float()))[:, hist:]
    x_in = xbc[..., :d_inner]
    bmat = xbc[..., d_inner: d_inner + s.d_state]
    cmat = xbc[..., d_inner + s.d_state:]
    dt = F.softplus(dt + p["dt_bias"].float())

    xh = x_in.reshape(*x_in.shape[:2], n_heads, s.head_dim)
    y, state = _ssd_chunked(xh, dt, p["A_log"], bmat, cmat, s.chunk,
                            h0=None if cache is None else cache["state"])
    y = y + p["D"].float()[:, None] * xh
    y = y.reshape(*x.shape[:2], d_inner)
    cdt = compute_dtype(cfg)
    y = _gated_rmsnorm(y.to(cdt), z.to(cdt), p["norm_scale"])
    out = _project(y, p["out_proj"]["w"], cfg).to(x.dtype)
    if not return_cache:
        return out
    tail = conv_in[:, -s.conv_width:]
    if tail.shape[1] < s.conv_width:
        tail = F.pad(tail, (0, 0, s.conv_width - tail.shape[1], 0))
    return out, {"state": state, "conv": tail.to(cdt)}


def init_ssd_cache(cfg, batch: int, dtype, device=None):
    """A layer's zero decode cache: the (B, H, P, N) f32 state and the
    (B, conv_width, conv_dim) ring in ``dtype`` (the compute dtype)."""
    s = cfg.ssm
    _, n_heads, conv_dim = _dims(cfg)
    return {"state": torch.zeros(batch, n_heads, s.head_dim, s.d_state,
                                 device=device),
            "conv": torch.zeros(batch, s.conv_width, conv_dim, dtype=dtype,
                                device=device)}


def ssd_decode(x, p, cfg, cache, *, row_valid=None):
    """Decode x (B, K, D) → (out (B, K, D), cache): one token, or a K-token
    speculative window computed as K decode steps (``ssm.py:212-246`` of
    the JAX package, which a verify window calls once per position).

    The projections take one product per window position over the B rows
    a decode step projects: the library's f32 product may pick other
    kernels, and so give other bits, for B·K rows than for B, and each row
    must get the bits of a decode step at its position.  The conv ring
    and the state advance per position.  The rows whose ``row_valid`` is
    True (all rows without it) end where K steps leave them; the others
    keep their state and ring (JAX's ``_mask_rows``), and each of their
    positions reads what they kept.  ``state`` and ``conv`` are written in
    place: the decode and speculative CUDA graphs hold their addresses."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    b, klen, _ = x.shape
    cdt = compute_dtype(cfg)

    conv_w, conv_b = p["conv_w"].float(), p["conv_b"].float()
    dt_bias, d_skip = p["dt_bias"].float(), p["D"].float()
    a = -torch.exp(p["A_log"].float())
    conv, state, outs = cache["conv"], cache["state"], []
    for i in range(klen):
        z, xbc, dt = _split_proj(_project(x[:, i], p["in_proj"]["w"], cfg),
                                 cfg)
        ring = torch.cat([conv[:, 1:], xbc[:, None].to(conv.dtype)], dim=1)
        xbc = F.silu(torch.einsum("bwc,wc->bc", ring.float(), conv_w)
                     + conv_b)
        x_in = xbc[:, :d_inner]
        bmat = xbc[:, d_inner: d_inner + s.d_state]
        cmat = xbc[:, d_inner + s.d_state:]
        dt = F.softplus(dt + dt_bias)                              # (B, H)
        xh = x_in.reshape(b, n_heads, s.head_dim)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, bmat)
        new = state * torch.exp(dt * a)[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", new, cmat) + d_skip[:, None] * xh
        y = _gated_rmsnorm(y.reshape(b, 1, d_inner).to(cdt),
                           z[:, None].to(cdt), p["norm_scale"])
        outs.append(_project(y, p["out_proj"]["w"], cfg).to(x.dtype))
        conv = keep_rows(conv, ring, row_valid)
        state = keep_rows(state, new, row_valid)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv)
    return torch.cat(outs, dim=1), cache
