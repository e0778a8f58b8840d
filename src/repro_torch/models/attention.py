"""MQA/GQA attention over the paged KV pool (the port of the serving half
of ``repro/models/attention.py``).

Projections run through the kernel GEMMs; prefill-chunk attention through
B5 (``flash_attention``) and decode attention through B4
(``flash_decode_paged``).  The KV scatter into pages, the prefix-page
gather and the dequantize outside the kernels stay plain PyTorch, as they
are plain jnp in JAX.

Unlike JAX, the port updates the page slabs **in place** (``index_put_``)
instead of returning fresh arrays: a decode step then allocates no new
cache and writes only the new token's KV.  The functions still return the
cache, so call sites read as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import resolve_format, to_torch_dtype
from repro_torch.models.layers import (compute_dtype, dense, init_dense,
                                       rmsnorm, rope)

__all__ = ["init_attention", "init_paged_attn_cache",
           "paged_decode_attention", "paged_prefill_attention"]


def init_attention(gen: torch.Generator, cfg, device=None):
    d, hd = cfg.d_model, cfg.hd
    dt = to_torch_dtype(cfg.param_dtype)
    if cfg.qk_norm:
        raise NotImplementedError("qk_norm is ROADMAP A10")
    return {
        "q": init_dense(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias,
                        dtype=dt, device=device),
        "k": init_dense(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        dtype=dt, device=device),
        "v": init_dense(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        dtype=dt, device=device),
        "o": init_dense(gen, cfg.n_heads * hd, d, dtype=dt,
                        scale=(cfg.n_heads * hd) ** -0.5, device=device),
    }


def _project_qkv(x, p, cfg, positions):
    b, s, _ = x.shape
    hd = cfg.hd
    q = dense(x, p["q"], cfg).reshape(b, s, cfg.n_heads, hd)
    k = dense(x, p["k"], cfg).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(x, p["v"], cfg).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta), v


def _quantize_kv(x: torch.Tensor, per_channel: bool = True):
    """Symmetric int8 KV quantization.  x: (..., kv, hd).  Per channel:
    one scale per (token, head); per tensor (int8pt): one per token over
    (kv, hd), broadcast to the (..., kv, 1) layout."""
    xf = x.float()
    dims = (-1,) if per_channel else (-2, -1)
    scale = xf.abs().amax(dim=dims, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    scale = scale.expand(*x.shape[:-1], 1)
    return q.to(torch.int8), scale.float()


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _kv_storage_format(cfg):
    name = getattr(cfg, "kv_cache_format", None)
    return resolve_format(name) if name is not None else None


def _scale(cfg) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else cfg.hd ** -0.5


def init_paged_attn_cache(cfg, num_pages: int, page_size: int, dtype,
                          device=None):
    """Paged KV storage for ONE global-attention layer; page 0 is the
    reserved null page."""
    fmt = _kv_storage_format(cfg)
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    if fmt is None:
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    if fmt.quantized:
        sshape = (num_pages, page_size, cfg.n_kv_heads, 1)
        return {"k_pages": torch.zeros(shape, dtype=torch.int8,
                                       device=device),
                "k_scale": torch.zeros(sshape, device=device),
                "v_pages": torch.zeros(shape, dtype=torch.int8,
                                       device=device),
                "v_scale": torch.zeros(sshape, device=device)}
    return {"k_pages": torch.zeros(shape, dtype=fmt.operand_torch,
                                   device=device),
            "v_pages": torch.zeros(shape, dtype=fmt.operand_torch,
                                   device=device)}


def _write_kv(cache, cfg, phys, slot, k, v):
    """Scatter K/V rows into (physical page, slot), quantizing under the
    KV storage format.  In place."""
    if "k_scale" in cache:
        fmt = _kv_storage_format(cfg)
        kq, ks = _quantize_kv(k, per_channel=fmt.per_channel)
        vq, vs = _quantize_kv(v, per_channel=fmt.per_channel)
        cache["k_pages"][phys, slot] = kq
        cache["k_scale"][phys, slot] = ks
        cache["v_pages"][phys, slot] = vq
        cache["v_scale"][phys, slot] = vs
    else:
        dt = cache["k_pages"].dtype
        cache["k_pages"][phys, slot] = k.to(dt)
        cache["v_pages"][phys, slot] = v.to(dt)


def paged_decode_attention(x, p, cfg, cache, pos, page_table, *,
                           window: Optional[int] = None):
    """One-token decode over the paged pool.  x: (B, 1, D); pos: (B,)
    positions; page_table: (B, max_pages) int32 (−1 unmapped; inactive
    rows write their garbage token into the null page 0).  The new
    token's K/V are scattered first, then B4 reads the table-selected
    pages.  Returns (out, cache)."""
    from repro_torch.kernels import ops
    b = x.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int64,
                            device=x.device).reshape(-1).expand(b)
    q, k, v = _project_qkv(x, p, cfg, pos_b[:, None])
    page = cache["k_pages"].shape[1]
    rows = torch.arange(b, device=x.device)
    phys = page_table[rows, pos_b // page].long().clamp(min=0)
    _write_kv(cache, cfg, phys, pos_b % page, k[:, 0], v[:, 0])
    out = ops.flash_decode_paged(
        q[:, 0], cache["k_pages"], cache["v_pages"], page_table, pos_b + 1,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        window=window, softcap=cfg.attn_softcap, scale=_scale(cfg))
    return dense(out.reshape(b, 1, -1), p["o"], cfg), cache


def paged_prefill_attention(x, p, cfg, cache, positions, page_table, *,
                            kv_len: int):
    """One prefill chunk over the paged pool.  x: (1, C, D); positions:
    (1, C) = [kv_len − C, kv_len); page_table: (1, max_pages).  The
    chunk's K/V are stored (quantized under the KV format); attention
    reads the prior prefix's pages (aliased prefix-cache pages included,
    dequantized to the compute dtype) followed by the chunk's own
    full-precision K/V, through B5.  Returns (out, cache)."""
    from repro_torch.kernels import ops
    b, c_len, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    page = cache["k_pages"].shape[1]
    pos_v = positions[0].long()
    phys = page_table[0, pos_v // page].long().clamp(min=0)
    _write_kv(cache, cfg, phys, pos_v % page, k[0], v[0])

    pos0 = kv_len - c_len
    n_prefix = -(-pos0 // page)
    cdt = compute_dtype(cfg)

    def gather(leaf):
        idx = page_table[:, :n_prefix].long().clamp(min=0)
        g = leaf[idx]
        return g.reshape(b, n_prefix * page, *leaf.shape[2:])[:, :pos0]

    if pos0:
        kg, vg = gather(cache["k_pages"]), gather(cache["v_pages"])
        if "k_scale" in cache:
            kg = _dequantize_kv(kg, gather(cache["k_scale"]), cdt)
            vg = _dequantize_kv(vg, gather(cache["v_scale"]), cdt)
        kg = torch.cat([kg.to(cdt), k.to(cdt)], dim=1)
        vg = torch.cat([vg.to(cdt), v.to(cdt)], dim=1)
    else:
        kg, vg = k.to(cdt), v.to(cdt)
    out = ops.flash_attention(
        q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
        causal=True, window=None, softcap=cfg.attn_softcap,
        scale=_scale(cfg))
    out = out.transpose(1, 2)
    return dense(out.reshape(b, c_len, -1), p["o"], cfg), cache
