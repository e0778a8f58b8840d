"""Decoder-stack entry points of the port (the serving subset of
``repro/models/model.py``).

Parameters are plain dictionaries: ``{"embedding": {"table"}, "layers":
[per-layer dict], "final_norm": {"scale"}}`` — JAX's ``lax.scan`` group
stack (``params["groups"]``) becomes a Python list of layers
(:func:`repro_torch.convert.params_from_jax` unstacks it).  The layer kind
ported is ``("attn", "mlp")``: dense global attention + gated MLP; other
kinds raise, naming the ROADMAP item (A10).

Entry points: :func:`init_params`, :func:`init_paged_cache`,
:func:`prefill_chunk`, :func:`decode`, :func:`sample_token`,
:func:`decode_and_sample`.  The paged cache is updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.formats import to_torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (check_backend, compute_dtype, embed,
                                       init_embedding, init_mlp, init_norm,
                                       mlp, rmsnorm, unembed)

__all__ = ["init_params", "init_paged_cache", "prefill_chunk", "decode",
           "sample_token", "decode_and_sample", "param_count"]

_PORTED_KIND = ("attn", "mlp")


def _check_kinds(cfg) -> None:
    for kind in cfg.layer_kinds:
        if tuple(kind) != _PORTED_KIND:
            raise NotImplementedError(
                f"layer kind {kind} is not ported yet (ROADMAP A10: "
                f"off-main-path models); ported: {_PORTED_KIND}")


def init_params(cfg, *, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters from ``torch.Generator(seed)`` on ``device`` (the
    card unless ``device="cpu"``): the JAX package's distributions (normal
    × fan-in scale, unit norms, 0.02 embedding), not its bits."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = to_torch_dtype(cfg.param_dtype)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "norm1": init_norm(cfg.d_model, cfg.norm_type, dt, dev),
            "mixer": attn_mod.init_attention(gen, cfg, dev),
            "norm2": init_norm(cfg.d_model, cfg.norm_type, dt, dev),
            "ffn": init_mlp(gen, cfg, dev),
        })
    return {"embedding": init_embedding(gen, cfg, dev), "layers": layers,
            "final_norm": init_norm(cfg.d_model, cfg.norm_type, dt, dev)}


def param_count(params) -> int:
    def walk(t):
        if isinstance(t, torch.Tensor):
            return t.numel()
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(walk(v) for v in t)
        return 0
    return walk(params)


def init_paged_cache(cfg, batch: int, seq_len: int, *, num_pages: int,
                     page_size: int, device=None):
    """Paged KV storage for every layer (page 0 reserved as the null
    page).  ``cfg.kv_cache_format`` selects the stored element type."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    cdt = compute_dtype(cfg)
    return {"layers": [attn_mod.init_paged_attn_cache(cfg, num_pages,
                                                      page_size, cdt, dev)
                       for _ in range(cfg.n_layers)]}


def _apply_layer(x, lp, cfg, positions, mode, cache, *, pos=None,
                 page_table=None, chunk_pos0=None):
    if cfg.post_norms:
        raise NotImplementedError("post_norms is ROADMAP A10")
    h = rmsnorm(x, lp["norm1"])
    if mode == "prefill_chunk":
        out, cache = attn_mod.paged_prefill_attention(
            h, lp["mixer"], cfg, cache, positions, page_table,
            kv_len=chunk_pos0 + h.shape[1])
    else:
        out, cache = attn_mod.paged_decode_attention(
            h, lp["mixer"], cfg, cache, pos, page_table)
    x = x + out
    h = rmsnorm(x, lp["norm2"])
    return x + mlp(h, lp["ffn"], cfg), cache


def _run_stack(x, params, cfg, positions, mode, cache, **kw):
    check_backend(cfg)
    _check_kinds(cfg)
    for i, lp in enumerate(params["layers"]):
        x, cache["layers"][i] = _apply_layer(x, lp, cfg, positions, mode,
                                             cache["layers"][i], **kw)
    return x, cache


def prefill_chunk(params, batch, cache, cfg, *, pos0: int):
    """One prompt chunk into the paged cache: ``batch["tokens"]`` (1, C)
    at positions [pos0, pos0+C), ``batch["page_table"]`` (1, max_pages).
    Returns (last-position logits (1, V) f32, cache)."""
    tokens = batch["tokens"]
    x = embed(tokens, params["embedding"], cfg)
    positions = pos0 + torch.arange(tokens.shape[1], device=x.device)[None]
    x, cache = _run_stack(x, params, cfg, positions, "prefill_chunk", cache,
                          page_table=batch["page_table"], chunk_pos0=pos0)
    x = rmsnorm(x, params["final_norm"])
    return unembed(x[:, -1:], params["embedding"], cfg)[:, 0], cache


def decode(params, batch, cache, cfg):
    """One-token decode: ``batch["tokens"]`` (B, 1), ``batch["pos"]`` (B,)
    per-slot positions, ``batch["page_table"]`` (B, max_pages).  Returns
    (logits (B, V) f32, cache)."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = embed(tokens, params["embedding"], cfg)
    pos = torch.as_tensor(batch["pos"], device=x.device).reshape(-1)
    positions = pos.to(torch.int64).expand(b).reshape(b, 1)
    x, cache = _run_stack(x, params, cfg, positions, "decode", cache,
                          pos=positions[:, 0],
                          page_table=batch["page_table"])
    x = rmsnorm(x, params["final_norm"])
    return unembed(x, params["embedding"], cfg)[:, 0], cache


def sample_token(logits, generator: Optional[torch.Generator], temperature):
    """One token per row: rows with temperature <= 0 take the f32 argmax
    (lowest index on ties, as XLA and numpy); rows above 0 draw from the
    tempered softmax with ``generator`` (torch's stream, not JAX's — only
    greedy rows are comparable across the two packages).  → (tokens (B,)
    int32, finite (B,) bool)."""
    lf = logits.float()
    temps = torch.as_tensor(temperature, dtype=torch.float32,
                            device=lf.device).reshape(-1).expand(lf.shape[0])
    tokens = lf.argmax(dim=-1).to(torch.int32)
    if bool((temps > 0).any()):
        safe = torch.where(temps > 0, temps, torch.ones_like(temps))
        probs = torch.softmax(lf / safe[:, None], dim=-1)
        drawn = torch.multinomial(probs, 1, generator=generator)[:, 0]
        tokens = torch.where(temps > 0, drawn.to(torch.int32), tokens)
    return tokens, torch.isfinite(lf).all(dim=-1)


def decode_and_sample(params, batch, cache, cfg, *, generator,
                      temperatures, active_rows):
    """Decode + sample in one call: → (tokens (B,), finite (B,),
    logits f32 (B, V), next_tokens (B, 1), cache); inactive rows keep
    their previous ``batch["tokens"]``."""
    logits, cache = decode(params, batch, cache, cfg)
    tokens, finite = sample_token(logits, generator, temperatures)
    active = torch.as_tensor(active_rows, dtype=torch.bool,
                             device=logits.device).reshape(-1)
    next_tokens = torch.where(active[:, None], tokens[:, None],
                              batch["tokens"].to(torch.int32))
    return tokens, finite, logits, next_tokens, cache
