"""Shared layers (the port of ``repro/models/layers.py``, eager path).

Every projection goes through :func:`repro_torch.kernels.ops.mte_gemm`
under the model's :class:`~repro_torch.core.formats.FormatPolicy`, with
bias and activation fused into the kernel's epilogue.  Parameters are plain
dictionaries of tensors, as in the JAX package.  ``init_*`` functions draw
from the same distributions as JAX's, from an explicit ``torch.Generator``
(so not the same bits).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import formats as formats_lib
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.formats import to_torch_dtype

__all__ = ["dense", "rmsnorm", "rope", "init_dense", "init_norm", "mlp",
           "init_mlp", "init_embedding", "embed", "unembed", "model_format",
           "check_backend", "compute_dtype"]


def compute_dtype(cfg) -> torch.dtype:
    return to_torch_dtype(cfg.compute_dtype)


def model_format(cfg) -> formats_lib.FormatPolicy:
    """``cfg.format_policy`` if set, else inferred from the compute dtype."""
    return formats_lib.resolve_format(getattr(cfg, "format_policy", None),
                                      compute_dtype(cfg))


def check_backend(cfg) -> None:
    """Raise for the execution knobs the port does not run yet."""
    if cfg.gemm_backend == "torch":
        raise NotImplementedError(
            "gemm_backend='torch' (the JAX 'xla' formulation) is queued "
            "(ROADMAP queue A: the 'torch' backend)")
    if cfg.gemm_backend != "kernels":
        raise ValueError(f"unknown gemm_backend {cfg.gemm_backend!r}")
    if cfg.use_graph:
        raise NotImplementedError("use_graph=True needs the repro.graph "
                                  "port (ROADMAP A7)")


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32,
               scale: Optional[float] = None, device=None):
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn(d_in, d_out, generator=gen, dtype=dtype,
                    device=device) * scale
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def dense(x: torch.Tensor, p, cfg, *, activation: str = "none"):
    """``act(x @ w + b)`` through the kernel GEMM; x: (..., d_in)."""
    check_backend(cfg)
    from repro_torch.kernels import ops
    b = p.get("b")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    epi = Epilogue(has_bias=b is not None, activation=activation)
    y = ops.mte_gemm(x2, p["w"], bias=b.float() if b is not None else None,
                     epilogue=epi, policy=cfg.gemm_policy,
                     out_dtype=compute_dtype(cfg),
                     format_policy=model_format(cfg))
    return y.reshape(*lead, -1)


def init_norm(d: int, kind: str, dtype=torch.float32, device=None):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is ROADMAP A10")
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(x: torch.Tensor, p, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embeddings.  x: (B, S, H, hd); positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen: torch.Generator, cfg, device=None):
    d, f = cfg.d_model, cfg.d_ff
    dt = to_torch_dtype(cfg.param_dtype)
    if cfg.mlp_type not in ("swiglu", "geglu"):
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is ROADMAP A10")
    return {
        "gate": init_dense(gen, d, f, bias=cfg.mlp_bias, dtype=dt,
                           device=device),
        "up": init_dense(gen, d, f, bias=cfg.mlp_bias, dtype=dt,
                         device=device),
        "down": init_dense(gen, f, d, bias=cfg.mlp_bias, dtype=dt,
                           scale=f ** -0.5, device=device),
    }


def mlp(x: torch.Tensor, p, cfg) -> torch.Tensor:
    """Gated MLP, eager: gate (fused activation) · up → down."""
    act = {"swiglu": "silu", "geglu": "gelu"}.get(cfg.mlp_type)
    if act is None:
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is ROADMAP A10")
    g = dense(x, p["gate"], cfg, activation=act)
    u = dense(x, p["up"], cfg)
    return dense(g * u, p["down"], cfg)


def init_embedding(gen: torch.Generator, cfg, device=None):
    dt = to_torch_dtype(cfg.param_dtype)
    if not cfg.tied_embeddings:
        raise NotImplementedError("untied LM heads are ROADMAP A10")
    return {"table": torch.randn(cfg.vocab, cfg.d_model, generator=gen,
                                 dtype=dt, device=device) * 0.02}


def embed(tokens: torch.Tensor, p, cfg) -> torch.Tensor:
    """Table lookup in the compute dtype, then × sqrt(d_model) cast to the
    compute dtype first (45.2548 → 45.25 in bf16), as in JAX."""
    x = p["table"][tokens.long()].to(compute_dtype(cfg))
    if cfg.embed_scale:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def unembed_operand_dtype(cfg) -> torch.dtype:
    fmt = model_format(cfg)
    return compute_dtype(cfg) if fmt.quantized else fmt.operand_torch


def unembed(x: torch.Tensor, p, cfg) -> torch.Tensor:
    """LM head → f32 logits from operands rounded to the head's operand
    dtype (JAX: einsum with ``preferred_element_type=f32``).  A plain
    library matmul in f32 on the rounded values: products of bf16 values
    are exact in f32.  ``p["unembed"]``, when the engine prepared it, is
    the table already rounded and widened (kept on the card so the
    widening is not redone per call)."""
    odt = unembed_operand_dtype(cfg)
    w = p.get("unembed")
    if w is None:
        w = p["table"].to(odt).float()
    logits = torch.matmul(x.to(odt).float(), w.t())
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
