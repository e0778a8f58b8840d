"""Shared layers (the port of ``repro/models/layers.py``).

Every projection goes through :func:`dense` under the model's
:class:`~repro_torch.core.formats.FormatPolicy`: on the kernel backend
(``cfg.gemm_backend="kernels"``, the default) one
:func:`repro_torch.kernels.ops.mte_gemm` with bias and activation fused
into the kernel's epilogue, on ``"torch"`` (JAX's ``"xla"``) the
library's product and the epilogue in plain PyTorch.  With
``cfg.use_graph`` (the default) the kernel backend runs the MLP block as
ONE compiled :mod:`repro_torch.graph` program (:func:`_mlp_compiled`).
Parameters are plain dictionaries of tensors, as in the JAX package.
``init_*`` functions draw from the same distributions as JAX's, from an
explicit ``torch.Generator`` (so not the same bits).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import GEMM_BACKENDS
from repro_torch.core import formats as formats_lib
from repro_torch.core.epilogue import ACTIVATIONS, Epilogue
from repro_torch.core.formats import to_torch_dtype

__all__ = ["dense", "rmsnorm", "layernorm", "norm", "rope", "init_dense",
           "init_norm", "mlp", "init_mlp", "init_embedding", "embed",
           "unembed", "model_format", "check_backend", "on_kernels",
           "compute_dtype", "use_graph"]


def compute_dtype(cfg) -> torch.dtype:
    return to_torch_dtype(cfg.compute_dtype)


def model_format(cfg) -> formats_lib.FormatPolicy:
    """``cfg.format_policy`` if set, else inferred from the compute dtype."""
    return formats_lib.resolve_format(getattr(cfg, "format_policy", None),
                                      compute_dtype(cfg))


def check_backend(cfg) -> None:
    """Raise ValueError for a GEMM backend the port does not have: the
    hand-written kernels (``"kernels"``, JAX's ``"pallas"``) or the plain
    formulation on the library's products (``"torch"``, JAX's
    ``"xla"``)."""
    if cfg.gemm_backend not in GEMM_BACKENDS:
        raise ValueError(f"unknown gemm_backend {cfg.gemm_backend!r}; the "
                         f"port's are {GEMM_BACKENDS}")


def on_kernels(cfg) -> bool:
    """True on the kernel backend, False on ``"torch"`` (ValueError for
    any other name)."""
    check_backend(cfg)
    return cfg.gemm_backend == "kernels"


def use_graph(cfg) -> bool:
    """True when layer pipelines execute as compiled
    :mod:`repro_torch.graph` programs: ``cfg.use_graph`` on the kernel
    backend (the program's decisions are plan-cache grants)."""
    return (bool(getattr(cfg, "use_graph", False))
            and cfg.gemm_backend == "kernels")


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


def dense(x: torch.Tensor, p, cfg, *, activation: str = "none",
          plan_rows: Optional[int] = None):
    """``act(x @ w + b)``; x: (..., d_in).  On the kernel backend one
    kernel GEMM with bias and activation fused into its epilogue;
    ``plan_rows`` runs it on the plan of that many rows
    (``ops.mte_gemm``): a verify window on the decode step's plan.  On
    the ``"torch"`` backend JAX's xla branch (``layers.py:81-86`` there):
    the library's product at the format's accumulator
    (``formats.torch_gemm``), then in f32 the bias and the activation,
    then the cast; with ``plan_rows`` a (B, K, d_in) window of B =
    ``plan_rows`` rows runs as K products of its B rows, one per
    position, so each row gets the product a decode step makes."""
    b = p.get("b")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not on_kernels(cfg):
        def run(rows):
            y = formats_lib.torch_gemm(rows, p["w"], model_format(cfg))
            y = y.float()
            if b is not None:
                y = y + b.float()
            return ACTIVATIONS[activation](y).to(compute_dtype(cfg))

        if plan_rows is not None and x.ndim == 3 and x.shape[1] > 1:
            return torch.stack([run(x[:, i].contiguous())
                                for i in range(x.shape[1])], dim=1)
        return run(x2).reshape(*lead, -1)
    from repro_torch.kernels import ops
    epi = Epilogue(has_bias=b is not None, activation=activation)
    y = ops.mte_gemm(x2, p["w"], bias=b.float() if b is not None else None,
                     epilogue=epi, policy=cfg.gemm_policy,
                     out_dtype=compute_dtype(cfg),
                     format_policy=model_format(cfg), plan_rows=plan_rows)
    return y.reshape(*lead, -1)


_NORM_KINDS = ("rmsnorm", "layernorm")


def init_norm(d: int, kind: str, dtype=torch.float32, device=None):
    """``{"scale"}`` of ones, and for ``"layernorm"`` a zero ``"bias"``."""
    if kind not in _NORM_KINDS:
        raise NotImplementedError(f"norm {kind!r} is ROADMAP A10")
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def rmsnorm(x: torch.Tensor, p, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """JAX's arithmetic (``layers.py:100-107`` of the JAX package): f32
    mean and population variance over the last axis, ``rsqrt(var +
    eps)``, scale and bias in f32, cast back.  Each row on its own, so a
    row's bits do not depend on the rows beside it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def norm(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    """The config's norm (``cfg.norm_type``) at its default eps."""
    return layernorm(x, p) if kind == "layernorm" else rmsnorm(x, p)


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


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S by shifted adds: x (B, S, C), w
    (width, C), b (C) — the RG-LRU's and the SSD's short conv."""
    width = w.shape[0]
    out = x * w[-1]
    for i in range(1, width):
        shifted = torch.nn.functional.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
        out = out + shifted * w[-1 - i]
    return out + b


def keep_rows(old: torch.Tensor, new: torch.Tensor,
              row_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """``new`` where ``row_valid`` (B,) is True, ``old`` elsewhere (all of
    ``new`` without it): a recurrent decode step's state update under
    JAX's ``_mask_rows`` contract."""
    if row_valid is None:
        return new
    return torch.where(row_valid.reshape(-1, *[1] * (new.ndim - 1)), new,
                       old)


def init_mlp(gen: torch.Generator, cfg, device=None):
    d, f = cfg.d_model, cfg.d_ff
    dt = to_torch_dtype(cfg.param_dtype)
    _mlp_act(cfg)                     # refuses an unported mlp_type
    p = {}
    if _gated(cfg):
        p["gate"] = init_dense(gen, d, f, bias=cfg.mlp_bias, dtype=dt,
                               device=device)
    p["up"] = init_dense(gen, d, f, bias=cfg.mlp_bias, dtype=dt,
                         device=device)
    p["down"] = init_dense(gen, f, d, bias=cfg.mlp_bias, dtype=dt,
                           scale=f ** -0.5, device=device)
    return p


def _mlp_act(cfg) -> str:
    """The activation fused into the gate (gated MLPs) or into ``up``
    (the plain ``"gelu"`` MLP)."""
    act = {"swiglu": "silu", "geglu": "gelu", "gelu": "gelu"}.get(
        cfg.mlp_type)
    if act is None:
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is ROADMAP A10")
    return act


def _gated(cfg) -> bool:
    return cfg.mlp_type in ("swiglu", "geglu")


def mlp(x: torch.Tensor, p, cfg, *,
        plan_rows: Optional[int] = None) -> torch.Tensor:
    """The MLP, eager or as one compiled program: gated (gate with the
    fused activation, · up, → down) or plain (``up`` with the fused
    GELU → ``down``).  ``plan_rows`` runs it on the plans, and the
    program, of an input of that many rows (see :func:`dense`)."""
    act = _mlp_act(cfg)
    if use_graph(cfg):
        return _mlp_compiled(x, p, cfg, plan_rows)
    if not _gated(cfg):
        h = dense(x, p["up"], cfg, activation=act, plan_rows=plan_rows)
        return dense(h, p["down"], cfg, plan_rows=plan_rows)
    g = dense(x, p["gate"], cfg, activation=act, plan_rows=plan_rows)
    u = dense(x, p["up"], cfg, plan_rows=plan_rows)
    return dense(g * u, p["down"], cfg, plan_rows=plan_rows)


def _mlp_compiled(x: torch.Tensor, p, cfg,
                  plan_rows: Optional[int] = None) -> torch.Tensor:
    """The MLP block as ONE compiled :mod:`repro_torch.graph` program
    (``layers.py:173-226`` of the JAX package).

    Same math as the eager path (each projection a GemmNode carrying the
    dense epilogue), scheduled at program level: a gated MLP's gate and
    up share the input and become one grouped launch (B3) when the Hopper
    model says grouping pays; the plain MLP is two GemmNodes, ``up`` with
    bias and GELU, then ``down``.  Memoized per (shape, format, type):
    repeat calls skip graph construction, and gated and plain programs
    never share a key.  With ``plan_rows`` the program is the one
    compiled for that many rows, grouping decision and plans included."""
    from repro_torch.graph import schedule as graph_schedule
    from repro_torch.graph.trace import GraphBuilder

    cdt = compute_dtype(cfg)
    fmt = model_format(cfg)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m, d = x2.shape
    m = m if plan_rows is None else plan_rows
    act = _mlp_act(cfg)
    gated = _gated(cfg)
    names = ("gate", "up", "down") if gated else ("up", "down")
    biased = tuple(n for n in names if "b" in p[n])

    def build():
        b = GraphBuilder()
        xv = b.input((m, d), x2.dtype, "x")
        wv = {n: b.input(p[n]["w"].shape, p[n]["w"].dtype, f"w_{n}")
              for n in names}
        bv = {n: b.input((p[n]["w"].shape[1],), "float32", f"b_{n}")
              for n in biased}

        def proj(src, n, activation="none"):
            return b.gemm(src, wv[n], bias=bv.get(n),
                          epilogue=Epilogue(has_bias=n in biased,
                                            activation=activation),
                          fmt=fmt.name, out_dtype=cdt,
                          policy=cfg.gemm_policy, name=n)

        if gated:
            h = b.mul(proj(xv, "gate", act), proj(xv, "up"))
        else:
            h = proj(xv, "up", act)
        b.output(proj(h, "down"))
        return b.build()

    key = ("mlp", cfg.mlp_type, m, d, cfg.d_ff, fmt.name, str(cdt),
           cfg.gemm_policy, biased, str(x2.dtype),
           str(p[names[0]]["w"].dtype))
    prog = graph_schedule.compile_cached(key, build)
    args = [x2] + [p[n]["w"] for n in names] \
        + [p[n]["b"].float() for n in biased]
    return prog(*args).reshape(*lead, -1)


def init_embedding(gen: torch.Generator, cfg, device=None):
    """The embedding ``table`` (vocab, d_model), N(0, 0.02²), and for an
    untied model the LM ``head`` at JAX's layout (d_model, vocab),
    N(0, 1/d_model) (``layers.py:238-245`` of the JAX package)."""
    dt = to_torch_dtype(cfg.param_dtype)
    p = {"table": torch.randn(cfg.vocab, cfg.d_model, generator=gen,
                              dtype=dt, device=device) * 0.02}
    if not cfg.tied_embeddings:
        p["head"] = torch.randn(cfg.d_model, cfg.vocab, generator=gen,
                                dtype=dt, device=device) \
            * cfg.d_model ** -0.5
    return p


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
    dtype (JAX: einsum with ``preferred_element_type=f32``): the tied
    table (vocab, d_model), or the untied ``head`` (d_model, vocab).  A
    plain library matmul in f32 on the rounded values: products of bf16
    values are exact in f32.  ``p["unembed"]``, when the engine prepared
    it, is that matrix already rounded and widened, in its own layout
    (kept on the card so the widening is not redone per call)."""
    odt = unembed_operand_dtype(cfg)
    w = p.get("unembed")
    if w is None:
        w = (p["table"] if cfg.tied_embeddings else p["head"]).to(odt).float()
    logits = torch.matmul(x.to(odt).float(),
                          w.t() if cfg.tied_embeddings else w)
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits
