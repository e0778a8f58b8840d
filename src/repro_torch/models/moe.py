"""Mixture-of-Experts block with capacity-based top-k routing (the port of
``repro/models/moe.py``).

Every expert is a small, skinny GEMM (granite_moe_1b: d_ff 512 over
d_model 1024), so the experts run as three grouped GEMMs (B3,
:func:`repro_torch.kernels.ops.grouped_gemm`) over an (E, C, D) dispatch
buffer, each expert its own x: gate with the SiLU in its epilogue, up,
and down over ``g * u``, under the model's format policy (per-expert,
per-channel scales under int8).

The dispatch is JAX's ``apply_moe`` (``moe.py:107-135`` of the JAX
package) with static shapes and no host sync, so a decode step holding
it can be captured as a CUDA graph:

- routing: an f32 router product (TF32 is off in the port), softmax, the
  top k by a stable descending sort, so equal probabilities keep the
  lower expert first, as ``jax.lax.top_k`` orders them;
- capacity C = :func:`moe_capacity` of the call's token count (every
  row counts: left-padded prompt tokens, empty decode slots);
- each assignment's slot in its expert's queue, token-major then k
  (:func:`_positions_in_expert`); assignments at slot C or past it are
  dropped: they are written into a spare row past the E·C rows the
  experts read (JAX's ``mode="drop"`` scatter) and read back as zeros
  (its ``mode="fill"`` gather);
- the combine, ``gathered * weights`` summed over k, in the buffer's
  dtype.

JAX's ``apply_moe_a2a`` (all-to-all expert parallelism) needs a device
mesh with a "model" axis; the port runs on one card with none, and JAX's
dispatch rule then takes ``apply_moe`` too (:func:`dispatch`).  The
all-to-all path waits for ROADMAP A12.
"""
from __future__ import annotations

import torch

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.formats import to_torch_dtype
from repro_torch.models.layers import (check_backend, compute_dtype,
                                       init_dense, model_format)

__all__ = ["init_moe", "moe_capacity", "apply_moe", "dispatch",
           "route_stats"]


def init_moe(gen: torch.Generator, cfg, device=None):
    """``router`` (d_model, E), N(0, 1/d_model), and the experts'
    ``gate``/``up`` (E, d_model, d_ff_expert), N(0, 1/d_model), and
    ``down`` (E, d_ff_expert, d_model), N(0, 1/d_ff_expert): JAX's
    distributions (``moe.py:37-48`` there), not its bits."""
    d, m = cfg.d_model, cfg.moe
    e, f = m.n_experts, m.d_ff_expert
    dt = to_torch_dtype(cfg.param_dtype)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device) * scale

    return {"router": init_dense(gen, d, e, dtype=dt, device=device)["w"],
            "gate": normal((e, d, f), d ** -0.5),
            "up": normal((e, d, f), d ** -0.5),
            "down": normal((e, f, d), f ** -0.5)}


def moe_capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens: T·k/E ×
    the capacity factor, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    cap = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def _route(x2, router_w, cfg):
    """Top-k routing of x2 (T, D) → weights (T, k) f32, expert ids (T, k),
    and the Switch load-balance aux loss (a 0-d f32 tensor)."""
    m = cfg.moe
    logits = torch.matmul(x2.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    # A stable descending sort keeps equal probabilities in expert order,
    # the order jax.lax.top_k gives them; torch.topk promises none.
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :m.top_k], idx[:, :m.top_k]
    vals = vals / vals.sum(dim=-1, keepdim=True)
    experts = torch.arange(m.n_experts, device=x2.device)
    density = (idx[..., None] == experts).float().sum(dim=(0, 1)) \
        / idx.numel()
    mean_prob = probs.sum(dim=0) / probs.shape[0]
    aux = m.n_experts * (density * mean_prob).sum() * m.router_aux_weight
    return vals, idx, aux


def _positions_in_expert(flat_e, n_experts: int):
    """Each assignment's slot in its expert's queue, in assignment order.
    The one-hot is laid out (E, assignments), so the running count is a
    scan along the contiguous axis: on the card a scan across rows of a
    (4096, 32) one-hot took 0.75 ms a layer."""
    experts = torch.arange(n_experts, device=flat_e.device)
    oh = (experts[:, None] == flat_e).to(torch.int32)
    return (oh.cumsum(dim=1) * oh).sum(dim=0) - 1


def _slots(x2, p, cfg):
    """Routing and dispatch slots of the T tokens x2 (T, D): weights,
    expert ids, aux, the flat buffer row of every assignment (expert ·
    C + slot; the spare row E·C where dropped), its keep mask, and C."""
    m = cfg.moe
    vals, idx, aux = _route(x2, p["router"], cfg)
    cap = moe_capacity(x2.shape[0], cfg)
    flat_e = idx.reshape(-1)
    pos = _positions_in_expert(flat_e, m.n_experts)
    keep = pos < cap
    rows = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, m.n_experts * cap))
    return vals, idx, aux, rows, keep, cap


def _expert_ffn(buf, p, cfg):
    """The experts' SwiGLU over the (E, C, D) dispatch buffer: three
    grouped GEMMs with a per-expert x under the model's format policy
    (``moe.py:80-97`` of the JAX package)."""
    from repro_torch.kernels import ops
    check_backend(cfg)
    cdt = compute_dtype(cfg)
    fmt = model_format(cfg)
    g = ops.grouped_gemm(buf, p["gate"],
                         epilogue=Epilogue(activation="silu"),
                         out_dtype=cdt, format_policy=fmt)
    u = ops.grouped_gemm(buf, p["up"], out_dtype=cdt, format_policy=fmt)
    return ops.grouped_gemm(g * u, p["down"], out_dtype=cdt,
                            format_policy=fmt)


def apply_moe(x, p, cfg):
    """Capacity-dispatch MoE: x (B, S, D) → (y (B, S, D), aux)."""
    b, s, d = x.shape
    m = cfg.moe
    x2 = x.reshape(-1, d)
    t = x2.shape[0]
    vals, _, aux, rows, keep, cap = _slots(x2, p, cfg)
    e_rows = m.n_experts * cap
    # Row e·C + slot of a flat buffer holds an expert's slot; dropped
    # assignments land in the spare last row, which no expert reads.
    flat = x.new_zeros(e_rows + 1, d)
    flat[rows] = x2[:, None].expand(t, m.top_k, d).reshape(-1, d)
    out = _expert_ffn(flat[:e_rows].view(m.n_experts, cap, d), p, cfg)
    out = out.reshape(e_rows, d)
    gathered = out[rows.clamp(max=e_rows - 1)]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=x.device))
    weighted = gathered.reshape(t, m.top_k, d) * vals[..., None].to(
        gathered.dtype)
    return weighted.sum(dim=1).reshape(b, s, d).to(x.dtype), aux


def dispatch(h, p, cfg):
    """The MoE layer of a model (JAX's ``_moe_dispatch``,
    ``model.py:280-293`` there): ``moe_impl="a2a"`` takes the all-to-all
    path only under a device mesh with a "model" axis; on one device --
    the port's only setting -- both ``"a2a"`` and ``"scatter"`` run
    :func:`apply_moe`."""
    if cfg.moe_impl not in ("scatter", "a2a"):
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    return apply_moe(h, p, cfg)


def route_stats(x, p, cfg):
    """→ (expert ids (T, k), keep mask (T·k,) bool, capacity C) of the
    tokens x (..., D), as :func:`apply_moe` routes them: the assignments
    it drops are those whose ``keep`` is False."""
    _, idx, _, _, keep, cap = _slots(x.reshape(-1, x.shape[-1]), p, cfg)
    return idx, keep, cap
