"""Autograd through the hand-written kernels (the port of
``repro/kernels/autodiff.py``).

The backward of a GEMM is two more GEMMs, so the MTE kernels are their
own backward engine::

    out   = epilogue(A @ B [, C, bias])
    dacc  = the autograd of the plain ``Epilogue.apply`` at the
            recomputed accumulator
    dA    = dacc @ Bᵀ         (kernel: B read as a transposed (N, K) B)
    dB    = Aᵀ @ dacc         (kernel: Aᵀ copied row-major first)
    dC, dbias from the epilogue's autograd

:class:`MteGemm`, :class:`GroupedGemm` and :class:`FlashAttention` are
the counterparts of JAX's ``mte_gemm_ad``, ``grouped_gemm_ad`` and
``flash_attention_ad``.  ``kernels/ops.py`` routes a call through them
when autograd is on and an input requires grad; otherwise it runs the
same forward with no graph recorded, so serving launches what it did.

- **Forward**: exactly ``ops``'s forward (the format's casts or int8
  quantize, the plan cache, B1/B2/B8, B3, B5), given as a callable.
- **Backward** (the straight-through estimator): on the full-precision
  residuals, the operands as the caller held them, in their promoted
  dtype (``ct``: f32 for bf16 activations against f32 parameters).  The
  accumulator is recomputed with the kernel where the epilogue's
  derivative reads it (an activation or a softcap); a linear epilogue's
  derivative does not, and JAX's compiled step drops that recompute as
  dead code, so the port does not launch it.  Every backward GEMM asks
  the plan cache for its own plan (B1, or B2 where the plan splits K) and
  launches a kernel on a CUDA tensor or raises: no library product
  stands in.  For the quantized formats the gradient equals the fp32
  gradient of the same operands: round and clip pass as identity.
- **Attention**: B5's backward recomputes through the plain attention
  (:func:`repro_torch.models.attention._xla_attention`) and differentiates
  it, as JAX recomputes through its ``_xla_attention`` (plain jnp, no
  Pallas kernel): plain PyTorch here too.
- **remat="dots"**: JAX's ``checkpoint_dots`` keeps the products' outputs
  and recomputes the rest.  A selective-checkpoint policy sees PyTorch's
  operators, and these Functions launch kernels outside them, so the
  policy is keyed on the Functions instead: inside a :class:`GemmStash`
  (one per checkpointed layer call) each GEMM Function's forward output
  is recorded, and in the checkpoint's recompute handed back in order,
  checked by shape and dtype, without a launch (:func:`stashed`).
  Outside a stash the Functions run as they always do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import deque
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import autotune
from repro_torch.core.epilogue import Epilogue

__all__ = ["wants_grad", "reads_acc", "raw_gemm", "raw_grouped",
           "epilogue_vjp", "gemm_vjp", "MteGemm", "GroupedGemm",
           "FlashAttention", "GemmStash", "stashed"]


class GemmStash:
    """The GEMM Functions' forward outputs of one checkpointed call under
    ``remat="dots"``.  The first :meth:`active` block (the forward)
    records each output; the second (the checkpoint's recompute) hands
    them back in order and is emptied when it ends, whether the recompute
    ran to its end or stopped early, so nothing is held past the layer's
    backward."""

    def __init__(self):
        self.outs = deque()
        self.recorded = False

    @contextlib.contextmanager
    def active(self):
        prev = getattr(_STASH, "current", None)
        _STASH.current = self
        try:
            yield
        finally:
            _STASH.current = prev
            if self.recorded:
                self.outs.clear()
            self.recorded = True


_STASH = threading.local()


def _like(out, want) -> bool:
    if isinstance(out, tuple):
        return len(out) == len(want) and all(
            _like(o, w) for o, w in zip(out, want))
    return tuple(out.shape) == tuple(want[0]) and out.dtype == want[1]


def stashed(forward_fn: Callable, want):
    """``forward_fn()``, a GEMM Function's forward, whose output has
    (shape, dtype) ``want`` (a tuple of them for a tuple of outputs).
    Inside a recording :class:`GemmStash` the output is also kept; inside
    a replaying one the kept output is returned instead of launching,
    after its shape and dtype are checked."""
    stash = getattr(_STASH, "current", None)
    if stash is None:
        return forward_fn()
    if stash.recorded:
        if not stash.outs:
            raise RuntimeError("remat='dots': the recompute ran more GEMMs "
                               "than the forward")
        out = stash.outs.popleft()
        if not _like(out, want):
            raise RuntimeError("remat='dots': a kept GEMM output does not "
                               "match the recompute's")
        return out
    out = forward_fn()
    stash.outs.append(tuple(o.detach() for o in out)
                      if isinstance(out, tuple) else out.detach())
    return out


def wants_grad(*tensors) -> bool:
    """True when autograd records and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def raw_gemm(a: torch.Tensor, b: torch.Tensor, policy: str = "mte", *,
             transposed_b: bool = False) -> torch.Tensor:
    """Plain ``a @ b`` at an f32 output through the planned route, no
    epilogue (JAX's ``_raw_gemm``).  ``b`` is (K, N), or (N, K) with
    ``transposed_b``: B1 reads it in place through its transposed-B
    geometry; the other routes (B2, B8) read a row-major B only, so they
    get a copy.  Backward GEMMs plan themselves, so a backward GEMM gets
    the plan its own shape earns."""
    m, k = a.shape
    n = b.shape[0] if transposed_b else b.shape[1]
    plan = autotune.get_plan(m, n, k, a.dtype, torch.float32, policy=policy)
    if transposed_b:
        if plan.route == "mte":
            plan = dataclasses.replace(plan, geometry=dataclasses.replace(
                plan.geometry, transposed_b=True))
        else:
            b = b.t().contiguous()
    return autotune.execute_plan(plan, a.contiguous(), b)


def raw_grouped(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain x (G, C, K) @ w (G, K, N) at an f32 output through the
    planned grouped route (B3), no epilogue."""
    g, c, k = x.shape
    plan = autotune.get_plan(c, w.shape[2], k, x.dtype, torch.float32,
                             group=g)
    return autotune.execute_plan(plan, x.contiguous(), w.contiguous())


def _transposed(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The last two axes of ``x`` swapped, row-major, at ``dtype``, in one
    pass."""
    shape = (*x.shape[:-2], x.shape[-1], x.shape[-2])
    out = torch.empty(shape, dtype=dtype, device=x.device)
    return out.copy_(x.transpose(-1, -2))


def reads_acc(epilogue: Epilogue) -> bool:
    """True when the epilogue's derivative depends on the accumulator."""
    return epilogue.activation != "none" or epilogue.softcap is not None


def epilogue_vjp(epilogue: Epilogue, acc: Optional[torch.Tensor], g,
                 out_dtype, *, shape, c=None, bias=None):
    """(dacc, dC, dbias) of ``epilogue.apply(acc, c, bias)`` cast to
    ``out_dtype``, by autograd at ``acc`` (f32).  ``acc`` None stands for
    an accumulator the derivative does not read (a zero one of
    ``shape``)."""
    if acc is None:
        acc = torch.zeros(shape, dtype=torch.float32, device=g.device)
    with torch.enable_grad():
        leaves = [acc.detach().requires_grad_()]
        c_ = bias_ = None
        if c is not None:
            c_ = c.detach().requires_grad_()
            leaves.append(c_)
        if bias is not None:
            bias_ = bias.detach().requires_grad_()
            leaves.append(bias_)
        out = epilogue.apply(leaves[0], c_in=c_, bias=bias_).to(out_dtype)
        grads = list(torch.autograd.grad(out, leaves, g, allow_unused=True))
    dacc = grads.pop(0)
    dc = grads.pop(0) if c is not None else None
    dbias = grads.pop(0) if bias is not None else None
    return dacc, dc, dbias


def gemm_vjp(a, b, epilogue: Epilogue, g, out_dtype, *, c=None, bias=None,
             policy: str = "mte", need_a: bool = True, need_b: bool = True,
             a_t: Optional[torch.Tensor] = None):
    """(dA, dB, dC, dbias) of ``epilogue(a @ b [, c, bias])`` cast to
    ``out_dtype``, at the cotangent ``g``: the straight-through backward.
    The operands are taken at their promoted dtype ``ct``; the accumulator
    is recomputed on the kernel where the epilogue's derivative reads it,
    ``dA = dacc @ Bᵀ`` and ``dB = Aᵀ @ dacc`` run on the kernels at
    ``ct`` (``a_t``, when given, is Aᵀ already row-major at ``ct``), and
    dA / dB come back at ``ct``; either is None when not needed."""
    ct = torch.promote_types(a.dtype, b.dtype)
    af, bf = a.to(ct), b.to(ct)
    acc = raw_gemm(af, bf, policy) if reads_acc(epilogue) else None
    dacc, dc, dbias = epilogue_vjp(
        epilogue, acc, g, out_dtype, shape=(a.shape[0], b.shape[1]),
        c=c if epilogue.needs_c_input else None,
        bias=bias if epilogue.has_bias else None)
    dacc = dacc.to(ct)
    da = raw_gemm(dacc, bf, policy, transposed_b=True) if need_a else None
    db = None
    if need_b:
        db = raw_gemm(a_t if a_t is not None else _transposed(af, ct), dacc,
                      policy)
    return da, db, dc, dbias


class MteGemm(torch.autograd.Function):
    """``epilogue(a @ b [, c, bias])`` whose backward runs on the kernels
    (``mte_gemm_ad`` in JAX).  ``forward_fn`` computes the forward (the
    format's casts or quantize and the planned launch)."""

    @staticmethod
    def forward(ctx, a, b, c, bias, forward_fn: Callable[[], torch.Tensor],
                epilogue: Epilogue, policy: str, out_dtype):
        ctx.save_for_backward(a, b, c, bias)
        ctx.epilogue, ctx.policy, ctx.out_dtype = epilogue, policy, out_dtype
        return stashed(forward_fn, ((a.shape[0], b.shape[1]), out_dtype))

    @staticmethod
    def backward(ctx, g):
        a, b, c, bias = ctx.saved_tensors
        da, db, dc, dbias = gemm_vjp(
            a, b, ctx.epilogue, g, ctx.out_dtype, c=c, bias=bias,
            policy=ctx.policy, need_a=ctx.needs_input_grad[0],
            need_b=ctx.needs_input_grad[1])
        da = da.to(a.dtype) if da is not None else None
        db = db.to(b.dtype) if db is not None else None
        dc = dc.to(c.dtype) if dc is not None else None
        dbias = dbias.to(bias.dtype) if dbias is not None else None
        return da, db, dc, dbias, None, None, None, None


class GroupedGemm(torch.autograd.Function):
    """x (G, C, K) @ w (G, K, N) with a per-group epilogue, whose backward
    runs on B3 (``grouped_gemm_ad`` in JAX): ``dx = dacc @ wᵀ`` and
    ``dw = xᵀ @ dacc``, each group's operand transposed row-major.  The
    columns past each member's ``widths`` come back as zeros whatever x
    and w hold, so no gradient flows through them."""

    @staticmethod
    def forward(ctx, x, w, forward_fn: Callable[[], torch.Tensor],
                epilogue: Epilogue, out_dtype,
                widths: Optional[Sequence[int]]):
        ctx.save_for_backward(x, w)
        ctx.epilogue, ctx.out_dtype, ctx.widths = epilogue, out_dtype, widths
        return stashed(forward_fn,
                       ((x.shape[0], x.shape[1], w.shape[2]), out_dtype))

    @staticmethod
    def backward(ctx, g):
        x_in, w_in = ctx.saved_tensors
        epi = ctx.epilogue
        ct = torch.promote_types(x_in.dtype, w_in.dtype)
        x, w = x_in.to(ct), w_in.to(ct)
        acc = raw_grouped(x, w) if reads_acc(epi) else None
        dacc, _, _ = epilogue_vjp(epi, acc, g, ctx.out_dtype,
                                  shape=(*x.shape[:2], w.shape[2]))
        if ctx.widths is not None:
            cols = torch.arange(w.shape[2], device=g.device)
            live = cols[None, :] < torch.as_tensor(
                ctx.widths, device=g.device)[:, None]
            dacc = dacc * live[:, None, :]
        dacc = dacc.to(ct).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = raw_grouped(dacc, _transposed(w, ct)).to(x_in.dtype)
        if ctx.needs_input_grad[1]:
            dw = raw_grouped(_transposed(x, ct), dacc).to(w_in.dtype)
        return dx, dw, None, None, None, None


class FlashAttention(torch.autograd.Function):
    """Blocked attention on B5 whose backward recomputes through the plain
    attention and differentiates it (``flash_attention_ad`` in JAX):
    queries right-aligned to the keys, as the kernel places them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                softcap: Optional[float], scale: Optional[float]):
        from repro_torch.kernels.flash_attention import \
            flash_attention_kernel
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, scale)
        return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      softcap=softcap, scale=scale)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import _xla_attention
        q, k, v = ctx.saved_tensors
        causal, window, softcap, scale = ctx.args
        b, sq, skv = q.shape[0], q.shape[2], k.shape[2]
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        dev = q.device
        q_pos = (torch.arange(sq, device=dev) + (skv - sq))[None].expand(b,
                                                                        sq)
        kv_pos = torch.arange(skv, device=dev)[None].expand(b, skv)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _xla_attention(*leaves, causal=causal, window=window,
                                 softcap=softcap, scale=scale,
                                 kv_positions=kv_pos, q_positions=q_pos)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None, None
