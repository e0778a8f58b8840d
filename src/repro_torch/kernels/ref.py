"""Plain PyTorch oracles of ``repro/kernels/ref.py``.

One dot + epilogue, no blocking, f32 accumulation — a numerics bug in a
kernel or in a kernel's plain version cannot hide in a shared code path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.epilogue import Epilogue

__all__ = ["mte_gemm", "grouped_gemm", "rigid_gemm", "flash_attention",
           "flash_decode", "rglru_scan"]


def mte_gemm(a, b, c=None, bias=None, *, epilogue: Epilogue = Epilogue(),
             out_dtype=torch.float32, b_transposed: bool = False,
             format_policy=None):
    """Oracle for mte_gemm: one dot + epilogue.  With a ``format_policy``
    the oracle replicates the policy's contract (cast / int8 quantize,
    accumulate, dequantize, epilogue)."""
    if b_transposed:
        b = b.t()
    if format_policy is not None:
        from repro_torch.core import formats
        from repro_torch.telemetry import gemm_account
        fmt = formats.resolve_format(format_policy, a.dtype)
        with gemm_account.suppress():   # oracle math, not a dispatch
            acc = formats.torch_gemm(a, b, fmt)
        out = epilogue.apply(acc.float() if fmt.quantized else acc,
                             c_in=c, bias=bias)
        return out.to(out_dtype)
    if not a.dtype.is_floating_point:
        from repro_torch.core.formats import int_matmul
        acc = int_matmul(a, b)
    else:
        acc = torch.matmul(a.float(), b.float())
    return epilogue.apply(acc, c_in=c, bias=bias).to(out_dtype)


def grouped_gemm(x, w, *, epilogue: Epilogue = Epilogue(),
                 out_dtype=torch.float32, format_policy=None):
    """Oracle for the grouped GEMM: x (G, C, K) @ w (G, K, N) → (G, C, N),
    one batched dot + epilogue (no C, no bias).  ``format_policy``
    replicates the policy's contract as in :func:`mte_gemm`."""
    if format_policy is not None:
        from repro_torch.core import formats
        from repro_torch.telemetry import gemm_account
        fmt = formats.resolve_format(format_policy, x.dtype)
        with gemm_account.suppress():   # oracle math, not a dispatch
            acc = formats.torch_grouped(x, w, fmt)
        out = epilogue.apply(acc.float() if fmt.quantized else acc)
        return out.to(out_dtype)
    if not x.dtype.is_floating_point:
        from repro_torch.core.formats import int_matmul
        acc = int_matmul(x, w)
    else:
        acc = torch.matmul(x.float(), w.float())
    return epilogue.apply(acc).to(out_dtype)


def rigid_gemm(a, b, c=None, bias=None, *, epilogue: Epilogue = Epilogue(),
               out_dtype=torch.float32):
    """Oracle for the rigid baseline: the raw accumulator of one dot (f32,
    int32 for integer operands), then the epilogue as a separate step."""
    if not a.dtype.is_floating_point:
        from repro_torch.core.formats import int_matmul
        acc = int_matmul(a, b)
    else:
        acc = torch.matmul(a.float(), b.float())
    if epilogue.is_identity:
        return acc.to(out_dtype)
    return epilogue.apply(acc.float(), c_in=c, bias=bias).to(out_dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """Oracle for the blocked attention kernel (KV repeated for GQA)."""
    b, h, sq, d = q.shape
    g = h // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    skv = k.shape[2]
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window is not None:
        mask &= kv_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def flash_decode(q, k, v, kv_positions, q_pos, *, window=None, softcap=None,
                 scale=None):
    """Oracle for one-token attention over a flat cache: q (B,H,D);
    k/v (B,Hkv,S,D); kv_positions (B,S) (−1 ⇒ unwritten); q_pos (B,)."""
    b, h, d = q.shape
    g = h // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    kp = kv_positions[:, None, :]
    qp = q_pos[:, None, None]
    mask = (kp >= 0) & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhk,bhkd->bhd", probs, v.float()).to(q.dtype)


def rglru_scan(a, b):
    """Oracle for the RG-LRU recurrence kernel: h_t = a_t·h_{t-1} + b_t
    along axis 1 from h_{-1} = 0.  a, b: (B, S, W)."""
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
