"""Plain PyTorch oracles of ``repro/kernels/ref.py``.

One dot + epilogue, no blocking, f32 accumulation — a numerics bug in a
kernel or in a kernel's plain version cannot hide in a shared code path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.epilogue import Epilogue

__all__ = ["mte_gemm", "flash_attention", "flash_decode"]


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
        fmt = formats.resolve_format(format_policy, a.dtype)
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
