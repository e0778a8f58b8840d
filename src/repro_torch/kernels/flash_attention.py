"""B5: blocked (flash) attention — CUDA kernel and plain version.

:func:`flash_attention_kernel` is the counterpart of
``flash_attention_pallas`` (``repro/kernels/flash_attention.py``):
q (B, H, Sq, D); k/v (B, Hkv, Skv, D) with H % Hkv == 0 and Sq ≤ Skv.
Queries are right-aligned (position ``i + Skv − Sq``, the chunked-prefill
case); causal mask, sliding window and softcap; GQA by an index fold;
fully masked rows give zeros.  Returns (B, H, Sq, D) in q.dtype.

Two engines, chosen by :func:`repro_torch.core.geometry.attention_engine`
(never a fallback): TMA + wgmma (``csrc/flash_attention_wgmma.cu``,
counter ``flash_attention_wgmma``) for bf16 at D ∈ {64, 128, 256} — it
rounds P to bf16 before P·V, where the plain version keeps f32 — and the
SIMT kernel (``csrc/flash_attention.cu``, counter ``flash_attention``)
for fp32 and other head dims up to 256.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.geometry import attention_engine, attention_kv_split
from repro_torch.kernels import build
from repro_torch.kernels.mte_gemm import DTYPE_CODES

__all__ = ["flash_attention_kernel", "flash_attention_torch"]

_NEG_INF = -1e30
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _scale(d: int, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / (d ** 0.5)


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_kernel`."""
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if h % hkv != 0:
        raise ValueError(f"GQA requires H % Hkv == 0, got {h} % {hkv}")
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, sq, d)
    logits = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) * _scale(
        d, scale)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bngqk,bnkd->bngqd", p, v.float())
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(b, h, sq, d).to(q.dtype)


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           kv_split: Optional[int] = None) -> torch.Tensor:
    """Blocked attention: the B5 CUDA kernel on CUDA tensors,
    :func:`flash_attention_torch` on CPU tensors.  ``kv_split`` (1 or 2;
    the wgmma engine only) pins how many CTAs share a query tile's kv
    range; None takes :func:`repro_torch.core.geometry.attention_kv_split`'s
    choice."""
    dev = build.require_cuda(q, k, v, what="flash_attention")
    if dev is None:
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if h % hkv != 0:
        raise ValueError(f"GQA requires H % Hkv == 0, got {h} % {hkv}")
    if sq > skv or d > 256:
        raise ValueError(f"flash_attention: Sq={sq} > Skv={skv} or "
                         f"D={d} > 256 unsupported")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype} unsupported")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    window_arg = -1 if window is None else int(window)
    if attention_engine(q.dtype, d) == "wgmma":
        if kv_split is None:
            kv_split = attention_kv_split(
                b * h * -(-sq // 64), -(-skv // 64),
                torch.cuda.get_device_properties(dev).multi_processor_count)
        if kv_split not in (1, 2):
            raise ValueError(f"flash_attention: kv_split={kv_split}, the "
                             f"wgmma engine takes 1 or 2")
        lib, fn = build.entry("flash_attention_wgmma",
                              "flash_attention_wgmma_launch",
                              _WGMMA_ARGTYPES)
        build.count_launch("flash_attention_wgmma")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, sq, skv, d, int(causal), window_arg,
                 int(softcap is not None), float(softcap or 0.0),
                 float(_scale(d, scale)), kv_split, build.stream_ptr(dev))
        build.check(lib, err, "flash_attention_wgmma")
        return out
    if kv_split not in (None, 1):
        raise ValueError("flash_attention: the SIMT kernel has no kv split")
    lib, fn = build.entry("flash_attention", "flash_attention_launch",
                          _ARGTYPES)
    build.count_launch("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             DTYPE_CODES[q.dtype], b, h, hkv, sq, skv, d, int(causal),
             window_arg, int(softcap is not None), float(softcap or 0.0),
             float(_scale(d, scale)), build.stream_ptr(dev))
    build.check(lib, err, "flash_attention")
    return out
