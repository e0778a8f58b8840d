"""B4: one-token attention over the paged KV pool — CUDA kernel and plain
version.

The kernel splits each sequence's KV axis over blocks (about two blocks
per SM in all) and merges the slices' partial softmax states in a second
small kernel of the same launch; the wrapper allocates the partials.

:func:`flash_decode_paged_kernel` is the counterpart of
``flash_decode_paged_pallas`` (``repro/kernels/flash_decode.py``).
q (B, H, D); k_pages/v_pages (P, page, Hkv, D) in f32, bf16 or int8;
page_table (B, maxp) int32 (−1 ⇒ unmapped: clamps to page 0 and is
masked); seq_lens (B,) int32 counts the written tokens including the
current one; ``k_scale``/``v_scale`` (P, page, Hkv, 1) f32 dequantize int8
pages in the kernel.  Mask: ``kvpos < seq_len``, page mapped, and
``kvpos > seq_len − 1 − window`` with a window.  A row whose softmax
denominator is 0 returns zeros.  Returns (B, H, D) in q.dtype.

The flat-cache variant (``flash_decode_pallas``, B6) is queued.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mte_gemm import DTYPE_CODES

__all__ = ["flash_decode_paged_kernel", "flash_decode_paged_torch"]

_NEG_INF = -1e30
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])
_CHUNK = 16   # logical positions a block processes at a time (csrc)


def flash_decode_paged_torch(q, k_pages, v_pages, page_table, seq_lens,
                             k_scale=None, v_scale=None, *,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode_paged_kernel`."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    g = h // hkv
    maxp = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    idx = page_table.clamp(min=0).long()

    def gather(pages, sc):
        x = pages[idx].float()                  # (B, maxp, page, Hkv, D)
        if sc is not None:
            x = x * sc[idx].float()
        return x.reshape(b, maxp * page, hkv, d).permute(0, 2, 1, 3)

    k = gather(k_pages, k_scale)                # (B, Hkv, S, D)
    v = gather(v_pages, v_scale)
    pos = torch.arange(maxp * page, device=q.device)[None, :]
    sl = seq_lens.to(torch.int64)[:, None]
    mapped = (page_table >= 0).repeat_interleave(page, dim=1)
    mask = (pos < sl) & mapped
    if window is not None:
        mask = mask & (pos > sl - 1 - window)
    mask = mask[:, None, None, :]               # (B, 1, 1, S)
    qg = q.float().reshape(b, hkv, g, d)
    logits = torch.einsum("bngd,bnsd->bngs", qg, k) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    v = torch.where(mask.reshape(b, 1, -1, 1), v, torch.zeros_like(v))
    out = torch.einsum("bngs,bnsd->bngd", p, v)
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(b, h, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _kv_split(rows: int, positions: int, dev):
    """(n_split, chunks per split): enough KV slices that the
    (sequence, kv head) rows × slices put about two blocks on every SM."""
    chunks = -(-positions // _CHUNK)
    want = max(1, min(chunks, -(-2 * _sm_count(dev) // rows)))
    per_split = -(-chunks // want)
    return -(-chunks // per_split), per_split


def flash_decode_paged_kernel(q, k_pages, v_pages, page_table, seq_lens,
                              k_scale=None, v_scale=None, *,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Paged one-token attention: the B4 CUDA kernel on CUDA tensors,
    :func:`flash_decode_paged_torch` on CPU tensors."""
    dev = build.require_cuda(q, k_pages, v_pages, page_table, seq_lens,
                             k_scale, v_scale, what="flash_decode_paged")
    if dev is None:
        return flash_decode_paged_torch(
            q, k_pages, v_pages, page_table, seq_lens, k_scale, v_scale,
            window=window, softcap=softcap, scale=scale)
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    if h % hkv or (h // hkv) * d > 4096:
        raise ValueError(f"flash_decode_paged: H={h}, Hkv={hkv}, D={d} "
                         f"unsupported (G*D <= 4096)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode_paged: q dtype {q.dtype}")
    if k_pages.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"flash_decode_paged: page dtype {k_pages.dtype}")
    if (k_pages.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("flash_decode_paged: int8 pages need scales")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    q = q.contiguous()
    kp, vp = k_pages.contiguous(), v_pages.contiguous()
    ks = k_scale.float().contiguous() if k_scale is not None else None
    vs = v_scale.float().contiguous() if v_scale is not None else None
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    maxp = table.shape[1]
    n_split, per_split = _kv_split(b * hkv, maxp * page, dev)
    g = h // hkv
    part_m = torch.empty(b * hkv, n_split, g, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(b * hkv, n_split, g * d, device=dev)
    lib, fn = build.entry("flash_decode_paged",
                          "flash_decode_paged_launch", _ARGTYPES)
    build.count_launch("flash_decode_paged")
    err = fn(q.data_ptr(), DTYPE_CODES[q.dtype], kp.data_ptr(),
             vp.data_ptr(), DTYPE_CODES[kp.dtype],
             ks.data_ptr() if ks is not None else None,
             vs.data_ptr() if vs is not None else None,
             table.data_ptr(), lens.data_ptr(), part_m.data_ptr(),
             part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
             b, h, hkv, d, page, maxp,
             -1 if window is None else int(window),
             int(softcap is not None), float(softcap or 0.0), float(scale),
             n_split, per_split, build.stream_ptr(dev))
    build.check(lib, err, "flash_decode_paged")
    return out
