"""B4 and B6: one-token attention over the paged KV pool and over a flat
or ring cache — CUDA kernels and plain versions.

The SIMT kernels (``csrc/flash_decode_paged.cu``, ``csrc/flash_decode.cu``)
split each sequence's KV axis over blocks (about two blocks per SM in all)
and merge the slices' partial softmax states in a second small kernel of
the same entry (``decode_combine.cuh``); the wrapper allocates the
partials.

:func:`flash_decode_paged_kernel` is the counterpart of
``flash_decode_paged_pallas`` (``repro/kernels/flash_decode.py``).  Two
engines, chosen by :func:`repro_torch.core.geometry.decode_engine` (never
a fallback): for bf16 pages and a bf16 query with G = H/Hkv ≤ 16 and D in
{64, 128, 256}, the mma engine (``csrc/flash_decode_paged_mma.cu``,
counter ``flash_decode_paged_mma``): one launch, a cluster of up to 8
CTAs per (sequence, kv head) over whole pages (split by
:func:`repro_torch.core.geometry.decode_kv_split`, pinned with
``kv_split``), QKᵀ and PV on the tensor cores with P rounded to bf16, the
slices merged through distributed shared memory; for everything else the
SIMT kernel (counter ``flash_decode_paged``).
q (B, H, D); k_pages/v_pages (P, page, Hkv, D) in f32, bf16 or int8;
page_table (B, maxp) int32 (−1 ⇒ unmapped: clamps to page 0 and is
masked); seq_lens (B,) int32 counts the written tokens including the
current one; ``k_scale``/``v_scale`` (P, page, Hkv, 1) f32 dequantize int8
pages in the kernel.  Mask: ``kvpos < seq_len``, page mapped, and
``kvpos > seq_len − 1 − window`` with a window.  A row whose softmax
denominator is 0 returns zeros.  Returns (B, H, D) in q.dtype.

:func:`flash_decode_kernel` is the counterpart of ``flash_decode_pallas``
(B6).  q (B, H, D); k/v (B, Hkv, S, D) in f32 or bf16, in any layout whose
D axis is contiguous (the serving ring is its (B, L, Hkv, D) storage seen
through ``transpose(1, 2)``: the kernels read it through strides, without
a copy); kv_positions (B, S) int32 (−1 ⇒ unwritten slot); q_pos (B,)
int32.  Mask: ``kvpos ≥ 0``, ``kvpos ≤ q_pos`` and, with a window,
``kvpos > q_pos − window``; the softcap applies before it; V rows with
``kvpos < 0`` never reach the output.  A row whose softmax denominator is
0 returns zeros.  Returns (B, H, D) in q.dtype.  Two engines, chosen by
:func:`repro_torch.core.geometry.flat_decode_engine` (never a fallback):
for a bf16 cache and query with G ≤ 16, D in {64, 128, 256} and strides
TMA can take (:func:`tma_strided`), B4's mma engine over 16-slot tiles of
the cache (``csrc/flash_decode_mma.cu``, counter ``flash_decode_mma``:
one launch, a cluster of ``decode_kv_split`` CTAs per (sequence, kv
head), pinned with ``kv_split``); for everything else the SIMT kernel
(counter ``flash_decode``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.geometry import (MAX_CLUSTER, decode_engine,
                                       decode_kv_split, flat_decode_engine)
from repro_torch.kernels import build
from repro_torch.kernels.mte_gemm import DTYPE_CODES, tma_ready

__all__ = ["flash_decode_paged_kernel", "flash_decode_paged_torch",
           "flash_decode_kernel", "flash_decode_torch", "tma_strided"]

_NEG_INF = -1e30
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])
_FLAT_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int] + [ctypes.c_long] * 6
                  + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                  + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p])
_MMA_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p])
_FLAT_MMA_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_long] * 6
                      + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                      + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])
_CHUNK = 16   # positions a SIMT block or an mma stage takes at a time (csrc)


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
                              scale: Optional[float] = None,
                              kv_split: Optional[int] = None) -> torch.Tensor:
    """Paged one-token attention: on CUDA tensors the B4 engine
    :func:`repro_torch.core.geometry.decode_engine` names (``kv_split``
    pins the mma engine's slices per row, 1–8), on CPU tensors
    :func:`flash_decode_paged_torch`."""
    dev = build.require_cuda(q, k_pages, v_pages, page_table, seq_lens,
                             k_scale, v_scale, what="flash_decode_paged")
    if dev is None:
        return flash_decode_paged_torch(
            q, k_pages, v_pages, page_table, seq_lens, k_scale, v_scale,
            window=window, softcap=softcap, scale=scale)
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    if h % hkv:
        raise ValueError(f"flash_decode_paged: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    maxp = table.shape[1]
    if decode_engine(k_pages.dtype, q.dtype, h // hkv, d) == "mma":
        if v_pages.dtype != k_pages.dtype or k_scale is not None:
            raise TypeError("flash_decode_paged: the mma engine takes bf16 "
                            "K and V pages without scales")
        if kv_split is None:
            kv_split = decode_kv_split(b * hkv, maxp, _sm_count(dev))
        elif not 1 <= kv_split <= MAX_CLUSTER:
            raise ValueError(f"flash_decode_paged: kv_split={kv_split} "
                             f"(1..{MAX_CLUSTER})")
        per_split = -(-maxp // kv_split)
        q_, kp, vp = (tma_ready(x) for x in (q, k_pages, v_pages))
        out = torch.empty_like(q_)
        lib, fn = build.entry("flash_decode_paged_mma",
                              "flash_decode_paged_mma_launch", _MMA_ARGTYPES)
        build.count_launch("flash_decode_paged_mma")
        err = fn(q_.data_ptr(), kp.data_ptr(), vp.data_ptr(), kp.shape[0],
                 table.data_ptr(), lens.data_ptr(), out.data_ptr(), b, h,
                 hkv, d, page, maxp, -1 if window is None else int(window),
                 int(softcap is not None), float(softcap or 0.0),
                 float(scale), kv_split, per_split, build.stream_ptr(dev))
        build.check(lib, err, "flash_decode_paged_mma")
        return out
    if kv_split is not None:
        raise ValueError("flash_decode_paged: kv_split pins the mma "
                         "engine's slices; the SIMT kernel sizes its own")
    if (h // hkv) * d > 4096:
        raise ValueError(f"flash_decode_paged: H={h}, Hkv={hkv}, D={d} "
                         f"unsupported (G*D <= 4096)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode_paged: q dtype {q.dtype}")
    if k_pages.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"flash_decode_paged: page dtype {k_pages.dtype}")
    if (k_pages.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("flash_decode_paged: int8 pages need scales")
    q = q.contiguous()
    kp, vp = k_pages.contiguous(), v_pages.contiguous()
    ks = k_scale.float().contiguous() if k_scale is not None else None
    vs = v_scale.float().contiguous() if v_scale is not None else None
    out = torch.empty_like(q)
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


def flash_decode_torch(q, k, v, kv_positions, q_pos, *,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode_kernel` (the Pallas
    kernel's arithmetic: masked logits at −1e30, V rows with kvpos < 0
    zeroed, a zero denominator divided as 1)."""
    b, h, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kp = kv_positions.to(torch.int64)[:, None, None, :]     # (B, 1, 1, S)
    qp = q_pos.to(torch.int64).reshape(b, 1, 1, 1)
    mask = (kp >= 0) & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    qg = q.float().reshape(b, hkv, g, d)
    logits = torch.einsum("bngd,bnsd->bngs", qg, k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    written = (kv_positions >= 0)[:, None, :, None]          # (B, 1, S, 1)
    vf = torch.where(written, v.float(), torch.zeros((), device=v.device))
    out = torch.einsum("bngs,bnsd->bngd", p, vf)
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(b, h, d).to(q.dtype)


def tma_strided(*tensors) -> bool:
    """Whether TMA can read each tensor in place: its last axis contiguous,
    every other axis of more than one element a positive multiple of 16
    bytes apart, its first element 16-byte aligned."""
    for x in tensors:
        if x.stride(-1) != 1 or x.data_ptr() % 16:
            return False
        for size, stride in zip(x.shape[:-1], x.stride()[:-1]):
            if size > 1 and (stride <= 0
                             or stride * x.element_size() % 16):
                return False
    return True


def flash_decode_kernel(q, k, v, kv_positions, q_pos, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        kv_split: Optional[int] = None) -> torch.Tensor:
    """One-token attention over a flat or ring cache: on CUDA tensors the
    B6 engine :func:`repro_torch.core.geometry.flat_decode_engine` names
    (``kv_split`` pins the mma engine's slices per row, 1–8), on CPU
    tensors :func:`flash_decode_torch`."""
    dev = build.require_cuda(q, k, v, kv_positions, q_pos,
                             what="flash_decode")
    if dev is None:
        return flash_decode_torch(q, k, v, kv_positions, q_pos,
                                  window=window, softcap=softcap,
                                  scale=scale)
    b, h, d = q.shape
    _, hkv, s, _ = k.shape
    if v.shape != k.shape or kv_positions.shape != (b, s):
        raise ValueError(f"flash_decode: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, kv_positions "
                         f"{tuple(kv_positions.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"flash_decode: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_decode: the D axis of k and v must be "
                         "contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode: q dtype {q.dtype}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"flash_decode: cache dtypes {k.dtype}, {v.dtype}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kvp = kv_positions.to(torch.int32).contiguous()
    qp = q_pos.to(torch.int32).reshape(b).contiguous()
    window_ = -1 if window is None else int(window)
    if flat_decode_engine(k.dtype, q.dtype, h // hkv, d,
                          tma_strided(k, v)) == "mma":
        tiles = -(-s // _CHUNK)
        if kv_split is None:
            kv_split = decode_kv_split(b * hkv, tiles, _sm_count(dev))
        elif not 1 <= kv_split <= MAX_CLUSTER:
            raise ValueError(f"flash_decode: kv_split={kv_split} "
                             f"(1..{MAX_CLUSTER})")
        per_split = -(-tiles // kv_split)
        q_ = tma_ready(q)
        out = torch.empty_like(q_)
        lib, fn = build.entry("flash_decode_mma", "flash_decode_mma_launch",
                              _FLAT_MMA_ARGTYPES)
        build.count_launch("flash_decode_mma")
        err = fn(q_.data_ptr(), k.data_ptr(), v.data_ptr(),
                 *k.stride()[:3], *v.stride()[:3], kvp.data_ptr(),
                 qp.data_ptr(), out.data_ptr(), b, h, hkv, d, s, window_,
                 int(softcap is not None), float(softcap or 0.0),
                 float(scale), kv_split, per_split, build.stream_ptr(dev))
        build.check(lib, err, "flash_decode_mma")
        return out
    if kv_split is not None:
        raise ValueError("flash_decode: kv_split pins the mma engine's "
                         "slices; the SIMT kernel sizes its own")
    if (h // hkv) * d > 4096:
        raise ValueError(f"flash_decode: H={h}, Hkv={hkv}, D={d} "
                         f"unsupported (G*D <= 4096)")
    q = q.contiguous()
    out = torch.empty_like(q)
    n_split, per_split = _kv_split(b * hkv, s, dev)
    g = h // hkv
    part_m = torch.empty(b * hkv, n_split, g, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(b * hkv, n_split, g * d, device=dev)
    lib, fn = build.entry("flash_decode", "flash_decode_launch",
                          _FLAT_ARGTYPES)
    build.count_launch("flash_decode")
    err = fn(q.data_ptr(), DTYPE_CODES[q.dtype], k.data_ptr(), v.data_ptr(),
             DTYPE_CODES[k.dtype], *k.stride()[:3], *v.stride()[:3],
             kvp.data_ptr(), qp.data_ptr(), part_m.data_ptr(),
             part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
             b, h, hkv, d, s, window_, int(softcap is not None),
             float(softcap or 0.0), float(scale), n_split, per_split,
             build.stream_ptr(dev))
    build.check(lib, err, "flash_decode")
    return out
