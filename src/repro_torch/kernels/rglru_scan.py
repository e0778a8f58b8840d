"""B7: the RG-LRU linear recurrence — CUDA kernel and plain version.

:func:`rglru_scan_kernel` is the counterpart of ``rglru_scan_pallas``
(``repro/kernels/rglru_scan.py``): ``h_t = a_t·h_{t−1} + b_t`` along axis
1 from ``h_{−1} = 0``, for a, b (B, S, W) f32; returns h (B, S, W) f32.
One CUDA thread per (batch, channel) walks S with h in a register
(``csrc/rglru_scan.cu``); the product and the sum are rounded apart, so
the kernel and :func:`rglru_scan_torch` agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["rglru_scan_kernel", "rglru_scan_torch"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(a, b):
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must both be (B, S, W)")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru_scan: a, b must be float32, got {a.dtype}, "
                        f"{b.dtype}")


def rglru_scan_torch(a, b) -> torch.Tensor:
    """Plain PyTorch version of :func:`rglru_scan_kernel`: one step per
    sequence position, product and sum rounded apart."""
    _check(a, b)
    out = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_kernel(a, b) -> torch.Tensor:
    """The recurrence: the B7 CUDA kernel on CUDA tensors,
    :func:`rglru_scan_torch` on CPU tensors."""
    dev = build.require_cuda(a, b, what="rglru_scan")
    if dev is None:
        return rglru_scan_torch(a, b)
    _check(a, b)
    bsz, s, w = a.shape
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    lib, fn = build.entry("rglru_scan", "rglru_scan_launch", _ARGTYPES)
    build.count_launch("rglru_scan")
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, w,
             build.stream_ptr(dev))
    build.check(lib, err, "rglru_scan")
    return out
