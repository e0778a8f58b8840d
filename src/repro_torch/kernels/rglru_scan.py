"""B7: the RG-LRU linear recurrence — CUDA kernels and plain version.

:func:`rglru_scan_kernel` is the counterpart of ``rglru_scan_pallas``
(``repro/kernels/rglru_scan.py``): ``h_t = a_t·h_{t−1} + b_t`` along axis
1 from ``h_{−1} = h0`` (zeros when ``h0`` is None), for a, b (B, S, W)
f32 and h0 (B, W) f32; returns h (B, S, W) f32.  JAX scans from zero and
folds a resumed chunk's state in afterwards (``exp(cumsum(log a))·h0``,
``repro/models/rglru.py``); starting the scan from h0 computes the same
h in the same pass.  Two engines, chosen by
:func:`repro_torch.core.geometry.scan_engine` (never a fallback), pinned
with ``engine``:

- ``"staged"`` (``csrc/rglru_scan_staged.cu``, counter
  ``rglru_scan_staged``): a block per batch row and slab of 32 channels,
  a and b brought into a ring of shared-memory spans by TMA; for W a
  multiple of 4 and 16-byte aligned bases of a and b;
- ``"direct"`` (``csrc/rglru_scan.cu``, counter ``rglru_scan``): one
  thread per (batch, channel) reading device memory; for the rest.

Both carry h in a register and round the product and the sum apart, so
both agree with :func:`rglru_scan_torch` bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.geometry import scan_engine
from repro_torch.kernels import build

__all__ = ["rglru_scan_kernel", "rglru_scan_torch"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(a, b, h0):
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must both be (B, S, W)")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru_scan: a, b must be float32, got {a.dtype}, "
                        f"{b.dtype}")
    if h0 is not None:
        if h0.shape != (a.shape[0], a.shape[2]):
            raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} must be "
                             f"(B, W) = {(a.shape[0], a.shape[2])}")
        if h0.dtype != torch.float32:
            raise TypeError(f"rglru_scan: h0 must be float32, got "
                            f"{h0.dtype}")


def rglru_scan_torch(a, b, h0=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rglru_scan_kernel`: from ``h0``
    (zeros when None), one step per sequence position, product and sum
    rounded apart."""
    _check(a, b, h0)
    out = torch.empty_like(a)
    h = h0 if h0 is not None else torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_kernel(a, b, h0=None, *,
                      engine: Optional[str] = None) -> torch.Tensor:
    """The recurrence from ``h0``: on CUDA tensors the B7 engine
    :func:`repro_torch.core.geometry.scan_engine` names (``engine`` pins
    ``"direct"``, or ``"staged"`` where the choice allows it), on CPU
    tensors :func:`rglru_scan_torch`."""
    dev = build.require_cuda(a, b, h0, what="rglru_scan")
    if dev is None:
        return rglru_scan_torch(a, b, h0)
    _check(a, b, h0)
    bsz, s, w = a.shape
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    out = torch.empty_like(a)
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    chosen = scan_engine(a.dtype, bsz, s, w, aligned)
    if engine is None:
        engine = chosen
    elif engine not in ("staged", "direct") or (
            engine == "staged" and chosen != "staged"):
        raise ValueError(f"rglru_scan: engine={engine!r} cannot run "
                         f"{tuple(a.shape)} (scan_engine chose {chosen!r})")
    name = "rglru_scan_staged" if engine == "staged" else "rglru_scan"
    lib, fn = build.entry(name, f"{name}_launch", _ARGTYPES)
    build.count_launch(name)
    err = fn(a.data_ptr(), b.data_ptr(),
             h0.data_ptr() if h0 is not None else None, out.data_ptr(), bsz,
             s, w, build.stream_ptr(dev))
    build.check(lib, err, name)
    return out
