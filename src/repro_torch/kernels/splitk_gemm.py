"""B2: split-K GEMM — CUDA kernel and plain version.

:func:`mte_gemm_splitk_kernel` is the counterpart of
``mte_gemm_splitk_pallas`` (``repro/kernels/splitk_gemm.py``): K is cut
into ``n_split`` slices of ``k_per_split`` (a multiple of the plan's
``bk``); each slice's partial accumulator, in the accumulator dtype, goes
into an (n_split, M, N) buffer; the sum over slices and the epilogue run
outside the kernel, in plain PyTorch (as in JAX), so β·C and the bias join
once.  The reduction is a plain ``sum`` — no atomics, the same bits every
run.  B is row-major (K, N) only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.geometry import BlockGeometry, cdiv
from repro_torch.kernels import build
from repro_torch.kernels.mte_gemm import (DTYPE_CODES, _acc_dtype,
                                          raw_accumulate)

__all__ = ["mte_gemm_splitk_kernel", "mte_gemm_splitk_torch",
           "splitk_partials_torch", "splitk_layout"]

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_long] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def splitk_layout(k: int, geom: BlockGeometry, n_split: int):
    """(bk, k_per_split) for a K of ``k`` — the JAX kernel's arithmetic
    (``splitk_gemm.py:84-85``) on the port's 32-deep inner tile."""
    bk = min(geom.bk, cdiv(k, 32) * 32)
    return bk, cdiv(cdiv(k, n_split), bk) * bk


def _check(a, b, c, bias, epilogue):
    m, k = a.shape
    k2, n = b.shape
    if k2 != k:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if epilogue.needs_c_input and c is None:
        raise ValueError("epilogue.beta != 0 requires c operand")
    if epilogue.has_bias and bias is None:
        raise ValueError("epilogue.has_bias requires bias operand")
    return m, n, k


def _reduce(partials: torch.Tensor, acc_dtype: torch.dtype) -> torch.Tensor:
    if not acc_dtype.is_floating_point:
        return partials.sum(0, dtype=torch.int32)
    return partials.float().sum(0).to(acc_dtype)


def splitk_partials_torch(a, b, *, geom: BlockGeometry, n_split: int,
                          acc_dtype=None) -> torch.Tensor:
    """Plain version of the kernel's output: the (n_split, M, N) partials."""
    acc_dtype = _acc_dtype(a, acc_dtype)
    k = a.shape[1]
    bk, kps = splitk_layout(k, geom, n_split)
    parts = []
    for s in range(n_split):
        k0, k1 = min(s * kps, k), min((s + 1) * kps, k)
        if k0 >= k1:
            parts.append(torch.zeros(a.shape[0], b.shape[1],
                                     dtype=acc_dtype, device=a.device))
        else:
            parts.append(raw_accumulate(a, b, acc_dtype, bk, k0, k1)
                         .to(acc_dtype))
    return torch.stack(parts)


def mte_gemm_splitk_torch(a, b, c=None, bias=None, *, geom: BlockGeometry,
                          n_split: int = 4,
                          epilogue: Epilogue = Epilogue(),
                          out_dtype=torch.float32,
                          acc_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`mte_gemm_splitk_kernel`."""
    _check(a, b, c, bias, epilogue)
    acc_dtype = _acc_dtype(a, acc_dtype)
    parts = splitk_partials_torch(a, b, geom=geom, n_split=n_split,
                                  acc_dtype=acc_dtype)
    return epilogue.apply(_reduce(parts, acc_dtype), c_in=c,
                          bias=bias).to(out_dtype)


def launch_partials(a, b, *, geom: BlockGeometry, n_split: int,
                    acc_dtype) -> torch.Tensor:
    """Launch the B2 kernel: the (n_split, M, N) partials on the card."""
    dev = a.device
    m, k = a.shape
    n = b.shape[1]
    bf16acc = acc_dtype == torch.bfloat16
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16,
                                             torch.int8):
        raise TypeError(f"splitk_gemm: operands {a.dtype} x {b.dtype} "
                        f"unsupported")
    if bf16acc and a.dtype != torch.bfloat16:
        raise TypeError("splitk_gemm: bf16acc needs bf16 operands")
    a = a.contiguous()
    b = b.contiguous()
    bk, kps = splitk_layout(k, geom, n_split)
    partials = torch.empty(n_split, m, n, dtype=acc_dtype, device=dev)
    lib, fn = build.entry("splitk_gemm", "splitk_gemm_launch", _ARGTYPES)
    build.count_launch("splitk_gemm")
    err = fn(a.data_ptr(), b.data_ptr(), partials.data_ptr(), m, n, k,
             a.stride(0), b.stride(0), DTYPE_CODES[a.dtype],
             DTYPE_CODES[acc_dtype], int(bf16acc), geom.bm, geom.bn, bk,
             n_split, kps, build.stream_ptr(dev))
    build.check(lib, err, "splitk_gemm")
    return partials


def mte_gemm_splitk_kernel(a, b, c=None, bias=None, *, geom: BlockGeometry,
                           n_split: int = 4,
                           epilogue: Epilogue = Epilogue(),
                           out_dtype=torch.float32,
                           acc_dtype=None) -> torch.Tensor:
    """``epilogue(a @ b [, c, bias])`` with K split over ``n_split``
    slices: the B2 CUDA kernel writes the partials on CUDA tensors (the
    sum and epilogue follow in PyTorch); CPU tensors run
    :func:`mte_gemm_splitk_torch`."""
    dev = build.require_cuda(a, b, c, bias, what="splitk_gemm")
    if dev is None:
        return mte_gemm_splitk_torch(a, b, c, bias, geom=geom,
                                     n_split=n_split, epilogue=epilogue,
                                     out_dtype=out_dtype,
                                     acc_dtype=acc_dtype)
    _check(a, b, c, bias, epilogue)
    acc_dtype = _acc_dtype(a, acc_dtype)
    parts = launch_partials(a, b, geom=geom, n_split=n_split,
                            acc_dtype=acc_dtype)
    return epilogue.apply(_reduce(parts, acc_dtype), c_in=c,
                          bias=bias).to(out_dtype)
