"""B2: split-K GEMM — CUDA kernels and plain version.

:func:`mte_gemm_splitk_kernel` is the counterpart of
``mte_gemm_splitk_pallas`` (``repro/kernels/splitk_gemm.py``): K is cut
into slices, each slice's partial accumulator is summed over the slices,
and the epilogue joins once, after the sum, so β·C and the bias are added
once.  B is row-major (K, N) only.  Two engines, chosen by
:func:`repro_torch.core.geometry.splitk_engine` (never a fallback):

- the cluster engine (``csrc/splitk_gemm_cluster.cu``, counter
  ``splitk_gemm_cluster``) for bf16 operands with an f32 accumulator,
  M ≤ 16, N a multiple of 8 and K within 8 slices of x in shared memory —
  the decode GEMMs.  One launch: the slices of a 128-column tile are one
  thread-block cluster, their partials are summed in rank order through
  distributed shared memory, and the reduction applies the whole epilogue
  in f32 and writes ``out_dtype``.  Its slices come from
  :func:`repro_torch.core.geometry.splitk_cluster_split` (``cluster_split``
  pins them), not from the plan's ``n_split``;
- the tile loop (``csrc/splitk_gemm.cu``, counter ``splitk_gemm``) for
  fp32, int8, bf16acc and M > 16: ``n_split`` slices of ``k_per_split``
  (a multiple of the plan's ``bk``), each slice's partial in the
  accumulator dtype into an (n_split, M, N) buffer; the sum over slices
  and the epilogue run in plain PyTorch, as in JAX.

Neither uses atomics: every call gives the same bits.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.epilogue import ACTIVATION_CODES, Epilogue
from repro_torch.core.geometry import (GROUPED_BK, GROUPED_BN, MAX_CLUSTER,
                                       BlockGeometry, cdiv,
                                       grouped_max_depth, round_up,
                                       splitk_cluster_split, splitk_engine)
from repro_torch.kernels import build
from repro_torch.kernels.mte_gemm import (DTYPE_CODES, _acc_dtype,
                                          raw_accumulate, tma_ready)

__all__ = ["mte_gemm_splitk_kernel", "mte_gemm_splitk_torch",
           "splitk_partials_torch", "splitk_layout", "cluster_layout"]

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_long] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                     + [ctypes.c_long] * 2 + [ctypes.c_int] * 6
                     + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_void_p])


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


def cluster_layout(m: int, n: int, k: int, dev,
                   cluster_split: Optional[int] = None,
                   split_rows: Optional[int] = None):
    """(slices, slice depth) of the cluster engine: the planner's
    :func:`splitk_cluster_split` for ``split_rows`` rows (default ``m``)
    and the card's SM count, or the pinned ``cluster_split``; ValueError
    when the engine cannot take the split for ``m`` rows."""
    if cluster_split is None:
        cluster_split, depth = splitk_cluster_split(
            cdiv(n, GROUPED_BN), k, m if split_rows is None else split_rows,
            torch.cuda.get_device_properties(dev).multi_processor_count)
    else:
        depth = round_up(cdiv(k, cluster_split), GROUPED_BK)
    if not 1 <= cluster_split <= MAX_CLUSTER \
            or cdiv(k, depth) != cluster_split \
            or depth > grouped_max_depth(m):
        raise ValueError(f"splitk_gemm: {cluster_split} slices of K={k} for "
                         f"{m} rows is not a split the cluster engine takes")
    return cluster_split, depth


def _launch_cluster(a, b, c, bias, epilogue, out_dtype, n_split, depth):
    dev = a.device
    m, k = a.shape
    n = b.shape[1]
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"splitk_gemm: the cluster engine writes f32 or "
                        f"bf16, not {out_dtype}")
    if a.stride(1) != 1 or (m > 1 and a.stride(0) < k):
        a = a.contiguous()
    b = tma_ready(b)

    def operand(x):
        if x is None:
            return None, DTYPE_CODES[torch.float32]
        if x.dtype not in (torch.float32, torch.bfloat16):
            x = x.float()
        return x.contiguous(), DTYPE_CODES[x.dtype]

    c_, c_type = operand(c if epilogue.needs_c_input else None)
    bias_, bias_type = operand(bias if epilogue.has_bias else None)
    out = torch.empty(m, n, dtype=out_dtype, device=dev)
    lib, fn = build.entry("splitk_gemm_cluster", "splitk_gemm_cluster_launch",
                          _CLUSTER_ARGTYPES)
    build.count_launch("splitk_gemm_cluster")
    err = fn(a.data_ptr(), b.data_ptr(),
             c_.data_ptr() if c_ is not None else None,
             bias_.data_ptr() if bias_ is not None else None,
             out.data_ptr(), m, n, k, a.stride(0),
             c_.stride(0) if c_ is not None else n, c_type, bias_type,
             int(epilogue.bias_axis == "col"), DTYPE_CODES[out_dtype],
             n_split, depth, float(epilogue.alpha), float(epilogue.beta),
             int(epilogue.softcap is not None),
             float(epilogue.softcap or 0.0),
             ACTIVATION_CODES[epilogue.activation], build.stream_ptr(dev))
    build.check(lib, err, "splitk_gemm_cluster")
    return out


def mte_gemm_splitk_kernel(a, b, c=None, bias=None, *, geom: BlockGeometry,
                           n_split: int = 4,
                           epilogue: Epilogue = Epilogue(),
                           out_dtype=torch.float32,
                           acc_dtype=None,
                           cluster_split: Optional[int] = None,
                           split_rows: Optional[int] = None
                           ) -> torch.Tensor:
    """``epilogue(a @ b [, c, bias])`` with K split into slices: on CUDA
    tensors the engine :func:`repro_torch.core.geometry.splitk_engine`
    names — the cluster engine in one launch (its own slices for
    ``split_rows`` rows, default M, pinned with ``cluster_split``), or
    the tile loop at ``n_split`` slices with the sum and epilogue in
    PyTorch; CPU tensors run :func:`mte_gemm_splitk_torch`."""
    dev = build.require_cuda(a, b, c, bias, what="splitk_gemm")
    if dev is None:
        return mte_gemm_splitk_torch(a, b, c, bias, geom=geom,
                                     n_split=n_split, epilogue=epilogue,
                                     out_dtype=out_dtype,
                                     acc_dtype=acc_dtype)
    m, n, k = _check(a, b, c, bias, epilogue)
    acc_dtype = _acc_dtype(a, acc_dtype)
    engine = splitk_engine(a.dtype, m, n, k,
                           bf16acc=acc_dtype == torch.bfloat16)
    if engine == "cluster":
        if b.dtype != a.dtype:
            raise TypeError(f"splitk_gemm: operands {a.dtype} x {b.dtype} "
                            f"unsupported")
        slices, depth = cluster_layout(m, n, k, dev, cluster_split,
                                       split_rows)
        return _launch_cluster(a, b, c, bias, epilogue, out_dtype, slices,
                               depth)
    if cluster_split is not None:
        raise ValueError("splitk_gemm: cluster_split pins the cluster "
                         "engine's slices; the tile loop takes n_split")
    parts = launch_partials(a, b, geom=geom, n_split=n_split,
                            acc_dtype=acc_dtype)
    return epilogue.apply(_reduce(parts, acc_dtype), c_in=c,
                          bias=bias).to(out_dtype)
