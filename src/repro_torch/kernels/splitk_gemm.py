"""B2: split-K GEMM — CUDA kernels and plain version.

:func:`mte_gemm_splitk_kernel` is the counterpart of
``mte_gemm_splitk_pallas`` (``repro/kernels/splitk_gemm.py``): K is cut
into slices, each slice's partial accumulator is summed over the slices,
and the epilogue joins once, after the sum, so β·C and the bias are added
once.  B is row-major (K, N) only.  Three engines, chosen by
:func:`repro_torch.core.geometry.splitk_engine` (never a fallback):

- the cluster engine (``csrc/splitk_gemm_cluster.cu``, counter
  ``splitk_gemm_cluster``) for bf16 operands with an f32 or a bf16
  (``bf16acc``) accumulator, M ≤ 16, N a multiple of 8 and K within 8
  slices of x in shared memory — the decode GEMMs.  One launch: the
  slices of a 128-column tile are one thread-block cluster, their
  partials are summed in rank order through distributed shared memory,
  and the reduction applies the whole epilogue and writes ``out_dtype``.
  Its slices come from
  :func:`repro_torch.core.geometry.splitk_cluster_split` (``cluster_split``
  pins them), not from the plan's ``n_split``.  int8 operands (the int32
  accumulator, the identity epilogue) with M ≤ 16 and N a multiple of 16
  take its s8 entry (counter ``splitk_gemm_cluster_s8``: 128-row int8
  stages of the (K, N) weight as it lies, the slices' int32 partials
  summed exactly, int32 out).  Plain version:
  :func:`splitk_cluster_torch`;
- the SIMT f32 engine (``csrc/splitk_gemm.cu`` on
  ``simt_f32_mainloop.cuh``, counter ``splitk_gemm_simt``) for f32
  operands, M > 16, a plan tile of
  :data:`~repro_torch.core.geometry.SIMT_TILES` and K and N multiples of
  4 (the training backward's dB of a narrow weight), and
- the tile loop (``csrc/splitk_gemm.cu``, counter ``splitk_gemm``) for
  the rest (fp32 off that rule, int8 off the cluster rule, bf16 past
  16 rows): both run
  ``n_split`` slices of ``k_per_split`` (a multiple of the plan's
  ``bk``), each slice's partial in the accumulator dtype into an
  (n_split, M, N) buffer; the sum over slices and the epilogue run in
  plain PyTorch, as in JAX.  Each slice is one FMA chain per output on
  either, so their partials agree bit for bit.  Plain version:
  :func:`mte_gemm_splitk_torch`.

Under ``bf16acc`` both keep the reference's split-K contract
(``splitk_gemm.py:76-105`` there): each slice's running sum is bf16,
rounded once per K block of the slice (the cluster engine's block is
:func:`~repro_torch.kernels.mte_gemm.bf16acc_block` of the plan's ``bk``,
counted from the slice's first row), the slices' bf16 partials are summed
in f32 in slice order and rounded to bf16 once, and the epilogue runs on
that bf16 sum with every step rounded to bf16.  So the split sets the
bits: on CPU tensors a bf16acc GEMM the cluster engine takes runs
:func:`splitk_cluster_torch` at the slices the engine would take on an
H100 (132 SMs).  With an f32 accumulator the two engines' results differ
only in the f32 summation order, and CPU tensors run
:func:`mte_gemm_splitk_torch`; with an int32 one every engine and split
gives the exact product.

Neither uses atomics: every call gives the same bits.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.epilogue import ACTIVATION_CODES, Epilogue
from repro_torch.core.geometry import (GROUPED_BK, GROUPED_BN, H100_SPEC,
                                       MAX_CLUSTER, TILE_LOOP_TILES,
                                       BlockGeometry, cdiv, cluster_stage,
                                       grouped_max_depth, round_up,
                                       splitk_cluster_split, splitk_engine)
from repro_torch.kernels import build
from repro_torch.kernels.mte_gemm import (DTYPE_CODES, _acc_dtype,
                                          bf16_scalar, bf16acc_block,
                                          raw_accumulate, tma_ready)

__all__ = ["mte_gemm_splitk_kernel", "mte_gemm_splitk_torch",
           "splitk_cluster_torch", "splitk_partials_torch", "splitk_layout",
           "cluster_layout"]

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_long] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
# splitk_gemm_simt_launch: as splitk_gemm_launch without the operand and
# partial types and the accumulator flag (f32 in, f32 partials).
_SIMT_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                  + [ctypes.c_long] * 2 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                     + [ctypes.c_long] * 2 + [ctypes.c_int] * 8
                     + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_void_p])
# splitk_gemm_cluster_s8_launch: a, w, out; M, N, K; lda; slices, depth;
# the stream.
_CLUSTER_S8_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                        + [ctypes.c_long] + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])


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
    """Plain version of the kernel's output: the (n_split, M, N) partials
    (slices past K are zeros)."""
    acc_dtype = _acc_dtype(a, acc_dtype)
    bk, kps = splitk_layout(a.shape[1], geom, n_split)
    parts = slice_partials(a, b, kps, acc_dtype, bk)
    empty = parts.new_zeros(n_split - parts.shape[0], *parts.shape[1:])
    return torch.cat([parts, empty])


def slice_partials(a, b, depth: int, acc_dtype: torch.dtype,
                   rbk: int) -> torch.Tensor:
    """The partials of K cut into slices of ``depth`` rows, one per slice
    that holds a row: slice s takes the K rows [s·depth, (s+1)·depth), in
    ``acc_dtype`` (bf16: the running sum rounded once per ``rbk`` rows
    counted from the slice's first row)."""
    return torch.stack([
        raw_accumulate(a[:, k0:k0 + depth], b[k0:k0 + depth], acc_dtype,
                       rbk).to(acc_dtype)
        for k0 in range(0, a.shape[1], depth)])


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


def splitk_cluster_torch(a, b, c=None, bias=None, *, n_split: int,
                         depth: int, rbk: int = GROUPED_BK,
                         epilogue: Epilogue = Epilogue(),
                         out_dtype=torch.float32,
                         acc_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the cluster engine: ``n_split`` slices of
    ``depth`` K rows (``cluster_layout``), each slice's partial in the
    accumulator dtype (bf16acc: rounded once per ``rbk`` rows of the
    slice), the partials summed in f32 in slice order (bf16acc: rounded
    to bf16 once), then the epilogue in the accumulator dtype."""
    _check(a, b, c, bias, epilogue)
    acc_dtype = _acc_dtype(a, acc_dtype)
    if cdiv(a.shape[1], depth) != n_split:
        raise ValueError(f"splitk_gemm: {n_split} slices of {depth} rows "
                         f"do not cover K={a.shape[1]}")
    parts = slice_partials(a, b, depth, acc_dtype, rbk)
    return epilogue.apply(_reduce(parts, acc_dtype), c_in=c,
                          bias=bias).to(out_dtype)


def launch_partials(a, b, *, geom: BlockGeometry, n_split: int,
                    acc_dtype, engine: str) -> torch.Tensor:
    """Launch the B2 kernel on ``engine`` (``"tile"`` or ``"simt"``): the
    (n_split, M, N) partials on the card."""
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
    bk, kps = splitk_layout(k, geom, n_split)
    partials = torch.empty(n_split, m, n, dtype=acc_dtype, device=dev)
    if engine == "simt":
        a, b = tma_ready(a), tma_ready(b)
        lib, fn = build.entry("splitk_gemm", "splitk_gemm_simt_launch",
                              _SIMT_ARGTYPES)
        build.count_launch("splitk_gemm_simt")
        err = fn(a.data_ptr(), b.data_ptr(), partials.data_ptr(), m, n, k,
                 a.stride(0), b.stride(0), geom.bm, geom.bn, n_split, kps,
                 build.stream_ptr(dev))
    else:
        a, b = a.contiguous(), b.contiguous()
        lib, fn = build.entry("splitk_gemm", "splitk_gemm_launch", _ARGTYPES)
        build.count_launch("splitk_gemm")
        err = fn(a.data_ptr(), b.data_ptr(), partials.data_ptr(), m, n, k,
                 a.stride(0), b.stride(0), DTYPE_CODES[a.dtype],
                 DTYPE_CODES[acc_dtype], int(bf16acc), geom.bm, geom.bn, bk,
                 n_split, kps, build.stream_ptr(dev))
    build.check(lib, err, f"splitk_gemm[{engine}]")
    return partials


def cluster_layout(m: int, n: int, k: int, dev,
                   cluster_split: Optional[int] = None,
                   split_rows: Optional[int] = None,
                   dtype_in=torch.bfloat16):
    """(slices, slice depth) of the cluster engine for ``dtype_in``
    operands: the planner's :func:`splitk_cluster_split` for
    ``split_rows`` rows (default ``m``) and the card's SM count (``dev``
    None: an H100's), or the pinned ``cluster_split`` (slices a whole
    number of :func:`cluster_stage` rows deep); ValueError when the
    engine cannot take the split for ``m`` rows."""
    if cluster_split is None:
        sms = (H100_SPEC.sm_count if dev is None else
               torch.cuda.get_device_properties(dev).multi_processor_count)
        cluster_split, depth = splitk_cluster_split(
            cdiv(n, GROUPED_BN), k, m if split_rows is None else split_rows,
            sms, dtype_in)
    else:
        depth = round_up(cdiv(k, cluster_split), cluster_stage(dtype_in))
    if not 1 <= cluster_split <= MAX_CLUSTER \
            or cdiv(k, depth) != cluster_split \
            or depth > grouped_max_depth(m, dtype_in):
        raise ValueError(f"splitk_gemm: {cluster_split} slices of K={k} for "
                         f"{m} rows is not a split the cluster engine takes")
    return cluster_split, depth


def _launch_cluster_s8(a, b, out_dtype, n_split, depth):
    """One launch of the cluster engine's s8 entry: the exact int32
    a @ b of int8 operands, the (K, N) weight read as it lies."""
    dev = a.device
    m, k = a.shape
    n = b.shape[1]
    if out_dtype != torch.int32:
        raise TypeError(f"splitk_gemm: the cluster engine's s8 entry writes "
                        f"the int32 accumulator, not {out_dtype}")
    if a.stride(1) != 1 or (m > 1 and a.stride(0) < k):
        a = a.contiguous()
    b = tma_ready(b)
    out = torch.empty(m, n, dtype=torch.int32, device=dev)
    lib, fn = build.entry("splitk_gemm_cluster",
                          "splitk_gemm_cluster_s8_launch",
                          _CLUSTER_S8_ARGTYPES)
    build.count_launch("splitk_gemm_cluster_s8")
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
             a.stride(0), n_split, depth, build.stream_ptr(dev))
    build.check(lib, err, "splitk_gemm_cluster[s8]")
    return out


def _launch_cluster(a, b, c, bias, epilogue, out_dtype, n_split, depth,
                    rbk, bf16acc):
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
    scalars = (float(epilogue.alpha), float(epilogue.beta),
               float(epilogue.softcap or 0.0))
    if bf16acc:
        scalars = tuple(map(bf16_scalar, scalars))
    alpha, beta, softcap = scalars
    lib, fn = build.entry("splitk_gemm_cluster", "splitk_gemm_cluster_launch",
                          _CLUSTER_ARGTYPES)
    build.count_launch("splitk_gemm_cluster")
    err = fn(a.data_ptr(), b.data_ptr(),
             c_.data_ptr() if c_ is not None else None,
             bias_.data_ptr() if bias_ is not None else None,
             out.data_ptr(), m, n, k, a.stride(0),
             c_.stride(0) if c_ is not None else n, c_type, bias_type,
             int(epilogue.bias_axis == "col"), DTYPE_CODES[out_dtype],
             n_split, depth, int(bf16acc), rbk, alpha, beta,
             int(epilogue.softcap is not None), softcap,
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
    ``split_rows`` rows, default M, pinned with ``cluster_split``;
    bf16acc blocks of :func:`~repro_torch.kernels.mte_gemm.bf16acc_block`
    of ``geom.bk``; int8 on its s8 entry, int32 out), or the SIMT f32
    engine or the tile loop at ``n_split`` slices with the sum and
    epilogue in PyTorch; CPU tensors
    run the plain version of the same contract (see the module
    docstring).  A tile no engine takes raises on either device."""
    dev = build.require_cuda(a, b, c, bias, what="splitk_gemm")
    m, n, k = _check(a, b, c, bias, epilogue)
    acc_dtype = _acc_dtype(a, acc_dtype)
    bf16acc = acc_dtype == torch.bfloat16
    engine = splitk_engine(a.dtype, m, n, k, bf16acc=bf16acc,
                           tile=(geom.bm, geom.bn))
    if engine == "tile" and (geom.bm, geom.bn) not in TILE_LOOP_TILES:
        raise ValueError(f"splitk_gemm: no engine takes the tile "
                         f"{geom.bm}x{geom.bn} for {a.dtype} operands at "
                         f"M={m}, K={k}, N={n}")
    if dev is None:
        if engine == "cluster" and bf16acc:
            slices, depth = cluster_layout(m, n, k, None, cluster_split,
                                           split_rows)
            return splitk_cluster_torch(
                a, b, c, bias, n_split=slices, depth=depth,
                rbk=bf16acc_block(geom.bk, k), epilogue=epilogue,
                out_dtype=out_dtype, acc_dtype=acc_dtype)
        return mte_gemm_splitk_torch(a, b, c, bias, geom=geom,
                                     n_split=n_split, epilogue=epilogue,
                                     out_dtype=out_dtype,
                                     acc_dtype=acc_dtype)
    if engine == "cluster":
        if b.dtype != a.dtype:
            raise TypeError(f"splitk_gemm: operands {a.dtype} x {b.dtype} "
                            f"unsupported")
        slices, depth = cluster_layout(m, n, k, dev, cluster_split,
                                       split_rows, a.dtype)
        if a.dtype == torch.int8:
            if acc_dtype != torch.int32 or not epilogue.is_identity:
                raise ValueError("splitk_gemm: int8 takes the int32 "
                                 "accumulator and the identity epilogue "
                                 "(dequantize first)")
            return _launch_cluster_s8(a, b, out_dtype, slices, depth)
        return _launch_cluster(a, b, c, bias, epilogue, out_dtype, slices,
                               depth, bf16acc_block(geom.bk, k), bf16acc)
    if cluster_split is not None:
        raise ValueError("splitk_gemm: cluster_split pins the cluster "
                         "engine's slices; the tile loop takes n_split")
    parts = launch_partials(a, b, geom=geom, n_split=n_split,
                            acc_dtype=acc_dtype, engine=engine)
    return epilogue.apply(_reduce(parts, acc_dtype), c_in=c,
                          bias=bias).to(out_dtype)
