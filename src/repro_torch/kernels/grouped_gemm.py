"""B3: the grouped GEMM — CUDA kernel and plain version.

:func:`grouped_gemm_kernel` is the counterpart of ``grouped_gemm_pallas``
(``repro/kernels/grouped_gemm.py``): x (G, C, K) @ w (G, K, N) → (G, C, N)
with the epilogue (no C, no bias) applied to each group's accumulator.  On
CUDA tensors it launches ``csrc/grouped_gemm.cu`` (or raises); on CPU
tensors it runs :func:`grouped_gemm_torch`, the plain PyTorch version.

- x may be shared across the group: an ``expand`` of a (C, K) matrix has
  group stride 0, and the kernel reads it through that stride, no copy.
  Each group's rows must be contiguous in K with a common row stride.
- ``widths`` (optional, one per group) marks each member's true output
  width: columns at or past it come back as zeros, and the kernel skips
  the tiles that lie wholly there (a member's zero-padded weight
  columns, which the graph programs drop).
- Accumulators as in B1: f32, int32 (int8 operands; identity epilogue)
  or bf16 (``bf16acc``: the running sum rounded to bf16 once per
  ``geom.bk``-deep K block).

Four engines, chosen by :func:`repro_torch.core.geometry.grouped_engine`
at ``geom``'s tile (never a fallback; ``engine="tile"`` pins the tile
loop):

- the cluster split-K kernel (``csrc/grouped_gemm_splitk.cu``, counter
  ``grouped_gemm_splitk``; plain version :func:`grouped_splitk_torch`)
  for bf16 operands with an f32 or a bf16 (``bf16acc``) accumulator,
  C ≤ 16, N a multiple of 8 and K within 8 slices of x in shared memory
  — the decode group; int8 operands (int32 accumulator) at C ≤ 16 with N
  a multiple of 16 take its s8 entry (counter ``grouped_gemm_splitk_s8``:
  128-row int8 stages of w (G, K, N) as it lies, the int32 sums exact,
  widths honoured as for bf16);
- B1's TMA + wgmma mainloop with the group on the grid
  (``csrc/grouped_gemm_wgmma.cu``, counter ``grouped_gemm_wgmma``; plain
  version :func:`grouped_gemm_torch`) for bf16 operands past 16 rows at
  a wgmma tile, K and N multiples of 8: the prefill groups, the MoE
  experts.  w is read through a 3-D tensor map, so each member's K tail
  loads zeros; a broadcast x through a 2-D one.  int8 operands past 16
  rows with K a multiple of 16 take its s8 entry (counter
  ``grouped_gemm_wgmma_s8``; the int32 accumulator written exactly),
  which reads w K-major: the wrapper copies w (G, K, N) to (G, N, K);
- the SIMT f32 mainloop with the group on the grid
  (``csrc/grouped_gemm.cu``, counter ``grouped_gemm_simt``; bit-equal to
  the tile loop) for f32 operands past 16 rows at a SIMT tile, K and N
  multiples of 4: ``GroupedGemm``'s backward;
- the tile loop (``csrc/grouped_gemm.cu``, counter ``grouped_gemm``, at
  ``geom``'s tile; plain version :func:`grouped_gemm_torch`) for the
  rest: fp32 at C ≤ 16, int8 off the split-K and s8 rules, unaligned
  shapes.

Under ``bf16acc`` the split-K engine keeps B2's cluster contract
(:mod:`repro_torch.kernels.splitk_gemm`): a bf16 running sum per K slice,
rounded once per :func:`~repro_torch.kernels.mte_gemm.bf16acc_block` of
``geom.bk`` rows of the slice, the slices summed in f32 and rounded to
bf16 once, the epilogue rounded at every step.  The reference's grouped
kernel rounds its running sum in K order over the whole of K: the two
agree to bf16 tolerance, not bit for bit.  On CPU tensors a bf16acc
group the split-K engine takes runs :func:`grouped_splitk_torch` at the
split the engine would take on an H100 (132 SMs); with an f32
accumulator the engines differ only in f32 summation order, and CPU
tensors run :func:`grouped_gemm_torch`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.core.epilogue import ACTIVATION_CODES, Epilogue
from repro_torch.core.geometry import (GROUPED_BK, H100_SPEC, MAX_CLUSTER,
                                       BlockGeometry, cdiv, cluster_stage,
                                       grouped_engine,
                                       grouped_live_tiles, grouped_max_depth,
                                       grouped_split, round_up)
from repro_torch.kernels import build
from repro_torch.kernels.mte_gemm import (DTYPE_CODES, _acc_dtype,
                                          bf16_scalar, bf16acc_block,
                                          raw_accumulate, tma_ready)
from repro_torch.kernels.splitk_gemm import _reduce, slice_partials

__all__ = ["grouped_gemm_kernel", "grouped_gemm_torch",
           "grouped_splitk_torch", "split_layout"]

MAX_WIDTHS = 8           # members that carry a width in one launch

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_long] * 2 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.c_void_p])
# grouped_gemm_wgmma_launch: as grouped_gemm_launch without the operand
# type (always bf16); grouped_gemm_simt_launch: without the operand type,
# the accumulator flag and its block (f32 operands and accumulator).
_WG_ARGTYPES = _ARGTYPES[:9] + _ARGTYPES[10:]
_SIMT_ARGTYPES = (_ARGTYPES[:9] + _ARGTYPES[10:11] + _ARGTYPES[12:14]
                  + _ARGTYPES[15:])
# grouped_gemm_wgmma_s8_launch: x, w (G, N, K), out; G, M, N, K; the
# group and row strides of x; the tile; the widths; the stream.
_S8_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_long] * 2 + [ctypes.c_int] * 3
                + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
_SPLITK_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_long] * 2 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
# grouped_gemm_splitk_s8_launch: x, w, out; G, M, N, K; the group and row
# strides of x; slices, depth, live tiles; the widths; the stream.
_SPLITK_S8_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_long] * 2 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])


def _check(x, w, epilogue, widths):
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be 3-D")
    g, m, k = x.shape
    gw, kw, n = w.shape
    if gw != g or kw != k:
        raise ValueError(f"group shapes mismatch: {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    if epilogue.needs_c_input or epilogue.has_bias:
        raise ValueError("grouped_gemm: the epilogue takes no C and no bias")
    if widths is not None and (len(widths) != g or g > MAX_WIDTHS):
        raise ValueError(f"grouped_gemm: {len(widths)} widths for {g} "
                         f"groups (at most {MAX_WIDTHS} carry a width)")
    return g, m, n, k


def grouped_gemm_torch(x, w, *, geom: BlockGeometry,
                       epilogue: Epilogue = Epilogue(),
                       out_dtype=torch.float32, acc_dtype=None,
                       widths: Optional[Sequence[int]] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version of :func:`grouped_gemm_kernel`."""
    g, m, n, k = _check(x, w, epilogue, widths)
    acc_dtype = _acc_dtype(x, acc_dtype)
    bk = min(geom.bk, max(1, k))
    out = torch.stack([
        epilogue.apply(raw_accumulate(x[i], w[i], acc_dtype, bk)
                       ).to(out_dtype) for i in range(g)])
    if widths is not None:
        for i, wd in enumerate(widths):
            out[i, :, wd:] = 0
    return out


def grouped_splitk_torch(x, w, *, n_split: int, depth: int,
                         rbk: int = GROUPED_BK,
                         epilogue: Epilogue = Epilogue(),
                         out_dtype=torch.float32, acc_dtype=None,
                         widths: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of the split-K engine: each member's K cut
    into ``n_split`` slices of ``depth`` rows (:func:`split_layout`),
    each slice's partial in the accumulator dtype (bf16acc: rounded once
    per ``rbk`` rows of the slice), the partials summed in f32 in slice
    order (bf16acc: rounded to bf16 once), the epilogue, and the columns
    past each member's width zeroed."""
    g, m, n, k = _check(x, w, epilogue, widths)
    acc_dtype = _acc_dtype(x, acc_dtype)
    if cdiv(k, depth) != n_split:
        raise ValueError(f"grouped_gemm: {n_split} slices of {depth} rows "
                         f"do not cover K={k}")
    out = torch.stack([
        epilogue.apply(_reduce(slice_partials(x[i], w[i], depth, acc_dtype,
                                              rbk), acc_dtype)
                       ).to(out_dtype) for i in range(g)])
    if widths is not None:
        for i, wd in enumerate(widths):
            out[i, :, wd:] = 0
    return out


def split_layout(x, w, *, widths=None, n_split: Optional[int] = None,
                 split_rows: Optional[int] = None, sm_count: int = 0):
    """(slices, slice depth) of the split-K engine for x (G, C, K) and
    w (G, K, N): :func:`repro_torch.core.geometry.grouped_split` over the
    members' live tiles for ``split_rows`` rows (default C), ``sm_count``
    SMs (0: an H100's) and x's operand type, or the pinned ``n_split``
    (slices a whole number of :func:`cluster_stage` rows deep);
    ValueError when the engine cannot take the split for C rows."""
    g, m, k = x.shape
    n = w.shape[2]
    if n_split is None:
        tiles = sum(grouped_live_tiles(n, widths, g))
        n_split, depth = grouped_split(
            tiles, k, m if split_rows is None else split_rows,
            sm_count or H100_SPEC.sm_count, x.dtype)
    else:
        depth = round_up(cdiv(k, n_split), cluster_stage(x.dtype))
    if not 1 <= n_split <= MAX_CLUSTER or cdiv(k, depth) != n_split \
            or depth > grouped_max_depth(m, x.dtype):
        raise ValueError(f"grouped_gemm: {n_split} slices of K={k} "
                         f"for {m} rows is not a split the split-K "
                         f"engine takes")
    return n_split, depth


def grouped_gemm_kernel(x, w, *, geom: BlockGeometry,
                        epilogue: Epilogue = Epilogue(),
                        out_dtype=torch.float32, acc_dtype=None,
                        widths: Optional[Sequence[int]] = None,
                        n_split: Optional[int] = None,
                        split_rows: Optional[int] = None,
                        engine: Optional[str] = None) -> torch.Tensor:
    """x (G, C, K) @ w (G, K, N) → (G, C, N), epilogue per group: the B3
    CUDA kernel on CUDA tensors, :func:`grouped_gemm_torch` on CPU
    tensors.  ``n_split`` (split-K engine only) pins the number of K
    slices, at most 8; None takes
    :func:`repro_torch.core.geometry.grouped_split`'s choice for
    ``split_rows`` rows (default C).  ``engine`` pins the engine: None
    (or the name :func:`~repro_torch.core.geometry.grouped_engine` gives)
    launches that engine's kernel, ``"tile"`` the tile loop at ``geom``'s
    tile whatever the rule names."""
    dev = build.require_cuda(x, w, what="grouped_gemm")
    g, m, n, k = _check(x, w, epilogue, widths)
    acc_dtype = _acc_dtype(x, acc_dtype)
    bf16acc = acc_dtype == torch.bfloat16
    if dev is None:
        if bf16acc and grouped_engine(x.dtype, m, n, k,
                                      bf16acc=True) == "splitk":
            slices, depth = split_layout(x, w, widths=widths,
                                         n_split=n_split,
                                         split_rows=split_rows)
            return grouped_splitk_torch(
                x, w, n_split=slices, depth=depth,
                rbk=bf16acc_block(geom.bk, k), epilogue=epilogue,
                out_dtype=out_dtype, acc_dtype=acc_dtype, widths=widths)
        return grouped_gemm_torch(x, w, geom=geom, epilogue=epilogue,
                                  out_dtype=out_dtype, acc_dtype=acc_dtype,
                                  widths=widths)
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16,
                                             torch.int8):
        raise TypeError(f"grouped_gemm: operands {x.dtype} x {w.dtype} "
                        f"unsupported")
    if bf16acc and x.dtype != torch.bfloat16:
        raise TypeError("grouped_gemm: bf16acc needs bf16 operands")
    if not acc_dtype.is_floating_point and not epilogue.is_identity:
        raise ValueError("grouped_gemm: an integer accumulator takes the "
                         "identity epilogue (dequantize first)")
    if out_dtype not in (torch.float32, torch.bfloat16, torch.int32):
        raise TypeError(f"grouped_gemm: out_dtype {out_dtype} unsupported")
    chosen = grouped_engine(x.dtype, m, n, k, bf16acc=bf16acc,
                            tile=(geom.bm, geom.bn))
    if engine is None:
        engine = chosen
    elif engine not in (chosen, "tile"):
        raise ValueError(f"grouped_gemm: engine={engine!r} cannot run "
                         f"{tuple(x.shape)} x {tuple(w.shape)} at the tile "
                         f"{geom.bm}x{geom.bn} (grouped_engine chose "
                         f"{chosen!r})")
    if n_split is not None and engine != "splitk":
        raise ValueError("grouped_gemm: n_split pins the split-K engine's "
                         "slices; the tile loop takes its split from geom")
    if engine in ("wgmma", "simt"):
        return _pipelined(engine, x, w, geom, epilogue, out_dtype, bf16acc,
                          widths, dev)
    if x.stride(2) != 1 or (m > 1 and x.stride(1) < k):
        x = x.contiguous()
    w = w.contiguous()
    n_widths = 0 if widths is None else g
    wd = (ctypes.c_int * MAX_WIDTHS)(*[int(v) for v in (widths or ())])
    out = torch.empty(g, m, n, dtype=out_dtype, device=dev)
    alpha = float(epilogue.alpha)
    softcap = float(epilogue.softcap or 0.0)
    if bf16acc:
        alpha, softcap = bf16_scalar(alpha), bf16_scalar(softcap)
    rbk = bf16acc_block(geom.bk, k)
    if engine == "splitk":
        s8 = x.dtype == torch.int8
        if out_dtype not in ((torch.int32,) if s8 else (torch.float32,
                                                        torch.bfloat16)):
            raise TypeError(f"grouped_gemm: the split-K engine writes "
                            f"{'int32' if s8 else 'f32 or bf16'} for "
                            f"{x.dtype} operands, not {out_dtype}")
        tiles = sum(grouped_live_tiles(n, widths, g))
        n_split, depth = split_layout(
            x, w, widths=widths, n_split=n_split, split_rows=split_rows,
            sm_count=torch.cuda.get_device_properties(
                dev).multi_processor_count)
        if s8:
            w = tma_ready(w)
            lib, fn = build.entry("grouped_gemm_splitk",
                                  "grouped_gemm_splitk_s8_launch",
                                  _SPLITK_S8_ARGTYPES)
            build.count_launch("grouped_gemm_splitk_s8")
            err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), g, m, n, k,
                     x.stride(0), x.stride(1), n_split, depth,
                     max(tiles, 1), n_widths, wd, build.stream_ptr(dev))
            build.check(lib, err, "grouped_gemm_splitk[s8]")
            return out
        lib, fn = build.entry("grouped_gemm_splitk",
                              "grouped_gemm_splitk_launch",
                              _SPLITK_ARGTYPES)
        build.count_launch("grouped_gemm_splitk")
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), g, m, n, k,
                 x.stride(0), x.stride(1), DTYPE_CODES[out_dtype], n_split,
                 depth, max(tiles, 1), int(bf16acc), rbk, alpha,
                 int(epilogue.softcap is not None), softcap,
                 ACTIVATION_CODES[epilogue.activation], n_widths, wd,
                 build.stream_ptr(dev))
        build.check(lib, err, "grouped_gemm_splitk")
        return out
    lib, fn = build.entry("grouped_gemm", "grouped_gemm_launch", _ARGTYPES)
    build.count_launch("grouped_gemm")
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), g, m, n, k,
             x.stride(0), x.stride(1), DTYPE_CODES[x.dtype],
             DTYPE_CODES[out_dtype], int(bf16acc), geom.bm, geom.bn, rbk,
             alpha, int(epilogue.softcap is not None), softcap,
             ACTIVATION_CODES[epilogue.activation], n_widths, wd,
             build.stream_ptr(dev))
    build.check(lib, err, "grouped_gemm")
    return out


def _pipelined(engine, x, w, geom, epilogue, out_dtype, bf16acc, widths,
               dev) -> torch.Tensor:
    """One launch of the wgmma or the SIMT f32 engine: both read 16-byte
    vectors of contiguous rows at 16-byte aligned addresses, a broadcast x
    (group stride 0) through its one matrix, no copy."""
    g, m, k = x.shape
    n = w.shape[2]
    s8 = x.dtype == torch.int8
    if s8 and out_dtype != torch.int32:
        raise TypeError(f"grouped_gemm: the s8 wgmma engine writes the "
                        f"int32 accumulator, not {out_dtype}")
    if not s8 and out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped_gemm: the {engine} engine writes f32 or "
                        f"bf16, not {out_dtype}")
    if x.stride(0) == 0 and g > 1:
        x = tma_ready(x[0])
        sx, ldx = 0, x.stride(0)
    else:
        x = tma_ready(x)
        sx, ldx = m * k, k
    # The s8 mainloop reads w K-major: (G, N, K).
    w = tma_ready(w.transpose(1, 2) if s8 else w)
    n_widths = 0 if widths is None else g
    wd = (ctypes.c_int * MAX_WIDTHS)(*[int(v) for v in (widths or ())])
    out = torch.empty(g, m, n, dtype=out_dtype, device=dev)
    if s8:
        lib, fn = build.entry("grouped_gemm_wgmma",
                              "grouped_gemm_wgmma_s8_launch", _S8_ARGTYPES)
        build.count_launch("grouped_gemm_wgmma_s8")
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), g, m, n, k,
                 sx, ldx, geom.bm, geom.bn, n_widths, wd,
                 build.stream_ptr(dev))
        build.check(lib, err, "grouped_gemm[wgmma s8]")
        return out
    alpha = float(epilogue.alpha)
    softcap = float(epilogue.softcap or 0.0)
    if bf16acc:
        alpha, softcap = bf16_scalar(alpha), bf16_scalar(softcap)
    if engine == "wgmma":
        lib, fn = build.entry("grouped_gemm_wgmma",
                              "grouped_gemm_wgmma_launch", _WG_ARGTYPES)
        mid = (DTYPE_CODES[out_dtype], int(bf16acc), geom.bm, geom.bn,
               bf16acc_block(geom.bk, k))
    else:
        lib, fn = build.entry("grouped_gemm", "grouped_gemm_simt_launch",
                              _SIMT_ARGTYPES)
        mid = (DTYPE_CODES[out_dtype], geom.bm, geom.bn)
    build.count_launch(f"grouped_gemm_{engine}")
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), g, m, n, k, sx,
             ldx, *mid, alpha, int(epilogue.softcap is not None), softcap,
             ACTIVATION_CODES[epilogue.activation], n_widths, wd,
             build.stream_ptr(dev))
    build.check(lib, err, f"grouped_gemm[{engine}]")
    return out
