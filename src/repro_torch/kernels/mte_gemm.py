"""B1: the MTE GEMM with its fused epilogue — CUDA kernel and plain version.

:func:`mte_gemm_kernel` is the counterpart of ``mte_gemm_pallas``
(``repro/kernels/mte_gemm.py``): ``epilogue(a @ b [, c, bias])`` with a
block schedule granted by the plan cache.  On CUDA tensors it launches
``csrc/mte_gemm.cu`` (or raises) on the engine
:func:`repro_torch.core.geometry.gemm_engine` names — the TMA + wgmma
mainloop (counter ``mte_gemm_wgmma``; int8 operands: its s8 entry,
counter ``mte_gemm_wgmma_s8``, which reads B K-major, so a (K, N) B is
copied to (N, K) first), the SIMT f32 mainloop (counter
``mte_gemm_simt``) or the tile loop (counter ``mte_gemm``); on CPU
tensors it runs :func:`mte_gemm_torch`, the plain
PyTorch version of the same function, after the same engine check, so a
tile no engine takes raises on either device.

a: (M, K); b: (K, N), or (N, K) when ``geom.transposed_b``.  Operands are
f32, bf16 or int8; the accumulator is f32, int32 (int8 operands — the
epilogue must then be the identity: the dequantize and the caller's
epilogue run outside, in ``kernels/ops.py``) or bf16 (``bf16acc``: each
``geom.bk``-deep K block's partial is rounded to bf16 and added to a
bf16-rounded running sum, so the result depends on ``geom.bk``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.epilogue import ACTIVATION_CODES, Epilogue
from repro_torch.core.formats import int_matmul
from repro_torch.core.geometry import (TILE_LOOP_TILES, BlockGeometry,
                                       cdiv, gemm_engine)
from repro_torch.kernels import build

__all__ = ["mte_gemm_kernel", "mte_gemm_torch", "DTYPE_CODES",
           "bf16_scalar", "tma_ready", "bf16acc_block", "k_major"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int32: 3}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_long] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_void_p])
# mte_gemm_wgmma_launch: as mte_gemm_launch without the operand type
# (always bf16).
_WG_ARGTYPES = _ARGTYPES[:12] + _ARGTYPES[13:]
# mte_gemm_simt_launch: as mte_gemm_wgmma_launch without the accumulator
# flag and its block (f32 operands, f32 accumulator).
_SIMT_ARGTYPES = _WG_ARGTYPES[:13] + _WG_ARGTYPES[14:16] + _WG_ARGTYPES[17:]
# mte_gemm_wgmma_s8_launch: a, b (N, K), out; M, N, K; lda, ldb, ldo; the
# tile; the stream.
_S8_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_long] * 3 + [ctypes.c_int] * 2
                + [ctypes.c_void_p])


def tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address, as TMA reads it (a
    view at an odd offset is copied)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _acc_dtype(a: torch.Tensor, acc_dtype) -> torch.dtype:
    if acc_dtype is not None:
        return acc_dtype
    return torch.float32 if a.dtype.is_floating_point else torch.int32


def bf16acc_block(bk: int, k: int) -> int:
    """The K rows of one bf16acc block the kernels round their running sum
    after: the plan's ``bk`` clipped to K, a multiple of the 32-deep inner
    tile (the ``rbk`` of every GEMM kernel)."""
    return max(32, min(bk, cdiv(k, 32) * 32))


def bf16_scalar(x: float) -> float:
    """``x`` rounded to the nearest bf16 value."""
    return float(torch.tensor(x, dtype=torch.bfloat16).float())


def _check(a, b, c, bias, geom, epilogue):
    m, k = a.shape
    n, kb = b.shape if geom.transposed_b else b.shape[::-1]
    if kb != k:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if epilogue.needs_c_input and c is None:
        raise ValueError("epilogue.beta != 0 requires c operand")
    if epilogue.has_bias and bias is None:
        raise ValueError("epilogue.has_bias requires bias operand")
    if epilogue.has_bias and epilogue.bias_axis != "row":
        raise NotImplementedError("kernel bias fusion supports row bias only")
    return m, n, k


def blocked_bf16_matmul(a: torch.Tensor, b: torch.Tensor, bk: int,
                        k0: int = 0, k1: Optional[int] = None
                        ) -> torch.Tensor:
    """``a[:, k0:k1] @ b[k0:k1]`` with a bf16 accumulator that is
    ``+=``-ed once per ``bk``-deep K block (blocks aligned to multiples of
    ``bk``): each block's f32 partial is rounded to bf16, added, and the
    sum rounded to bf16."""
    k1 = a.shape[1] if k1 is None else k1
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.bfloat16,
                      device=a.device)
    start = k0
    while start < k1:
        stop = min((start // bk + 1) * bk, k1)
        part = torch.matmul(a[:, start:stop].float(),
                            b[start:stop].float()).to(torch.bfloat16)
        acc = (acc.float() + part.float()).to(torch.bfloat16)
        start = stop
    return acc


def raw_accumulate(a: torch.Tensor, b: torch.Tensor, acc_dtype: torch.dtype,
                   bk: int, k0: int = 0, k1: Optional[int] = None
                   ) -> torch.Tensor:
    """The accumulator of ``a[:, k0:k1] @ b[k0:k1]`` at ``acc_dtype``
    (plain PyTorch; b row-major (K, N))."""
    k1 = a.shape[1] if k1 is None else k1
    if not acc_dtype.is_floating_point:
        return int_matmul(a[:, k0:k1], b[k0:k1])
    if acc_dtype == torch.bfloat16:
        return blocked_bf16_matmul(a, b, bk, k0, k1)
    return torch.matmul(a[:, k0:k1].float(), b[k0:k1].float())


def mte_gemm_torch(a, b, c=None, bias=None, *, geom: BlockGeometry,
                   epilogue: Epilogue = Epilogue(),
                   out_dtype=torch.float32, acc_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`mte_gemm_kernel`."""
    _check(a, b, c, bias, geom, epilogue)
    acc_dtype = _acc_dtype(a, acc_dtype)
    bk = min(geom.bk, max(1, a.shape[1]))
    bt = b.t() if geom.transposed_b else b
    acc = raw_accumulate(a, bt, acc_dtype, bk)
    return epilogue.apply(acc, c_in=c, bias=bias).to(out_dtype)


def mte_gemm_kernel(a, b, c=None, bias=None, *, geom: BlockGeometry,
                    epilogue: Epilogue = Epilogue(),
                    out_dtype=torch.float32, acc_dtype=None,
                    engine: Optional[str] = None) -> torch.Tensor:
    """``epilogue(a @ b [, c, bias])``: the B1 CUDA kernel on CUDA
    tensors, :func:`mte_gemm_torch` on CPU tensors.  ``engine`` pins the
    engine: None (or the name :func:`~repro_torch.core.geometry.
    gemm_engine` gives) launches that engine's kernel, ``"tile"`` the tile
    loop at ``geom``'s tile whatever the rule names (its tiles only)."""
    dev = build.require_cuda(a, b, c, bias, what="mte_gemm")
    m, n, k = _check(a, b, c, bias, geom, epilogue)
    acc_dtype = _acc_dtype(a, acc_dtype)
    bf16acc = acc_dtype == torch.bfloat16
    chosen = gemm_engine(a.dtype, geom.bm, geom.bn, n, k, m=m,
                         bf16acc=bf16acc)
    if engine is None:
        engine = chosen
    elif engine not in (chosen, "tile") or (
            engine == "tile" and (geom.bm, geom.bn) not in TILE_LOOP_TILES):
        raise ValueError(f"mte_gemm: engine={engine!r} cannot run "
                         f"{m}x{n}x{k} at the tile {geom.bm}x{geom.bn} "
                         f"(gemm_engine chose {chosen!r})")
    if dev is None:
        return mte_gemm_torch(a, b, c, bias, geom=geom, epilogue=epilogue,
                              out_dtype=out_dtype, acc_dtype=acc_dtype)
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16,
                                             torch.int8):
        raise TypeError(f"mte_gemm: operands {a.dtype} x {b.dtype} "
                        f"unsupported")
    if bf16acc and a.dtype != torch.bfloat16:
        raise TypeError("mte_gemm: bf16acc needs bf16 operands")
    if not acc_dtype.is_floating_point and not epilogue.is_identity:
        raise ValueError("mte_gemm: an integer accumulator takes the "
                         "identity epilogue (dequantize first)")
    if out_dtype not in (torch.float32, torch.bfloat16, torch.int32):
        raise TypeError(f"mte_gemm: out_dtype {out_dtype} unsupported")
    if engine == "wgmma" and a.dtype == torch.int8:
        return _s8_launch(a, b, geom, out_dtype, dev)
    acc_f = torch.bfloat16 if bf16acc else torch.float32
    c_ = (c.to(acc_f).float().contiguous()
          if epilogue.needs_c_input else None)
    bias_ = (bias.to(acc_f).float().contiguous()
             if epilogue.has_bias else None)
    out = torch.empty(m, n, dtype=out_dtype, device=dev)
    alpha, beta = float(epilogue.alpha), float(epilogue.beta)
    softcap = float(epilogue.softcap or 0.0)
    if bf16acc:
        alpha, beta, softcap = map(bf16_scalar, (alpha, beta, softcap))
    # Each entry's arguments between the strides and the B layout.
    rbk = bf16acc_block(geom.bk, k)
    out_code = DTYPE_CODES[out_dtype]
    if engine == "tile":
        a, b = a.contiguous(), b.contiguous()
        symbol, argtypes, counter = "mte_gemm_launch", _ARGTYPES, "mte_gemm"
        mid = (DTYPE_CODES[a.dtype], out_code, int(bf16acc), geom.bm,
               geom.bn, rbk)
    else:
        # Both pipelined engines read 16-byte vectors of contiguous rows.
        a, b = tma_ready(a), tma_ready(b)
        symbol, counter = f"mte_gemm_{engine}_launch", f"mte_gemm_{engine}"
        if engine == "wgmma":
            argtypes = _WG_ARGTYPES
            mid = (out_code, int(bf16acc), geom.bm, geom.bn, rbk)
        else:
            argtypes = _SIMT_ARGTYPES
            mid = (out_code, geom.bm, geom.bn)
    lib, fn = build.entry("mte_gemm", symbol, argtypes)
    build.count_launch(counter)
    err = fn(a.data_ptr(), b.data_ptr(),
             c_.data_ptr() if c_ is not None else None,
             bias_.data_ptr() if bias_ is not None else None,
             out.data_ptr(), m, n, k, a.stride(0), b.stride(0), n, n, *mid,
             int(geom.transposed_b), alpha, beta,
             int(epilogue.softcap is not None), softcap,
             ACTIVATION_CODES[epilogue.activation], build.stream_ptr(dev))
    build.check(lib, err, f"mte_gemm[{engine}]")
    return out


def k_major(b: torch.Tensor, transposed: bool) -> torch.Tensor:
    """B as the s8 wgmma engine reads it: (N, K) row-major at a 16-byte
    aligned address -- a (K, N) B copied, an (N, K) one as it is."""
    return tma_ready(b if transposed else b.t())


def _s8_launch(a, b, geom: BlockGeometry, out_dtype, dev) -> torch.Tensor:
    """One launch of the s8 wgmma entry: int8 operands, the int32
    accumulator written as it is (the epilogue is the identity)."""
    if out_dtype != torch.int32:
        raise TypeError(f"mte_gemm[wgmma s8]: writes the int32 "
                        f"accumulator, not {out_dtype}")
    m, k = a.shape
    a, bk = tma_ready(a), k_major(b, geom.transposed_b)
    n = bk.shape[0]
    out = torch.empty(m, n, dtype=torch.int32, device=dev)
    lib, fn = build.entry("mte_gemm", "mte_gemm_wgmma_s8_launch",
                          _S8_ARGTYPES)
    build.count_launch("mte_gemm_wgmma_s8")
    err = fn(a.data_ptr(), bk.data_ptr(), out.data_ptr(), m, n, k,
             a.stride(0), bk.stride(0), n, geom.bm, geom.bn,
             build.stream_ptr(dev))
    build.check(lib, err, "mte_gemm[wgmma s8]")
    return out
