"""B8: the rigid AMX-style baseline — two CUDA kernels and their plain
versions.

The counterpart of ``rigid_gemm_pallas`` + ``epilogue_pass_pallas``
(``repro/kernels/rigid_gemm.py``), the paper's stand-in for a rigid
matrix ISA (§II-D).  It keeps both handicaps on purpose:

1. **Fixed geometry.** :func:`rigid_accumulate_kernel` runs one 128 x 128
   tile with a 128-deep K block whatever the shape, with the identity
   epilogue, and writes the raw accumulator (f32 for float operands,
   int32 for int8) to device memory.  Its mainloop is B1's, on the engine
   :func:`repro_torch.core.geometry.gemm_engine` names: the TMA + wgmma
   mainloop for bf16 with K and N multiples of 8 (counter
   ``rigid_gemm_wgmma``) and, on its s8 path, for int8 with K a multiple
   of 16 (up to ``S8_MAX_K``) and N of 8 at every M (counter
   ``rigid_gemm_wgmma_s8``; B read K-major, so a (K, N) B is copied to
   (N, K) first by :func:`~repro_torch.kernels.mte_gemm.k_major`, as B1's
   s8 entry reads it; int32 exact, bit-equal to the tile loop), the SIMT
   f32 mainloop for f32 with K and N multiples of 4 at every M (counter
   ``rigid_gemm_simt``; bit-equal to the tile loop), else the tile loop
   (counter ``rigid_gemm``) — so that MTE against rigid compares
   flexibility, not mainloops.
2. **No matrix↔vector interplay.** :func:`epilogue_pass_kernel` is a
   separate element-wise kernel that reads the accumulator back and
   applies α, β·C, bias, softcap and the activation.

:func:`rigid_gemm_kernel` chains the two (an identity epilogue skips the
pass and casts, as in JAX).  On CUDA tensors each launches its kernel in
``csrc/rigid_gemm.cu`` (or raises); on CPU tensors each runs its plain
PyTorch version.  B is row-major (K, N).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.epilogue import ACTIVATION_CODES, Epilogue
from repro_torch.core.formats import int_matmul
from repro_torch.core.geometry import RIGID_TILE, gemm_engine
from repro_torch.kernels import build
from repro_torch.kernels.mte_gemm import DTYPE_CODES, k_major, tma_ready

__all__ = ["rigid_gemm_kernel", "rigid_gemm_torch",
           "rigid_accumulate_kernel", "rigid_accumulate_torch",
           "s8_accumulate",
           "epilogue_pass_kernel", "epilogue_pass_torch"]

_RIGID_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_long] * 2 + [ctypes.c_int, ctypes.c_void_p])
# rigid_gemm_wgmma_launch, rigid_gemm_wgmma_s8_launch (b (N, K)) and
# rigid_gemm_simt_launch: as rigid_gemm_launch without the operand type.
_RIGID_WG_ARGTYPES = _RIGID_ARGTYPES[:8] + _RIGID_ARGTYPES[9:]
_PASS_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_long] * 3
                  + [ctypes.c_float] * 2
                  + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p])


def _check(a, b):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return a.shape[0], b.shape[1], a.shape[1]


def _acc_dtype(a) -> torch.dtype:
    return torch.float32 if a.dtype.is_floating_point else torch.int32


def rigid_accumulate_torch(a, b) -> torch.Tensor:
    """Plain version of stage 1: the raw accumulator of ``a @ b``."""
    _check(a, b)
    if not a.dtype.is_floating_point:
        return int_matmul(a, b)
    return torch.matmul(a.float(), b.float())


def rigid_accumulate_kernel(a, b, *, engine: Optional[str] = None
                            ) -> torch.Tensor:
    """Stage 1: ``a @ b`` at the fixed 128 x 128 tile into an f32 (int32
    for int8) accumulator in device memory.  ``engine`` pins the engine:
    None (or the name :func:`~repro_torch.core.geometry.gemm_engine`
    gives) launches that engine's kernel, ``"tile"`` the tile loop
    whatever the rule names."""
    dev = build.require_cuda(a, b, what="rigid_gemm")
    if dev is None:
        return rigid_accumulate_torch(a, b)
    m, n, k = _check(a, b)
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16,
                                             torch.int8):
        raise TypeError(f"rigid_gemm: operands {a.dtype} x {b.dtype} "
                        f"unsupported")
    chosen = gemm_engine(a.dtype, *RIGID_TILE[:2], n, k, m=m, rigid=True)
    if engine is None:
        engine = chosen
    elif engine not in (chosen, "tile"):
        raise ValueError(f"rigid_gemm: engine={engine!r} cannot run "
                         f"{tuple(a.shape)} x {tuple(b.shape)} "
                         f"(gemm_engine chose {chosen!r})")
    if engine == "wgmma" and a.dtype == torch.int8:
        # The s8 path reads B K-major: (N, K), copied as B1's is.
        return s8_accumulate(tma_ready(a), k_major(b, False))
    acc = torch.empty(m, n, dtype=_acc_dtype(a), device=dev)
    if engine == "tile":
        name, argtypes = "rigid_gemm", _RIGID_ARGTYPES
        head = (DTYPE_CODES[a.dtype],)
        a, b = a.contiguous(), b.contiguous()
    else:
        name, argtypes, head = f"rigid_gemm_{engine}", _RIGID_WG_ARGTYPES, ()
        a, b = tma_ready(a), tma_ready(b)
    lib, fn = build.entry("rigid_gemm", f"{name}_launch", argtypes)
    build.count_launch(name)
    err = fn(a.data_ptr(), b.data_ptr(), acc.data_ptr(), m, n, k,
             a.stride(0), b.stride(0), *head, build.stream_ptr(dev))
    build.check(lib, err, name)
    return acc


def s8_accumulate(a, bk) -> torch.Tensor:
    """One launch of stage 1's s8 entry (counter ``rigid_gemm_wgmma_s8``):
    int8 ``a`` (M, K) times a K-major ``bk`` (N, K), both CUDA tensors with
    16-byte aligned rows, into the raw int32 accumulator (M, N).  Raises
    what the entry refuses (K % 16, N % 8, K past ``S8_MAX_K``, unaligned
    pointers or strides); :func:`rigid_accumulate_kernel` reaches it with
    the (K, N) B copied, and ``chip_smoke.py`` times it without the copy."""
    if build.require_cuda(a, bk, what="rigid_gemm_wgmma_s8") is None:
        raise ValueError("rigid_gemm_wgmma_s8: takes CUDA tensors")
    m, k = a.shape
    n = bk.shape[0]
    if a.dtype != torch.int8 or bk.dtype != torch.int8 or bk.shape[1] != k:
        raise TypeError(f"rigid_gemm_wgmma_s8: takes int8 (M, K) x (N, K), "
                        f"got {a.dtype} {tuple(a.shape)} x {bk.dtype} "
                        f"{tuple(bk.shape)}")
    acc = torch.empty(m, n, dtype=torch.int32, device=a.device)
    lib, fn = build.entry("rigid_gemm", "rigid_gemm_wgmma_s8_launch",
                          _RIGID_WG_ARGTYPES)
    build.count_launch("rigid_gemm_wgmma_s8")
    err = fn(a.data_ptr(), bk.data_ptr(), acc.data_ptr(), m, n, k,
             a.stride(0), bk.stride(0), build.stream_ptr(a.device))
    build.check(lib, err, "rigid_gemm_wgmma_s8")
    return acc


def _check_pass(acc, c, bias, epilogue):
    if acc.dtype != torch.float32 or acc.ndim != 2:
        raise TypeError(f"epilogue_pass: takes a 2-D f32 accumulator, got "
                        f"{acc.dtype} {tuple(acc.shape)}")
    if epilogue.needs_c_input and c is None:
        raise ValueError("epilogue.beta != 0 requires c operand")
    if epilogue.has_bias and bias is None:
        raise ValueError("epilogue.has_bias requires bias operand")
    if epilogue.has_bias and epilogue.bias_axis != "row":
        raise NotImplementedError("the epilogue pass takes a row bias only")


def epilogue_pass_torch(acc, c=None, bias=None, *,
                        epilogue: Epilogue = Epilogue(),
                        out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of stage 2."""
    _check_pass(acc, c, bias, epilogue)
    return epilogue.apply(acc, c_in=c, bias=bias).to(out_dtype)


def epilogue_pass_kernel(acc, c=None, bias=None, *,
                         epilogue: Epilogue = Epilogue(),
                         out_dtype=torch.float32) -> torch.Tensor:
    """Stage 2: ``epilogue(acc [, c, bias])`` as a separate element-wise
    pass over the f32 accumulator read back from device memory."""
    dev = build.require_cuda(acc, c, bias, what="epilogue_pass")
    if dev is None:
        return epilogue_pass_torch(acc, c, bias, epilogue=epilogue,
                                   out_dtype=out_dtype)
    _check_pass(acc, c, bias, epilogue)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"epilogue_pass: out_dtype {out_dtype} unsupported")
    m, n = acc.shape
    acc = acc.contiguous()
    c_ = c.float().contiguous() if epilogue.needs_c_input else None
    bias_ = bias.float().contiguous() if epilogue.has_bias else None
    out = torch.empty(m, n, dtype=out_dtype, device=dev)
    lib, fn = build.entry("rigid_gemm", "epilogue_pass_launch",
                          _PASS_ARGTYPES)
    build.count_launch("epilogue_pass")
    err = fn(acc.data_ptr(), c_.data_ptr() if c_ is not None else None,
             bias_.data_ptr() if bias_ is not None else None,
             out.data_ptr(), m, n, n, float(epilogue.alpha),
             float(epilogue.beta), int(epilogue.softcap is not None),
             float(epilogue.softcap or 0.0),
             ACTIVATION_CODES[epilogue.activation], DTYPE_CODES[out_dtype],
             build.stream_ptr(dev))
    build.check(lib, err, "epilogue_pass")
    return out


def rigid_gemm_torch(a, b, c=None, bias=None, *,
                     epilogue: Epilogue = Epilogue(),
                     out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`rigid_gemm_kernel`."""
    acc = rigid_accumulate_torch(a, b)
    if epilogue.is_identity:
        return acc.to(out_dtype)
    return epilogue_pass_torch(acc, c, bias, epilogue=epilogue,
                               out_dtype=out_dtype)


def rigid_gemm_kernel(a, b, c=None, bias=None, *,
                      epilogue: Epilogue = Epilogue(),
                      out_dtype=torch.float32) -> torch.Tensor:
    """AMX-semantics GEMM: the fixed-tile product, then (unless the
    epilogue is the identity) the epilogue through a memory round trip."""
    if not a.dtype.is_floating_point and not epilogue.is_identity:
        raise ValueError("rigid_gemm: int8 operands take the identity "
                         "epilogue (dequantize first)")
    acc = rigid_accumulate_kernel(a, b)
    if epilogue.is_identity:
        return acc.to(out_dtype)
    return epilogue_pass_kernel(acc, c, bias, epilogue=epilogue,
                                out_dtype=out_dtype)
