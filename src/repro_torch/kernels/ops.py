"""Public wrappers for the Hopper kernels (the port of
``repro/kernels/ops.py``).

Each wrapper asks the plan cache (:mod:`repro_torch.core.autotune`) for an
execution plan and launches the granted route: B1 (``mte``) or B2
(``splitk``).  ``format_policy`` sets the operand and accumulator widths;
the operand cast or int8 quantize happens once, here, as in
``autodiff.mte_gemm_ad`` (forward only — the backward is ROADMAP A3).
A CUDA tensor goes to its kernel or raises; a CPU tensor goes to the
kernel's plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autotune
from repro_torch.core import formats as formats_lib
from repro_torch.core.epilogue import Epilogue

__all__ = ["mte_gemm", "flash_attention", "flash_decode_paged"]


def _plan(m, n, k, dt_in, dt_out, policy, epilogue, fmt, geometry):
    if geometry is None:
        return autotune.get_plan(m, n, k, dt_in, dt_out, epilogue=epilogue,
                                 policy=policy, fmt=fmt)
    sig = autotune.GemmSignature.make(m, n, k, dt_in, dt_out, epilogue,
                                      policy, fmt=fmt)
    return autotune.ExecutionPlan(
        signature=sig, geometry=geometry,
        route=autotune._route_for(sig, geometry),
        predicted_s=autotune.score_geometry(sig, geometry),
        source="program")


def mte_gemm(a, b, c=None, bias=None, *, epilogue: Epilogue = Epilogue(),
             policy: str = "mte", out_dtype=torch.float32,
             format_policy=None, geometry=None):
    """``epilogue(a @ b [, c, bias])`` through the plan cache under a
    format policy.  ``geometry`` pins the plan to a block geometry."""
    if policy == "amx":
        raise NotImplementedError("the rigid AMX-style route is ROADMAP B8")
    fmt = formats_lib.resolve_format(format_policy, a.dtype)
    m, k = a.shape
    n = b.shape[1]
    if fmt.quantized:
        aq, bq, sa, sb = formats_lib.quantize_operands(a, b, fmt)
        plan = _plan(m, n, k, aq.dtype, torch.int32, policy, Epilogue(),
                     fmt.name, geometry)
        acc = autotune.execute_plan(plan, aq, bq)
        acc = formats_lib.dequantize(acc, sa, sb)
        return epilogue.apply(acc.float(), c_in=c, bias=bias).to(out_dtype)
    ac = a.to(fmt.operand_torch)
    bc = b.to(fmt.operand_torch)
    plan = _plan(m, n, k, ac.dtype, out_dtype, policy, epilogue, fmt.name,
                 geometry)
    return autotune.execute_plan(plan, ac, bc, c, bias)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """Blocked attention (B5)."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)


def flash_decode_paged(q, k_pages, v_pages, page_table, seq_lens, *,
                       k_scale=None, v_scale=None, window=None,
                       softcap=None, scale=None):
    """Single-token attention over a paged KV pool (B4), with optional
    in-kernel int8 dequantization."""
    from repro_torch.kernels.flash_decode import flash_decode_paged_kernel
    return flash_decode_paged_kernel(q, k_pages, v_pages, page_table,
                                     seq_lens, k_scale, v_scale,
                                     window=window, softcap=softcap,
                                     scale=scale)
