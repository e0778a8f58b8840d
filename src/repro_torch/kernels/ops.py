"""Public wrappers for the Hopper kernels (the port of
``repro/kernels/ops.py``).

Each wrapper asks the plan cache (:mod:`repro_torch.core.autotune`) for an
execution plan and launches the granted route: B1 (``mte``), B2
(``splitk``), B3 (``grouped``) or, for ``policy="amx"``, the rigid
baseline B8 (``rigid``: one fixed tile whatever the shape).
``format_policy`` sets the operand and accumulator widths; the operand
cast or int8 quantize happens once, here, as in JAX's
``autodiff.mte_gemm_ad`` and ``grouped_gemm_ad``.  A CUDA tensor goes to
its kernel or raises; a CPU tensor goes to the kernel's plain version.

Differentiable: when autograd records and an input requires grad,
:func:`mte_gemm`, :func:`grouped_gemm` and :func:`flash_attention` run
their forward inside the :mod:`repro_torch.kernels.autodiff` Functions,
whose backward GEMMs run on the kernels too; otherwise (every serving
path) the same forward runs with no graph recorded.

While a :func:`repro_torch.graph.trace.trace_gemms` capture is active,
every GEMM issued here is recorded in it (``record_gemm`` /
``record_grouped``).

``plan_rows`` plans a GEMM as if it had that many rows, and the split-K
engines take their K slices for that many.  The rows then run in chunks
of :func:`repro_torch.core.geometry.window_rows`: at most 16
(``geometry.GROUPED_MAX_M``) while the planned rows are that few, fewer
where the planned K slice would not fit a chunk's rows in B2's or B3's
shared memory, and exactly ``plan_rows`` past 16.  Each chunk runs the
planned rows' engine and K partition, on which a row's bits do not
depend on the rows that ride with it.  A speculative verify window of
slots·k rows runs on the decode step's plans this way, every row with a
decode step's bits (:func:`repro_torch.models.model.verify_chunk`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autotune
from repro_torch.core import formats as formats_lib
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.geometry import (GROUPED_BN, H100_SPEC,
                                       check_kernel_tile, cdiv,
                                       grouped_engine, grouped_live_tiles,
                                       grouped_split, splitk_cluster_split,
                                       splitk_engine, window_rows)
from repro_torch.kernels import autodiff

__all__ = ["mte_gemm", "grouped_gemm", "flash_attention",
           "flash_decode", "flash_decode_paged", "rglru_scan"]


def _trace_sink():
    """The active repro_torch.graph capture, if any."""
    from repro_torch.graph import trace
    return trace.active()


def _plan(m, n, k, fmt, out_dtype, policy, epilogue, geometry,
          group: int = 1):
    sig = autotune.GemmSignature.for_format(m, n, k, fmt, out_dtype,
                                            epilogue, policy, group)
    if geometry is None:
        return autotune.plan_cache().plan(sig)
    check_kernel_tile(geometry, group)
    return autotune.ExecutionPlan(
        signature=sig, geometry=geometry,
        route=autotune._route_for(sig, geometry),
        predicted_s=autotune.score_geometry(sig, geometry),
        source="program")


def _chunk_rows(plan, x, rows: int, n: int, k: int, widths=None) -> int:
    """Rows per launch of ``plan`` over ``rows`` rows: all of them when
    they are no more than it was planned for, else
    :func:`~repro_torch.core.geometry.window_rows` of the planned rows'
    engine, and of the K slice of its split on the split-K engines, for
    the card's SM count (an H100's on the CPU)."""
    sig = plan.signature
    if rows <= sig.m:
        return rows
    sms = (torch.cuda.get_device_properties(x.device).multi_processor_count
           if x.is_cuda else H100_SPEC.sm_count)
    bf16acc = sig.format_policy.accum_torch == torch.bfloat16
    depth = 0
    if x.dim() == 3:            # B3, a one-member group's plan too
        engine = grouped_engine(x.dtype, sig.m, n, k, bf16acc=bf16acc,
                                tile=(plan.geometry.bm, plan.geometry.bn))
        if engine == "splitk":
            tiles = sum(grouped_live_tiles(n, widths, sig.group))
            depth = grouped_split(tiles, k, sig.m, sms, x.dtype)[1]
    elif plan.route == "splitk":
        engine = splitk_engine(x.dtype, sig.m, n, k, bf16acc=bf16acc,
                               tile=(plan.geometry.bm, plan.geometry.bn))
        if engine == "cluster":
            depth = splitk_cluster_split(cdiv(n, GROUPED_BN), k, sig.m,
                                         sms, x.dtype)[1]
    else:
        engine = plan.route
    return window_rows(engine, sig.m, depth, x.dtype)


def _by_rows(run, m: int, rows: int, axis: int):
    """``run(lo, hi)`` over the rows [0, m) in chunks of at most ``rows``,
    joined along ``axis``."""
    if m <= rows:
        return run(0, m)
    return torch.cat([run(lo, min(lo + rows, m))
                      for lo in range(0, m, rows)], dim=axis)


def mte_gemm(a, b, c=None, bias=None, *, epilogue: Epilogue = Epilogue(),
             policy: str = "mte", out_dtype=torch.float32,
             format_policy=None, geometry=None,
             plan_rows: Optional[int] = None):
    """``epilogue(a @ b [, c, bias])`` through the plan cache under a
    format policy.  ``geometry`` pins the plan to a block geometry, which
    must be a tile the kernels are compiled for (else ValueError).
    ``policy="amx"`` routes to the rigid baseline (B8): it cannot adapt
    its geometry or its accumulator to the format, but it still executes
    the format's arithmetic (int8: quantize, rigid product into int32,
    dequantize and epilogue outside, as ``ops.py:72-84`` in JAX).
    ``plan_rows``: see the module docstring."""
    fmt = formats_lib.resolve_format(format_policy, a.dtype)

    def forward():
        return _mte_gemm(a, b, c, bias, epilogue, policy, out_dtype, fmt,
                         geometry, plan_rows)

    if autodiff.wants_grad(a, b, c, bias):
        out = autodiff.MteGemm.apply(a, b, c, bias, forward, epilogue,
                                     policy, out_dtype)
    else:
        out = forward()
    sink = _trace_sink()
    if sink is not None:
        sink.record_gemm(a, b, out, c=c, bias=bias, epilogue=epilogue,
                         fmt=fmt.name, policy=policy, out_dtype=out_dtype,
                         backend="kernels")
    return out


def _mte_gemm(a, b, c, bias, epilogue, policy, out_dtype, fmt, geometry,
              plan_rows):
    """The forward of :func:`mte_gemm`."""
    rows, k = a.shape
    m = rows if plan_rows is None else plan_rows
    n = b.shape[1]
    plan = _plan(m, n, k, fmt, out_dtype, policy, epilogue, geometry)
    if fmt.quantized:
        aq, bq, sa, sb = formats_lib.quantize_operands(a, b, fmt)
        acc = _by_rows(
            lambda lo, hi: autotune.execute_plan(plan, aq[lo:hi], bq),
            rows, _chunk_rows(plan, aq, rows, n, k), 0)
        acc = formats_lib.dequantize(acc, sa, sb)
        out = epilogue.apply(acc.float(), c_in=c, bias=bias).to(out_dtype)
    else:
        ac = a.to(fmt.operand_torch)
        bc = b.to(fmt.operand_torch)

        def run(lo, hi):
            cr = c[lo:hi] if c is not None else None
            br = bias[lo:hi] if bias is not None \
                and epilogue.bias_axis == "col" else bias
            return autotune.execute_plan(plan, ac[lo:hi], bc, cr, br)

        out = _by_rows(run, rows, _chunk_rows(plan, ac, rows, n, k), 0)
    return out


def grouped_gemm(x, w, *, epilogue: Epilogue = Epilogue(),
                 out_dtype=torch.float32, format_policy=None,
                 geometry=None, widths=None,
                 plan_rows: Optional[int] = None):
    """Grouped GEMM x (G, C, K) @ w (G, K, N) → (G, C, N) through the
    plan cache (route ``grouped``, B3) under a format policy (per-group
    per-channel scales for int8).  ``geometry`` pins a program-scheduled
    block shape; ``widths`` marks each member's true output width (the
    columns past it come back as zeros and cost the kernel no reads).
    The quantize, cast and dequantize follow ``autodiff.py:165-191`` of
    the JAX package.  ``plan_rows``: see the module docstring."""
    fmt = formats_lib.resolve_format(format_policy, x.dtype)

    def forward():
        return _grouped_gemm(x, w, epilogue, out_dtype, fmt, geometry,
                             widths, plan_rows)

    if autodiff.wants_grad(x, w):
        out = autodiff.GroupedGemm.apply(x, w, forward, epilogue, out_dtype,
                                         widths)
    else:
        out = forward()
    sink = _trace_sink()
    if sink is not None:
        sink.record_grouped(x, w, out, epilogue=epilogue, fmt=fmt.name,
                            out_dtype=out_dtype, backend="kernels")
    return out


def _grouped_gemm(x, w, epilogue, out_dtype, fmt, geometry, widths,
                  plan_rows):
    """The forward of :func:`grouped_gemm`."""
    from repro_torch.kernels.grouped_gemm import grouped_gemm_kernel
    g, rows, k = x.shape
    cap = rows if plan_rows is None else plan_rows
    n = w.shape[2]
    plan = _plan(cap, n, k, fmt, out_dtype, "mte", epilogue, geometry,
                 group=g)
    if fmt.quantized:
        xc, wc, sx, sw = formats_lib.quantize_operands(x, w, fmt)
    else:
        xc, wc = x.to(fmt.operand_torch), w.to(fmt.operand_torch)
    sig = plan.signature
    # B3 at the plan's geometry: a one-member group (a 1 x 1 convolution)
    # plans as its member's plain GEMM, as in the JAX package, and B3's
    # engines run K whole at that plan's tile.
    out = _by_rows(
        lambda lo, hi: grouped_gemm_kernel(
            xc[:, lo:hi], wc, geom=plan.geometry, epilogue=sig.epilogue,
            out_dtype=formats_lib.to_torch_dtype(sig.dtype_out),
            acc_dtype=sig.format_policy.accum_torch, widths=widths,
            split_rows=sig.m),
        rows, _chunk_rows(plan, xc, rows, n, k, widths), 1)
    if fmt.quantized:
        out = formats_lib.dequantize(out, sx, sw)
        out = epilogue.apply(out.float()).to(out_dtype)
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """Blocked attention (B5); differentiable (its backward recomputes
    through the plain attention, :class:`~repro_torch.kernels.autodiff.
    FlashAttention`)."""
    if autodiff.wants_grad(q, k, v):
        return autodiff.FlashAttention.apply(q, k, v, causal, window,
                                             softcap, scale)
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)


def flash_decode(q, k, v, kv_positions, q_pos, *, window=None, softcap=None,
                 scale=None):
    """Single-token attention over a flat or ring KV cache (B6); k/v may
    be strided views of the cache."""
    from repro_torch.kernels.flash_decode import flash_decode_kernel
    return flash_decode_kernel(q, k, v, kv_positions, q_pos, window=window,
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


def rglru_scan(a, b, h0=None):
    """RG-LRU linear recurrence h_t = a_t·h_{t-1} + b_t from h_{-1} = h0
    (zeros when None) (B7, serving prefill)."""
    from repro_torch.kernels.rglru_scan import rglru_scan_kernel
    return rglru_scan_kernel(a, b, h0)
