"""Public MTE GEMM entry point — the framework's "instruction set".

The port of ``repro.core.dispatch``.  ``mte_gemm`` is the GEMM surface a
caller states *what* it wants through (operand shapes, dtypes, format,
epilogue); the dispatch layer grants an execution plan and routes to a
backend:

- ``backend="kernels"``   — the Hopper kernels through the plan cache
                            (:func:`repro_torch.kernels.ops.mte_gemm`: B1,
                            B2 or, under ``policy="amx"``, B8); CPU
                            tensors run the kernels' plain versions.  The
                            JAX package's ``"pallas"``.
- ``backend="torch"``     — one plain PyTorch product under the format
                            (:func:`repro_torch.core.formats.torch_gemm`)
                            and the epilogue as torch ops; no plan.  The
                            JAX package's ``"xla"``, and the default as
                            that is JAX's.
- ``backend="reference"`` — the oracle of :mod:`repro_torch.kernels.ref`.

``format_policy`` (a name, a :class:`~repro_torch.core.formats.
FormatPolicy`, or None ⇒ inferred from ``a.dtype``) sets the operand cast
or int8 quantize, the accumulator and the default output dtype, the same
on every backend, so the three agree numerically.

:func:`plan_gemm` is the dry ``tss`` handshake: the plan cache's grant for
the signature a kernels-backed call would make, its modelled seconds and
the CSR word (:class:`~repro_torch.core.tile_state.TileState`) of one of
its block steps, without running anything.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import autotune
from repro_torch.core import formats as formats_lib
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.geometry import (BlockGeometry, HopperProfile, Policy,
                                       tile_state_for)
from repro_torch.core.tile_state import TileState

__all__ = ["GemmPlan", "plan_gemm", "mte_gemm", "BACKENDS"]

BACKENDS = ("kernels", "torch", "reference")
_DEFAULT_BACKEND = "torch"


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A granted execution plan for one GEMM (the dry ``tss`` handshake):
    the plan cache's grant (route, geometry, predicted seconds), the
    analytic base candidate's seconds
    (:func:`repro_torch.core.perfmodel.analytic_seconds`) and the CSR
    word of one block step."""

    m: int
    n: int
    k: int
    plan: autotune.ExecutionPlan
    analytic_s: float
    tile_state: TileState

    @property
    def geometry(self) -> BlockGeometry:
        return self.plan.geometry

    @property
    def route(self) -> str:
        return self.plan.route

    @property
    def engine(self) -> str:
        """The mainloop the grant launches (:func:`autotune.plan_engine`)."""
        return autotune.plan_engine(self.plan.signature, self.plan.geometry)

    @property
    def seconds(self) -> float:
        return self.plan.predicted_s


def default_out_dtype(fmt: formats_lib.FormatPolicy, dtype) -> torch.dtype:
    """The JAX package's output rule (``dispatch.py:143-147`` there): f32
    for quantized and narrowing formats (bf16 or int8 operands), else the
    input's dtype."""
    if fmt.quantized or fmt.operand_torch in (torch.bfloat16, torch.int8):
        return torch.float32
    return formats_lib.to_torch_dtype(dtype)


def plan_gemm(m: int, n: int, k: int, dtype_in=torch.float32,
              dtype_out=None, policy: Policy = "mte",
              profile: Optional[HopperProfile] = None, format_policy=None,
              *, epilogue: Optional[Epilogue] = None,
              group: int = 1) -> GemmPlan:
    """The grant for one GEMM, without execution: the signature
    (:meth:`~repro_torch.core.autotune.GemmSignature.for_format`)
    :func:`mte_gemm` (``group`` 1) or a grouped launch of ``group``
    members would plan (``format_policy`` None ⇒ inferred from
    ``dtype_in``; ``dtype_out`` None ⇒ the default output rule), granted
    by the process plan cache, or by a cache of its own on ``profile``
    when one is given.  The CSR word carries the format's SEW pair."""
    from repro_torch.core import perfmodel
    fmt = formats_lib.resolve_format(format_policy, dtype_in)
    out = dtype_out if dtype_out is not None else default_out_dtype(
        fmt, dtype_in)
    sig = autotune.GemmSignature.for_format(m, n, k, fmt, out, epilogue,
                                            policy, group)
    cache = (autotune.plan_cache() if profile is None
             else autotune.PlanCache(profile=profile))
    plan = cache.plan(sig)
    geom = dataclasses.replace(plan.geometry, sew_i=fmt.sew_i,
                               sew_o=fmt.sew_o)
    return GemmPlan(m=m, n=n, k=k, plan=plan,
                    analytic_s=perfmodel.analytic_seconds(
                        m, n, k, fmt=fmt.name, policy=policy, group=group,
                        profile=cache.profile),
                    tile_state=tile_state_for(geom, m, n, k))


def mte_gemm(a, b, c=None, bias=None, *,
             epilogue: Optional[Epilogue] = None,
             policy: Policy = "mte",
             backend: str = _DEFAULT_BACKEND,
             out_dtype=None,
             format_policy=None):
    """Compute ``epilogue(a @ b [, c, bias])`` on the chosen backend.

    a: (M, K); b: (K, N); optional c: (M, N) when ``epilogue.beta != 0``;
    optional bias: (N,) or (M,) per ``epilogue.bias_axis``.
    ``format_policy`` sets the operand/accumulator element widths:
    operands are cast (or int8-quantized with per-channel scales), the
    accumulator runs at the policy's ``SEW_o``, and the output is cast to
    ``out_dtype`` (default: :func:`default_out_dtype`).  The tensors'
    device decides where it runs: CUDA tensors on the card (the kernels
    backend launches the Hopper kernels or raises), CPU tensors on the
    CPU."""
    epilogue = epilogue or Epilogue()
    fmt = formats_lib.resolve_format(format_policy, a.dtype)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"GEMM contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if out_dtype is None:
        out_dtype = default_out_dtype(fmt, a.dtype)
    if backend == "kernels":
        from repro_torch.kernels import ops
        # ops.mte_gemm records into an active repro_torch.graph capture.
        return ops.mte_gemm(a, b, c=c, bias=bias, epilogue=epilogue,
                            policy=policy, out_dtype=out_dtype,
                            format_policy=fmt)
    if backend == "reference":
        from repro_torch.kernels import ref
        out = ref.mte_gemm(a, b, c=c, bias=bias, epilogue=epilogue,
                           out_dtype=out_dtype, format_policy=fmt)
    elif backend == "torch":
        acc = formats_lib.torch_gemm(a, b, fmt)
        out = epilogue.apply(acc.float() if fmt.quantized else acc,
                             c_in=c, bias=bias).to(out_dtype)
    else:
        raise ValueError(f"unknown backend {backend!r}; the port's are "
                         f"{BACKENDS} (the JAX package's 'pallas' is "
                         f"'kernels', its 'xla' 'torch')")
    from repro_torch.graph import trace as graph_trace
    sink = graph_trace.active()
    if sink is not None:
        sink.record_gemm(a, b, out, c=c, bias=bias, epilogue=epilogue,
                         fmt=fmt.name, policy=policy, out_dtype=out_dtype,
                         backend=backend)
    return out
