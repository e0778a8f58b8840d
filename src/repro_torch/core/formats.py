"""First-class data-format policy — the SEW field as a framework contract.

The port's copy of ``repro.core.formats``: the same :class:`FormatPolicy`
table (fp32, bf16, bf16acc, int8, int8pt), and bit-exact ``quantize`` /
``dequantize`` / ``quantize_operands`` (symmetric, scale = max|x|/127, a
zero scale becomes 1, round half to even).  ``xla_gemm`` and
``xla_grouped`` become :func:`torch_gemm` and :func:`torch_grouped`, the
plain-formulation GEMMs under a policy.

========  ==========  ===========  =======================================
name      operands    accumulator  notes
========  ==========  ===========  =======================================
fp32      float32     float32      the uniform-precision baseline
bf16      bfloat16    float32      widening (SEW_i < SEW_o)
bf16acc   bfloat16    bfloat16     narrow accumulator (E16)
int8      int8        int32        quantize → integer-dot → dequantize
int8pt    int8        int32        as int8, one per-tensor scale
========  ==========  ===========  =======================================
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.tile_state import SEW, dtype_name

__all__ = [
    "FormatPolicy", "FORMATS", "FP32", "BF16", "BF16_ACCUM", "INT8",
    "INT8_PT", "resolve_format", "infer_format", "quantize", "dequantize",
    "quantize_operands", "torch_gemm", "torch_grouped", "to_torch_dtype",
    "int_matmul", "library_product", "int_product",
]


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype_name(dtype))


@dataclasses.dataclass(frozen=True)
class FormatPolicy:
    """One named data format: operand/accumulator dtypes + SEW mapping."""

    name: str
    operand_dtype: str
    accum_dtype: str
    quantized: bool = False
    per_channel: bool = True

    @property
    def operand_torch(self) -> torch.dtype:
        return to_torch_dtype(self.operand_dtype)

    @property
    def accum_torch(self) -> torch.dtype:
        return to_torch_dtype(self.accum_dtype)

    @property
    def sew_i(self) -> SEW:
        return SEW.from_dtype(self.operand_dtype)

    @property
    def sew_o(self) -> SEW:
        return SEW.from_dtype(self.accum_dtype)

    def describe(self) -> str:
        tail = " quantized" if self.quantized else ""
        return (f"{self.name}[{self.operand_dtype}->{self.accum_dtype} "
                f"SEW {self.sew_i.name}->{self.sew_o.name}{tail}]")


FP32 = FormatPolicy("fp32", "float32", "float32")
BF16 = FormatPolicy("bf16", "bfloat16", "float32")
BF16_ACCUM = FormatPolicy("bf16acc", "bfloat16", "bfloat16")
INT8 = FormatPolicy("int8", "int8", "int32", quantized=True)
INT8_PT = FormatPolicy("int8pt", "int8", "int32", quantized=True,
                       per_channel=False)

FORMATS: Dict[str, FormatPolicy] = {
    p.name: p for p in (FP32, BF16, BF16_ACCUM, INT8, INT8_PT)
}


def infer_format(dtype) -> FormatPolicy:
    """The policy an un-annotated operand dtype implies."""
    dt = to_torch_dtype(dtype)
    if not dt.is_floating_point:
        return INT8
    if dt == torch.bfloat16:
        return BF16
    return FP32


def resolve_format(fmt: Union[None, str, FormatPolicy],
                   dtype=None) -> FormatPolicy:
    """Resolve a policy from a name, an instance, or (None) a dtype."""
    if fmt is None:
        return infer_format(dtype if dtype is not None else torch.float32)
    if isinstance(fmt, FormatPolicy):
        return fmt
    name = str(fmt)
    if name not in FORMATS:
        raise ValueError(f"unknown format policy {name!r}; "
                         f"known: {sorted(FORMATS)}")
    return FORMATS[name]


def quantize(x: torch.Tensor, *, contract_axis: int,
             per_channel: bool = True
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Symmetric int8 quantization with keepdims scales over
    ``contract_axis``.  Integer inputs pass through unscaled."""
    if not x.dtype.is_floating_point:
        return x, None
    xf = x.float()
    if per_channel:
        amax = xf.abs().amax(dim=contract_axis, keepdim=True)
    else:
        amax = xf.abs().amax().reshape((1,) * x.ndim)
    # A true division on every device: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which rounds some scales differently.
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(acc: torch.Tensor, scale_a: Optional[torch.Tensor],
               scale_b: Optional[torch.Tensor]) -> torch.Tensor:
    """Map an integer accumulator back to f32: ``acc · s_a · s_b``."""
    if scale_a is None and scale_b is None:
        return acc
    out = acc.float()
    if scale_a is not None:
        out = out * scale_a
    if scale_b is not None:
        out = out * scale_b
    return out


def quantize_operands(a, b, fmt: FormatPolicy = INT8):
    """Quantize a GEMM pair: A per-row (…, M, 1), B per-column (…, 1, N)."""
    aq, sa = quantize(a, contract_axis=a.ndim - 1,
                      per_channel=fmt.per_channel)
    bq, sb = quantize(b, contract_axis=b.ndim - 2,
                      per_channel=fmt.per_channel)
    return aq, bq, sa, sb


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer ``a @ b`` → int32 on any device: the plain version
    the int8 kernels are held to.  Products of int8 operands summed over
    K stay far below 2^53, so float64 is exact at every shape (CUDA's one
    integer product, ``torch._int_mm``, takes only M > 16 and K and N
    multiples of 8; ``chip_smoke.py`` times it as the int8 kernels'
    yardstick)."""
    return torch.matmul(a.double(), b.double()).round().to(torch.int32)


class _LibraryProduct(torch.autograd.Function):
    """The card's product of two same-dtype float operands into a wider
    accumulator, ``torch.mm``/``torch.bmm(..., out_dtype=)`` (cuBLAS on
    the operands as they are, JAX's ``preferred_element_type``), which
    has no derivative of its own.  The backward is JAX's transpose of
    ``dot_general``: each cotangent product in the accumulator's dtype on
    the other operand widened to it, cast to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b, acc_dtype):
        ctx.save_for_backward(a, b)
        mm = torch.bmm if a.ndim == 3 else torch.mm
        return mm(a, b, out_dtype=acc_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.to(g.dtype).transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.matmul(a.to(g.dtype).transpose(-1, -2), g).to(b.dtype)
        return da, db, None


def library_product(a: torch.Tensor, b: torch.Tensor,
                    acc_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` (2-D, or batched (G, C, K) @ (G, K, N)) by the library,
    on float operands of one dtype, at ``acc_dtype``: on the card cuBLAS
    on the operands as they are (into a wider accumulator through
    :class:`_LibraryProduct`), on the CPU, which has no bf16 product into
    f32, the f32 product of the widened operands.  Differentiable."""
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float()).to(acc_dtype)
    if a.dtype == acc_dtype:
        return torch.matmul(a, b)
    return _LibraryProduct.apply(a, b, acc_dtype)


def int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 ``a @ b`` → int32, 2-D: ``torch._int_mm`` on the card
    where it takes the shape (K and N multiples of 8; M ≤ 16 padded with
    zero rows to 32, as it takes M > 16 only), :func:`int_matmul`
    elsewhere."""
    m, k = a.shape
    if not a.is_cuda or k % 8 or b.shape[1] % 8:
        return int_matmul(a, b)
    if m > 16:
        return torch._int_mm(a, b)
    pad = a.new_zeros(32, k)
    pad[:m] = a
    return torch._int_mm(pad, b)[:m]


def _record_plain(kind: str, x, w, fmt: FormatPolicy) -> None:
    """One ``unplanned`` record of a plain product for the active per-GEMM
    accountant (repro_torch.telemetry), unless a seam that records itself
    suppressed it."""
    from repro_torch.telemetry import gemm_account
    acct = gemm_account.active_unsuppressed()
    if acct is None:
        return
    if kind == "gemm":
        acct.record_gemm(x.shape[0], w.shape[1], x.shape[1], fmt=fmt.name,
                         policy="torch", backend="torch")
    else:
        acct.record_grouped(w.shape[-3], x.shape[-2], w.shape[-1],
                            x.shape[-1], fmt=fmt.name, policy="torch",
                            backend="torch")


def torch_gemm(a: torch.Tensor, b: torch.Tensor, fmt: FormatPolicy):
    """2-D ``a @ b`` under the policy, the library's product
    (:func:`library_product`, :func:`int_product`).  Returns the
    accumulator — f32 for the dequantized int8 route, the policy's
    accumulator dtype otherwise."""
    _record_plain("gemm", a, b, fmt)
    if fmt.quantized:
        aq, bq, sa, sb = quantize_operands(a, b, fmt)
        return dequantize(int_product(aq, bq), sa, sb)
    return library_product(a.to(fmt.operand_torch), b.to(fmt.operand_torch),
                           fmt.accum_torch)


def torch_grouped(x: torch.Tensor, w: torch.Tensor, fmt: FormatPolicy):
    """Grouped ``(G,C,K) @ (G,K,N)`` under the policy, the library's
    batched product (per-group per-channel scales for int8)."""
    _record_plain("grouped", x, w, fmt)
    if fmt.quantized:
        xq, wq, sx, sw = quantize_operands(x, w, fmt)
        return dequantize(int_matmul(xq, wq), sx, sw)
    return library_product(x.to(fmt.operand_torch), w.to(fmt.operand_torch),
                           fmt.accum_torch)
