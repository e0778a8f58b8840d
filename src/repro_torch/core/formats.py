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
    "int_matmul",
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
        scale = xf.abs().amax(dim=contract_axis, keepdim=True) / 127.0
    else:
        scale = xf.abs().amax().reshape((1,) * x.ndim) / 127.0
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
    """Exact integer ``a @ b`` → int32 on any device.  Products of int8
    operands summed over K stay far below 2^53, so float64 is exact; CUDA
    has no integer matmul."""
    return torch.matmul(a.double(), b.double()).round().to(torch.int32)


def torch_gemm(a: torch.Tensor, b: torch.Tensor, fmt: FormatPolicy):
    """2-D ``a @ b`` under the policy, in plain torch.  Returns the
    accumulator — f32 for the dequantized int8 route, the policy's
    accumulator dtype otherwise."""
    if fmt.quantized:
        aq, bq, sa, sb = quantize_operands(a, b, fmt)
        return dequantize(int_matmul(aq, bq), sa, sb)
    ac = a.to(fmt.operand_torch).float()
    bc = b.to(fmt.operand_torch).float()
    return torch.matmul(ac, bc).to(fmt.accum_torch)


def torch_grouped(x: torch.Tensor, w: torch.Tensor, fmt: FormatPolicy):
    """Grouped ``(G,C,K) @ (G,K,N)`` under the policy, in plain torch
    (per-group per-channel scales for int8)."""
    if fmt.quantized:
        xq, wq, sx, sw = quantize_operands(x, w, fmt)
        return dequantize(int_matmul(xq, wq), sx, sw)
    xc = x.to(fmt.operand_torch).float()
    wc = w.to(fmt.operand_torch).float()
    return torch.matmul(xc, wc).to(fmt.accum_torch)
