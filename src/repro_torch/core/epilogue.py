"""GEMM epilogues — the paper's "vector processing mode" (§III-C4).

The same :class:`Epilogue` spec drives the CUDA kernels' fused epilogue
(``csrc/gemm_tile.cuh``) and this plain PyTorch application, which the
plain versions, the split-K reduction and the quantized dequantize path
use.  The order is the JAX package's: α·acc, then +β·C, then +bias, then
softcap, then the activation.  gelu is the tanh approximation.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["Epilogue", "ACTIVATIONS", "ACTIVATION_CODES"]


ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}
# The integer each activation is passed to the CUDA kernels as.
ACTIVATION_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """BLAS-style epilogue: ``act(alpha * acc + beta * C_in + bias)``.

    ``bias_axis`` ``"row"`` broadcasts a (N,) bias over rows, ``"col"`` a
    (M,) bias over columns.  ``softcap`` applies tanh soft capping before
    the activation."""

    alpha: float = 1.0
    beta: float = 0.0
    has_bias: bool = False
    bias_axis: str = "row"
    activation: str = "none"
    softcap: Optional[float] = None

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.bias_axis not in ("row", "col"):
            raise ValueError("bias_axis must be 'row' or 'col'")

    @property
    def is_identity(self) -> bool:
        return (self.alpha == 1.0 and self.beta == 0.0 and not self.has_bias
                and self.activation == "none" and self.softcap is None)

    @property
    def needs_c_input(self) -> bool:
        return self.beta != 0.0

    def apply(self, acc: torch.Tensor, c_in=None, bias=None) -> torch.Tensor:
        """Plain application in the accumulator dtype.  Scalars enter as
        Python numbers already rounded to that dtype (JAX multiplies by
        ``jnp.asarray(alpha, acc.dtype)``), so no host-to-device copy is
        made per call; α = 1 is skipped (exact)."""
        dt = acc.dtype
        out = acc
        if self.alpha != 1.0:
            out = out * _scalar(self.alpha, dt)
        if self.beta != 0.0:
            if c_in is None:
                raise ValueError("beta != 0 requires c_in")
            out = out + _scalar(self.beta, dt) * c_in.to(dt)
        if self.has_bias:
            if bias is None:
                raise ValueError("has_bias requires bias operand")
            b = bias.to(dt)
            out = out + (b[None, :] if self.bias_axis == "row"
                         else b[:, None])
        if self.softcap is not None:
            cap = _scalar(self.softcap, dt)
            out = cap * torch.tanh(out / cap)
        return ACTIVATIONS[self.activation](out)


@functools.lru_cache(maxsize=None)
def _scalar(x: float, dtype: torch.dtype):
    """``x`` as a Python number of ``dtype``'s value set."""
    if not dtype.is_floating_point:
        return int(x)
    return float(torch.tensor(x, dtype=dtype))
