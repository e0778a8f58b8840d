"""Direct convolution lowered onto MTE GEMMs (paper §V-B1).

The port of ``repro.core.conv``.  The convolution is reduced to matrix
tile multiplications with *minibatch·spatial → M*, *output channels → N*,
*input channels → K*, and, as in the JAX package, the KH·KW offset
windows are stacked into one **grouped** operand pair — x-windows
(KH·KW, N·OH·OW, IC) against weight slices (KH·KW, IC, OC) — so the whole
convolution is a *single* B3 launch (``ops.grouped_gemm``) whose group
axis is the kernel offset; the partial products are then summed over the
group axis and the α/β/bias/activation epilogue applied once (§III-C4).
One launch means one plan: the plan cache grants the grouped schedule
once per (shape, format).  The stack costs KH·KW copies of the (strided)
input, the price of one launch.

``backend`` maps as in :mod:`repro_torch.core.dispatch`: ``"kernels"``
(B3 through the plan cache; CPU tensors run its plain version),
``"torch"`` (one batched product under the format,
:func:`repro_torch.core.formats.torch_grouped`; the JAX package's
``"xla"`` and default) and ``"reference"`` (:mod:`repro_torch.kernels.
ref`).  ``format_policy`` selects the data format as in ``mte_gemm``;
int8 quantizes per offset group (x per row, w per column of each
member).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.epilogue import Epilogue

__all__ = ["ConvSpec", "conv2d_direct", "conv_gemm_dims", "stack_windows"]


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One convolution workload (a row of the paper's 75-layer suite)."""

    name: str
    n: int          # minibatch
    h: int
    w: int
    ic: int
    oc: int
    kh: int
    kw: int
    stride: int = 1
    pad: int = 0

    @property
    def oh(self) -> int:
        return (self.h + 2 * self.pad - self.kh) // self.stride + 1

    @property
    def ow(self) -> int:
        return (self.w + 2 * self.pad - self.kw) // self.stride + 1

    @property
    def flops(self) -> int:
        return 2 * self.n * self.oh * self.ow * self.oc * self.ic * self.kh * self.kw


def conv_gemm_dims(spec: ConvSpec) -> Tuple[int, int, int]:
    """GEMM (M, N, K) for the direct algorithm: one GEMM per (kh, kw) offset.

    M = minibatch × output spatial, N = OC, K = IC (paper §V-B1: "we map the
    minibatch, output feature map, and input feature map dimensions to the
    M, N, and K GEMM matrix dimensions").
    """
    return (spec.n * spec.oh * spec.ow, spec.oc, spec.ic)


def stack_windows(x: torch.Tensor, kh: int, kw: int, stride: int,
                  pad: int) -> torch.Tensor:
    """The KH·KW strided windows of NHWC ``x`` stacked on a leading group
    axis, (KH·KW, N·OH·OW, IC), window (i, j) at member i·KW + j (the JAX
    package's order): one strided view of the padded input, copied once."""
    n, h, wid, ic = x.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    x = x.contiguous()
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (wid + 2 * pad - kw) // stride + 1
    s_n, s_h, s_w, s_c = x.stride()
    view = x.as_strided((kh, kw, n, oh, ow, ic),
                        (s_h, s_w, s_n, stride * s_h, stride * s_w, s_c))
    return view.reshape(kh * kw, n * oh * ow, ic)


def conv2d_direct(x, w, bias=None, *, stride: int = 1, pad: int = 0,
                  epilogue: Optional[Epilogue] = None,
                  backend: str = "torch", policy: str = "mte",
                  format_policy=None):
    """NHWC direct convolution via one grouped MTE GEMM launch.

    x: (N, H, W, IC); w: (KH, KW, IC, OC).  Returns (N, OH, OW, OC) f32.
    The KH·KW offset windows form the group axis of a single
    ``grouped_gemm`` — one plan-cache entry per (shape, format) for the
    whole convolution — whose f32 partials are summed over the group axis
    before the epilogue (with ``bias``) is applied once.  ``policy`` is
    accepted as the JAX package accepts it; the grouped route has the one
    (MTE) policy.  A non-quantized format casts x to its operand type
    before the windows are stacked (the same values as casting the stack,
    at the operand type's bytes)."""
    from repro_torch.core import formats as formats_lib
    epilogue = epilogue or Epilogue()
    fmt = formats_lib.resolve_format(format_policy, x.dtype)
    n, h, wid, ic = x.shape
    kh, kw, ic2, oc = w.shape
    if ic != ic2:
        raise ValueError(f"channel mismatch {ic} vs {ic2}")
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (wid + 2 * pad - kw) // stride + 1
    if not fmt.quantized:
        x, w = x.to(fmt.operand_torch), w.to(fmt.operand_torch)
    xg = stack_windows(x, kh, kw, stride, pad)     # (KH·KW, M, IC)
    wg = w.reshape(kh * kw, ic, oc)                # (KH·KW, IC, OC)

    if backend == "kernels":
        from repro_torch.kernels import ops
        parts = ops.grouped_gemm(xg, wg, out_dtype=torch.float32,
                                 format_policy=fmt)
    elif backend == "reference":
        from repro_torch.kernels import ref
        parts = ref.grouped_gemm(xg, wg, out_dtype=torch.float32,
                                 format_policy=fmt)
    elif backend == "torch":
        parts = formats_lib.torch_grouped(xg, wg, fmt).float()
    else:
        raise ValueError(f"unknown backend {backend!r}; the port's are "
                         f"'kernels', 'torch' and 'reference' (the JAX "
                         f"package's 'pallas' is 'kernels', its 'xla' "
                         f"'torch')")
    acc = parts.sum(dim=0)                         # reduce over offsets
    out = epilogue.apply(acc, bias=bias)
    return out.reshape(n, oh, ow, oc)
