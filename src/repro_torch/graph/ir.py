"""Typed IR for GEMM programs — the unit the graph subsystem rewrites (the
port of ``repro/graph/ir.py``; the IR is pure Python, only
:func:`stack_group_weights` touches tensors).

A :class:`Graph` is a small SSA program over abstract tensor *values*
(:class:`ValueInfo`: shape + dtype, identified by integer ids).  Four node
kinds cover everything a layer pipeline issues through the MTE dispatch
surface:

- :class:`GemmNode` — one ``epilogue(a @ b [, c, bias])`` dispatch under a
  named :class:`~repro_torch.core.formats.FormatPolicy`; the in-kernel epilogue
  is the paper's vector-mode post-processing (§III-C4).
- :class:`EpilogueNode` — element-wise glue *between* dispatches: a raw
  ``mul``/``add`` or a full :class:`~repro_torch.core.epilogue.Epilogue` spec
  applied as a separate pass.  The epilogue-absorption rewrite
  (:mod:`repro_torch.graph.fuse`) folds these into the producing GemmNode so
  bias/activation/residual ride the accumulator registers instead of a
  memory round-trip.
- :class:`CastNode` — a format-boundary materialization: the value is
  re-expressed in the target policy's operand grid (a dtype cast for the
  float policies, a fake-quantization for the int8 policies).  Redundant
  boundary pairs — a producer's dequantize feeding a consumer's quantize
  under the *same* policy — are eliminated by the cast rewrite, which is
  exact: re-quantizing a value already on the policy's grid reproduces the
  same integers.
- :class:`GroupNode` — G sibling GEMMs sharing one left operand executed
  as ONE grouped kernel launch (the q/k/v projections, a gated MLP's
  gate+up, MoE experts).  Member weights are zero-padded to a common
  width and stacked (``stack_group_weights``); per-member epilogues apply
  post-kernel at accumulator precision, so grouping is a layout change,
  not a numerics change.

Values are append-only and nodes reference earlier values only, so the
node list is always topologically ordered; rewrites substitute value ids
and drop dead nodes without renumbering.  ``Graph.signature()`` is the
stable program hash compiled programs are memoized under
(:mod:`repro_torch.graph.schedule`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.epilogue import Epilogue

__all__ = [
    "ValueInfo", "GemmNode", "EpilogueNode", "CastNode", "GroupNode",
    "Node", "Graph", "stack_group_weights",
]


@dataclasses.dataclass(frozen=True)
class ValueInfo:
    """One abstract tensor: static shape + dtype name (+ debug name)."""

    shape: Tuple[int, ...]
    dtype: str
    name: str = ""

    def describe(self) -> str:
        dims = "x".join(str(d) for d in self.shape)
        tag = f" {self.name}" if self.name else ""
        return f"({dims}:{self.dtype}{tag})"


@dataclasses.dataclass(frozen=True)
class GemmNode:
    """One GEMM dispatch: ``epilogue(a @ b [, c, bias])`` under ``fmt``."""

    a: int
    b: int
    out: int
    epilogue: Epilogue = Epilogue()
    c: Optional[int] = None
    bias: Optional[int] = None
    fmt: str = "fp32"
    out_dtype: str = "float32"
    policy: str = "mte"

    def inputs(self) -> Tuple[int, ...]:
        ins = [self.a, self.b]
        if self.c is not None:
            ins.append(self.c)
        if self.bias is not None:
            ins.append(self.bias)
        return tuple(ins)

    def outs(self) -> Tuple[int, ...]:
        return (self.out,)


@dataclasses.dataclass(frozen=True)
class EpilogueNode:
    """Element-wise op between dispatches.

    ``op``: ``"mul"`` / ``"add"`` (binary, args = (x, y)) or
    ``"epilogue"`` (args = (x[, c][, bias]) per ``spec.needs_c_input`` /
    ``spec.has_bias``, applied via ``spec.apply``).
    """

    op: str
    args: Tuple[int, ...]
    out: int
    spec: Optional[Epilogue] = None
    out_dtype: str = "float32"

    def inputs(self) -> Tuple[int, ...]:
        return self.args

    def outs(self) -> Tuple[int, ...]:
        return (self.out,)


@dataclasses.dataclass(frozen=True)
class CastNode:
    """Materialize a value on ``fmt``'s operand grid (cast / fake-quant)."""

    x: int
    out: int
    fmt: str = "fp32"

    def inputs(self) -> Tuple[int, ...]:
        return (self.x,)

    def outs(self) -> Tuple[int, ...]:
        return (self.out,)


@dataclasses.dataclass(frozen=True)
class GroupNode:
    """G sibling GEMMs over one shared left operand as ONE grouped launch.

    Either ``weights`` (per-member (K, N_i) operands, stacked at run time)
    or ``stacked`` (a precomputed (G, K, Nmax) operand — the serving
    engine's hot decode path) supplies the right-hand side; ``widths``
    records each member's true output width so padded columns are sliced
    off.  ``epilogues``/``biases`` apply per member *post-kernel* at
    accumulator precision (the grouped kernel itself runs the identity
    epilogue so every member shares one plan-cache signature).
    """

    a: int
    widths: Tuple[int, ...]
    outputs: Tuple[int, ...]
    weights: Tuple[int, ...] = ()
    stacked: Optional[int] = None
    biases: Tuple[Optional[int], ...] = ()
    epilogues: Tuple[Epilogue, ...] = ()
    fmt: str = "fp32"
    out_dtype: str = "float32"
    policy: str = "mte"

    def __post_init__(self):
        if (self.stacked is None) == (not self.weights):
            raise ValueError("GroupNode needs weights xor stacked")
        g = len(self.widths)
        if len(self.outputs) != g:
            raise ValueError("widths/outputs length mismatch")
        if self.epilogues and len(self.epilogues) != g:
            raise ValueError("epilogues length != group size")
        if self.biases:
            if len(self.biases) != g:
                raise ValueError("biases length != group size")
            for i, b in enumerate(self.biases):
                epi = self.epilogues[i] if self.epilogues else Epilogue()
                if (b is not None) != epi.has_bias:
                    # A bias without a has_bias epilogue (or vice versa)
                    # would be silently dropped at execution.
                    raise ValueError(f"member {i}: bias operand and "
                                     f"epilogue.has_bias disagree")

    @property
    def group(self) -> int:
        return len(self.widths)

    def inputs(self) -> Tuple[int, ...]:
        ins = [self.a]
        ins.extend(self.weights)
        if self.stacked is not None:
            ins.append(self.stacked)
        ins.extend(b for b in self.biases if b is not None)
        return tuple(ins)

    def outs(self) -> Tuple[int, ...]:
        return self.outputs


Node = Union[GemmNode, EpilogueNode, CastNode, GroupNode]
KERNEL_NODES = (GemmNode, GroupNode)


@dataclasses.dataclass
class Graph:
    """An SSA GEMM program: append-only values, topologically-ordered nodes."""

    values: List[ValueInfo]
    nodes: List[Node]
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]

    # -- queries --------------------------------------------------------------
    def producer_of(self) -> Dict[int, int]:
        """value id → producing node index (inputs absent)."""
        return {v: i for i, n in enumerate(self.nodes) for v in n.outs()}

    def consumers_of(self) -> Dict[int, List[int]]:
        """value id → node indices consuming it."""
        cons: Dict[int, List[int]] = {}
        for i, n in enumerate(self.nodes):
            for v in n.inputs():
                cons.setdefault(v, []).append(i)
        return cons

    def kernel_nodes(self) -> List[int]:
        """Indices of nodes that launch a GEMM kernel (dispatch count)."""
        return [i for i, n in enumerate(self.nodes)
                if isinstance(n, KERNEL_NODES)]

    @property
    def n_dispatches(self) -> int:
        return len(self.kernel_nodes())

    def shape(self, v: int) -> Tuple[int, ...]:
        return self.values[v].shape

    # -- rewriting helpers ----------------------------------------------------
    def substituted(self, nodes: List[Node], subst: Dict[int, int]
                    ) -> "Graph":
        """Rebuild with ``subst`` applied to node inputs and graph outputs,
        then drop nodes whose outputs are no longer referenced."""

        def s(v):
            while v in subst:
                v = subst[v]
            return v

        def remap(n: Node) -> Node:
            if isinstance(n, GemmNode):
                return dataclasses.replace(
                    n, a=s(n.a), b=s(n.b),
                    c=None if n.c is None else s(n.c),
                    bias=None if n.bias is None else s(n.bias))
            if isinstance(n, EpilogueNode):
                return dataclasses.replace(
                    n, args=tuple(s(a) for a in n.args))
            if isinstance(n, CastNode):
                return dataclasses.replace(n, x=s(n.x))
            return dataclasses.replace(
                n, a=s(n.a), weights=tuple(s(w) for w in n.weights),
                stacked=None if n.stacked is None else s(n.stacked),
                biases=tuple(None if b is None else s(b)
                             for b in n.biases))

        nodes = [remap(n) for n in nodes]
        outputs = tuple(s(v) for v in self.outputs)
        # Dead-node elimination (iterate: dropping one may orphan another).
        while True:
            live = set(outputs)
            for n in nodes:
                live.update(n.inputs())
            kept = [n for n in nodes
                    if any(o in live for o in n.outs())]
            if len(kept) == len(nodes):
                break
            nodes = kept
        return Graph(values=list(self.values), nodes=nodes,
                     inputs=self.inputs, outputs=outputs)

    # -- identity -------------------------------------------------------------
    def signature(self) -> str:
        """Stable program hash: node structure + value shapes/dtypes.

        Two calls that build the same program (same shapes, formats,
        epilogues, wiring) share one signature — the memoization key for
        compiled programs (:mod:`repro_torch.graph.schedule`).  Debug names are
        excluded.
        """
        parts: List[str] = [
            "in:" + ",".join(f"{v}={self.values[v].shape}"
                             f":{self.values[v].dtype}"
                             for v in self.inputs),
            "out:" + ",".join(map(str, self.outputs)),
        ]
        for n in self.nodes:
            d = dataclasses.asdict(n)
            parts.append(type(n).__name__ + ":" + repr(sorted(d.items())))
        h = hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]
        return f"g{h}"

    def describe(self) -> str:
        lines = [f"graph[{self.signature()}] "
                 f"inputs={[self.values[v].describe() for v in self.inputs]}"]
        for i, n in enumerate(self.nodes):
            if isinstance(n, GemmNode):
                m, k = self.shape(n.a)
                nn = self.shape(n.b)[1]
                epi = "" if n.epilogue.is_identity else " +epi"
                lines.append(f"  %{n.out} = gemm[{m}x{nn}x{k} {n.fmt}{epi}]"
                             f"(%{n.a}, %{n.b})")
            elif isinstance(n, GroupNode):
                m, k = self.shape(n.a)
                lines.append(
                    f"  {tuple('%%%d' % o for o in n.outputs)} = "
                    f"group[G={n.group} {m}x{max(n.widths)}x{k} {n.fmt}]"
                    f"(%{n.a})")
            elif isinstance(n, CastNode):
                lines.append(f"  %{n.out} = cast[{n.fmt}](%{n.x})")
            else:
                lines.append(f"  %{n.out} = {n.op}"
                             f"({', '.join('%%%d' % a for a in n.args)})")
        lines.append(f"  return {[f'%{v}' for v in self.outputs]}"
                     f"  ({self.n_dispatches} dispatches)")
        return "\n".join(lines)


def stack_group_weights(ws):
    """Stack G projection weights (…, K, N_i) into the grouped-GEMM
    layout (…, G, K, Nmax), zero-padding narrower outputs.  Leading axes
    pass through.  This is the ONE stacking implementation — the serving
    engine's precomputed decode ``qkv`` leaf and GroupNode execution both
    use it."""
    import torch
    import torch.nn.functional as F

    nmax = max(w.shape[-1] for w in ws)
    return torch.stack([F.pad(w, (0, nmax - w.shape[-1])) for w in ws],
                       dim=-3)
