"""Program capture: an explicit builder API + a dispatch-hooked tracer (the
port of ``repro/graph/trace.py``).

Two ways to obtain a :class:`~repro_torch.graph.ir.Graph`:

- :class:`GraphBuilder` — explicit construction.  This is the
  full-fidelity path the model layers use (``models/layers.py`` /
  ``models/attention.py``): every GEMM, element-wise glue op and format
  boundary is stated, so the fuser sees the complete program.
- :func:`trace_gemms` — a context manager that hooks the MTE dispatch
  surface (``kernels.ops.mte_gemm`` / ``grouped_gemm``): every GEMM a
  model layer issues while the capture is active is recorded as a node,
  with operand identity tracked by tensor object so shared inputs (q/k/v
  sharing x) and producer→consumer chains reconstruct the wiring.
  Execution proceeds normally — tracing is observation, not abstraction —
  which makes it the tool for *auditing* eager dispatch behaviour
  (``capture.n_dispatches``, ``capture.graph()``) and for re-scheduling
  pure GEMM pipelines.
  Element-wise torch glue between dispatches is invisible to the hook, so
  a traced graph replays faithfully only when every node input is a graph
  input or another node's output (``capture.is_complete()``); the
  builder API covers the general case.

:func:`merge_graphs` concatenates independent programs into one: the
serving engine's speculative step presents the draft's decode projection,
the target's verify projection and the verify unembedding to the
scheduler as one program.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.tile_state import dtype_name as _dtype_name
from repro_torch.graph.ir import (CastNode, EpilogueNode, GemmNode, Graph,
                                  GroupNode, ValueInfo)

__all__ = ["GraphBuilder", "GemmCapture", "trace_gemms", "active",
           "merge_graphs"]


class GraphBuilder:
    """Imperative construction of a :class:`Graph`.

    Methods return integer value ids; ``build()`` freezes the program.
    Inputs are registered in call order — execution binds positional
    arguments in the same order.
    """

    def __init__(self):
        self._values: List[ValueInfo] = []
        self._nodes: list = []
        self._inputs: List[int] = []
        self._outputs: List[int] = []

    # -- values ---------------------------------------------------------------
    def _value(self, shape, dtype, name="") -> int:
        self._values.append(ValueInfo(tuple(int(d) for d in shape),
                                      _dtype_name(dtype), name))
        return len(self._values) - 1

    def input(self, shape, dtype, name: str = "") -> int:
        v = self._value(shape, dtype, name)
        self._inputs.append(v)
        return v

    def shape(self, v: int) -> Tuple[int, ...]:
        return self._values[v].shape

    # -- nodes ----------------------------------------------------------------
    def gemm(self, a: int, b: int, *, c: Optional[int] = None,
             bias: Optional[int] = None,
             epilogue: Optional[Epilogue] = None, fmt: str = "fp32",
             out_dtype="float32", policy: str = "mte",
             name: str = "") -> int:
        m, k = self.shape(a)
        k2, n = self.shape(b)
        if k != k2:
            raise ValueError(f"gemm contraction mismatch: "
                             f"{self.shape(a)} @ {self.shape(b)}")
        out = self._value((m, n), out_dtype, name)
        self._nodes.append(GemmNode(
            a=a, b=b, out=out, epilogue=epilogue or Epilogue(), c=c,
            bias=bias, fmt=str(fmt), out_dtype=_dtype_name(out_dtype),
            policy=policy))
        return out

    def group(self, a: int, *, weights: Sequence[int] = (),
              stacked: Optional[int] = None,
              widths: Optional[Sequence[int]] = None,
              biases: Optional[Sequence[Optional[int]]] = None,
              epilogues: Optional[Sequence[Epilogue]] = None,
              fmt: str = "fp32", out_dtype="float32",
              policy: str = "mte") -> Tuple[int, ...]:
        """Explicitly-grouped sibling GEMMs (one grouped launch)."""
        m, _ = self.shape(a)
        if widths is None:
            widths = [self.shape(w)[1] for w in weights]
        g = len(widths)
        biases = tuple(biases) if biases is not None else (None,) * g
        # Default epilogues carry the bias when one is supplied — a bias
        # operand without a has_bias epilogue is rejected by GroupNode.
        epilogues = (tuple(epilogues) if epilogues is not None
                     else tuple(Epilogue(has_bias=b is not None)
                                for b in biases))
        outs = tuple(self._value((m, int(w)), out_dtype) for w in widths)
        self._nodes.append(GroupNode(
            a=a, widths=tuple(int(w) for w in widths), outputs=outs,
            weights=tuple(weights), stacked=stacked, biases=biases,
            epilogues=epilogues, fmt=str(fmt),
            out_dtype=_dtype_name(out_dtype), policy=policy))
        return outs

    def cast(self, x: int, fmt: str) -> int:
        from repro_torch.core.formats import resolve_format
        fp = resolve_format(fmt)
        dt = "float32" if fp.quantized else fp.operand_dtype
        out = self._value(self.shape(x), dt)
        self._nodes.append(CastNode(x=x, out=out, fmt=fp.name))
        return out

    def _binary(self, op: str, x: int, y: int) -> int:
        sx, sy = self.shape(x), self.shape(y)
        shape = sx if len(sx) >= len(sy) else sy
        out = self._value(shape, self._values[x].dtype)
        self._nodes.append(EpilogueNode(op=op, args=(x, y), out=out,
                                        out_dtype=self._values[x].dtype))
        return out

    def mul(self, x: int, y: int) -> int:
        return self._binary("mul", x, y)

    def add(self, x: int, y: int) -> int:
        return self._binary("add", x, y)

    def epilogue(self, x: int, spec: Epilogue, *, c: Optional[int] = None,
                 bias: Optional[int] = None, out_dtype=None) -> int:
        args = [x]
        if spec.needs_c_input:
            if c is None:
                raise ValueError("epilogue with beta != 0 needs c")
            args.append(c)
        if spec.has_bias:
            if bias is None:
                raise ValueError("epilogue with has_bias needs bias")
            args.append(bias)
        dt = out_dtype if out_dtype is not None else self._values[x].dtype
        out = self._value(self.shape(x), dt)
        self._nodes.append(EpilogueNode(op="epilogue", args=tuple(args),
                                        out=out, spec=spec,
                                        out_dtype=_dtype_name(dt)))
        return out

    # -- finalize -------------------------------------------------------------
    def output(self, *vals: int) -> None:
        self._outputs.extend(vals)

    def build(self) -> Graph:
        if not self._outputs:
            raise ValueError("graph has no outputs")
        return Graph(values=list(self._values), nodes=list(self._nodes),
                     inputs=tuple(self._inputs),
                     outputs=tuple(self._outputs))


# ---------------------------------------------------------------------------
# Dispatch-hooked tracing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Record:
    """One observed dispatch (for audit listings)."""

    kind: str          # "gemm" | "grouped"
    m: int
    n: int
    k: int
    fmt: str
    policy: str
    backend: str
    group: int = 1


class GemmCapture:
    """Sink for GEMM dispatches observed while :func:`trace_gemms` is
    active.  Operand identity (``id(tensor)``) reconstructs the wiring:
    a tensor seen first as an operand becomes a graph input; a tensor
    produced by a recorded dispatch links producer → consumer."""

    def __init__(self):
        self._builder = GraphBuilder()
        self._by_id: Dict[int, int] = {}
        self._keepalive: List[Any] = []   # pin ids for the capture's life
        self.records: List[_Record] = []

    @property
    def n_dispatches(self) -> int:
        return len(self.records)

    def _val_of(self, arr, name: str = "") -> int:
        vid = self._by_id.get(id(arr))
        if vid is None:
            vid = self._builder.input(arr.shape, arr.dtype, name)
            self._by_id[id(arr)] = vid
            self._keepalive.append(arr)
        return vid

    def _bind(self, arr, vid: int) -> None:
        self._by_id[id(arr)] = vid
        self._keepalive.append(arr)

    def record_gemm(self, a, b, out, *, c=None, bias=None,
                    epilogue: Epilogue, fmt: str, policy: str,
                    out_dtype, backend: str) -> None:
        va = self._val_of(a, "a")
        vb = self._val_of(b, "b")
        vc = self._val_of(c, "c") if c is not None else None
        vbias = self._val_of(bias, "bias") if bias is not None else None
        vo = self._builder.gemm(va, vb, c=vc, bias=vbias, epilogue=epilogue,
                                fmt=fmt, out_dtype=out_dtype, policy=policy)
        self._bind(out, vo)
        m, k = a.shape
        self.records.append(_Record("gemm", int(m), int(b.shape[1]), int(k),
                                    fmt, policy, backend))

    def record_grouped(self, x, w, out, *, epilogue: Epilogue, fmt: str,
                       out_dtype, backend: str) -> None:
        """An already-grouped launch counts as ONE dispatch.  It is kept
        in ``records`` (dispatch audit) but not lowered into the builder
        graph — its batched (G, M, K) operand layout is the *result* of
        grouping, not a program to re-fuse."""
        g, m, k = x.shape
        self.records.append(_Record("grouped", int(m), int(w.shape[2]),
                                    int(k), fmt, "mte", backend,
                                    group=int(g)))

    # -- results --------------------------------------------------------------
    def graph(self) -> Graph:
        """The captured program.  Outputs = every produced value that no
        recorded node consumed (the pipeline's live results)."""
        b = self._builder
        consumed = set()
        produced = []
        for node in b._nodes:
            consumed.update(node.inputs())
            produced.extend(node.outs())
        b._outputs = [v for v in produced if v not in consumed]
        return b.build()

    def is_complete(self) -> bool:
        """True when every node input is a graph input or node output —
        i.e. no invisible element-wise glue feeds a recorded dispatch,
        so the captured graph replays the computation faithfully."""
        g = self.graph()
        known = set(g.inputs)
        for n in g.nodes:
            if any(v not in known for v in n.inputs()):
                return False
            known.update(n.outs())
        return True


_ACTIVE: Optional[GemmCapture] = None


def active() -> Optional[GemmCapture]:
    return _ACTIVE


@contextlib.contextmanager
def trace_gemms():
    """Capture every GEMM dispatched through the MTE surface.

    Execution is unchanged; the capture observes.  Not reentrant (the
    inner capture wins until it exits).  The hook lives in the wrappers
    of :mod:`repro_torch.kernels.ops`, which run eagerly, so every call
    is seen.
    """
    global _ACTIVE
    prev = _ACTIVE
    cap = GemmCapture()
    _ACTIVE = cap
    try:
        yield cap
    finally:
        _ACTIVE = prev


def merge_graphs(*graphs: Graph) -> Graph:
    """Concatenate independent programs into ONE :class:`Graph`
    (``trace.py:291-338`` of the JAX package).

    Value ids of graph ``i`` are shifted by the total value count of the
    graphs before it; inputs and outputs concatenate in graph order, so
    execution binds each constituent's arguments contiguously.  The
    merged program has one signature and compiles (fuses, schedules,
    plans) as a unit.  The constituents must be independent: no value
    flows from one graph into another."""
    values: List[ValueInfo] = []
    nodes: list = []
    inputs: List[int] = []
    outputs: List[int] = []
    for g in graphs:
        off = len(values)

        def s(v, off=off):
            return None if v is None else v + off

        values.extend(g.values)
        inputs.extend(v + off for v in g.inputs)
        outputs.extend(v + off for v in g.outputs)
        for n in g.nodes:
            if isinstance(n, GemmNode):
                nodes.append(dataclasses.replace(
                    n, a=s(n.a), b=s(n.b), out=s(n.out), c=s(n.c),
                    bias=s(n.bias)))
            elif isinstance(n, EpilogueNode):
                nodes.append(dataclasses.replace(
                    n, args=tuple(s(a) for a in n.args), out=s(n.out)))
            elif isinstance(n, CastNode):
                nodes.append(dataclasses.replace(n, x=s(n.x), out=s(n.out)))
            elif isinstance(n, GroupNode):
                nodes.append(dataclasses.replace(
                    n, a=s(n.a), outputs=tuple(s(o) for o in n.outputs),
                    weights=tuple(s(w) for w in n.weights),
                    stacked=s(n.stacked),
                    biases=tuple(s(b) for b in n.biases)))
            else:
                raise TypeError(type(n).__name__)
    return Graph(values=values, nodes=nodes, inputs=tuple(inputs),
                 outputs=tuple(outputs))
