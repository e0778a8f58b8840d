"""Graph rewrite rules: epilogue absorption, cast elimination, grouping (the
port of ``repro/graph/fuse.py``, rule for rule).

Each rule is ``Graph -> Optional[Graph]`` — it applies ONE rewrite and
returns the new graph, or None when nothing matches; :func:`fuse` runs a
rule set to fixpoint.  All three rules preserve program semantics at
accumulator precision:

- **epilogue absorption** (:func:`absorb_epilogues`): an element-wise
  consumer of a GemmNode's only use — a residual ``add``, a bias add, or
  a full :class:`~repro_torch.core.epilogue.Epilogue` spec — folds into the
  producing node's epilogue, so the post-op rides the accumulator
  registers instead of a second memory pass (the paper's vector-mode
  claim, §III-C4).  Composition is only performed where the BLAS epilogue
  order ``act(softcap(α·acc + β·C + bias))`` can express the sequence
  (additive terms only fold *before* an activation).
- **cast elimination** (:func:`eliminate_casts`): a CastNode whose every
  consumer is a kernel node running the *same* FormatPolicy — in a slot
  whose own operand handling reproduces the cast exactly (the left
  operand; for float policies also the weight) — is redundant: the
  kernel re-quantizes/casts that operand itself, and re-quantizing a
  value already on the policy's grid is exact (scales reproduce, the
  integers round-trip).  Producer-dequantize → consumer-quantize under a
  matching policy thereby collapses to the direct int path.  Adjacent
  same-format cast pairs collapse for the same reason.  Quantized weight
  slots and c/bias operands keep their casts (the kernel's B grid is
  per-column over K and the epilogue consumes c/bias unconverted).
- **sibling grouping** (:func:`group_siblings`): GemmNodes sharing the
  same left operand, format and policy become one :class:`GroupNode` —
  one grouped kernel launch, one plan-cache signature (q/k/v, gated-MLP
  gate+up, the decode GEMVs).  Member epilogues move post-kernel at
  accumulator precision, so this is a layout/launch change, not a
  numerics change.  Whether grouping actually *pays* is decided by the
  scheduler, which scores the grouped and ungrouped programs with the
  perf model (:mod:`repro_torch.graph.schedule`).

Adding a rule: write ``Graph -> Optional[Graph]`` using
``Graph.substituted`` (value-id substitution + dead-node elimination) and
append it to ``DEFAULT_RULES`` — see ROADMAP.md "Graph subsystem".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.epilogue import Epilogue
from repro_torch.graph.ir import (CastNode, EpilogueNode, GemmNode, Graph,
                                  GroupNode)

__all__ = ["absorb_epilogues", "eliminate_casts", "group_siblings",
           "DEFAULT_RULES", "fuse"]


def _single_consumer(g: Graph, vid: int, cons) -> Optional[int]:
    """The one consuming node index, or None (0 or >1 consumers, or the
    value is a graph output and must stay materialized)."""
    users = cons.get(vid, [])
    if len(users) != 1 or vid in g.outputs:
        return None
    return users[0]


# ---------------------------------------------------------------------------
# Rule 1: epilogue absorption
# ---------------------------------------------------------------------------


def _compose(e1: Epilogue, node: EpilogueNode, g: Graph, gemm: GemmNode,
             pidx: int, prod, y: Optional[int] = None
             ) -> Optional[GemmNode]:
    """The GemmNode with ``node`` folded into its epilogue, or None.

    Every operand folded into the gemm must be available when the gemm
    executes — produced by a node *before* it (or a graph input) — else
    absorption would break the topological-order invariant (the
    parallel-branch shape ``add(gemm1, gemm2)`` may fold into the later
    gemm only).
    """

    def available(v: int) -> bool:
        return prod.get(v, -1) < pidx

    m, _ = g.shape(gemm.a)
    n = g.shape(gemm.b)[1]
    if node.op == "add":
        # Additive terms fold only before the activation/softcap.
        if e1.activation != "none" or e1.softcap is not None:
            return None
        if not available(y):
            return None
        yshape = g.shape(y)
        if yshape == (m, n) and e1.beta == 0.0 and gemm.c is None:
            e = dataclasses.replace(e1, beta=1.0)
            return dataclasses.replace(gemm, epilogue=e, c=y,
                                       out=node.out,
                                       out_dtype=node.out_dtype)
        if not e1.has_bias and gemm.bias is None:
            if yshape == (n,):
                e = dataclasses.replace(e1, has_bias=True, bias_axis="row")
            elif yshape == (m,) and m != n:
                e = dataclasses.replace(e1, has_bias=True, bias_axis="col")
            else:
                return None
            return dataclasses.replace(gemm, epilogue=e, bias=y,
                                       out=node.out,
                                       out_dtype=node.out_dtype)
        return None
    if node.op == "epilogue":
        e2 = node.spec
        if e1.is_identity:
            # Wholesale adoption: c/bias operands come from the node.
            args = list(node.args[1:])
            c = args.pop(0) if e2.needs_c_input else None
            bias = args.pop(0) if e2.has_bias else None
            if any(v is not None and not available(v) for v in (c, bias)):
                return None
            return dataclasses.replace(gemm, epilogue=e2, c=c, bias=bias,
                                       out=node.out,
                                       out_dtype=node.out_dtype)
        if (e1.activation == "none" and e1.softcap is None
                and e2.alpha == 1.0 and e2.beta == 0.0 and not e2.has_bias):
            # Activation/softcap-only spec on top of additive-only e1.
            e = dataclasses.replace(e1, activation=e2.activation,
                                    softcap=e2.softcap)
            return dataclasses.replace(gemm, epilogue=e, out=node.out,
                                       out_dtype=node.out_dtype)
    return None


def absorb_epilogues(g: Graph) -> Optional[Graph]:
    prod = g.producer_of()
    cons = g.consumers_of()
    for idx, node in enumerate(g.nodes):
        if not isinstance(node, EpilogueNode) or node.op == "mul":
            continue
        # ``add`` commutes: either operand may be the absorbing gemm.
        orders = ((node.args[0], node.args[1]),
                  (node.args[1], node.args[0])) if node.op == "add" \
            else ((node.args[0], None),)
        for src, other in orders:
            pidx = prod.get(src)
            if pidx is None or not isinstance(g.nodes[pidx], GemmNode):
                continue
            if _single_consumer(g, src, cons) != idx:
                continue
            merged = _compose(g.nodes[pidx].epilogue, node, g,
                              g.nodes[pidx], pidx, prod, y=other)
            if merged is None:
                continue
            nodes = [merged if i == pidx else n
                     for i, n in enumerate(g.nodes) if i != idx]
            return g.substituted(nodes, {})
    return None


# ---------------------------------------------------------------------------
# Rule 2: cast-pair elimination at format boundaries
# ---------------------------------------------------------------------------


def eliminate_casts(g: Graph) -> Optional[Graph]:
    prod = g.producer_of()
    cons = g.consumers_of()
    for idx, node in enumerate(g.nodes):
        if not isinstance(node, CastNode):
            continue
        # (a) adjacent same-format cast pair: the second is a no-op.
        pidx = prod.get(node.x)
        if (pidx is not None and isinstance(g.nodes[pidx], CastNode)
                and g.nodes[pidx].fmt == node.fmt
                and node.out not in g.outputs):
            nodes = [n for i, n in enumerate(g.nodes) if i != idx]
            return g.substituted(nodes, {node.out: node.x})
        # (b) every consumer is a kernel node under the same policy that
        # takes the cast value in a slot whose own operand handling
        # subsumes the boundary cast exactly: the left operand (the
        # kernel re-quantizes/casts it over the same last-axis grid the
        # CastNode used — producer dequant + consumer quant collapse to
        # the int path), or for the *float* policies also the weight
        # operand (an idempotent dtype cast).  The quantized weight slot
        # is excluded (the kernel quantizes B per-column over K, not the
        # cast's last-axis grid), as are c/bias (the epilogue consumes
        # them unconverted).
        users = cons.get(node.out, [])
        if node.out in g.outputs or not users:
            continue
        from repro_torch.core.formats import FORMATS
        quantized = FORMATS[node.fmt].quantized

        def subsumed(n) -> bool:
            if not isinstance(n, (GemmNode, GroupNode)) \
                    or n.fmt != node.fmt:
                return False
            in_weight = (isinstance(n, GemmNode) and n.b == node.out
                         or isinstance(n, GroupNode)
                         and node.out in n.weights)
            left = n.a == node.out
            weight = not quantized and in_weight
            # Slots whose kernel-side handling does NOT reproduce the
            # cast: c/bias (epilogue consumes them unconverted), the
            # prestacked operand, and — for quantized policies — the
            # weight slot (B is quantized per-column over K, not the
            # cast's last-axis grid).  Any such use keeps the cast.
            others = ((isinstance(n, GemmNode)
                       and node.out in (n.c, n.bias))
                      or (isinstance(n, GroupNode)
                          and (node.out in n.biases
                               or node.out == n.stacked))
                      or (quantized and in_weight))
            return (left or weight) and not others

        if all(subsumed(g.nodes[u]) for u in users):
            nodes = [n for i, n in enumerate(g.nodes) if i != idx]
            return g.substituted(nodes, {node.out: node.x})
    return None


# ---------------------------------------------------------------------------
# Rule 3: sibling-GEMM grouping
# ---------------------------------------------------------------------------


def _groupable(n) -> bool:
    return (isinstance(n, GemmNode) and n.c is None
            and n.policy == "mte" and n.epilogue.beta == 0.0)


def group_siblings(g: Graph) -> Optional[Graph]:
    by_key = {}
    for idx, node in enumerate(g.nodes):
        if _groupable(node):
            key = (node.a, node.fmt, node.out_dtype, node.policy)
            by_key.setdefault(key, []).append(idx)
    for key, members in by_key.items():
        if len(members) < 2:
            continue
        first, last = members[0], members[-1]
        # No node in the span — members included — may consume a member's
        # output (the GroupNode lands at the last member's slot, and a
        # member feeding another member's weight/c/bias is a chain, not a
        # sibling set).
        outs = {g.nodes[i].out for i in members}
        if any(set(g.nodes[i].inputs()) & outs
               for i in range(first, last + 1)):
            continue
        gemms = [g.nodes[i] for i in members]
        group = GroupNode(
            a=gemms[0].a,
            widths=tuple(g.shape(n.b)[1] for n in gemms),
            outputs=tuple(n.out for n in gemms),
            weights=tuple(n.b for n in gemms),
            biases=tuple(n.bias for n in gemms),
            epilogues=tuple(n.epilogue for n in gemms),
            fmt=gemms[0].fmt, out_dtype=gemms[0].out_dtype,
            policy=gemms[0].policy)
        nodes = []
        for i, n in enumerate(g.nodes):
            if i == last:
                nodes.append(group)
            elif i not in members:
                nodes.append(n)
        return g.substituted(nodes, {})
    return None


DEFAULT_RULES = (absorb_epilogues, eliminate_casts, group_siblings)


def fuse(g: Graph, rules=DEFAULT_RULES, max_steps: int = 200) -> Graph:
    """Apply ``rules`` to fixpoint (each call performs one rewrite)."""
    for _ in range(max_steps):
        for rule in rules:
            g2 = rule(g)
            if g2 is not None:
                g = g2
                break
        else:
            return g
    return g
