"""Program-level scheduling: compile a fused Graph against the plan cache
(the port of ``repro/graph/schedule.py``).

Eager dispatch plans every GEMM in a vacuum; this module plans a *whole
program*:

1. **Candidate programs.**  The always-profitable rewrites (epilogue
   absorption, cast elimination — :mod:`repro_torch.graph.fuse`) run
   first; sibling grouping is a *trade* (one grouped launch over
   zero-padded, restacked weights vs. N launches), so both the grouped and
   ungrouped programs are scored with the port's Hopper model
   (:func:`repro_torch.core.autotune.score_geometry`, the plan cache's own
   scores) and the cheaper one wins.  Program cost = Σ per-node plan
   score (which already holds each launch's overhead) + the weight
   re-stacking traffic a grouped node pays when no precomputed stacked
   operand exists + :data:`RECONFIG_S` per change of tile between
   consecutive launches.
2. **Plan grants.**  Each kernel node of the winning program requests its
   plan from the process-global plan cache, so a program and eager
   dispatch of the same GEMM are granted the same plan.
3. **Tile stabilization.**  Chains of plain-MTE nodes may trade their
   per-GEMM-optimal geometries for ONE shared geometry when the modeled
   total beats the per-node optima plus their reconfigurations.  Every
   candidate is a geometry some node of the chain was granted and that
   an engine takes for every node of the chain (a wgmma tile granted to
   one bf16 node may not suit another's alignment), so a pinned geometry
   is always one a kernel is compiled for; ``ops.mte_gemm(geometry=...)``
   refuses any other.
4. **Weight prefetch.**  For every consecutive kernel-node pair the
   program records which graph-input weights of the next node could
   stream while the current one computes, and the modeled time that
   overlap would hide (``CompiledProgram.prefetch`` /
   ``prefetch_saved_s``).  As in JAX it is an annotation: nothing is
   prefetched, and ``modeled_s`` stays the no-overlap figure.

Constants: the JAX package's ``DISPATCH_OVERHEAD_S = 1e-6`` and
``RECONFIG_S = 2e-7`` are TPU figures and are not carried over.  A
launch's overhead is already inside each plan's score
(``HopperProfile.launch_s``, a spec-sheet figure, uncalibrated), so the
program adds no second per-launch charge; :data:`RECONFIG_S` is 0,
uncalibrated: a kernel's tile is a template parameter, with no tile
register to rewrite between launches.

Compiled programs are memoized per ``(graph signature, backend)``
(:func:`compile_graph`) and per caller key (:func:`compile_cached`, which
skips graph construction on a hit); a :func:`~repro_torch.core.autotune.
reset_cache` invalidates both.  Execution interprets the node list; every
kernel node launches through :mod:`repro_torch.kernels.ops` and is one
record for an installed per-GEMM accountant (a grouped sibling set is
one), under a ``graph.program`` span for an installed tracer.  Programs
are differentiable: GEMM nodes through ``ops``'s autograd, and the
member-wise grouped GEMM through :class:`_GroupMemberGemm`, the port of
JAX's custom VJP of ``_group_member_gemm``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core import formats as formats_lib
from repro_torch.core.autotune import (ExecutionPlan, GemmSignature,
                                       PlanCache, _route_for, plan_engine,
                                       score_geometry)
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.formats import to_torch_dtype
from repro_torch.graph import fuse as fuse_mod
from repro_torch.graph.ir import (CastNode, EpilogueNode, GemmNode, Graph,
                                  GroupNode, stack_group_weights)

__all__ = ["CompiledProgram", "compile_graph", "compile_cached",
           "reset_programs", "program_stats", "compiled_programs",
           "RECONFIG_S"]

# The charge per change of tile between consecutive launches (see the
# module docstring): uncalibrated, 0 on Hopper.
RECONFIG_S = 0.0

BACKEND = "kernels"


# ---------------------------------------------------------------------------
# Signatures: the compile-time mirror of what execution launches
# ---------------------------------------------------------------------------


def _group_kernel_out_dtype(node: GroupNode, fmt) -> str:
    """The grouped kernel's own output dtype.  The member path (no
    precomputed stack) always emits accumulator-precision members so the
    post-kernel epilogues apply exactly where the fused eager kernel
    would apply them; a prestacked launch with identity members (the
    serving decode step) comes out at the node's target dtype directly."""
    if fmt.quantized:
        return "float32"          # dequantized accumulator
    if node.stacked is None \
            or any(not e.is_identity for e in node.epilogues):
        return fmt.accum_dtype
    return node.out_dtype


def _node_signature(g: Graph, node) -> GemmSignature:
    """The GemmSignature this node's launch resolves to — kept in exact
    mirror with ``kernels/ops.py`` so the plans compiled here are the
    plans eager execution of the same GEMM would be granted."""
    fmt = formats_lib.FORMATS[node.fmt]
    if isinstance(node, GemmNode):
        m, k = g.shape(node.a)
        n = g.shape(node.b)[1]
        return GemmSignature.for_format(m, n, k, fmt, node.out_dtype,
                                        node.epilogue, node.policy)
    if not isinstance(node, GroupNode):
        raise TypeError(f"not a kernel node: {type(node).__name__}")
    a_shape = g.shape(node.a)
    m, k = a_shape[-2], a_shape[-1]
    nmax = (g.shape(node.stacked)[-1] if node.stacked is not None
            else max(g.shape(w)[1] for w in node.weights))
    return GemmSignature.for_format(m, nmax, k, fmt,
                                    _group_kernel_out_dtype(node, fmt),
                                    group=node.group)


# ---------------------------------------------------------------------------
# Whole-program scoring
# ---------------------------------------------------------------------------


def _restack_seconds(g: Graph, node: GroupNode, profile) -> float:
    """HBM round trip of building the stacked operand at run time: the
    member weights read and the (G, K, Nmax) stack written, at the
    operand width.  Zero when a precomputed stack is fed.  The port
    stacks exactly as JAX does (``_group_member_gemm`` pads and stacks
    the members on every call), so this is the traffic it moves."""
    if node.stacked is not None:
        return 0.0
    fmt = formats_lib.FORMATS[node.fmt]
    k = g.shape(node.a)[-1]
    nmax = max(g.shape(w)[1] for w in node.weights)
    itemsize = torch.empty((), dtype=fmt.operand_torch).element_size()
    nbytes = 2 * node.group * k * nmax * itemsize
    return nbytes / profile.hbm_bw_bytes_per_s


def _program_time(g: Graph, cache: Optional[PlanCache] = None,
                  plans: Optional[Dict[int, ExecutionPlan]] = None,
                  profile=None) -> float:
    """Whole-program modeled seconds: per-node plan score (launch
    overhead included) + restack traffic + tile reconfigurations.  Plans
    come from ``plans`` (already granted, e.g. after stabilization) or
    are looked up/solved in ``cache``."""
    profile = profile if profile is not None else cache.profile
    total = 0.0
    prev_geom = None
    for idx in g.kernel_nodes():
        node = g.nodes[idx]
        plan = (plans[idx] if plans is not None
                else cache.plan(_node_signature(g, node)))
        total += plan.predicted_s
        if isinstance(node, GroupNode):
            total += _restack_seconds(g, node, profile)
        if prev_geom is not None and plan.geometry != prev_geom:
            total += RECONFIG_S
        prev_geom = plan.geometry
    return total


def _weight_ids(g: Graph, node) -> Tuple[int, ...]:
    """The value ids a kernel node reads as *weight* operands."""
    if isinstance(node, GemmNode):
        return (node.b,)
    if isinstance(node, GroupNode):
        return ((node.stacked,) if node.stacked is not None
                else tuple(node.weights))
    return ()


def _weight_load_seconds(g: Graph, node, profile) -> float:
    """HBM read time of the node's weight operands at the format's
    operand width."""
    fmt = formats_lib.FORMATS[node.fmt]
    itemsize = torch.empty((), dtype=fmt.operand_torch).element_size()
    nbytes = 0
    for vid in _weight_ids(g, node):
        n = 1
        for d in g.shape(vid):
            n *= int(d)
        nbytes += n * itemsize
    return nbytes / profile.hbm_bw_bytes_per_s


def _prefetch_plan(g: Graph, plans: Dict[int, ExecutionPlan],
                   profile) -> Tuple[Dict[int, Tuple[int, ...]], float]:
    """Weight double-buffering annotation: for each consecutive kernel
    pair (i, i+1), node i+1's weight inputs that could stream during node
    i's compute (graph *inputs* only).  Returns (node idx -> value ids,
    modeled seconds the overlap would hide); the hidden time per pair is
    ``min(compute_i, weight_load_{i+1}, compute_{i+1})``."""
    idxs = list(g.kernel_nodes())
    inputs = set(g.inputs)
    plan: Dict[int, Tuple[int, ...]] = {}
    saved = 0.0
    for prev, nxt in zip(idxs, idxs[1:]):
        ids = tuple(v for v in _weight_ids(g, g.nodes[nxt]) if v in inputs)
        pp, np_ = plans.get(prev), plans.get(nxt)
        if not ids or pp is None or np_ is None:
            continue
        win = min(pp.predicted_s,
                  _weight_load_seconds(g, g.nodes[nxt], profile),
                  np_.predicted_s)
        if win <= 0.0:
            continue
        plan[prev] = ids
        saved += win
    return plan, saved


def _runs_on(sig, geom, profile) -> bool:
    """An engine takes ``geom`` for ``sig`` within the block's shared
    memory."""
    try:
        engine = plan_engine(sig, geom)
    except ValueError:
        return False
    return geom.smem_bytes(engine) <= profile.smem_per_block


def _stabilize_tiles(g: Graph, plans: Dict[int, ExecutionPlan],
                     profile) -> Dict[int, ExecutionPlan]:
    """Trade per-GEMM-optimal geometries for one shared tile shape across
    a chain of plain-MTE nodes when the modeled total (zero tile
    reconfigurations) beats the per-node optima plus their reconfig
    cost.  Candidates are the chain's own granted geometries (no split),
    and only those every node's engine takes, so the pinned tile is
    always one a kernel is compiled for."""
    idxs = [i for i in g.kernel_nodes()
            if isinstance(g.nodes[i], GemmNode)
            and i in plans and plans[i].route == "mte"]
    if len(idxs) < 2 or len({g.nodes[i].fmt for i in idxs}) != 1:
        return plans

    def reconfigs(geoms: List) -> int:
        return sum(1 for a, b in zip(geoms, geoms[1:]) if a != b)

    current = (sum(plans[i].predicted_s for i in idxs)
               + RECONFIG_S * reconfigs([plans[i].geometry for i in idxs]))
    best_geom, best_t = None, current
    for cand in sorted({plans[i].geometry for i in idxs},
                       key=lambda geo: (geo.bm, geo.bn, geo.bk)):
        if cand.split_k > 1 or not all(
                _runs_on(plans[i].signature, cand, profile) for i in idxs):
            continue
        t = sum(score_geometry(plans[i].signature, cand, profile)
                for i in idxs)
        if t < best_t:
            best_geom, best_t = cand, t
    if best_geom is None:
        return plans
    out = dict(plans)
    for i in idxs:
        sig = plans[i].signature
        out[i] = ExecutionPlan(
            signature=sig, geometry=best_geom,
            route=_route_for(sig, best_geom),
            predicted_s=score_geometry(sig, best_geom, profile),
            source="program")
    return out


# ---------------------------------------------------------------------------
# Compiled programs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledProgram:
    """An executable scheduled program.

    ``plans`` maps kernel-node index → the granted/pinned ExecutionPlan.
    ``n_source_dispatches`` is the dispatch count of the *unfused* source
    program — the eager baseline the fusion win is measured against.
    ``prefetch`` / ``prefetch_saved_s``: the weight-prefetch annotation
    (``modeled_s`` stays the no-overlap figure).
    """

    graph: Graph
    plans: Dict[int, ExecutionPlan]
    backend: str
    signature: str
    modeled_s: float
    n_source_dispatches: int
    generation: int = -1       # autotune.cache_generation() at compile
    prefetch: Dict[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    prefetch_saved_s: float = 0.0

    @property
    def n_dispatches(self) -> int:
        return self.graph.n_dispatches

    @property
    def grouped(self) -> bool:
        """True when the program launches at least one grouped kernel."""
        return any(isinstance(n, GroupNode) for n in self.graph.nodes)

    def describe(self) -> str:
        head = (f"program[{self.signature}] {self.n_dispatches} dispatches "
                f"(eager {self.n_source_dispatches}), "
                f"~{self.modeled_s * 1e6:.2f}us modeled")
        if self.prefetch:
            head += (f", prefetch {len(self.prefetch)} pair(s) "
                     f"~{self.prefetch_saved_s * 1e6:.2f}us overlapped")
        return head + "\n" + self.graph.describe()

    def __call__(self, *args):
        """Run the program on ``args``.  Every launch runs on its granted
        plan, planned for the rows the program was compiled for
        (``ops.mte_gemm(plan_rows=)``): a program compiled at M rows and
        called on more computes each row as the M-row program would."""
        g = self.graph
        if len(args) != len(g.inputs):
            raise ValueError(f"program takes {len(g.inputs)} inputs, "
                             f"got {len(args)}")
        # The graph.program span: traces attribute host time to the
        # program, not only to the engine phase around it.  It brackets
        # the launches as the host issues them (eager calls and a CUDA
        # graph's capture; a replay runs no Python).
        from repro_torch.telemetry import tracing
        tr = tracing.active()
        span = (tr.span("graph.program", args={
                    "signature": self.signature,
                    "nodes": len(g.nodes),
                    "grouped": sum(1 for n in g.nodes
                                   if isinstance(n, GroupNode)),
                    "dispatches": self.n_dispatches,
                    "prefetch_pairs": len(self.prefetch)})
                if tr is not None else tracing.NOOP.span("graph.program"))
        with span:
            env: Dict[int, object] = dict(zip(g.inputs, args))
            for idx, node in enumerate(g.nodes):
                if isinstance(node, GemmNode):
                    env[node.out] = self._run_gemm(node, env,
                                                   self.plans.get(idx))
                elif isinstance(node, GroupNode):
                    for vid, val in zip(node.outputs,
                                        self._run_group(
                                            node, env,
                                            self.plans.get(idx))):
                        env[vid] = val
                elif isinstance(node, CastNode):
                    env[node.out] = _apply_cast(env[node.x], node.fmt)
                else:
                    env[node.out] = _run_epilogue(node, env)
            outs = tuple(env[v] for v in g.outputs)
        return outs[0] if len(outs) == 1 else outs

    # -- node execution -------------------------------------------------------
    def _run_gemm(self, node: GemmNode, env, plan):
        from repro_torch.kernels import ops
        from repro_torch.telemetry import gemm_account
        a, b = env[node.a], env[node.b]
        c = env[node.c] if node.c is not None else None
        bias = env[node.bias] if node.bias is not None else None
        # One record for the node, with the program's plan provenance
        # (_account_node), instead of ops' own.
        with gemm_account.suppress():
            out = ops.mte_gemm(
                a, b, c=c, bias=bias,
                epilogue=node.epilogue, policy=node.policy,
                out_dtype=to_torch_dtype(node.out_dtype),
                format_policy=formats_lib.FORMATS[node.fmt],
                geometry=plan.geometry if plan is not None else None,
                plan_rows=plan.signature.m if plan is not None else None)
        _account_node(plan.signature.m if plan is not None else a.shape[0],
                      b.shape[1], a.shape[1], fmt=node.fmt,
                      policy=node.policy, plan=plan)
        return out

    def _run_group(self, node: GroupNode, env, plan):
        fmt = formats_lib.FORMATS[node.fmt]
        x = env[node.a]
        geom = plan.geometry if plan is not None else None
        rows = plan.signature.m if plan is not None else None
        kernel_dt = to_torch_dtype(_group_kernel_out_dtype(node, fmt))
        out_dtype = to_torch_dtype(node.out_dtype)
        biases = tuple(env[b] if b is not None else None
                       for b in node.biases) or (None,) * node.group
        from repro_torch.telemetry import gemm_account
        # The sibling set is ONE grouped dispatch: one record
        # (_account_node), the launch under it suppressed.
        if node.stacked is None:
            ws = tuple(env[w] for w in node.weights)
            with gemm_account.suppress():
                members = _group_member_gemm(x, ws, biases, node.widths,
                                             node.fmt, node.epilogues, geom,
                                             rows)
            _account_node(rows or x.shape[-2], max(node.widths),
                          x.shape[-1], fmt=node.fmt, policy="mte",
                          plan=plan, group=node.group)
            return [y.to(out_dtype) for y in members]
        wstack = env[node.stacked]
        with gemm_account.suppress():
            members = _grouped_launch(x, wstack, node.widths, fmt,
                                      kernel_dt, geom, rows)
        _account_node(rows or x.shape[-2], wstack.shape[-1], x.shape[-1],
                      fmt=node.fmt, policy="mte", plan=plan,
                      group=node.group)
        outs = []
        for i, y in enumerate(members):
            epi = node.epilogues[i]
            if not epi.is_identity:
                if fmt.quantized:
                    y = y.float()
                y = epi.apply(y, bias=biases[i])
            outs.append(y.to(out_dtype))
        return outs


def _account_node(m, n, k, *, fmt, policy, plan, group=1):
    """Report one compiled-program node execution to the active per-GEMM
    accountant (repro_torch.telemetry), unless the program runs under
    :func:`~repro_torch.telemetry.gemm_account.suppress` (the warm-up
    before a CUDA-graph capture).  A pinned program plan carries its own
    provenance and modelled time; without one the accountant joins
    against the planner's ``note_plan`` stream (or ``unplanned``)."""
    from repro_torch.telemetry import gemm_account
    acct = gemm_account.active_unsuppressed()
    if acct is None:
        return
    source = "program" if plan is not None else None
    modeled = plan.predicted_s if plan is not None else None
    if group > 1:
        acct.record_grouped(group, m, n, k, fmt=fmt, policy=policy,
                            backend="kernels", plan_source=source,
                            modeled_s=modeled)
    else:
        acct.record_gemm(m, n, k, fmt=fmt, policy=policy, backend="kernels",
                         plan_source=source, modeled_s=modeled)


def _grouped_launch(x, wstack, widths, fmt, kernel_dt, geom, plan_rows):
    """One grouped kernel launch over the stacked operand; returns the
    per-member slices (padded columns dropped) at the kernel dtype.  x
    is cast to the operand width first and then broadcast over the group
    with ``expand`` (group stride 0): the kernel reads the shared rows
    without a copy."""
    from repro_torch.kernels import ops
    g = wstack.shape[-3]
    if x.ndim == 2:
        if not fmt.quantized:
            x = x.to(fmt.operand_torch)
        x = x[None].expand(g, *x.shape)
    out = ops.grouped_gemm(x, wstack, epilogue=Epilogue(),
                           out_dtype=kernel_dt, format_policy=fmt,
                           geometry=geom, widths=widths,
                           plan_rows=plan_rows)
    return [out[i, :, :w] for i, w in enumerate(widths)]


def _group_member_gemm(x, ws, biases, widths, fmt_name: str, epilogues,
                       geom, plan_rows):
    """Member-wise grouped GEMM → tuple of members with their epilogues
    applied at accumulator precision (JAX's ``_group_member_gemm``):
    :func:`_group_member_fwd`, through :class:`_GroupMemberGemm` when
    autograd records and an operand requires grad."""
    from repro_torch.kernels.autodiff import wants_grad
    live = [bias for bias in biases if bias is not None]
    if not wants_grad(x, *ws, *live):
        return _group_member_fwd(x, ws, biases, widths, fmt_name, epilogues,
                                 geom, plan_rows)
    spec = (widths, fmt_name, epilogues, geom, plan_rows,
            tuple(bias is not None for bias in biases))
    return _GroupMemberGemm.apply(spec, x, *ws, *live)


class _GroupMemberGemm(torch.autograd.Function):
    """The member-wise grouped GEMM with the straight-through backward of
    ``kernels/autodiff.py``, as JAX's ``_group_member_bwd`` (its forward
    output kept under ``remat="dots"``, ``autodiff.stashed``): each
    member's accumulator recomputed at f32 (where its epilogue's
    derivative reads it), the epilogue differentiated there, and the
    operand grads formed by the unfused per-member GEMMs, f32 on the
    kernels (B1, or B2 where a plan splits K); operand casts and
    quantization pass as identity, as in the eager per-projection
    backward.  Arguments: ``spec`` (widths, format, epilogues, geometry,
    plan rows, which members carry a bias), x, the member weights, then
    the biases present."""

    @staticmethod
    def forward(ctx, spec, x, *tensors):
        widths, fmt_name, epilogues, geom, plan_rows, has_bias = spec
        ws = tensors[:len(epilogues)]
        live = iter(tensors[len(epilogues):])
        biases = tuple(next(live) if h else None for h in has_bias)
        from repro_torch.kernels.autodiff import stashed
        ctx.save_for_backward(x, *tensors)
        ctx.spec = spec
        fmt = formats_lib.FORMATS[fmt_name]
        dt = torch.float32 if fmt.quantized else fmt.accum_torch
        return stashed(
            lambda: _group_member_fwd(x, ws, biases, widths, fmt_name,
                                      epilogues, geom, plan_rows),
            tuple(((x.shape[0], w), dt) for w in widths))

    @staticmethod
    def backward(ctx, *gs):
        from repro_torch.kernels.autodiff import gemm_vjp
        _, _, epilogues, _, _, has_bias = ctx.spec
        x, *tensors = ctx.saved_tensors
        ws = tensors[:len(epilogues)]
        live = iter(tensors[len(epilogues):])
        xf = x.float()
        xt = xf.t().contiguous()
        dx = torch.zeros_like(xf)
        dws, dbs = [], []
        for gi, w, h, epi in zip(gs, ws, has_bias, epilogues):
            bias = next(live) if h else None
            da, dw, _, db = gemm_vjp(xf, w.float(), epi, gi.float(),
                                     torch.float32, bias=bias, a_t=xt)
            dx = dx + da
            dws.append(dw.to(w.dtype))
            if h:
                dbs.append(db.to(bias.dtype))
        return (None, dx.to(x.dtype), *dws, *dbs)


def _group_member_fwd(x, ws, biases, widths, fmt_name: str, epilogues,
                      geom, plan_rows):
    """The forward of :func:`_group_member_gemm`.

    Quantized formats: quantize x once and each member weight with its
    own scales (bit-identical to G eager quantized GEMMs: int
    accumulation is exact and stacking *after* quantization keeps the
    per-member scales intact), stack the int8 weights, launch ONE grouped
    kernel, dequantize and apply each member's epilogue at f32.  Float
    formats: cast to the operand width, stack, one launch at the
    accumulator dtype, member epilogues there."""
    from repro_torch.kernels import ops
    fmt = formats_lib.FORMATS[fmt_name]
    if fmt.quantized:
        xq, sa = formats_lib.quantize(x, contract_axis=x.ndim - 1,
                                      per_channel=fmt.per_channel)
        qs = [formats_lib.quantize(w, contract_axis=0,
                                   per_channel=fmt.per_channel)
              for w in ws]
        wstack = stack_group_weights([q for q, _ in qs])
        xg = xq[None].expand(len(ws), *xq.shape)
        acc = ops.grouped_gemm(xg, wstack, epilogue=Epilogue(),
                               out_dtype=torch.float32, format_policy=fmt,
                               geometry=geom, widths=widths,
                               plan_rows=plan_rows)
        outs = []
        for i, (_, sb) in enumerate(qs):
            o = acc[i, :, : widths[i]]
            # Same dequant order as formats.dequantize: ·s_a then ·s_b.
            if sa is not None:
                o = o * sa
            if sb is not None:
                o = o * sb
            outs.append(epilogues[i].apply(o, bias=biases[i]))
        return tuple(outs)
    xc = x.to(fmt.operand_torch)
    wstack = stack_group_weights([w.to(fmt.operand_torch) for w in ws])
    xg = xc[None].expand(len(ws), *xc.shape)
    acc = ops.grouped_gemm(xg, wstack, epilogue=Epilogue(),
                           out_dtype=fmt.accum_torch, format_policy=fmt,
                           geometry=geom, widths=widths,
                           plan_rows=plan_rows)
    return tuple(
        epilogues[i].apply(acc[i, :, : widths[i]], bias=biases[i])
        for i in range(len(ws)))


def _apply_cast(x, fmt_name: str):
    """Materialize ``x`` on the policy's operand grid.  Float policies
    cast; quantized policies fake-quantize (per-row scales over the last
    axis) back to f32."""
    fmt = formats_lib.FORMATS[fmt_name]
    if not fmt.quantized:
        return x.to(fmt.operand_torch)
    q, s = formats_lib.quantize(x, contract_axis=x.ndim - 1,
                                per_channel=fmt.per_channel)
    if s is None:
        return x
    return q.float() * s


def _run_epilogue(node: EpilogueNode, env):
    args = [env[a] for a in node.args]
    if node.op == "mul":
        out = args[0] * args[1]
    elif node.op == "add":
        out = args[0] + args[1]
    else:
        rest = list(args[1:])
        c = rest.pop(0) if node.spec.needs_c_input else None
        bias = rest.pop(0) if node.spec.has_bias else None
        out = node.spec.apply(args[0], c_in=c, bias=bias)
    return out.to(to_torch_dtype(node.out_dtype))


# ---------------------------------------------------------------------------
# Compilation + memoization
# ---------------------------------------------------------------------------

# Both memos are LRU-bounded and purged of generation-stale entries on
# every cold compile.
_MAX_PROGRAMS = 1024
_PROGRAMS: "OrderedDict[object, CompiledProgram]" = OrderedDict()
_KEYED: "OrderedDict[object, CompiledProgram]" = OrderedDict()
_STATS = {"compiles": 0, "hits": 0}


def _remember(store: OrderedDict, key, prog: CompiledProgram) -> None:
    store[key] = prog
    store.move_to_end(key)
    while len(store) > _MAX_PROGRAMS:
        store.popitem(last=False)


def _purge_stale() -> None:
    gen = autotune.cache_generation()
    for store in (_PROGRAMS, _KEYED):
        for k in [k for k, p in store.items() if p.generation != gen]:
            del store[k]


def reset_programs() -> None:
    _PROGRAMS.clear()
    _KEYED.clear()
    _STATS.update(compiles=0, hits=0)


def program_stats() -> Dict[str, int]:
    return dict(_STATS)


def compiled_programs() -> List[CompiledProgram]:
    """The current-generation programs compiled so far."""
    gen = autotune.cache_generation()
    return [p for p in _PROGRAMS.values() if p.generation == gen]


def compile_graph(graph: Graph, *, fuse: bool = True,
                  prefetch: bool = True) -> CompiledProgram:
    """Fuse, score, schedule and memoize one program.

    The grouped and ungrouped fusions are scored with the Hopper model
    and the cheaper program wins (at equal cost the one with fewer
    launches); the winner's kernel plans are granted by the
    process-global plan cache and then tile-stabilized, and the
    weight-prefetch annotation is computed (``prefetch=False`` skips
    it).  Memoized per graph signature."""
    key = (graph.signature(), BACKEND, prefetch)
    hit = _PROGRAMS.get(key)
    if hit is not None and hit.generation == autotune.cache_generation():
        _STATS["hits"] += 1
        return hit
    _purge_stale()
    _STATS["compiles"] += 1
    source_dispatches = graph.n_dispatches

    chosen = graph
    gcache = autotune.plan_cache()
    if fuse:
        base = fuse_mod.fuse(graph, rules=(fuse_mod.absorb_epilogues,
                                           fuse_mod.eliminate_casts))
        grouped = fuse_mod.fuse(base, rules=(fuse_mod.group_siblings,))
        chosen = base
        if grouped is not base:
            # Score in a scratch cache seeded from the global one: granted
            # plans are reused, and the losing candidate's plans never
            # enter the global cache.
            scratch = PlanCache(maxsize=gcache.maxsize,
                                profile=gcache.profile)
            scratch._plans.update(gcache._plans)
            if (_program_time(grouped, scratch)
                    <= _program_time(base, scratch)):
                chosen = grouped

    plans = {idx: gcache.plan(_node_signature(chosen, chosen.nodes[idx]))
             for idx in chosen.kernel_nodes()}
    plans = _stabilize_tiles(chosen, plans, gcache.profile)
    modeled = _program_time(chosen, plans=plans, profile=gcache.profile)
    pf_plan: Dict[int, Tuple[int, ...]] = {}
    pf_saved = 0.0
    if prefetch:
        pf_plan, pf_saved = _prefetch_plan(chosen, plans, gcache.profile)

    prog = CompiledProgram(graph=chosen, plans=plans, backend=BACKEND,
                           signature=graph.signature(), modeled_s=modeled,
                           n_source_dispatches=source_dispatches,
                           generation=autotune.cache_generation(),
                           prefetch=pf_plan, prefetch_saved_s=pf_saved)
    _remember(_PROGRAMS, key, prog)
    return prog


def compile_cached(key, build: Callable[[], Graph], *, fuse: bool = True,
                   prefetch: bool = True) -> CompiledProgram:
    """Memoized compile that skips graph *construction* on a hit — the
    hot-path entry the model layers use (``key`` encodes everything the
    built graph depends on: shapes, dtypes, format, policy)."""
    full_key = (key, BACKEND, prefetch)
    prog = _KEYED.get(full_key)
    if prog is None or prog.generation != autotune.cache_generation():
        prog = compile_graph(build(), fuse=fuse, prefetch=prefetch)
        _remember(_KEYED, full_key, prog)
    else:
        _STATS["hits"] += 1
    return prog
