"""The port's ``repro_torch.graph`` against the JAX package's ``repro.graph``:
the cases of tests/test_graph.py run in both packages (builder signatures,
epilogue absorption, cast elimination, sibling grouping, memoization,
tracing), the compiled MLP and q/k/v programs against JAX's
``_mlp_compiled`` / ``_qkv_compiled`` per format, and the port's own
contract: compiled equals eager, ≥ 30% fewer plan-cache signatures on a
transformer block, ONE grouped signature for the decode q/k/v.

Tolerances (rtol = atol): fp32 1e-5 for programs of the same GEMMs;
per format ``MODEL_TOL`` (torch_parity) where the two packages plan and
group on their own models: bf16acc rounds its running sum once per plan
K block, and int8 re-quantizes the MLP's hidden product, where an f32
last-bit difference can move one rounding tie."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import autotune as jautotune
from repro.core.epilogue import Epilogue as JEpilogue
from repro.graph import GraphBuilder as JGraphBuilder
from repro.graph import fuse as jfuse
from repro.graph import schedule as jschedule
from repro.models import attention as jattn
from repro.models import layers as jlayers

from torch_lazy import LazyModule, torch
from torch_parity import MODEL_TOL, n, t

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tepilogue = LazyModule("repro_torch.core.epilogue")
tconfigs = LazyModule("repro_torch.configs")
tgraph = LazyModule("repro_torch.graph")
tfuse = LazyModule("repro_torch.graph.fuse")
tir = LazyModule("repro_torch.graph.ir")
tschedule = LazyModule("repro_torch.graph.schedule")
ttrace = LazyModule("repro_torch.graph.trace")
tops = LazyModule("repro_torch.kernels.ops")
tattn = LazyModule("repro_torch.models.attention")
tlayers = LazyModule("repro_torch.models.layers")

RNG = np.random.default_rng(7)
FORMATS = ("fp32", "bf16", "bf16acc", "int8", "int8pt")
TOL = dict(MODEL_TOL, fp32=1e-5, int8pt=MODEL_TOL["int8"])


@pytest.fixture(autouse=True)
def fresh_caches():
    """Both packages' plan caches and program memos start empty."""
    jautotune.reset_cache()
    jschedule.reset_programs()
    tautotune.reset_cache()
    tschedule.reset_programs()
    yield
    jautotune.reset_cache()
    jschedule.reset_programs()


def _arr(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _mlp_graph(pkg_builder, epi_cls, m=8, d=64, f=128, fmt="fp32"):
    b = pkg_builder()
    x = b.input((m, d), "float32", "x")
    wg = b.input((d, f), "float32")
    wu = b.input((d, f), "float32")
    wd = b.input((f, d), "float32")
    g = b.gemm(x, wg, epilogue=epi_cls(activation="silu"), fmt=fmt)
    u = b.gemm(x, wu, fmt=fmt)
    h = b.mul(g, u)
    b.output(b.gemm(h, wd, fmt=fmt))
    return b.build()


def _both_mlp_graphs(**kw):
    return (_mlp_graph(JGraphBuilder, JEpilogue, **kw),
            _mlp_graph(ttrace.GraphBuilder, tepilogue.Epilogue, **kw))


def _kinds(g):
    return [type(node).__name__ for node in g.nodes]


# -- IR, builder, rewrites: the same programs in both packages ---------------

@pytest.mark.parametrize("kw", [{}, {"m": 16}, {"fmt": "int8"}])
def test_builder_signatures_equal_across_packages(kw):
    """The same program hashes to the same signature in both packages,
    stable across builds and distinct across shapes and formats."""
    jg, tg = _both_mlp_graphs(**kw)
    assert tg.signature() == jg.signature()
    assert tg.signature() == _both_mlp_graphs(**kw)[1].signature()
    assert tg.signature() != _both_mlp_graphs(m=2)[1].signature()
    assert tg.n_dispatches == jg.n_dispatches == 3


def test_epilogue_absorption_matches_jax():
    """bias + activation + residual fold into the producing GEMM; the
    residual after an activation stays separate — the same rewrites."""
    def build(B, E):
        b = B()
        x = b.input((8, 32), "float32")
        w = b.input((32, 16), "float32")
        bias = b.input((16,), "float32")
        res = b.input((8, 16), "float32")
        y = b.gemm(x, w)
        y = b.add(y, bias)
        y = b.add(y, res)
        y = b.epilogue(y, E(activation="gelu"))
        b.output(y)
        return b.build()

    jg, tg = build(JGraphBuilder, JEpilogue), build(ttrace.GraphBuilder,
                                                     tepilogue.Epilogue)
    jf = jfuse.fuse(jg, rules=(jfuse.absorb_epilogues,))
    tf = tfuse.fuse(tg, rules=(tfuse.absorb_epilogues,))
    assert _kinds(tf) == _kinds(jf) == ["GemmNode"]
    assert (dataclasses.asdict(tf.nodes[0].epilogue)
            == dataclasses.asdict(jf.nodes[0].epilogue))
    assert tf.signature() == jf.signature()
    x, w, bias, res = _arr(8, 32), _arr(32, 16), _arr(16), _arr(8, 16)
    want = jschedule.compile_graph(jg)(*map(jnp.asarray, (x, w, bias, res)))
    got = tschedule.compile_graph(tg)(*map(t, (x, w, bias, res)))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def test_epilogue_not_absorbed_after_activation_in_both():
    def build(B, E):
        b = B()
        x = b.input((8, 32), "float32")
        w = b.input((32, 16), "float32")
        res = b.input((8, 16), "float32")
        y = b.gemm(x, w, epilogue=E(activation="relu"))
        b.output(b.add(y, res))
        return b.build()

    jf = jfuse.fuse(build(JGraphBuilder, JEpilogue))
    tf = tfuse.fuse(build(ttrace.GraphBuilder, tepilogue.Epilogue))
    assert _kinds(tf) == _kinds(jf) == ["GemmNode", "EpilogueNode"]


@pytest.mark.parametrize("fmt,slot", [("int8", "a"), ("int8", "b"),
                                      ("bf16", "b"), ("bf16", "a")])
def test_cast_elimination_slot_aware_matches_jax(fmt, slot):
    """A same-format cast in the left-operand slot goes; in the weight
    slot it goes for float formats and stays for quantized ones."""
    def build(B):
        b = B()
        x = b.input((8, 32), "float32")
        w = b.input((32, 16), "float32")
        if slot == "a":
            x = b.cast(x, fmt)
        else:
            w = b.cast(w, fmt)
        b.output(b.gemm(x, w, fmt=fmt))
        return b.build()

    jf = jfuse.fuse(build(JGraphBuilder))
    tf = tfuse.fuse(build(ttrace.GraphBuilder))
    assert _kinds(tf) == _kinds(jf)
    assert tf.signature() == jf.signature()


def test_sibling_grouping_rewrite_matches_jax():
    jg, tg = _both_mlp_graphs()
    jf = jfuse.fuse(jg, rules=(jfuse.group_siblings,))
    tf = tfuse.fuse(tg, rules=(tfuse.group_siblings,))
    assert _kinds(tf) == _kinds(jf)
    assert tf.n_dispatches == jf.n_dispatches == 2
    group = next(nd for nd in tf.nodes if isinstance(nd, tir.GroupNode))
    assert group.group == 2 and group.epilogues[0].activation == "silu"
    assert tf.signature() == jf.signature()


def test_chained_members_are_not_grouped():
    b = ttrace.GraphBuilder()
    x = b.input((8, 32), "float32")
    w1 = b.input((32, 32), "float32")
    y1 = b.gemm(x, w1)
    w2 = b.input((32, 32), "float32")
    y2 = b.gemm(x, w2, c=y1, epilogue=tepilogue.Epilogue(beta=1.0))
    b.output(y1, y2)
    g = tfuse.fuse(b.build(), rules=(tfuse.group_siblings,))
    assert not any(isinstance(nd, tir.GroupNode) for nd in g.nodes)


def test_group_builder_rejects_bias_without_has_bias():
    b = ttrace.GraphBuilder()
    x = b.input((8, 16), "float32")
    w = b.input((16, 16), "float32")
    bb = b.input((16,), "float32")
    with pytest.raises(ValueError, match="disagree"):
        b.group(x, weights=[w], biases=[bb],
                epilogues=[tepilogue.Epilogue()])


# -- scheduling ---------------------------------------------------------------

def test_grouping_is_a_scheduling_choice():
    """Decode-like shapes (the grid underfills the card): the Hopper model
    groups gate+up; at full-width decode, where the per-call restack of
    two 2048 x 16384 weights costs more than a second launch, it does
    not."""
    small = tschedule.compile_graph(_both_mlp_graphs(m=2)[1])
    assert small.n_dispatches == 2 and small.n_source_dispatches == 3
    assert small.grouped and small.modeled_s > 0
    tautotune.reset_cache(profile=tautotune.H100_SPEC)
    big = tschedule.compile_graph(_mlp_graph(
        ttrace.GraphBuilder, tepilogue.Epilogue, m=4, d=2048, f=16384,
        fmt="bf16"))
    assert not big.grouped and big.n_dispatches == 3


def test_program_memoization_and_compile_counts():
    g = _both_mlp_graphs()[1]
    p1 = tschedule.compile_graph(g)
    stats0 = tschedule.program_stats()
    p2 = tschedule.compile_graph(_both_mlp_graphs()[1])
    stats1 = tschedule.program_stats()
    assert p1 is p2 and stats1["compiles"] == stats0["compiles"] == 1
    assert stats1["hits"] == stats0["hits"] + 1
    tautotune.reset_cache()
    assert tschedule.compile_graph(g) is not p1   # a reset invalidates


def test_tile_stabilization_shares_a_compiled_geometry(monkeypatch):
    """With a reconfiguration cost that dominates, a two-GEMM chain trades
    per-node tiles for one shared geometry — one the chain was granted,
    hence one the kernels are compiled for — and runs pinned to it."""
    b = ttrace.GraphBuilder()
    x = b.input((1024, 64), "float32")
    w1 = b.input((64, 2048), "float32")
    w2 = b.input((2048, 1024), "float32")
    b.output(b.gemm(b.gemm(x, w1), w2))
    g = b.build()
    cache = tautotune.plan_cache()
    plans = {i: cache.plan(tschedule._node_signature(g, g.nodes[i]))
             for i in g.kernel_nodes()}
    geoms = [plans[i].geometry for i in g.kernel_nodes()]
    assert all(plans[i].route == "mte" for i in g.kernel_nodes())
    assert geoms[0] != geoms[1]
    monkeypatch.setattr("repro_torch.graph.schedule.RECONFIG_S", 1.0)
    stab = tschedule._stabilize_tiles(g, plans, cache.profile)
    assert len({stab[i].geometry for i in g.kernel_nodes()}) == 1
    assert all(stab[i].source == "program" for i in g.kernel_nodes())
    assert stab[g.kernel_nodes()[0]].geometry in geoms
    prog = tschedule.CompiledProgram(
        graph=g, plans=stab, backend="kernels", signature=g.signature(),
        modeled_s=0.0, n_source_dispatches=2)
    args = (t(_arr(1024, 64)), t(_arr(64, 2048) / 8),
            t(_arr(2048, 1024) / 45))
    want = tops.mte_gemm(tops.mte_gemm(args[0], args[1]), args[2])
    np.testing.assert_allclose(n(prog(*args)), n(want), rtol=1e-5,
                               atol=1e-5)


# -- tracing ------------------------------------------------------------------

def test_trace_recovers_sibling_wiring_and_replays():
    a, w1, w2, w3 = (t(_arr(8, 32)), t(_arr(32, 48)), t(_arr(32, 48)),
                     t(_arr(32, 16)))
    with ttrace.trace_gemms() as cap:
        y1 = tops.mte_gemm(a, w1)
        y2 = tops.mte_gemm(a, w2)
        y3 = tops.mte_gemm(a, w3)
    g = cap.graph()
    assert cap.is_complete() and cap.n_dispatches == 3
    assert len(g.inputs) == 4 and len(g.outputs) == 3
    prog = tschedule.compile_graph(g)
    assert prog.n_dispatches < 3
    for got, want in zip(prog(a, w1, w2, w3), (y1, y2, y3)):
        np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


# -- compiled layers against JAX ----------------------------------------------

def _cfgs(fmt, **kw):
    j = dataclasses.replace(jget_config("gemma_2b").reduced(),
                            gemm_backend="pallas", format_policy=fmt, **kw)
    tc = dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                             format_policy=fmt, **kw)
    return j, tc


def _tree(p):
    return jax.tree.map(lambda a: t(np.asarray(a)), p)


@pytest.mark.parametrize("fmt", FORMATS)
def test_compiled_mlp_matches_jax_and_eager(fmt):
    jcfg, tcfg = _cfgs(fmt)
    jp = jlayers.init_mlp(jax.random.PRNGKey(0), jcfg)
    x = _arr(2, 8, jcfg.d_model)
    want = jlayers._mlp_compiled(jnp.asarray(x), jp, jcfg)
    got = tlayers.mlp(t(x), _tree(jp), tcfg)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(n(got), n(want), rtol=TOL[fmt],
                               atol=TOL[fmt])
    eager = tlayers.mlp(t(x), _tree(jp),
                        dataclasses.replace(tcfg, use_graph=False))
    if fmt.startswith("int8"):
        np.testing.assert_array_equal(n(got), n(eager))
    else:
        np.testing.assert_allclose(n(got), n(eager), rtol=TOL[fmt],
                                   atol=TOL[fmt])
    with ttrace.trace_gemms() as cap:
        tlayers.mlp(t(x), _tree(jp), tcfg)
    assert cap.n_dispatches == 2                 # gate+up grouped, down


@pytest.mark.parametrize("fmt", FORMATS)
def test_compiled_qkv_matches_jax(fmt):
    jcfg, tcfg = _cfgs(fmt)
    jp = jattn.init_attention(jax.random.PRNGKey(1), jcfg)
    x2 = _arr(16, jcfg.d_model)
    want = jattn._qkv_compiled(jnp.asarray(x2), jp, jcfg)
    got = tattn._qkv_compiled(t(x2), _tree(jp), tcfg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=TOL[fmt], atol=TOL[fmt])


def test_transformer_block_signatures_fall_by_30_percent():
    """The block of test_graph.py (q/k/v + o + MLP on reduced gemma_2b,
    head_dim 16): compiled equals eager, with ≥ 30% fewer plan-cache
    signatures and fewer dispatches."""
    _, cfg = _cfgs(None, head_dim=16)
    jcfg, _ = _cfgs(None, head_dim=16)
    key = jax.random.PRNGKey(0)
    pa = _tree(jattn.init_attention(key, jcfg))
    pm = _tree(jlayers.init_mlp(key, jcfg))
    x = t(_arr(2, 8, cfg.d_model))
    pos = torch.arange(8)[None].repeat(2, 1)

    def run(use_graph):
        tautotune.reset_cache()
        tschedule.reset_programs()
        c = dataclasses.replace(cfg, use_graph=use_graph)
        with ttrace.trace_gemms() as cap:
            q, k, v = tattn._project_qkv(x, pa, c, pos)
            o = tlayers.dense(q.reshape(2, 8, -1), pa["o"], c)
            y = tlayers.mlp(x, pm, c)
        return len(tautotune.plan_cache()), cap.n_dispatches, (q, k, v, o, y)

    sigs_eager, disp_eager, outs_eager = run(False)
    sigs_comp, disp_comp, outs_comp = run(True)
    assert sigs_comp <= 0.7 * sigs_eager, (sigs_comp, sigs_eager)
    assert disp_comp < disp_eager
    for a, b in zip(outs_comp, outs_eager):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", [None, "bf16", "int8"])
def test_decode_qkv_is_one_grouped_signature(fmt):
    """The decode q/k/v program over the prestacked weight issues exactly
    ONE grouped signature (tests/test_graph.py:510 in JAX), and matches
    JAX's grouped projection and the port's per-projection path."""
    jcfg, tcfg = _cfgs(fmt, decode_qkv_grouped=True)
    jp = jattn.init_attention(jax.random.PRNGKey(1), jcfg)
    x = _arr(3, 1, jcfg.d_model)
    pos = np.zeros((3, 1), np.int32)
    tp = _tree(jp)
    q, k, v = tattn._project_qkv_decode(t(x), tp, tcfg, t(pos))
    sigs = list(tautotune.plan_cache()._plans)
    assert len([s for s in sigs if s.group > 1]) == 1
    assert not [s for s in sigs if s.group == 1]
    want = jattn._project_qkv_grouped(jnp.asarray(x), jp, jcfg,
                                      jnp.asarray(pos))
    per = tattn._project_qkv(
        t(x), tp, dataclasses.replace(tcfg, decode_qkv_grouped=False),
        t(pos))
    tol = TOL[fmt or "fp32"]
    for a, b, c in zip((q, k, v), want, per):
        np.testing.assert_allclose(n(a), n(b), rtol=tol, atol=tol)
        np.testing.assert_allclose(n(a), n(c), rtol=tol, atol=tol)
    tp["qkv"] = tgraph.stack_group_weights([tp["q"]["w"], tp["k"]["w"],
                                            tp["v"]["w"]])
    q2, _, _ = tattn._project_qkv_decode(t(x), tp, tcfg, t(pos))
    np.testing.assert_array_equal(n(q2), n(q))


def test_amx_policy_never_groups():
    """Under the rigid policy every projection stays its own rigid GEMM:
    no grouping rewrite, no grouped decode (a rigid ISA has no grouped
    launch)."""
    _, cfg = _cfgs(None, gemm_policy="amx", decode_qkv_grouped=True)
    jcfg, _ = _cfgs(None)
    pa = _tree(jattn.init_attention(jax.random.PRNGKey(1), jcfg))
    pm = _tree(jlayers.init_mlp(jax.random.PRNGKey(0), jcfg))
    assert not tattn.grouped_decode(cfg)
    x = t(_arr(3, 1, cfg.d_model))
    with ttrace.trace_gemms() as cap:
        tattn._project_qkv_decode(x, pa, cfg, torch.zeros(3, 1,
                                                          dtype=torch.long))
        tlayers.mlp(x, pm, cfg)
    assert cap.n_dispatches == 6
    assert {r.policy for r in cap.records} == {"amx"}
    plans = tautotune.plan_cache()._plans.values()
    assert plans and {p.route for p in plans} == {"rigid"}
