"""int8 decode GEMMs (at most 16 rows) on the cluster split-K engines of B2
and B3 (the s8 entries ``splitk_gemm_cluster_s8`` and
``grouped_gemm_splitk_s8``): the engine rules (``geometry.splitk_engine``,
``geometry.grouped_engine``: int8 at M <= 16 with N a multiple of 16 and K
within 8 slices of x, else the tile loops), the x budget worked out in
bytes, the split plans at 128-row int8 stages, gemma_2b's int8 decode plans
naming the new engines at the tile loop's price (no route or grouping
decision moves), the int32 plain versions at the engine's split against
JAX's Pallas kernels in interpret mode (exactly equal), and ``ops``
under ``int8`` / ``int8pt`` at 4 rows against the JAX package.  On the CPU
the wrappers run their plain versions; the CUDA kernels against those are
in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import formats as jformats
from repro.core.geometry import BlockGeometry as JGeom
from repro.core.tile_state import SEW as JSEW
from repro.kernels import ops as jops
from repro.kernels.grouped_gemm import grouped_gemm_pallas
from repro.kernels.splitk_gemm import mte_gemm_splitk_pallas

from torch_lazy import LazyModule, torch
from torch_parity import n, t

tautotune = LazyModule("repro_torch.core.autotune")
tbuild = LazyModule("repro_torch.kernels.build")
tformats = LazyModule("repro_torch.core.formats")
tgeometry = LazyModule("repro_torch.core.geometry")
tgrouped = LazyModule("repro_torch.kernels.grouped_gemm")
tops = LazyModule("repro_torch.kernels.ops")
tschedule = LazyModule("repro_torch.graph.schedule")
tsplitk = LazyModule("repro_torch.kernels.splitk_gemm")
ttrace = LazyModule("repro_torch.graph.trace")

RNG = np.random.default_rng(30)

# gemma_2b's decode GEMMs at 4 slots: (N, K) of o, gate/up and down.
GEMMA_DECODE = {"o": (2048, 2048), "gate/up": (16384, 2048),
                "down": (2048, 16384)}


@pytest.fixture(autouse=True)
def fresh_caches():
    tautotune.reset_cache(profile=tautotune.H100_SPEC)
    tschedule.reset_programs()
    yield
    tautotune.reset_cache()
    tschedule.reset_programs()


def _ints(*shape):
    return RNG.integers(-127, 128, shape).astype(np.int8)


# -- the engine rules --------------------------------------------------------

@pytest.mark.parametrize("m,n_,k,want", [
    (4, 2048, 2048, True),        # gemma_2b's o
    (4, 16384, 2048, True),       # its gate and up
    (4, 2048, 16384, True),       # its down
    (1, 16, 1, True),
    (16, 2064, 144, True),        # N past the last tile, one short stage
    (16, 2048, 64512, True),      # 8 slices of 8064 int8 rows of x fit
    (16, 2048, 64513, False),     # they do not
    (1, 2048, 131072, True),      # S8_MAX_K: 127^2 K stays in int32
    (1, 2048, 131073, False),     # past it
    (4, 2056, 2048, False),       # N a multiple of 8, not of 16
    (4, 2040, 2048, False),
    (17, 2048, 2048, False),      # M > 16
])
def test_int8_cluster_rule_on_both_engines(m, n_, k, want):
    """B2 names the cluster engine and B3 its split-K engine for the same
    int8 shapes; off the rule both keep the tile loop (B3 at a tile-loop
    tile; past 16 rows B3's s8 wgmma rule is a tile's business)."""
    assert tgeometry.splitk_engine(torch.int8, m, n_, k) == (
        "cluster" if want else "tile")
    assert tgeometry.splitk_engine("int8", m, n_, k) == (
        "cluster" if want else "tile")
    assert tgeometry.grouped_engine(torch.int8, m, n_, k,
                                    tile=(16, 128)) == (
        "splitk" if want else "tile")


@pytest.mark.parametrize("m", [1, 4, 5, 9, 16])
def test_the_int8_x_budget_is_worked_out_in_bytes(m):
    """An int8 slice holds twice a bf16 slice's rows in the same bytes: m
    rows of depth bytes plus 16 of padding fit GROUPED_X_BYTES, the depth
    a whole number of 128-row stages, and one stage more would not fit;
    bf16 keeps its budget (rows padded by 8 elements)."""
    d8 = tgeometry.grouped_max_depth(m, torch.int8)
    d16 = tgeometry.grouped_max_depth(m)
    assert d8 == 2 * d16 == tgeometry.grouped_max_depth(m, "int8")
    assert d8 % tgeometry.GROUPED_BK_S8 == 0
    assert m * (d8 + 16) <= tgeometry.GROUPED_X_BYTES
    assert m * (d8 + tgeometry.GROUPED_BK_S8 + 16) > tgeometry.GROUPED_X_BYTES
    assert m * (d16 + 8) * 2 <= tgeometry.GROUPED_X_BYTES
    assert tgeometry.cluster_stage(torch.int8) == 128
    assert tgeometry.cluster_stage(torch.bfloat16) == 64


@pytest.mark.parametrize("tiles,k,m,want", [
    (128, 2048, 4, (2, 1024)),    # gemma_2b's gate and up
    (16, 2048, 4, (4, 512)),      # its o
    (16, 16384, 4, (8, 2048)),    # its down: deep slices, one step on
    (1, 144, 16, (2, 128)),       # a short K: one 128-row stage a slice
    (1, 64512, 16, (8, 8064)),    # x's budget, not the fill, sets 8
])
def test_int8_cluster_split_at_128_row_stages(tiles, k, m, want):
    s, depth = tgeometry.splitk_cluster_split(tiles, k, m, 132, torch.int8)
    assert (s, depth) == want
    assert depth % 128 == 0 and (s - 1) * depth < k <= s * depth
    assert depth <= tgeometry.grouped_max_depth(m, torch.int8)


@pytest.mark.parametrize("live,k,m,want", [
    ((16, 2, 2), 2048, 4, (4, 512)),     # gemma_2b's decode q/k/v
    ((16, 16, 16), 2048, 16, (4, 512)),
    ((1,), 144, 1, (2, 128)),
])
def test_int8_group_split_at_128_row_stages(live, k, m, want):
    s, depth = tgeometry.grouped_split(sum(live), k, m, 132, "int8")
    assert (s, depth) == want
    assert depth % 128 == 0 and (s - 1) * depth < k <= s * depth


# -- gemma_2b's int8 decode plans --------------------------------------------

@pytest.mark.parametrize("label", sorted(GEMMA_DECODE))
@pytest.mark.parametrize("fmt", ["int8", "int8pt"])
def test_gemma_decode_plans_name_the_cluster_engine(label, fmt):
    """Every int8 decode GEMM of gemma_2b keeps its split-K route and the
    tile loop's price; ``plan_engine`` names the cluster engine the
    wrapper launches, and a chunk of a verify window takes 16 rows."""
    n_out, k_in = GEMMA_DECODE[label]
    plan = tautotune.get_plan(4, n_out, k_in, torch.int8, torch.int32,
                              fmt=fmt)
    assert plan.route == "splitk" and plan.n_split > 1
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "cluster"
    assert plan.predicted_s == tautotune.score_geometry(
        plan.signature, plan.geometry, tgeometry.H100_SPEC)
    depth = tgeometry.splitk_cluster_split(n_out // 128, k_in, 4, 132,
                                           torch.int8)[1]
    assert tgeometry.window_rows("cluster", 4, depth, torch.int8) == 16


def _qkv_decode_graph(fmt):
    b = ttrace.GraphBuilder()
    x = b.input((4, 2048), torch.float32, "x")
    w = b.input((3, 2048, 2048), torch.float32, "qkv")
    b.output(*b.group(x, stacked=w, widths=(2048, 256, 256), fmt=fmt,
                      out_dtype=torch.float32, policy="mte"))
    return b.build()


def _mlp_decode_graph(fmt):
    b = ttrace.GraphBuilder()
    x = b.input((4, 2048), torch.float32, "x")
    outs = [b.gemm(x, b.input((2048, 16384), torch.float32), fmt=fmt,
                   out_dtype=torch.float32) for _ in range(2)]
    b.output(*outs)
    return b.build()


@pytest.mark.parametrize("label,build,grouped,engine", [
    ("q/k/v", _qkv_decode_graph, True, "splitk"),
    ("gate+up", _mlp_decode_graph, False, "cluster"),
])
def test_gemma_int8_decode_programs(label, build, grouped, engine):
    """The int8 decode step's programs at gemma_2b's width: the q/k/v
    group stays grouped (its plan on B3's split-K engine), the gate and up
    stay ungrouped (their plans on B2's cluster engine): the grouping
    decisions of the tile loops' prices, unmoved."""
    prog = tschedule.compile_graph(build("int8"))
    assert prog.grouped == grouped, label
    engines = {tautotune.plan_engine(p.signature, p.geometry)
               for p in prog.plans.values()}
    assert engines == {engine}


def test_the_cluster_s8_counters_exist():
    for name in ("splitk_gemm_cluster_s8", "grouped_gemm_splitk_s8"):
        assert name in tbuild.KERNEL_NAMES
        assert tbuild.launch_counts()[name] == 0


# -- the int32 plain versions against JAX (interpret mode) --------------------

def _jgeom(bk, split=1):
    return JGeom(bm=16, bn=128, bk=bk, split_k=split, n_acc=1,
                 transposed_b=False, sew_i=JSEW.E8, sew_o=JSEW.E32,
                 policy="mte")


@pytest.mark.parametrize("m,n_,k", [(4, 256, 2048), (5, 272, 1040),
                                    (16, 256, 2048), (1, 400, 3000)])
def test_splitk_cluster_int32_plain_equals_pallas(m, n_, k):
    """B2's plain version of the cluster engine at the engine's int8 split
    (``splitk_cluster_torch``) and the tile loop's (``mte_gemm_splitk_torch``
    at the plan's split) against JAX's split-K kernel at the plan's split:
    int32, exactly equal; on CPU tensors the wrapper returns the same."""
    a, b = _ints(m, k), _ints(k, n_)
    plan = tautotune.get_plan(m, n_, k, torch.int8, torch.int32, fmt="int8")
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "cluster"
    g = plan.geometry
    want = np.asarray(mte_gemm_splitk_pallas(
        jnp.asarray(a), jnp.asarray(b), geom=_jgeom(g.bk, g.split_k),
        n_split=plan.n_split, out_dtype=jnp.int32, interpret=True))
    np.testing.assert_array_equal(
        want, a.astype(np.int64) @ b.astype(np.int64))
    ta, tb = t(a), t(b)
    s, depth = tsplitk.cluster_layout(m, n_, k, None, dtype_in=torch.int8)
    assert depth % 128 == 0
    plain = tsplitk.splitk_cluster_torch(ta, tb, n_split=s, depth=depth,
                                         out_dtype=torch.int32)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(tsplitk.mte_gemm_splitk_torch(
        ta, tb, geom=g, n_split=plan.n_split,
        out_dtype=torch.int32).numpy(), want)
    before = tbuild.launch_counts()
    got = tsplitk.mte_gemm_splitk_kernel(ta, tb, geom=g,
                                         n_split=plan.n_split,
                                         out_dtype=torch.int32)
    assert tbuild.launch_counts() == before        # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,k,n_,shared,widths", [
    (4, 2048, 256, True, (256, 128, 128)),   # the decode q/k/v, narrowed
    (5, 1040, 144, False, (144, 16, 0)),
    (16, 144, 128, True, None),
])
def test_grouped_splitk_int32_plain_equals_pallas(c, k, n_, shared, widths):
    """B3's plain versions at int32 -- the split-K engine's at its int8
    split (``grouped_splitk_torch``) and the tile loop's
    (``grouped_gemm_torch``) -- against JAX's grouped kernel, a broadcast
    or a per-member x, the columns past each width zeroed: exactly
    equal."""
    g = 3
    x = _ints(1 if shared else g, c, k)
    x = np.broadcast_to(x, (g, c, k)).copy() if shared else x
    w = _ints(g, k, n_)
    want = np.asarray(grouped_gemm_pallas(
        jnp.asarray(x), jnp.asarray(w), geom=_jgeom(256),
        out_dtype=jnp.int32, interpret=True)).copy()
    for i, wd in enumerate(widths or ()):
        want[i, :, wd:] = 0
    tx = t(x[:1]).expand(g, c, k) if shared else t(x)
    tw = t(w)
    assert tgeometry.grouped_engine(torch.int8, c, n_, k) == "splitk"
    s, depth = tgrouped.split_layout(tx, tw, widths=widths)
    assert depth % 128 == 0
    plain = tgrouped.grouped_splitk_torch(tx, tw, n_split=s, depth=depth,
                                          out_dtype=torch.int32,
                                          widths=widths)
    np.testing.assert_array_equal(plain.numpy(), want)
    sew = tgeometry.SEW
    geom = tgeometry.BlockGeometry(16, 128, 256, 1, 1, False, sew.E8,
                                   sew.E32, "mte")
    before = tbuild.launch_counts()
    got = tgrouped.grouped_gemm_kernel(tx, tw, geom=geom,
                                       out_dtype=torch.int32, widths=widths)
    assert tbuild.launch_counts() == before        # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), want)


# -- ops at 4 rows against the JAX package ------------------------------------

@pytest.mark.parametrize("fmt", ["int8", "int8pt"])
def test_ops_mte_gemm_int8_at_4_rows_matches_jax(fmt):
    """``ops.mte_gemm`` under int8 at 4 rows: the same quantized operands
    as JAX's, its plan on the cluster engine, the int32 accumulator
    exactly JAX's split-K kernel's at the plan's split, the dequantized
    output within 1e-5 (f32 rounding of the scale products)."""
    m, n_, k = 4, 272, 1040
    a = RNG.standard_normal((m, k)).astype(np.float32)
    b = RNG.standard_normal((k, n_)).astype(np.float32)
    jfmt, tfmt = jformats.FORMATS[fmt], tformats.FORMATS[fmt]
    jaq, jbq, _, _ = jformats.quantize_operands(jnp.asarray(a),
                                                jnp.asarray(b), jfmt)
    aq, bq, _, _ = tformats.quantize_operands(t(a), t(b), tfmt)
    np.testing.assert_array_equal(aq.numpy(), np.asarray(jaq))
    np.testing.assert_array_equal(bq.numpy(), np.asarray(jbq))
    plan = tautotune.get_plan(m, n_, k, torch.int8, torch.int32, fmt=fmt)
    assert plan.route == "splitk"
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "cluster"
    acc = tautotune.execute_plan(plan, aq, bq)
    g = plan.geometry
    want_acc = mte_gemm_splitk_pallas(jaq, jbq, geom=_jgeom(g.bk, g.split_k),
                                      n_split=plan.n_split,
                                      out_dtype=jnp.int32, interpret=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    got = tops.mte_gemm(t(a), t(b), format_policy=fmt)
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b), format_policy=fmt)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["int8", "int8pt"])
@pytest.mark.parametrize("shared", [True, False], ids=["broadcast-x",
                                                        "own-x"])
def test_ops_grouped_gemm_int8_at_4_rows_matches_jax(fmt, shared):
    """``ops.grouped_gemm`` under int8 at 4 rows: its plan on B3's split-K
    engine, the int32 accumulator exactly JAX's grouped kernel's, the
    dequantized output within 1e-5."""
    g, c, k, n_ = 3, 4, 640, 256
    x = (RNG.standard_normal((1 if shared else g, c, k))
         / np.sqrt(k)).astype(np.float32)
    x = np.broadcast_to(x, (g, c, k)).copy() if shared else x
    w = RNG.standard_normal((g, k, n_)).astype(np.float32)
    jfmt, tfmt = jformats.FORMATS[fmt], tformats.FORMATS[fmt]
    tx = t(x[:1]).expand(g, c, k) if shared else t(x)
    jxq, jwq, _, _ = jformats.quantize_operands(jnp.asarray(x),
                                                jnp.asarray(w), jfmt)
    xq, wq, _, _ = tformats.quantize_operands(tx, t(w), tfmt)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    plan = tautotune.get_plan(c, n_, k, torch.int8, torch.int32, fmt=fmt,
                              group=g)
    assert plan.route == "grouped"
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "splitk"
    acc = tautotune.execute_plan(plan, xq, wq)
    want_acc = grouped_gemm_pallas(jxq, jwq, geom=_jgeom(256),
                                   out_dtype=jnp.int32, interpret=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    got = tops.grouped_gemm(tx, t(w), format_policy=fmt)
    want = jops.grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                             format_policy=fmt)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
