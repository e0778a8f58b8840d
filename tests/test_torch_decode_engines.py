"""The engine choice of the port's B3 (grouped GEMM) and B5 (flash
attention): ``repro_torch.core.geometry.grouped_engine`` (the cluster
split-K kernel for the bf16 and int8 decode groups, else the tile loop) and
``attention_engine`` (TMA + wgmma for bf16 at D 64/128/256, else SIMT),
B3's split plan, the plan cache's engine for grouped signatures, the
grouping decisions at full width (which the new engine must not move),
and the plain versions these engines are held to against the JAX package
at the engines' own type and shapes (Pallas in interpret mode).  The
kernels themselves are held in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.geometry import BlockGeometry as JGeom
from repro.core.tile_state import SEW as JSEW
from repro.kernels import ops as jops
from repro.kernels.grouped_gemm import grouped_gemm_pallas

from torch_lazy import LazyModule, torch
from torch_parity import n, t

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tgeometry = LazyModule("repro_torch.core.geometry")
tschedule = LazyModule("repro_torch.graph.schedule")
ttrace = LazyModule("repro_torch.graph.trace")
tbuild = LazyModule("repro_torch.kernels.build")
tattn = LazyModule("repro_torch.kernels.flash_attention")
tgrouped = LazyModule("repro_torch.kernels.grouped_gemm")

RNG = np.random.default_rng(15)


@pytest.fixture(autouse=True)
def fresh_caches():
    tautotune.reset_cache(profile=tautotune.H100_SPEC)
    tschedule.reset_programs()
    yield
    tautotune.reset_cache()
    tschedule.reset_programs()


# -- engine choice ------------------------------------------------------------

@pytest.mark.parametrize("dtype,m,n_,k,bf16acc,want", [
    ("bfloat16", 4, 2048, 2048, False, "splitk"),   # gemma_2b's decode group
    ("bfloat16", 4, 4096, 4096, False, "splitk"),   # recurrentgemma_9b's
    ("bfloat16", 1, 8, 1, False, "splitk"),
    ("bfloat16", 16, 2048, 32256, False, "splitk"),  # 8 slices of x fit
    ("bfloat16", 16, 2048, 32257, False, "tile"),   # they do not
    ("bfloat16", 17, 2048, 2048, False, "tile"),    # C > 16
    ("bfloat16", 512, 16384, 2048, False, "tile"),  # prefill gate+up
    ("bfloat16", 4, 2048, 2048, True, "splitk"),    # bf16acc: by slice
    ("bfloat16", 4, 2560, 2560, True, "splitk"),    # qwen15_4b's MHA group
    ("bfloat16", 17, 2560, 2560, True, "tile"),     # C > 16
    ("bfloat16", 4, 2050, 2048, False, "tile"),     # N not a multiple of 8
    ("float32", 4, 2048, 2048, False, "tile"),
    ("int8", 4, 2048, 2048, False, "splitk"),       # its s8 entry
    ("int8", 4, 2056, 2048, False, "tile"),         # N not a multiple of 16
])
def test_grouped_engine_table(dtype, m, n_, k, bf16acc, want):
    assert tgeometry.grouped_engine(getattr(torch, dtype), m, n_, k,
                                    bf16acc=bf16acc) == want
    assert tgeometry.grouped_engine(dtype, m, n_, k,
                                    bf16acc=bf16acc) == want


@pytest.mark.parametrize("dtype,d,want", [
    ("bfloat16", 256, "wgmma"),     # gemma_2b, recurrentgemma_9b
    ("bfloat16", 128, "wgmma"),
    ("bfloat16", 64, "wgmma"),
    ("bfloat16", 32, "simt"),       # the reduced configs
    ("bfloat16", 96, "simt"),
    ("bfloat16", 16, "simt"),
    ("float32", 256, "simt"),
    ("float32", 32, "simt"),
])
def test_attention_engine_table(dtype, d, want):
    assert tgeometry.attention_engine(getattr(torch, dtype), d) == want


@pytest.mark.parametrize("ctas,kv_tiles,want", [
    (64, 16, 2),       # gemma_2b's prefill chunk: 8 heads x 8 query tiles
    (66, 8, 2),        # twice the grid just fills 132 SMs
    (67, 8, 1),
    (64, 1, 1),        # one kv tile: nothing to split
    (1, 2, 2),
    (512, 32, 1),
])
def test_attention_kv_split_table(ctas, kv_tiles, want):
    assert tgeometry.attention_kv_split(ctas, kv_tiles, 132) == want


# -- B3's split plan ----------------------------------------------------------

@pytest.mark.parametrize("n_,widths,g,want", [
    (2048, (2048, 256, 256), 3, (16, 2, 2)),
    (4096, (4096, 256, 256), 3, (32, 2, 2)),
    (392, (392, 40, 129, 0, 8, 300, 256, 500), 8, (4, 1, 2, 0, 1, 3, 2, 4)),
    (300, None, 2, (3, 3)),
])
def test_live_tiles_count_straddling_widths(n_, widths, g, want):
    assert tgeometry.grouped_live_tiles(n_, widths, g) == want


@pytest.mark.parametrize("tiles,k,m", [(20, 2048, 4), (36, 4096, 4),
                                       (17, 1000, 16), (1, 130, 1),
                                       (1, 64, 4), (1, 1, 1), (200, 2048, 4),
                                       (3, 32256, 16), (400, 8192, 16),
                                       (66, 4096, 4), (5, 192, 8)])
def test_split_plan_fills_the_card_within_a_cluster(tiles, k, m):
    """At most 8 slices (one portable cluster), each a multiple of 64 rows
    deep, none empty, none deeper than m rows of x can be held; live tiles
    x slices >= 132 wherever four slices of whole stages could reach it,
    and no more slices than that or x's budget needs."""
    s, depth = tgeometry.grouped_split(tiles, k, m, 132)
    assert 1 <= s <= tgeometry.MAX_CLUSTER
    assert depth % tgeometry.GROUPED_BK == 0 and depth > 0
    assert (s - 1) * depth < k <= s * depth
    assert m * (depth + 8) * 2 <= tgeometry.GROUPED_X_BYTES
    fill = tgeometry.GROUPED_FILL_SPLIT
    if k % (tgeometry.GROUPED_BK * fill) == 0 and tiles * fill >= 132:
        assert tiles * s >= 132
    if s > 1 and k % (tgeometry.GROUPED_BK * s) == 0:
        assert tiles * s // 2 < 132 or (s // 2) * \
            tgeometry.grouped_max_depth(m) < k
        assert s <= fill or (s // 2) * tgeometry.grouped_max_depth(m) < k


@pytest.mark.parametrize("tiles,k,m,want", [(20, 2048, 4, (4, 512)),
                                            (36, 4096, 4, (4, 1024)),
                                            (200, 2048, 4, (1, 2048)),
                                            (400, 8192, 16, (4, 2048)),
                                            (1, 130, 1, (2, 128))])
def test_split_plan_at_the_decode_groups(tiles, k, m, want):
    assert tgeometry.grouped_split(tiles, k, m, 132) == want


# -- the plan cache -----------------------------------------------------------

def _gsig(m, n_, k, fmt, group=3):
    dt = {"bf16": "bfloat16", "bf16acc": "bfloat16", "fp32": "float32",
          "int8": "int8"}[fmt]
    out = "int32" if fmt == "int8" else dt
    return tautotune.GemmSignature.make(m, n_, k, dt, out, group=group,
                                        fmt=fmt)


@pytest.mark.parametrize("m,n_,k,fmt,want", [
    (4, 2048, 2048, "bf16", "splitk"),
    (4, 4096, 4096, "bf16", "splitk"),
    (4, 2048, 2048, "bf16acc", "splitk"),
    (4, 2048, 2048, "fp32", "tile"),
    (4, 2048, 2048, "int8", "splitk"),
    (4, 2056, 2048, "int8", "tile"),
    (512, 16384, 2048, "bf16", "wgmma"),
    (4, 2050, 2048, "bf16", "tile"),
])
def test_plan_engine_reports_the_grouped_engine(m, n_, k, fmt, want):
    """Grouped plans keep their route and the tile loop's price (at a
    wgmma tile past 16 bf16 rows); plan_engine names the engine the
    wrapper will launch."""
    sig = _gsig(m, n_, k, fmt)
    plan = tautotune.get_plan(m, n_, k, sig.dtype_in, sig.dtype_out,
                              group=3, fmt=fmt)
    assert plan.route == "grouped"
    tiles = (tgeometry.WGMMA_TILES if want == "wgmma"
             else tgeometry.TILE_LOOP_TILES)
    assert (plan.geometry.bm, plan.geometry.bn) in tiles
    assert tautotune.plan_engine(plan.signature, plan.geometry) == want
    assert plan.predicted_s == tautotune.score_geometry(
        plan.signature, plan.geometry, tgeometry.H100_SPEC)


def _qkv_decode_graph(m, d, nq, nkv):
    b = ttrace.GraphBuilder()
    x = b.input((m, d), torch.bfloat16, "x")
    w = b.input((3, d, nq), torch.bfloat16, "qkv")
    b.output(*b.group(x, stacked=w, widths=(nq, nkv, nkv), fmt="bf16",
                      out_dtype=torch.bfloat16, policy="mte"))
    return b.build()


def _siblings_graph(m, d, widths):
    b = ttrace.GraphBuilder()
    x = b.input((m, d), torch.bfloat16, "x")
    outs = [b.gemm(x, b.input((d, w), torch.bfloat16), fmt="bf16",
                   out_dtype=torch.bfloat16) for w in widths]
    b.output(*outs)
    return b.build()


@pytest.mark.parametrize("label,build,grouped", [
    ("gemma decode q/k/v", lambda: _qkv_decode_graph(4, 2048, 2048, 256),
     True),
    ("recurrentgemma decode q/k/v",
     lambda: _qkv_decode_graph(4, 4096, 4096, 256), True),
    ("gemma decode gate+up", lambda: _siblings_graph(4, 2048,
                                                     (16384, 16384)), False),
    ("gemma prefill q/k/v", lambda: _siblings_graph(512, 2048,
                                                    (2048, 256, 256)), False),
    ("recurrentgemma prefill q/k/v",
     lambda: _siblings_graph(512, 4096, (4096, 256, 256)), False),
], ids=lambda v: v if isinstance(v, str) else "")
def test_full_width_grouping_decisions(label, build, grouped):
    """The full-width decisions phase 4 of chip_smoke.py prints: the
    decode q/k/v grouped (its plans on the split-K engine), no prefill
    projection and no decode gate+up grouped."""
    prog = tschedule.compile_graph(build())
    assert prog.grouped == grouped, label
    engines = {tautotune.plan_engine(p.signature, p.geometry)
               for p in prog.plans.values() if p.route == "grouped"}
    assert engines == ({"splitk"} if grouped else set())


# -- the plain versions against JAX at the engines' type ----------------------

def test_decode_group_plain_matches_pallas_in_bf16():
    """The decode group's plain version (what the split-K kernel is held
    to on the card) against JAX's Pallas kernel: bf16 operands, f32
    accumulator (exact products: 1e-5), widths zeroing the padding."""
    g, c, k, n_ = 3, 4, 320, 256
    x = (RNG.standard_normal((1, c, k)) / np.sqrt(k)).astype(np.float32)
    w = RNG.standard_normal((g, k, n_)).astype(np.float32)
    w[1:, :, 64:] = 0.0                       # k/v padded to q's width
    xb = jnp.broadcast_to(jnp.asarray(x).astype(jnp.bfloat16), (g, c, k))
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    jg = JGeom(bm=16, bn=128, bk=64, split_k=1, n_acc=1, transposed_b=False,
               sew_i=JSEW.E16, sew_o=JSEW.E32, policy="mte")
    want = grouped_gemm_pallas(xb, wb, geom=jg, interpret=True)
    sew = tgeometry.SEW
    tg = tgeometry.BlockGeometry(16, 128, 64, 1, 1, False, sew.E16, sew.E32,
                                 "mte")
    xt = t(np.asarray(xb[:1])).expand(g, c, k)
    before = tbuild.launch_counts()
    got = tgrouped.grouped_gemm_kernel(xt, t(np.asarray(wb)), geom=tg,
                                       widths=[256, 64, 64])
    assert tbuild.launch_counts() == before        # CPU: the plain version
    assert tgeometry.grouped_engine(xt.dtype, c, n_, k) == "splitk"
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,bk", [(640, 128), (2560, 256)])
def test_decode_group_bf16acc_plain_matches_pallas(k, bk):
    """B3's plain version of the split-K engine under bf16acc
    (``grouped_splitk_torch`` at the engine's split: each slice's running
    sum in bf16, rounded once per ``bk`` rows of the slice, the slices'
    partials summed in f32 and rounded once) against JAX's grouped kernel
    with a bf16 accumulator at the same ``bk`` (its running sum rounded
    once per ``bk`` rows in K order over the whole of K): the deliberate
    difference of ROADMAP §C, held within rtol 1e-2 (its bf16acc kernel
    tolerance) and atol 2e-2: the two round running sums of magnitude ~1
    (bf16 steps of 2^-8 to 2^-7) at different K rows, so an output whose
    slices cancel to a small value keeps the intermediates' absolute
    error (one or two of those steps).  The identity epilogue of the
    decode group (the bias joins after it) and widths zeroing the
    padding; the second case is qwen15_4b's decode split, 4 slices of
    640.  On CPU tensors the wrapper runs exactly this plain version."""
    g, c, n_ = 3, 4, 256
    x = (RNG.standard_normal((1, c, k)) / np.sqrt(k)).astype(np.float32)
    w = RNG.standard_normal((g, k, n_)).astype(np.float32)
    w[1:, :, 128:] = 0.0
    xb = jnp.broadcast_to(jnp.asarray(x).astype(jnp.bfloat16), (g, c, k))
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    jg = JGeom(bm=16, bn=128, bk=bk, split_k=1, n_acc=1, transposed_b=False,
               sew_i=JSEW.E16, sew_o=JSEW.E16, policy="mte")
    want = np.asarray(grouped_gemm_pallas(xb, wb, geom=jg,
                                          acc_dtype=jnp.bfloat16,
                                          interpret=True))
    xt = t(np.asarray(xb[:1])).expand(g, c, k)
    wt = t(np.asarray(wb))
    widths = [256, 128, 128]
    slices, depth = tgrouped.split_layout(xt, wt, widths=widths)
    assert tgeometry.grouped_engine(xt.dtype, c, n_, k,
                                    bf16acc=True) == "splitk"
    kw = dict(acc_dtype=torch.bfloat16, widths=widths)
    got = tgrouped.grouped_splitk_torch(xt, wt, n_split=slices, depth=depth,
                                        rbk=bk, **kw)
    np.testing.assert_allclose(n(got), want.astype(np.float64), rtol=1e-2,
                               atol=2e-2)
    sew = tgeometry.SEW
    tg = tgeometry.BlockGeometry(16, 128, bk, 1, 1, False, sew.E16, sew.E16,
                                 "mte")
    before = tbuild.launch_counts()
    via = tgrouped.grouped_gemm_kernel(xt, wt, geom=tg, **kw)
    assert tbuild.launch_counts() == before        # CPU: the plain version
    assert torch.equal(via, got)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kw", [{}, {"window": 24, "softcap": 20.0}],
                         ids=["causal", "window_softcap"])
def test_attention_plain_matches_jax_in_bf16(d, kw):
    """B5's plain version (what the wgmma kernel is held to on the card)
    against JAX's flash attention in interpret mode, on bf16 inputs at a
    head dim the wgmma engine takes, GQA 2:1, Sq < Skv (1e-2: both round
    the output to bf16)."""
    q = RNG.standard_normal((1, 4, 24, d)).astype(np.float32)
    k = RNG.standard_normal((1, 2, 40, d)).astype(np.float32)
    v = RNG.standard_normal((1, 2, 40, d)).astype(np.float32)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention(qb, kb, vb, **kw)
    tq, tk, tv = (t(np.asarray(a)) for a in (qb, kb, vb))
    assert tgeometry.attention_engine(tq.dtype, d) == "wgmma"
    before = tbuild.launch_counts()
    got = tattn.flash_attention_kernel(tq, tk, tv, **kw)
    assert tbuild.launch_counts() == before        # CPU: the plain version
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), n(want), rtol=1e-2, atol=1e-2)


def test_meta_tensors_never_reach_a_plain_version():
    """A tensor that is not on the CPU launches or raises in both new
    branches; the meta device stands in for a card here."""
    x = torch.empty(3, 4, 64, dtype=torch.bfloat16, device="meta")
    sew = tgeometry.SEW.E16
    geo = tgeometry.BlockGeometry(16, 128, 64, 1, 1, False, sew, sew, "mte")
    with pytest.raises(ValueError, match="unsupported device"):
        tgrouped.grouped_gemm_kernel(x, x.transpose(1, 2).contiguous(),
                                     geom=geo)
    q = torch.empty(1, 2, 64, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.flash_attention_kernel(q, q, q)
