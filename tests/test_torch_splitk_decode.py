"""The engine choice of the port's B2 (split-K decode GEMM) and B4 (paged
flash decode): ``repro_torch.core.geometry.splitk_engine`` (B3's cluster
split-K mainloop at G = 1 for the bf16 and int8 decode GEMMs, else the
tile loop)
and ``decode_engine`` (mma.sync over whole pages for bf16 pages, else
SIMT), B2's cluster split plan and B4's kv split at the decode shapes of
both served models, the plan cache's engine for split plans, and the plain
versions these engines are held to on the card against the JAX package at
the engines' own type (Pallas in interpret mode).  The kernels themselves
are held in test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.epilogue import Epilogue as JEpilogue
from repro.core.geometry import BlockGeometry as JGeom
from repro.core.tile_state import SEW as JSEW
from repro.kernels.flash_decode import flash_decode_paged_pallas
from repro.kernels.splitk_gemm import mte_gemm_splitk_pallas

from torch_lazy import LazyModule, torch
from torch_parity import n, t

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tepilogue = LazyModule("repro_torch.core.epilogue")
tgeometry = LazyModule("repro_torch.core.geometry")
tbuild = LazyModule("repro_torch.kernels.build")
tdecode = LazyModule("repro_torch.kernels.flash_decode")
tsplitk = LazyModule("repro_torch.kernels.splitk_gemm")

RNG = np.random.default_rng(16)

# The decode GEMMs (M = 4 serving slots) that the plan cache sends split-K:
# (N, K) of gemma_2b (d_model 2048, d_ff 16384, one 256-wide kv head) and
# of recurrentgemma_9b (d_model and RG-LRU width 4096, d_ff 12288).
DECODE_SHAPES = {
    "gemma q/o": (2048, 2048), "gemma k/v": (256, 2048),
    "gemma gate/up": (16384, 2048), "gemma down": (2048, 16384),
    "rg q/o/rglru": (4096, 4096), "rg k/v": (256, 4096),
    "rg gate/up": (12288, 4096), "rg down": (4096, 12288),
}


@pytest.fixture(autouse=True)
def fresh_caches():
    tautotune.reset_cache(profile=tautotune.H100_SPEC)
    yield
    tautotune.reset_cache()


# -- engine choice ------------------------------------------------------------

@pytest.mark.parametrize("dtype,m,n_,k,bf16acc,want", [
    ("bfloat16", 4, 16384, 2048, False, "cluster"),  # gemma_2b's gate/up
    ("bfloat16", 4, 2048, 16384, False, "cluster"),  # its down
    ("bfloat16", 1, 8, 1, False, "cluster"),
    ("bfloat16", 16, 2048, 32256, False, "cluster"),  # 8 slices of x fit
    ("bfloat16", 16, 2048, 32257, False, "tile"),     # they do not
    ("bfloat16", 17, 2048, 2048, False, "tile"),      # M > 16
    ("bfloat16", 4, 2048, 2048, True, "cluster"),     # bf16acc: by slice
    ("bfloat16", 4, 6912, 2560, True, "cluster"),     # qwen15_4b's gate/up
    ("bfloat16", 4, 2560, 6912, True, "cluster"),     # its down
    ("bfloat16", 17, 2560, 2560, True, "tile"),       # M > 16
    ("bfloat16", 4, 300, 1000, False, "tile"),        # N not a multiple of 8
    ("float32", 4, 2048, 2048, False, "tile"),
    ("int8", 4, 2048, 2048, False, "cluster"),       # its s8 entry
    ("int8", 4, 2056, 2048, False, "tile"),           # N not a multiple of 16
])
def test_splitk_engine_table(dtype, m, n_, k, bf16acc, want):
    assert tgeometry.splitk_engine(getattr(torch, dtype), m, n_, k,
                                   bf16acc=bf16acc) == want
    assert tgeometry.splitk_engine(dtype, m, n_, k,
                                   bf16acc=bf16acc) == want


@pytest.mark.parametrize("kv,q,g,d,want", [
    ("bfloat16", "bfloat16", 8, 256, "mma"),     # gemma_2b's decode
    ("bfloat16", "bfloat16", 2, 128, "mma"),     # gemma2_27b's GQA 2:1
    ("bfloat16", "bfloat16", 1, 64, "mma"),
    ("bfloat16", "bfloat16", 16, 256, "mma"),
    ("bfloat16", "bfloat16", 17, 64, "simt"),    # G > 16
    ("bfloat16", "bfloat16", 4, 32, "simt"),     # the reduced configs' D
    ("bfloat16", "bfloat16", 8, 96, "simt"),
    ("bfloat16", "float32", 8, 256, "simt"),     # an f32 query
    ("float32", "float32", 8, 256, "simt"),      # f32 pages
    ("int8", "bfloat16", 8, 256, "simt"),        # int8 pages
])
def test_decode_engine_table(kv, q, g, d, want):
    assert tgeometry.decode_engine(getattr(torch, kv), getattr(torch, q),
                                   g, d) == want
    assert tgeometry.decode_engine(kv, q, g, d) == want


# -- the split plans ----------------------------------------------------------

@pytest.mark.parametrize("label", sorted(DECODE_SHAPES))
def test_cluster_split_at_every_decode_shape(label):
    """At every decode shape of both models: at most 8 slices (one
    portable cluster), each a whole number of 64-deep stages and at least
    one, none empty, x's slice within its shared-memory budget, the slices
    fill the card where GROUPED_FILL_SPLIT of them can, and past that cap
    only while the grid fits one CTA per SM with deep slices."""
    n_, k = DECODE_SHAPES[label]
    m = 4
    assert tgeometry.splitk_engine("bfloat16", m, n_, k) == "cluster"
    tiles = tgeometry.cdiv(n_, tgeometry.GROUPED_BN)
    s, depth = tgeometry.splitk_cluster_split(tiles, k, m, 132)
    assert 1 <= s <= tgeometry.MAX_CLUSTER
    assert depth % tgeometry.GROUPED_BK == 0 and depth >= tgeometry.GROUPED_BK
    assert (s - 1) * depth < k <= s * depth
    assert m * (depth + 8) * 2 <= tgeometry.GROUPED_X_BYTES
    if tiles * tgeometry.GROUPED_FILL_SPLIT >= 132:
        assert tiles * s >= 132
    if s > 1:
        assert tiles * (s // 2) < 132
    if s > tgeometry.GROUPED_FILL_SPLIT:
        assert tiles * s <= 132 and depth >= tgeometry.SPLITK_DEEP_DEPTH


@pytest.mark.parametrize("tiles,k,m,want", [
    (128, 2048, 4, (2, 1024)),     # gemma_2b's gate and up
    (16, 2048, 4, (4, 512)),       # its o
    (16, 16384, 4, (8, 2048)),     # its down: deep slices, one step on
    (32, 16384, 4, (4, 4096)),     # two CTAs on some SMs: no step
    (16, 8192, 4, (4, 2048)),      # 1024-row slices: no step
    (32, 12288, 4, (4, 3072)),     # recurrentgemma_9b's down
    (1, 32256, 16, (8, 4032)),     # x's budget, not the fill, sets 8
])
def test_cluster_split_values(tiles, k, m, want):
    assert tgeometry.splitk_cluster_split(tiles, k, m, 132) == want


@pytest.mark.parametrize("rows,pages,want", [
    (4, 68, 8),       # gemma_2b's decode: 4 slots, one kv head, 68 pages
    (4, 3, 2),        # no more slices than pages
    (4, 1, 1),
    (64, 68, 4),      # 2 slices would leave 4 SMs idle
    (132, 68, 1),
    (33, 68, 4),
])
def test_decode_kv_split_table(rows, pages, want):
    assert tgeometry.decode_kv_split(rows, pages, 132) == want


# -- the plan cache -----------------------------------------------------------

@pytest.mark.parametrize("label", sorted(DECODE_SHAPES))
def test_plan_engine_reports_cluster_for_decode_plans(label):
    """Every bf16 decode GEMM keeps its split-K route and the tile loop's
    price; plan_engine names the cluster engine the wrapper launches."""
    n_, k = DECODE_SHAPES[label]
    plan = tautotune.get_plan(4, n_, k, "bfloat16", "bfloat16", fmt="bf16")
    assert plan.route == "splitk" and plan.n_split > 1
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "cluster"
    assert plan.predicted_s == tautotune.score_geometry(
        plan.signature, plan.geometry, tgeometry.H100_SPEC)


@pytest.mark.parametrize("fmt,m,n_,k", [("fp32", 4, 2048, 2048),
                                        ("bf16", 17, 256, 4096),
                                        ("int8", 4, 2056, 2048),
                                        ("bf16", 4, 300, 2048)])
def test_plan_engine_keeps_the_tile_loop_off_the_cluster_engine(fmt, m, n_,
                                                                k):
    dt = {"fp32": "float32", "int8": "int8", "bf16": "bfloat16"}[fmt]
    out = "int32" if fmt == "int8" else dt
    plan = tautotune.get_plan(m, n_, k, dt, out, fmt=fmt)
    assert plan.route == "splitk"
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "tile"


# -- the plain versions against JAX at the engines' type ----------------------

@pytest.mark.parametrize("m,n_,k", [(4, 256, 2048), (4, 512, 640),
                                    (3, 136, 1000), (16, 128, 384)])
def test_splitk_plain_at_engine_split_matches_pallas_in_bf16(m, n_, k):
    """B2's plain version at the cluster engine's split (what the kernel is
    held to on the card) against JAX's Pallas kernel at the plan's split:
    bf16 operands, β·C, a row bias, softcap and gelu, bf16 out, within
    2e-2 x (1 + |ref|) (both round the output to bf16; the slices only
    change the f32 summation order)."""
    a = (RNG.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    b = RNG.standard_normal((k, n_)).astype(np.float32)
    c = RNG.standard_normal((m, n_)).astype(np.float32)
    bias = RNG.standard_normal(n_).astype(np.float32)
    ab, bb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (a, b))
    epi = dict(alpha=0.7, beta=0.5, has_bias=True, softcap=20.0,
               activation="gelu")
    plan = tautotune.get_plan(m, n_, k, "bfloat16", "bfloat16",
                              epilogue=tepilogue.Epilogue(**epi), fmt="bf16")
    assert plan.route == "splitk"
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "cluster"
    g = plan.geometry
    jg = JGeom(bm=g.bm, bn=g.bn, bk=g.bk, split_k=g.split_k, n_acc=1,
               transposed_b=False, sew_i=JSEW.E16, sew_o=JSEW.E16,
               policy="mte")
    want = mte_gemm_splitk_pallas(ab, bb, jnp.asarray(c), jnp.asarray(bias),
                                  geom=jg, n_split=plan.n_split,
                                  epilogue=JEpilogue(**epi),
                                  out_dtype=jnp.bfloat16, interpret=True)
    s, depth = tgeometry.splitk_cluster_split(
        tgeometry.cdiv(n_, tgeometry.GROUPED_BN), k, m, 132)
    geom = dataclasses.replace(g, bk=tgeometry.GROUPED_BK)
    assert tsplitk.splitk_layout(k, geom, s)[1] == depth
    ta, tb = t(np.asarray(ab)), t(np.asarray(bb))
    before = tbuild.launch_counts()
    got = tsplitk.mte_gemm_splitk_kernel(
        ta, tb, t(c), t(bias), geom=geom, n_split=s,
        epilogue=tepilogue.Epilogue(**epi), out_dtype=torch.bfloat16)
    assert tbuild.launch_counts() == before        # CPU: the plain version
    assert got.dtype == torch.bfloat16
    ref = n(want)
    assert np.all(np.abs(n(got) - ref) <= 2e-2 * (1 + np.abs(ref)))


@pytest.mark.parametrize("m,n_,k,s,bk", [(4, 256, 2048, 4, 128),
                                         (3, 136, 1000, 2, 64),
                                         (4, 384, 2560, 4, 160)])
def test_splitk_cluster_bf16acc_plain_matches_pallas(m, n_, k, s, bk):
    """B2's plain version of the cluster engine under bf16acc
    (``splitk_cluster_torch``: each slice's running sum in bf16, rounded
    once per ``bk`` rows of the slice, the slices' bf16 partials summed
    in f32 and rounded once, the epilogue rounded at every step) against
    JAX's split-K kernel with a bf16 accumulator at the same ``n_split``
    and ``bk`` -- the slices coincide: the engine's depth,
    round_up(cdiv(K, s), 64), is JAX's ``k_per_split`` here (the last
    case is qwen15_4b's 4-slice, 160-row split of K = 2560) --, with
    alpha, beta·C, a row bias, softcap and gelu: within 1e-2 (ROADMAP
    §C's bf16acc kernel tolerance; a block partial on a rounding tie can
    land one bf16 ulp apart when the two f32 dot products sum in another
    order).  On CPU tensors the wrapper runs exactly this plain version
    at the split the engine takes."""
    a = (RNG.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    b = RNG.standard_normal((k, n_)).astype(np.float32)
    c = RNG.standard_normal((m, n_)).astype(np.float32)
    bias = RNG.standard_normal(n_).astype(np.float32)
    ab, bb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (a, b))
    epi = dict(alpha=0.7, beta=0.5, has_bias=True, softcap=20.0,
               activation="gelu")
    jg = JGeom(bm=16, bn=128, bk=bk, split_k=s, n_acc=1, transposed_b=False,
               sew_i=JSEW.E16, sew_o=JSEW.E16, policy="mte")
    want = mte_gemm_splitk_pallas(ab, bb, jnp.asarray(c), jnp.asarray(bias),
                                  geom=jg, n_split=s,
                                  epilogue=JEpilogue(**epi),
                                  out_dtype=jnp.float32,
                                  acc_dtype=jnp.bfloat16, interpret=True)
    depth = tgeometry.round_up(tgeometry.cdiv(k, s), tgeometry.GROUPED_BK)
    assert depth == tgeometry.cdiv(tgeometry.cdiv(k, s), bk) * bk
    ta, tb = t(np.asarray(ab)), t(np.asarray(bb))
    kw = dict(epilogue=tepilogue.Epilogue(**epi), out_dtype=torch.float32,
              acc_dtype=torch.bfloat16)
    got = tsplitk.splitk_cluster_torch(ta, tb, t(c), t(bias), n_split=s,
                                       depth=depth, rbk=bk, **kw)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-2, atol=1e-2)
    assert tgeometry.splitk_engine(ta.dtype, m, n_, k,
                                   bf16acc=True) == "cluster"
    slices, depth = tsplitk.cluster_layout(m, n_, k, None)
    sew = tgeometry.SEW.E16
    geom = tgeometry.BlockGeometry(16, 128, bk, 4, 1, False, sew, sew, "mte")
    before = tbuild.launch_counts()
    via = tsplitk.mte_gemm_splitk_kernel(ta, tb, t(c), t(bias), geom=geom,
                                         n_split=4, **kw)
    assert tbuild.launch_counts() == before        # CPU: the plain version
    assert torch.equal(via, tsplitk.splitk_cluster_torch(
        ta, tb, t(c), t(bias), n_split=slices, depth=depth,
        rbk=tsplitk.bf16acc_block(bk, k), **kw))


@pytest.mark.parametrize("kw", [{}, {"window": 21, "softcap": 20.0}],
                         ids=["plain", "window_softcap"])
@pytest.mark.parametrize("g,d", [(8, 64), (2, 128)])
def test_paged_decode_plain_matches_pallas_in_bf16(g, d, kw):
    """B4's plain version (what the mma engine is held to on the card)
    against JAX's Pallas kernel in bf16 at a head dim the mma engine
    takes: 16-token pages, an unmapped page inside a live row, a mapped
    stale page past seq_len, a zero-length row (zeros out), lengths 1, 17
    and 40 (1e-2: both round the output to bf16)."""
    b, hkv, page = 4, 2, 16
    lens = np.array([40, 17, 0, 1], np.int32)
    maxp = 4
    total = 12
    kp = RNG.standard_normal((total, page, hkv, d)).astype(np.float32)
    vp = RNG.standard_normal((total, page, hkv, d)).astype(np.float32)
    q = RNG.standard_normal((b, g * hkv, d)).astype(np.float32)
    table = np.array([[3, -1, 5, 11], [1, 2, 9, -1], [-1, -1, -1, -1],
                      [7, -1, -1, -1]], np.int32)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, kp, vp))
    want = flash_decode_paged_pallas(qb, kb, vb, jnp.asarray(table),
                                     jnp.asarray(lens), interpret=True, **kw)
    tq, tk, tv = (t(np.asarray(x)) for x in (qb, kb, vb))
    assert tgeometry.decode_engine(tk.dtype, tq.dtype, g, d) == "mma"
    before = tbuild.launch_counts()
    got = tdecode.flash_decode_paged_kernel(tq, tk, tv, t(table), t(lens),
                                            **kw)
    assert tbuild.launch_counts() == before        # CPU: the plain version
    assert got.dtype == torch.bfloat16
    assert torch.count_nonzero(got[2]) == 0
    np.testing.assert_allclose(n(got), n(want), rtol=1e-2, atol=1e-2)


def test_meta_tensors_never_reach_a_plain_version():
    """A tensor that is not on the CPU launches or raises in both new
    branches; the meta device stands in for a card here."""
    sew = tgeometry.SEW.E16
    geo = tgeometry.BlockGeometry(16, 128, 64, 2, 1, False, sew, sew, "mte")
    a = torch.empty(4, 2048, dtype=torch.bfloat16, device="meta")
    b = torch.empty(2048, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsplitk.mte_gemm_splitk_kernel(a, b, geom=geo, n_split=2)
    q = torch.empty(4, 8, 256, dtype=torch.bfloat16, device="meta")
    pages = torch.empty(9, 16, 1, 256, dtype=torch.bfloat16, device="meta")
    table = torch.zeros(4, 2, dtype=torch.int32, device="meta")
    lens = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdecode.flash_decode_paged_kernel(q, pages, pages, table, lens)
