"""int8 past 16 rows on the wgmma engine of B1 and B3 (the mainloop's s8
entries, ``mte_gemm_wgmma_s8`` and ``grouped_gemm_wgmma_s8``): the engine
rules (``geometry.gemm_engine``, ``geometry.grouped_engine``; B8's rigid
int8 stage 1 on the same entry, test_torch_rigid_int8.py), the plans
(``autotune.enumerate_candidates`` offers the wgmma tiles to int8
signatures from 64 rows; gemma_2b's and granite_moe_1b's prefill
projections are granted one; the price pads K to the 128-deep int8
stage), and ``ops.mte_gemm`` / ``ops.grouped_gemm`` under ``int8`` and
``int8pt`` at shapes planned onto that engine against the JAX package's
Pallas kernels in interpret mode (int32 accumulators exactly equal).  On
the CPU the wrappers run their plain versions; the CUDA kernels against
those are in test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import formats as jformats
from repro.core.geometry import BlockGeometry as JGeom
from repro.core.tile_state import SEW as JSEW
from repro.kernels import ops as jops
from repro.kernels.grouped_gemm import grouped_gemm_pallas
from repro.kernels.mte_gemm import mte_gemm_pallas

from torch_lazy import LazyModule, torch
from torch_parity import n, t

tautotune = LazyModule("repro_torch.core.autotune")
tbuild = LazyModule("repro_torch.kernels.build")
tformats = LazyModule("repro_torch.core.formats")
tgeometry = LazyModule("repro_torch.core.geometry")
tgemm = LazyModule("repro_torch.kernels.mte_gemm")
tgrouped = LazyModule("repro_torch.kernels.grouped_gemm")
tops = LazyModule("repro_torch.kernels.ops")

WGMMA = [(64, 64), (64, 128), (64, 256), (128, 64), (128, 128), (128, 256)]
LOOP = [(16, 128), (64, 64)]

RNG = np.random.default_rng(29)


@pytest.fixture(autouse=True)
def fresh_cache():
    tautotune.reset_cache(profile=tautotune.H100_SPEC)
    yield
    tautotune.reset_cache()


def _sig(m, n_, k, group=1, policy="mte", fmt="int8"):
    return tautotune.GemmSignature.make(m, n_, k, "int8", "int32",
                                        policy=policy, group=group, fmt=fmt)


# -- the engine rules ---------------------------------------------------------

@pytest.mark.parametrize("tile", WGMMA, ids=lambda t_: f"{t_[0]}x{t_[1]}")
@pytest.mark.parametrize("m,n_,k,want", [
    (512, 16384, 2048, "wgmma"),     # gemma_2b's gate
    (512, 2048, 16384, "wgmma"),     # its down
    (512, 512, 1024, "wgmma"),       # granite_moe_1b's k/v
    (17, 72, 144, "wgmma"),          # past 16 rows, a K tail past 128
    (512, 2048, 2040, "tile"),       # K not a multiple of 16
    (512, 2052, 2048, "tile"),       # N not a multiple of 8
])
def test_b1_int8_takes_the_s8_engine_at_a_wgmma_tile(tile, m, n_, k, want):
    call = lambda: tgeometry.gemm_engine(  # noqa: E731
        torch.int8, *tile, n_, k, m=m)
    if want == "tile" and tile != (64, 64):
        # Off the s8 rule only the tile loop's tiles run.
        with pytest.raises(ValueError, match="GEMM engine"):
            call()
    else:
        assert call() == want


@pytest.mark.parametrize("m,tile,want", [
    (16, (16, 128), "tile"),         # decode rows keep the 16 x 128 loop
    (16, (64, 64), "tile"),          # M <= 16 at a tile both engines have
    (17, (64, 64), "wgmma"),
    (4096, (64, 64), "wgmma"),
])
def test_b1_int8_stays_on_the_tile_loop_up_to_16_rows(m, tile, want):
    assert tgeometry.gemm_engine(torch.int8, *tile, 2048, 2048,
                                 m=m) == want


@pytest.mark.parametrize("m,n_,k,want", [
    (4, 2048, 2048, "wgmma"), (512, 2048, 2048, "wgmma"),
    (4096, 2048, 2048, "wgmma"),
    (512, 2048, 2040, "tile"),       # K not a multiple of 16
    (4, 2052, 2048, "tile"),         # N not a multiple of 8
])
def test_b8_int8_stage_one_takes_the_s8_engine_at_every_m(m, n_, k, want):
    """B8's int8 stage 1 runs the s8 path of the wgmma mainloop at its one
    128 x 128 tile whatever M (rows past M are TMA's zeros), where K is a
    multiple of 16 and N of 8; off that rule, the tile loop."""
    assert tgeometry.gemm_engine(torch.int8, 128, 128, n_, k, m=m,
                                 rigid=True) == want


@pytest.mark.parametrize("g,m,n_,k,tile,want", [
    (32, 1024, 512, 1024, (128, 256), "wgmma"),   # granite's experts
    (32, 160, 1024, 512, (128, 128), "wgmma"),    # a 512-token chunk's
    (4, 96, 128, 256, (64, 128), "wgmma"),
    (2, 512, 16384, 2048, (64, 64), "wgmma"),
    (4, 96, 128, 264, (64, 128), "tile"),         # K % 16
    (4, 96, 132, 256, (64, 128), "tile"),         # N % 8
    (4, 16, 128, 256, (64, 128), "splitk"),       # C <= 16: split-K's s8
    (3, 4, 2048, 2048, (16, 128), "splitk"),      # the decode group
    (3, 4, 2056, 2048, (16, 128), "tile"),        # N % 16
    (4, 96, 128, 256, None, "tile"),              # no tile
])
def test_b3_int8_takes_the_s8_engine_past_16_rows(g, m, n_, k, tile, want):
    assert tgeometry.grouped_engine(torch.int8, m, n_, k, tile=tile) == want


# -- plans ----------------------------------------------------------------------

@pytest.mark.parametrize("m,n_,k,group", [
    (64, 256, 512, 1), (512, 2048, 2048, 1), (128, 256, 512, 1),
    (96, 128, 256, 4), (1024, 512, 1024, 32)])
def test_wgmma_tiles_offered_to_int8_from_64_rows(m, n_, k, group):
    sig = _sig(m, n_, k, group)
    cands = tautotune.enumerate_candidates(sig, tgeometry.H100_SPEC)
    wg = {(g.bm, g.bn) for g in cands
          if g.split_k == 1 and tautotune.plan_engine(sig, g) == "wgmma"}
    assert wg == set(WGMMA)


@pytest.mark.parametrize("m,n_,k", [(16, 2048, 2048), (4, 16384, 2048),
                                    (512, 2048, 2040), (512, 2052, 2048)])
def test_no_wgmma_tile_where_the_s8_rule_refuses(m, n_, k):
    sig = _sig(m, n_, k)
    for g in tautotune.enumerate_candidates(sig, tgeometry.H100_SPEC):
        assert tautotune.plan_engine(sig, g) != "wgmma"
        assert (g.bm, g.bn) in LOOP


@pytest.mark.parametrize("m,n_,k", [
    # gemma_2b's prefill chunk: q/o, k/v, gate/up, down
    (512, 2048, 2048), (512, 256, 2048), (512, 16384, 2048),
    (512, 2048, 16384),
    # granite_moe_1b's q/o and k/v (d_model 1024, 16 x 64, 8 kv heads)
    (512, 1024, 1024), (512, 512, 1024)])
@pytest.mark.parametrize("fmt", ["int8", "int8pt"])
def test_prefill_projections_are_granted_a_wgmma_tile(m, n_, k, fmt):
    plan = tautotune.plan_cache().plan(_sig(m, n_, k, fmt=fmt))
    assert plan.route == "mte"
    assert (plan.geometry.bm, plan.geometry.bn) in WGMMA
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "wgmma"


@pytest.mark.parametrize("k", [1040, 144, 2048])
def test_the_s8_price_pads_k_to_the_128_deep_stage(k):
    # Device memory out of the way: the int32 output bounds these shapes.
    spec = dataclasses.replace(tgeometry.H100_SPEC, hbm_bw_bytes_per_s=1e18)
    sig = _sig(512, 16384, k)
    geom = tgeometry.BlockGeometry(128, 256, 256, 1, 1, False,
                                   tgeometry.SEW.E8, tgeometry.SEW.E32,
                                   "mte")
    assert tautotune.plan_engine(sig, geom) == "wgmma"
    depth = -(-k // 128) * 128
    want = tautotune._wave_seconds(sig, geom, spec, depth, 0.0) \
        + spec.launch_s
    assert tautotune.score_geometry(sig, geom, spec) == want
    if k % 128:
        assert want > tautotune._wave_seconds(
            sig, geom, spec, -(-k // 64) * 64, 0.0) + spec.launch_s


def test_the_s8_price_uses_the_int8_peak():
    """At the same tile, with the memory rates out of the way, the int8
    wgmma plan is priced at the int8 peak (1979 TOPS), the bf16 one at
    989 TFLOP/s."""
    spec = dataclasses.replace(tgeometry.H100_SPEC, l2_bw_bytes_per_s=1e18,
                               hbm_bw_bytes_per_s=1e18)
    sew8, sew16 = tgeometry.SEW.E8, tgeometry.SEW.E16
    m, n_, k = 4096, 4096, 4096
    g8 = tgeometry.BlockGeometry(128, 256, 256, 1, 1, False, sew8, sew8,
                                 "mte")
    g16 = dataclasses.replace(g8, sew_i=sew16, sew_o=sew16)
    bf16 = tautotune.GemmSignature.make(m, n_, k, "bfloat16", "bfloat16")
    t8 = tautotune.score_geometry(_sig(m, n_, k), g8, spec) - spec.launch_s
    t16 = tautotune.score_geometry(bf16, g16, spec) - spec.launch_s
    assert t8 == pytest.approx(
        t16 * spec.peak_bf16_flops / spec.peak_int8_ops, rel=1e-9)


@pytest.mark.parametrize("group", [2, 32])
def test_grouped_int8_plans_keep_the_tile_loops_price(group):
    """No grouping decision moves: a grouped int8 plan on the s8 engine is
    priced as the tile loop is (the L2 rate does not move it, the load
    stretch does)."""
    spec = tgeometry.H100_SPEC
    sig = _sig(512, 1024, 1024, group)
    g = tgeometry.BlockGeometry(128, 256, 256, 1, 1, False,
                                tgeometry.SEW.E8, tgeometry.SEW.E32, "mte")
    assert tautotune.plan_engine(sig, g) == "wgmma"
    price = tautotune.score_geometry(sig, g, spec)
    assert price == tautotune.score_geometry(
        sig, g, dataclasses.replace(spec, l2_bw_bytes_per_s=1e12))
    assert price < tautotune.score_geometry(
        sig, g, dataclasses.replace(spec, blocks_per_sm=64))


def test_the_s8_counters_exist():
    for name in ("mte_gemm_wgmma_s8", "grouped_gemm_wgmma_s8"):
        assert name in tbuild.KERNEL_NAMES
        assert tbuild.launch_counts()[name] == 0


# -- the wrappers on the CPU ----------------------------------------------------

def _ints(*shape):
    return RNG.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("m,n_,k", [(65, 72, 144), (128, 256, 1040)])
@pytest.mark.parametrize("transposed", [False, True])
def test_b1_int8_wrapper_exact_at_an_s8_tile(m, n_, k, transposed):
    """At a wgmma tile the wrapper names the s8 engine and, on CPU
    tensors, returns the exact int32 product (B as (K, N) or (N, K))."""
    a, b = _ints(m, k), _ints(k, n_)
    geom = tgeometry.BlockGeometry(128, 128, 256, 1, 1, transposed,
                                   tgeometry.SEW.E8, tgeometry.SEW.E32,
                                   "mte")
    assert tgeometry.gemm_engine(torch.int8, 128, 128, n_, k,
                                 m=m) == "wgmma"
    bb = t(b.T.copy()) if transposed else t(b)
    got = tgemm.mte_gemm_kernel(t(a), bb, geom=geom, out_dtype=torch.int32)
    assert got.dtype == torch.int32
    want = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tgemm.k_major(bb, transposed).numpy(), b.T)


def test_int32_sums_past_two_to_the_24_are_exact():
    """±127 operands at K = 4096: sums up to 127² · 4096 = 66064384 >
    2^24, some of which f32 cannot hold (a trip through f32 would change
    their bits), must come out exactly."""
    m, n_, k = 64, 64, 4096
    a = np.full((m, k), 127, np.int8)
    b = np.full((k, n_), -127, np.int8)
    b[::2, 1::2] = 127
    b[:3, ::3] = 1
    b[3, ::3] = 2
    geom = tgeometry.BlockGeometry(64, 64, 256, 1, 1, False,
                                   tgeometry.SEW.E8, tgeometry.SEW.E32,
                                   "mte")
    got = tgemm.mte_gemm_kernel(t(a), t(b), geom=geom, out_dtype=torch.int32)
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(want).max() > 2 ** 24
    assert (want.astype(np.float32).astype(np.int64) != want).any()
    np.testing.assert_array_equal(got.numpy(), want)


# -- parity with JAX (interpret mode) through ops ------------------------------

def _jgeom(bm=64, bn=128):
    return JGeom(bm=bm, bn=bn, bk=128, split_k=1, n_acc=1,
                 transposed_b=False, sew_i=JSEW.E8, sew_o=JSEW.E32,
                 policy="mte")


@pytest.mark.parametrize("fmt", ["int8", "int8pt"])
def test_ops_mte_gemm_int8_matches_jax_on_the_s8_plan(fmt):
    m, n_, k = 128, 256, 512
    a = RNG.standard_normal((m, k)).astype(np.float32)
    b = RNG.standard_normal((k, n_)).astype(np.float32)
    jfmt, tfmt = jformats.FORMATS[fmt], tformats.FORMATS[fmt]
    jaq, jbq, _, _ = jformats.quantize_operands(jnp.asarray(a),
                                                jnp.asarray(b), jfmt)
    aq, bq, sa, sb = tformats.quantize_operands(t(a), t(b), tfmt)
    np.testing.assert_array_equal(aq.numpy(), np.asarray(jaq))
    np.testing.assert_array_equal(bq.numpy(), np.asarray(jbq))
    # The plan ops takes, on the s8 engine; its int32 accumulator exactly
    # equal to the Pallas kernel's.
    plan = tautotune.get_plan(m, n_, k, torch.int8, torch.int32, fmt=fmt)
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "wgmma"
    acc = tautotune.execute_plan(plan, aq, bq)
    want_acc = mte_gemm_pallas(jaq, jbq, geom=_jgeom(), out_dtype=jnp.int32,
                               interpret=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    got = tops.mte_gemm(t(a), t(b), format_policy=fmt)
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b), format_policy=fmt)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["int8", "int8pt"])
@pytest.mark.parametrize("shared", [True, False], ids=["broadcast-x",
                                                        "own-x"])
def test_ops_grouped_gemm_int8_matches_jax_on_the_s8_plan(fmt, shared):
    g, c, k, n_ = 4, 96, 256, 128
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
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "wgmma"
    acc = tautotune.execute_plan(plan, xq, wq)
    want_acc = grouped_gemm_pallas(jxq, jwq, geom=_jgeom(),
                                   out_dtype=jnp.int32, interpret=True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    got = tops.grouped_gemm(tx, t(w), format_policy=fmt)
    want = jops.grouped_gemm(jnp.asarray(x), jnp.asarray(w),
                             format_policy=fmt)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def test_grouped_int8_widths_zero_the_padding_on_the_s8_plan():
    """Member widths on the s8 engine's plan (CPU: its plain version):
    the columns past each width are 0, the rest the exact product."""
    g, c, k, n_ = 3, 80, 160, 136
    x, w = _ints(g, c, k), _ints(g, k, n_)
    widths = [136, 40, 0]
    geom = tgeometry.BlockGeometry(64, 128, 256, 1, 1, False,
                                   tgeometry.SEW.E8, tgeometry.SEW.E32,
                                   "mte")
    assert tgeometry.grouped_engine(torch.int8, c, n_, k,
                                    tile=(64, 128)) == "wgmma"
    got = tgrouped.grouped_gemm_kernel(t(x), t(w), geom=geom,
                                       out_dtype=torch.int32, widths=widths)
    want = np.einsum("gck,gkn->gcn", x.astype(np.int64), w.astype(np.int64))
    for i, wd in enumerate(widths):
        want[i, :, wd:] = 0
    np.testing.assert_array_equal(got.numpy(), want)
