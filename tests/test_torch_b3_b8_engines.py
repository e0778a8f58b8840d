"""B8's f32 stage 1 and B3 past 16 rows on the Hopper mainloops: the
engine rules (``geometry.gemm_engine`` under the rigid route,
``geometry.grouped_engine`` at a plan's tile), the tiles
``check_kernel_tile`` accepts and ``autotune.enumerate_candidates``
offers and their price, the rigid route's price on the SIMT engine, the
grouped GEMM
through ``ops`` at 64 rows against JAX's Pallas kernel (interpret mode),
and gemma_2b's loss and gradients under ``gemm_policy="amx"`` against
JAX's kernel path.  On the CPU the wrappers run their plain versions; the
CUDA kernels against those are in test_torch_cuda.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.epilogue import Epilogue as JEpilogue
from repro.core.geometry import BlockGeometry as JGeom
from repro.core.tile_state import SEW as JSEW
from repro.kernels.grouped_gemm import grouped_gemm_pallas
from repro.models import model as jax_model

from torch_lazy import LazyModule, torch
from torch_parity import n, t
from test_torch_training import (_as_port, _assert_trees, _batch, _cfgs,
                                 _jbatch, _params, _tbatch)

tautotune = LazyModule("repro_torch.core.autotune")
tepilogue = LazyModule("repro_torch.core.epilogue")
tgeometry = LazyModule("repro_torch.core.geometry")
tops = LazyModule("repro_torch.kernels.ops")
ttrainer = LazyModule("repro_torch.training.trainer")

WGMMA = [(64, 64), (64, 128), (64, 256), (128, 64), (128, 128), (128, 256)]
SIMT = [(128, 128), (128, 64)]
LOOP = [(16, 128), (64, 64)]

RNG = np.random.default_rng(28)


@pytest.fixture(autouse=True)
def fresh_cache():
    tautotune.reset_cache(profile=tautotune.H100_SPEC)
    yield
    tautotune.reset_cache()


# -- the engine rules ---------------------------------------------------------

@pytest.mark.parametrize("dtype,m,n_,k,want", [
    ("float32", 4, 2048, 2048, "simt"),      # decode rows: padded to 128
    ("float32", 16, 256, 128, "simt"),       # the reduced amx model
    ("float32", 4096, 16384, 2048, "simt"),  # the training backward
    ("float32", 1, 4, 4, "simt"),
    ("float32", 16, 258, 128, "tile"),       # N not a multiple of 4
    ("float32", 16, 256, 130, "tile"),       # K not a multiple of 4
    ("int8", 4096, 2048, 2048, "wgmma"),     # the s8 path, every M
    ("int8", 4096, 2048, 2040, "tile"),      # K not a multiple of 16
    ("int8", 4, 2052, 2048, "tile"),         # N not a multiple of 8
    ("bfloat16", 4, 2048, 2048, "wgmma"),
    ("bfloat16", 4, 2052, 2048, "tile"),     # N not a multiple of 8
])
def test_rigid_route_takes_the_simt_engine_at_every_m(dtype, m, n_, k,
                                                      want):
    assert tgeometry.gemm_engine(getattr(torch, dtype), 128, 128, n_, k,
                                 m=m, rigid=True) == want
    # B1 keeps its rule: no SIMT launch at M <= 16 (its decode rows stay
    # on the tile loop's 16 x 128 tile, where no 128 x 128 one runs).
    if dtype == "float32" and want == "simt":
        if m > 16:
            assert tgeometry.gemm_engine(torch.float32, 128, 128, n_, k,
                                         m=m) == "simt"
        else:
            with pytest.raises(ValueError, match="GEMM engine"):
                tgeometry.gemm_engine(torch.float32, 128, 128, n_, k, m=m)


@pytest.mark.parametrize("dtype,m,n_,k,bf16acc,tile,want", [
    # split-K: bf16 at C <= 16, whatever the tile
    ("bfloat16", 16, 2048, 2048, False, (16, 128), "splitk"),
    ("bfloat16", 16, 2048, 2048, False, (128, 128), "splitk"),
    ("bfloat16", 16, 2048, 2048, True, (64, 64), "splitk"),
    # wgmma: bf16 past 16 rows at a wgmma tile, K and N multiples of 8
    ("bfloat16", 17, 2048, 2048, False, (64, 64), "wgmma"),
    ("bfloat16", 512, 16384, 2048, False, (128, 256), "wgmma"),
    ("bfloat16", 512, 2560, 2560, True, (128, 128), "wgmma"),
    ("bfloat16", 512, 2560, 2560, True, (128, 256), "tile"),   # bf16acc
    ("bfloat16", 512, 2052, 2048, False, (128, 128), "tile"),  # N % 8
    ("bfloat16", 512, 2048, 2044, False, (128, 128), "tile"),  # K % 8
    ("bfloat16", 512, 2048, 2048, False, (16, 128), "tile"),   # loop tile
    ("bfloat16", 512, 2048, 2048, False, None, "tile"),        # no tile
    # simt: f32 past 16 rows at a SIMT tile, K and N multiples of 4
    ("float32", 17, 2048, 2048, False, (128, 128), "simt"),
    ("float32", 2048, 16384, 4096, False, (128, 64), "simt"),
    ("float32", 16, 2048, 2048, False, (128, 128), "tile"),    # C <= 16
    ("float32", 512, 2050, 2048, False, (128, 128), "tile"),   # N % 4
    ("float32", 512, 2048, 2046, False, (128, 128), "tile"),   # K % 4
    ("float32", 512, 2048, 2048, False, (64, 64), "tile"),     # loop tile
    ("float32", 512, 2048, 2048, False, (128, 256), "tile"),
    # int8: the s8 wgmma engine past 16 rows at a wgmma tile, K a
    # multiple of 16 and N of 8; the split-K engine's s8 entry at C <= 16
    # with N a multiple of 16; else the tile loop
    ("int8", 512, 2048, 2048, False, (128, 128), "wgmma"),
    ("int8", 17, 512, 1024, False, (64, 64), "wgmma"),
    ("int8", 512, 2048, 2040, False, (128, 128), "tile"),      # K % 16
    ("int8", 512, 2052, 2048, False, (128, 128), "tile"),      # N % 8
    ("int8", 512, 2048, 2048, False, (16, 128), "tile"),       # loop tile
    ("int8", 16, 2048, 2048, False, (128, 128), "splitk"),     # C <= 16
    ("int8", 4, 2048, 2048, False, (16, 128), "splitk"),
    ("int8", 4, 2056, 2048, False, (16, 128), "tile"),         # N % 16
])
def test_grouped_engine_names_each_engine(dtype, m, n_, k, bf16acc, tile,
                                          want):
    assert tgeometry.grouped_engine(getattr(torch, dtype), m, n_, k,
                                    bf16acc=bf16acc, tile=tile) == want


def _geom(tile, split=1):
    sew = tgeometry.SEW.E32
    return tgeometry.BlockGeometry(*tile, 64, split, 1, False, sew, sew,
                                   "mte")


@pytest.mark.parametrize("tile", WGMMA + SIMT + LOOP,
                         ids=lambda t_: f"{t_[0]}x{t_[1]}")
@pytest.mark.parametrize("group", [2, 3, 32])
def test_check_kernel_tile_accepts_the_group_tiles(tile, group):
    """Every wgmma and SIMT tile unsplit in a group; a split only on the
    tile loop's tiles (B3 takes no split of the pipelined engines)."""
    tgeometry.check_kernel_tile(_geom(tile), group)
    if tile in LOOP:
        tgeometry.check_kernel_tile(_geom(tile, 4), group)
    else:
        with pytest.raises(ValueError, match="no 'mte'"):
            tgeometry.check_kernel_tile(_geom(tile, 4), group)


def _sig(m, n_, k, fmt, group):
    dt = {"bf16": "bfloat16", "bf16acc": "bfloat16", "fp32": "float32",
          "int8": "int8"}[fmt]
    out = "int32" if fmt == "int8" else dt
    return tautotune.GemmSignature.make(m, n_, k, dt, out, group=group,
                                        fmt=fmt)


@pytest.mark.parametrize("m,n_,k,fmt,want", [
    (64, 2048, 2048, "bf16", set(WGMMA)),
    (512, 16384, 2048, "bf16", set(WGMMA)),
    (512, 2560, 2560, "bf16acc", set(WGMMA) - {(64, 256), (128, 256)}),
    (63, 2048, 2048, "bf16", {(64, 64)}),      # the base tile alone
    (16, 2048, 2048, "bf16", set()),           # the decode group
    (512, 2052, 2048, "bf16", set()),          # N not a multiple of 8
    (17, 6144, 2048, "fp32", {(128, 128)}),    # 3 x 48 tiles fill 132 SMs
    (17, 2048, 2048, "fp32", set(SIMT)),       # 3 x 16 tiles do not
    (2048, 16384, 4096, "fp32", {(128, 128)}),
    (16, 2048, 2048, "fp32", set()),           # C <= 16
    (512, 2048, 2046, "fp32", set()),          # K not a multiple of 4
    (512, 2048, 2048, "int8", set(WGMMA)),    # the s8 engine
    (512, 2048, 2040, "int8", set()),         # K not a multiple of 16
    (16, 2048, 2048, "int8", set()),          # C <= 16
])
def test_grouped_candidates_only_where_the_engines_take_them(m, n_, k, fmt,
                                                             want):
    sig = _sig(m, n_, k, fmt, group=3)
    cands = tautotune.enumerate_candidates(sig, tgeometry.H100_SPEC)
    assert all(g.split_k == 1 for g in cands)
    assert (cands[0].bm, cands[0].bn) in LOOP
    offered = {(g.bm, g.bn) for g in cands
               if tautotune.plan_engine(sig, g) in ("wgmma", "simt")}
    assert offered == want
    assert {(g.bm, g.bn) for g in cands[1:]} <= want


@pytest.mark.parametrize("m,n_,k,fmt,tile", [
    (512, 16384, 2048, "bf16", (128, 256)),
    (512, 2560, 2560, "bf16acc", (128, 128)),
    (2048, 16384, 4096, "fp32", (128, 128)),
])
def test_grouped_plans_keep_the_tile_loops_price(m, n_, k, fmt, tile):
    """A grouped plan on the wgmma or SIMT engine is priced as the tile
    loop is (the scheduler weighs grouped programs with these prices):
    the load stretch (``blocks_per_sm``) moves it, the L2 rate of the
    pipelined engines' model does not."""
    spec = tgeometry.H100_SPEC
    sig = _sig(m, n_, k, fmt, group=2)
    g = dataclasses.replace(_geom(tile), bk=256)
    assert tautotune.plan_engine(sig, g) in ("wgmma", "simt")
    price = tautotune.score_geometry(sig, g, spec)
    assert price == tautotune.score_geometry(
        sig, g, dataclasses.replace(spec, l2_bw_bytes_per_s=1e12))
    assert price < tautotune.score_geometry(
        sig, g, dataclasses.replace(spec, blocks_per_sm=64))


def test_rigid_simt_price_charges_the_round_trip_and_the_pass():
    """The rigid route on the SIMT engine pays the accumulator's write and
    read back (8 bytes an output) and, with an activation, the epilogue
    pass's launch, as on the wgmma engine: where device memory bounds the
    GEMM (K = 4), amx costs exactly those bytes more than mte at the same
    tile, and the gelu one launch more than the identity."""
    spec = tgeometry.H100_SPEC
    m, n_, k = 4096, 4096, 4
    geom = dataclasses.replace(_geom((128, 128)), bk=128)
    mte = tautotune.GemmSignature.make(m, n_, k, "float32", "float32")
    amx = tautotune.GemmSignature.make(m, n_, k, "float32", "float32",
                                       policy="amx")
    gelu = tautotune.GemmSignature.make(
        m, n_, k, "float32", "float32",
        tepilogue.Epilogue(activation="gelu"), policy="amx")
    rigid = dataclasses.replace(geom, policy="amx")
    for sig, g_ in ((mte, geom), (amx, rigid), (gelu, rigid)):
        assert tautotune.plan_engine(sig, g_) == "simt"
    base = tautotune.score_geometry(mte, geom, spec)
    price = tautotune.score_geometry(amx, rigid, spec)
    assert price - base == pytest.approx(
        2.0 * m * n_ * 4 / spec.hbm_bw_bytes_per_s)
    assert tautotune.score_geometry(gelu, rigid, spec) - price == \
        pytest.approx(spec.launch_s)
    plan = tautotune.get_plan(m, n_, k, torch.float32, policy="amx")
    assert plan.predicted_s == pytest.approx(price)


# -- the grouped GEMM at 64 rows against JAX ----------------------------------

@pytest.mark.parametrize("fmt,engine", [("fp32", "tile"),
                                        ("bf16", "wgmma"),
                                        ("bf16acc", "wgmma")])
def test_ops_grouped_gemm_at_64_rows_matches_pallas(fmt, engine):
    """``ops.grouped_gemm`` at C = 64, where the plan takes a tile of the
    wgmma engine (bf16, bf16acc) or, in f32, the tile loop's (at the tile
    loop's price a 128-row SIMT tile pads 64 rows to 128), against JAX's
    grouped kernel in interpret mode at the plan's K block, within
    test_torch_grouped_rigid.py's tolerances: fp32 and bf16 into an f32
    accumulator 1e-5, bf16acc 1e-2 (a partial on a bf16 rounding tie can
    land one ulp apart)."""
    g, c, k, n_ = 3, 64, 136, 264
    x = (RNG.standard_normal((g, c, k)) / np.sqrt(k)).astype(np.float32)
    w = RNG.standard_normal((g, k, n_)).astype(np.float32)
    epi = JEpilogue(alpha=0.5, activation="gelu")
    sig = _sig(c, n_, k, fmt, group=g)
    sig = dataclasses.replace(sig, dtype_out="float32",
                              epilogue=tepilogue.Epilogue(
                                  **dataclasses.asdict(epi)))
    plan = tautotune.plan_cache().plan(sig)
    assert tautotune.plan_engine(sig, plan.geometry) == engine
    got = tops.grouped_gemm(t(x), t(w), epilogue=sig.epilogue,
                            format_policy=fmt)
    jg = JGeom(bm=64, bn=128, bk=plan.geometry.bk, split_k=1, n_acc=1,
               transposed_b=False,
               sew_i=JSEW.E32 if fmt == "fp32" else JSEW.E16,
               sew_o=JSEW.E32, policy="mte")
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    if fmt != "fp32":
        xj, wj = xj.astype(jnp.bfloat16), wj.astype(jnp.bfloat16)
    want = grouped_gemm_pallas(
        xj, wj, geom=jg, epilogue=epi,
        acc_dtype=jnp.bfloat16 if fmt == "bf16acc" else None,
        interpret=True)
    tol = 1e-2 if fmt == "bf16acc" else 1e-5
    np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol)


# -- training under the rigid baseline ------------------------------------

def test_loss_and_grads_match_jax_gemma_amx():
    """gemma_2b reduced, remat full, under ``gemm_policy="amx"`` on both
    sides (the port: B8 in every forward and backward GEMM, on the CPU
    its plain versions).  JAX's kernel path runs the rigid forward
    (``rigid_gemm_pallas`` in interpret mode): the loss within 2e-3.  Its
    amx forward calls the Pallas kernel outside its custom VJP
    (``kernels/ops.py:72-97`` there), so JAX cannot differentiate it; the
    gradients are held to JAX's ``xla`` path, which computes the same
    function: the loss within 1e-5 relative, each leaf within 1e-4
    relative Frobenius error."""
    jcfg, tcfg = _cfgs("gemma_2b", "xla", gemm_policy="amx")
    tcfg = dataclasses.replace(tcfg, remat="full")
    jp, tp = _params(jcfg, tcfg, 2)
    batch = _batch(tcfg, batch=1, seq=16)
    tm, tg = ttrainer.loss_and_grads(tp, _tbatch(batch), tcfg)
    tl = float(tm["loss"])
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, _jbatch(batch), jcfg),
        has_aux=True)(jp)
    assert abs(tl - float(jl)) <= 1e-5 * abs(float(jl))
    _assert_trees(tg, _as_port(jg, tcfg), 1e-4)
    pcfg = dataclasses.replace(jcfg, gemm_backend="pallas")
    pl, _ = jax_model.loss_fn(jp, _jbatch(batch), pcfg)
    assert abs(tl - float(pl)) <= 2e-3 * abs(float(pl))
