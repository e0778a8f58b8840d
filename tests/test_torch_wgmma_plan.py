"""The plan cache and the engine choice of the port's B1 and B8 stage 1
(``repro_torch.core.geometry.gemm_engine``): which shapes are offered the
wgmma tiles, how they are priced, which tiles are compiled, and the JAX
package's results through them (plain versions on the CPU; the kernels
themselves are held in test_torch_cuda.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as jops

from torch_lazy import LazyModule, torch
from torch_parity import TOL, n, t

# The port, imported at first use (see torch_lazy).
tautotune = LazyModule("repro_torch.core.autotune")
tepilogue = LazyModule("repro_torch.core.epilogue")
tgeometry = LazyModule("repro_torch.core.geometry")
tgemm = LazyModule("repro_torch.kernels.mte_gemm")
tops = LazyModule("repro_torch.kernels.ops")
tschedule = LazyModule("repro_torch.graph.schedule")
ttrace = LazyModule("repro_torch.graph.trace")

WGMMA = [(64, 64), (64, 128), (64, 256), (128, 64), (128, 128), (128, 256)]
LOOP = [(16, 128), (64, 64)]
SIMT = [(128, 128), (128, 64)]


def _sig(m, n_, k, fmt="bf16", policy="mte", group=1):
    dt = {"bf16": "bfloat16", "bf16acc": "bfloat16", "fp32": "float32",
          "int8": "int8"}[fmt]
    out = "int32" if fmt == "int8" else dt
    return tautotune.GemmSignature.make(m, n_, k, dt, out, policy=policy,
                                        group=group, fmt=fmt)


def _tiles(sig):
    return {(g.bm, g.bn) for g in
            tautotune.enumerate_candidates(sig, tgeometry.H100_SPEC)
            if g.split_k == 1}


@pytest.mark.parametrize("m,n_,k,fmt,offered", [
    (512, 16384, 2048, "bf16", True),
    (512, 2048, 16384, "bf16", True),
    (64, 64, 64, "bf16", True),
    (520, 2056, 1032, "bf16", True),
    (512, 2048, 2048, "bf16acc", True),
    (63, 2048, 2048, "bf16", False),      # below one 64-row MMA
    (4, 16384, 2048, "bf16", False),      # decode: split-K's shapes
    (512, 2050, 2048, "bf16", False),     # N not a multiple of 8
    (512, 2048, 2044, "bf16", False),     # K not a multiple of 8
    (512, 2048, 2048, "fp32", False),     # f32 gets the SIMT engine's
    (512, 2048, 2048, "int8", True),      # s8: B copied K-major
    (512, 2048, 2040, "int8", False),     # int8: K not a multiple of 16
    (63, 2048, 2048, "int8", False),      # below one 64-row MMA
])
def test_wgmma_tiles_offered_only_where_the_engine_runs(m, n_, k, fmt,
                                                        offered):
    tiles = _tiles(_sig(m, n_, k, fmt))
    wg = tiles - set(LOOP)
    if offered:
        want = set(WGMMA) - ({(64, 256), (128, 256)} if fmt == "bf16acc"
                             else set())
        assert tiles == want
        if fmt == "int8":
            sig = _sig(m, n_, k, fmt)
            assert all(tautotune.plan_engine(sig, g) == "wgmma" for g in
                       tautotune.enumerate_candidates(sig,
                                                      tgeometry.H100_SPEC)
                       if g.split_k == 1)
    else:
        # No wgmma tile; f32 past 16 rows gets the SIMT engine's tiles
        # (128 x 64 too: 128 x 128 makes 64 tiles here).
        simt = set(SIMT) if fmt == "fp32" else set()
        assert wg == simt and tiles <= set(LOOP) | simt


@pytest.mark.parametrize("m,n_,k", [(512, 256, 2048), (128, 64, 4096)])
def test_split_k_candidates_stay_on_the_tile_loop(m, n_, k):
    """Split-K derives from the solver's base tile: B2 never gets a
    wgmma tile, and a grouped signature no split (past 64 rows it gets
    the wgmma tiles, unsplit, as B1 does)."""
    sig = _sig(m, n_, k)
    cands = tautotune.enumerate_candidates(sig, tgeometry.H100_SPEC)
    splits = [g for g in cands if g.split_k > 1]
    assert splits and all((g.bm, g.bn) in LOOP for g in splits)
    grouped = tautotune.enumerate_candidates(_sig(m, n_, k, group=3),
                                             tgeometry.H100_SPEC)
    assert all(g.split_k == 1 for g in grouped)
    assert (grouped[0].bm, grouped[0].bn) == (64, 64)
    assert {(g.bm, g.bn) for g in grouped} == set(WGMMA)


@pytest.mark.parametrize("bm,bn", WGMMA + LOOP)
def test_every_compiled_tile_fits_shared_memory(bm, bn):
    sew = tgeometry.SEW.E16
    g = tgeometry.BlockGeometry(bm, bn, 256, 1, 1, False, sew, sew, "mte")
    engines = ["tile"] if (bm, bn) not in WGMMA else ["wgmma"]
    engines += ["tile"] if (bm, bn) in LOOP else []
    for engine in engines:
        assert g.smem_bytes(engine) <= 227 * 1024, engine
    if (bm, bn) in WGMMA:
        stages = tgeometry.wgmma_stages(bm, bn)
        assert 3 <= stages <= 5
        assert g.smem_bytes("wgmma") == (
            1024 + stages * (bm + bn) * 64 * 2 + 16 * stages)


def test_check_kernel_tile_accepts_exactly_the_compiled_set():
    sew = tgeometry.SEW.E16
    for bm in (8, 16, 32, 64, 128, 256):
        for bn in (32, 64, 128, 256, 512):
            for split in (1, 4):
                for group in (1, 3):
                    g = tgeometry.BlockGeometry(bm, bn, 64, split, 1, False,
                                                sew, sew, "mte")
                    ok = (bm, bn) in LOOP or (
                        (bm, bn) in WGMMA and split == 1) or (
                        (bm, bn) in SIMT and (group == 1 or split == 1))
                    if ok:
                        tgeometry.check_kernel_tile(g, group)
                    else:
                        with pytest.raises(ValueError, match="no 'mte'"):
                            tgeometry.check_kernel_tile(g, group)
            rigid = tgeometry.BlockGeometry(bm, bn, 128, 1, 1, False, sew,
                                            sew, "amx")
            if (bm, bn) == (128, 128):
                tgeometry.check_kernel_tile(rigid)
            else:
                with pytest.raises(ValueError, match="no 'amx'"):
                    tgeometry.check_kernel_tile(rigid)


@pytest.mark.parametrize("dtype,bm,bn,n_,k,bf16acc,rigid,want", [
    ("bfloat16", 128, 256, 16384, 2048, False, False, "wgmma"),
    ("bfloat16", 64, 64, 2048, 2048, False, False, "wgmma"),
    ("bfloat16", 128, 128, 2048, 2048, True, False, "wgmma"),
    ("bfloat16", 64, 64, 70, 130, False, False, "tile"),     # unaligned
    ("bfloat16", 16, 128, 2048, 2048, False, False, "tile"),  # M <= 16
    ("bfloat16", 64, 64, 2048, 2048, True, False, "wgmma"),
    ("float32", 64, 64, 2048, 2048, False, False, "tile"),
    ("int8", 64, 64, 2048, 2048, False, False, "wgmma"),     # s8
    ("int8", 128, 256, 2048, 2048, False, False, "wgmma"),
    ("int8", 64, 64, 2048, 2040, False, False, "tile"),      # K % 16
    ("int8", 64, 64, 2044, 2048, False, False, "tile"),      # N % 8
    ("int8", 16, 128, 2048, 2048, False, False, "tile"),     # M <= 16
    ("int8", 128, 128, 2048, 2040, False, False, None),      # K % 16
    ("bfloat16", 128, 256, 2048, 2048, True, False, None),    # bf16acc
    ("bfloat16", 128, 128, 2048, 2044, False, False, None),   # K % 8
    ("float32", 128, 256, 2048, 2048, False, False, None),
    ("bfloat16", 32, 64, 2048, 2048, False, False, None),
    ("bfloat16", 128, 128, 16384, 2048, False, True, "wgmma"),
    ("bfloat16", 128, 128, 300, 1000, False, True, "tile"),
    ("float32", 128, 128, 2048, 2048, False, True, "simt"),
    ("int8", 128, 128, 2048, 2048, False, True, "wgmma"),    # s8, rigid
    ("int8", 128, 128, 2048, 2040, False, True, "tile"),     # K % 16
    ("int8", 128, 128, 2044, 2048, False, True, "tile"),     # N % 8
    ("bfloat16", 64, 64, 2048, 2048, False, True, None),
])
def test_gemm_engine_table(dtype, bm, bn, n_, k, bf16acc, rigid, want):
    call = lambda: tgeometry.gemm_engine(  # noqa: E731
        getattr(torch, dtype), bm, bn, n_, k, m=16 if bm == 16 else 512,
        bf16acc=bf16acc, rigid=rigid)
    if want is None:
        with pytest.raises(ValueError, match="GEMM engine"):
            call()
    else:
        assert call() == want


@pytest.mark.parametrize("m,n_,k", [(512, 16384, 2048), (520, 2056, 1032),
                                    (64, 64, 64), (512, 2048, 16384)])
def test_bf16acc_never_gets_bn_256(m, n_, k):
    cache = tautotune.PlanCache(profile=tgeometry.H100_SPEC)
    sig = _sig(m, n_, k, "bf16acc")
    assert all(g.bn <= 128 for g in
               tautotune.enumerate_candidates(sig, tgeometry.H100_SPEC))
    assert cache.plan(sig).geometry.bn <= 128


@pytest.mark.parametrize("m,n_,k,fmt", [
    (4, 2048, 2048, "bf16"), (512, 16384, 2048, "bf16"),
    (512, 2048, 16384, "bf16acc"), (7, 9, 13, "fp32"),
    (520, 2056, 1032, "int8")])
def test_rigid_policy_still_returns_exactly_its_tile(m, n_, k, fmt):
    cache = tautotune.PlanCache(profile=tgeometry.H100_SPEC)
    plan = cache.plan(_sig(m, n_, k, fmt, policy="amx"))
    g = plan.geometry
    assert plan.route == "rigid"
    assert (g.bm, g.bn, g.bk, g.split_k) == (128, 128, 128, 1)


def test_the_load_stretch_prices_only_the_tile_loop():
    """``blocks_per_sm`` models the tile loop's missing load pipeline: it
    moves the price of a tile-loop plan and leaves a wgmma plan's."""
    spec = tgeometry.H100_SPEC
    deep = dataclasses.replace(spec, blocks_per_sm=16)
    sig = _sig(512, 2048, 2048)
    sew = tgeometry.SEW.E16
    wg = tgeometry.BlockGeometry(128, 128, 256, 1, 1, False, sew, sew, "mte")
    assert tautotune.plan_engine(sig, wg) == "wgmma"
    assert tautotune.score_geometry(sig, wg, spec) == \
        tautotune.score_geometry(sig, wg, deep)
    f32 = _sig(512, 2048, 2048, "fp32")
    loop = dataclasses.replace(wg, bm=64, bn=64)
    assert tautotune.plan_engine(f32, loop) == "tile"
    assert tautotune.score_geometry(f32, loop, spec) < \
        tautotune.score_geometry(f32, loop, deep)


@pytest.mark.parametrize("m,n_,k,tile", [
    (512, 16384, 2048, (128, 256)),       # the gate/up projections
    (512, 2048, 16384, (64, 128)),        # down: 128 blocks, one wave
    (512, 2048, 2048, (64, 128)),         # q/o: 64 tiles at 128 x 128
])
def test_prefill_projections_plan_wgmma_tiles_on_b1(m, n_, k, tile):
    """The tile follows the shape: full-width gemma_2b prefill GEMMs stay
    on the mte route (B1) and get the tile whose waves and operand traffic
    price lowest."""
    cache = tautotune.PlanCache(profile=tgeometry.H100_SPEC)
    plan = cache.plan(_sig(m, n_, k))
    assert plan.route == "mte"
    assert (plan.geometry.bm, plan.geometry.bn) == tile
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "wgmma"


@pytest.mark.parametrize("m,n_,k", [(128, 136, 200), (192, 264, 72)])
def test_bf16_through_a_wgmma_plan_matches_jax(m, n_, k):
    """bf16 GEMMs whose plan runs on the wgmma engine give JAX's result
    (plain version here; the tile does not change the f32-accumulated
    arithmetic)."""
    rng = np.random.default_rng(m)
    a = (rng.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal((k, n_)).astype(np.float32)
    bias = rng.standard_normal(n_).astype(np.float32)
    from repro.core.epilogue import Epilogue as JEpilogue
    jepi = JEpilogue(has_bias=True, activation="gelu")
    epi = tepilogue.Epilogue(has_bias=True, activation="gelu")
    tautotune.reset_cache()
    plan = tautotune.get_plan(m, n_, k, torch.bfloat16, torch.float32,
                              epilogue=epi, fmt="bf16")
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "wgmma"
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b),
                         bias=jnp.asarray(bias), epilogue=jepi,
                         format_policy="bf16")
    got = tops.mte_gemm(t(a), t(b), bias=t(bias), epilogue=epi,
                        format_policy="bf16")
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["bf16"],
                               atol=TOL["bf16"])


def test_pinned_tile_no_engine_takes_raises_on_the_cpu_too():
    a, b = torch.zeros(128, 64), torch.zeros(64, 256)
    sew = tgeometry.SEW.E32
    big = tgeometry.BlockGeometry(128, 256, 64, 1, 1, False, sew, sew, "mte")
    with pytest.raises(ValueError, match="no mte GEMM engine"):
        tops.mte_gemm(a, b, geometry=big)
    with pytest.raises(ValueError, match="no mte GEMM engine"):
        tgemm.mte_gemm_kernel(a, b, geom=big)
    assert tops.mte_gemm(a, b, format_policy="bf16",
                         geometry=big).shape == (128, 256)


def test_tile_stabilization_skips_a_tile_one_node_cannot_run(monkeypatch):
    """A chain of bf16 GEMMs where one node's N is not a multiple of 8:
    the wgmma tile granted to the aligned node is no candidate for the
    chain, so the shared geometry is the one both nodes' engines take."""
    b = ttrace.GraphBuilder()
    x = b.input((512, 2048), "bfloat16")
    w1 = b.input((2048, 16384), "bfloat16")
    w2 = b.input((16384, 2050), "bfloat16")
    b.output(b.gemm(b.gemm(x, w1, fmt="bf16", out_dtype="bfloat16"), w2,
                    fmt="bf16", out_dtype="bfloat16"))
    g = b.build()
    cache = tautotune.PlanCache(profile=tgeometry.H100_SPEC)
    plans = {i: cache.plan(tschedule._node_signature(g, g.nodes[i]))
             for i in g.kernel_nodes()}
    first, second = (plans[i] for i in g.kernel_nodes())
    assert tautotune.plan_engine(first.signature, first.geometry) == "wgmma"
    assert (first.geometry.bm, first.geometry.bn) not in LOOP
    assert second.route == "mte"
    assert tautotune.plan_engine(second.signature, second.geometry) == "tile"
    monkeypatch.setattr("repro_torch.graph.schedule.RECONFIG_S", 1.0)
    stab = tschedule._stabilize_tiles(g, plans, cache.profile)
    shared = {stab[i].geometry for i in g.kernel_nodes()}
    assert shared == {second.geometry}
    assert tautotune.plan_engine(first.signature,
                                 second.geometry) == "wgmma"
