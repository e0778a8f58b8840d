"""The port's ``core/conv.py`` against the JAX package's, and the plans
the paper's convolutions get (``dispatch.mte_gemm`` against JAX's is in
``test_torch_core_isa.py``).

Backends map as the port names them: the port's ``"kernels"`` (the plain
versions on the CPU) against JAX's ``"pallas"`` (interpret mode), its
``"torch"`` against JAX's ``"xla"``, ``"reference"`` against
``"reference"``; in fp32 (1e-5), bf16 (2e-2) and int8 (the quantized
operands and their int32 sums exactly equal; outputs 1e-5, the f32 sum
over a convolution's offsets being taken in another order).  Inputs are
numpy arrays from a seed.  The convolution cases are
``tests/test_substrates.py:237-240`` and its fused-epilogue case
(``:258-272``).  The plans: one plan-cache entry per convolution shape
and format (JAX's contract, ``tests/test_formats.py:347-356``), and at
the suite's full size (chip_smoke.py's list, checked against
``benchmarks/workloads.py``) every aligned layer planned onto a B3
engine, only the unaligned ones onto the tile loop, within its grid."""
import dataclasses
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import autotune as jautotune
from repro.core import conv as jconv
from repro.core import formats as jformats
from repro.core.epilogue import Epilogue as JEpilogue
from repro.kernels import ref as jref

from torch_lazy import LazyModule, torch
from torch_parity import n, t

tautotune = LazyModule("repro_torch.core.autotune")
tconv = LazyModule("repro_torch.core.conv")
tdispatch = LazyModule("repro_torch.core.dispatch")
tepilogue = LazyModule("repro_torch.core.epilogue")
tformats = LazyModule("repro_torch.core.formats")
tgeometry = LazyModule("repro_torch.core.geometry")
tref = LazyModule("repro_torch.kernels.ref")

ROOT = pathlib.Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(34)
FMTS = ["fp32", "bf16", "int8"]
TOL = {"fp32": 1e-5, "bf16": 2e-2, "int8": 1e-5}
# (port backend, JAX backend).
PAIRS = [("kernels", "pallas"), ("torch", "xla"),
         ("reference", "reference")]
CONV_SPECS = [
    jconv.ConvSpec("pointwise", 2, 8, 8, 16, 32, 1, 1),
    jconv.ConvSpec("spatial3x3", 2, 9, 9, 8, 16, 3, 3, stride=1, pad=1),
    jconv.ConvSpec("strided", 1, 12, 12, 4, 8, 3, 3, stride=2, pad=1),
    jconv.ConvSpec("nonsquare", 1, 10, 8, 4, 8, 1, 3, stride=1, pad=0),
]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod      # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def fresh_caches():
    tautotune.reset_cache(profile=tautotune.H100_SPEC)
    jautotune.reset_cache()
    yield
    tautotune.reset_cache()
    jautotune.reset_cache()


def _t_epi(kw):
    return tepilogue.Epilogue(**kw)


# -- conv.conv2d_direct ----------------------------------------------------------

def _conv_inputs(spec):
    x = RNG.standard_normal((spec.n, spec.h, spec.w, spec.ic)).astype(
        np.float32)
    w = RNG.standard_normal((spec.kh, spec.kw, spec.ic, spec.oc)).astype(
        np.float32)
    return x, w


def _convs(x, w, pair, fmt, **kw):
    pb, jb = pair
    got = tconv.conv2d_direct(t(x), t(w), backend=pb, format_policy=fmt,
                              **{k: (t(v) if isinstance(v, np.ndarray)
                                     else v) for k, v in kw.items()
                                 if k != "epilogue"},
                              epilogue=_t_epi(kw.get("epilogue", {})))
    want = jconv.conv2d_direct(
        jnp.asarray(x), jnp.asarray(w), backend=jb, format_policy=fmt,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items() if k != "epilogue"},
        epilogue=JEpilogue(**kw.get("epilogue", {})))
    return got, want


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("spec", CONV_SPECS, ids=[s.name for s in CONV_SPECS])
def test_conv2d_direct_matches_jax(pair, fmt, spec):
    x, w = _conv_inputs(spec)
    got, want = _convs(x, w, pair, fmt, stride=spec.stride, pad=spec.pad)
    assert tuple(got.shape) == tuple(want.shape) == (
        spec.n, spec.oh, spec.ow, spec.oc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=TOL[fmt], atol=TOL[fmt])
    m, n_, k = tconv.conv_gemm_dims(tconv.ConvSpec(
        spec.name, spec.n, spec.h, spec.w, spec.ic, spec.oc, spec.kh,
        spec.kw, spec.stride, spec.pad))
    assert (m, n_, k) == jconv.conv_gemm_dims(spec)


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("fmt", FMTS)
def test_conv2d_direct_fused_epilogue_matches_jax(pair, fmt):
    x = RNG.standard_normal((1, 6, 6, 4)).astype(np.float32)
    w = RNG.standard_normal((3, 3, 4, 8)).astype(np.float32)
    bias = RNG.standard_normal(8).astype(np.float32)
    got, want = _convs(x, w, pair, fmt, bias=bias, pad=1,
                       epilogue=dict(has_bias=True, activation="relu"))
    np.testing.assert_allclose(n(got), n(want), rtol=TOL[fmt], atol=TOL[fmt])
    if fmt == "fp32":
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        np.testing.assert_allclose(n(got), np.maximum(n(ref) + bias, 0.0),
                                   rtol=2e-4, atol=2e-4)


def _jax_windows(x, spec):
    """The JAX package's stacking (``core/conv.py:110-122`` there)."""
    x = jnp.pad(x, ((0, 0), (spec.pad, spec.pad), (spec.pad, spec.pad),
                    (0, 0)))
    return jnp.stack([
        x[:, i:i + spec.stride * spec.oh:spec.stride,
          j:j + spec.stride * spec.ow:spec.stride, :]
        .reshape(spec.n * spec.oh * spec.ow, spec.ic)
        for i in range(spec.kh) for j in range(spec.kw)])


@pytest.mark.parametrize("spec", CONV_SPECS, ids=[s.name for s in CONV_SPECS])
def test_int8_windows_scales_and_sums_equal_jax(spec):
    """The stacked windows equal JAX's stack, and under int8 the
    per-offset-group quantized operands, their scales and the int32
    partial sums (G, M, OC) are exactly JAX's."""
    x, w = _conv_inputs(spec)
    xg = tconv.stack_windows(t(x), spec.kh, spec.kw, spec.stride, spec.pad)
    jxg = _jax_windows(jnp.asarray(x), spec)
    np.testing.assert_array_equal(n(xg), n(jxg))
    g = spec.kh * spec.kw
    wg = w.reshape(g, spec.ic, spec.oc)
    q = tformats.quantize_operands(xg, t(wg), tformats.INT8)
    jq = jformats.quantize_operands(jxg, jnp.asarray(wg), jformats.INT8)
    for mine, theirs in zip(q, jq):
        np.testing.assert_array_equal(n(mine), n(theirs))
    sums = tref.grouped_gemm(q[0], q[1], out_dtype=torch.int32)
    jsums = jref.grouped_gemm(jq[0], jq[1], out_dtype=jnp.int32)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))


def test_conv_plans_once_per_shape_and_format():
    """One plan-cache entry per (shape, format), repeat calls hits (JAX's
    ``test_formats.py:347-356``); a 1 x 1 convolution (one member) plans
    as its plain GEMM, as in JAX, and still runs the grouped route."""
    cache = tautotune.plan_cache()
    x = torch.randn(1, 8, 8, 8)
    w = torch.randn(3, 3, 8, 16)
    tconv.conv2d_direct(x, w, backend="kernels")
    assert len(cache) == 1 and cache.stats.misses == 1
    tconv.conv2d_direct(x, w, backend="kernels")
    assert cache.stats.misses == 1 and cache.stats.hits >= 1
    tconv.conv2d_direct(x, w, backend="kernels", format_policy="int8")
    assert len(cache) == 2
    tconv.conv2d_direct(x, w, backend="kernels", format_policy="bf16")
    assert len(cache) == 3
    for backend in ("torch", "reference"):
        tconv.conv2d_direct(x, w, backend=backend)
    assert len(cache) == 3 and cache.stats.misses == 3
    out = tconv.conv2d_direct(x, w[1:2, 1:2], backend="kernels")
    assert len(cache) == 4 and tuple(out.shape) == (1, 8, 8, 16)
    with pytest.raises(ValueError):
        tconv.conv2d_direct(x, w, backend="xla")


# -- the suite's plans at full size ------------------------------------------------

def _chip_smoke():
    return _load("_chip_smoke_for_conv_tests", ROOT / "chip_smoke.py")


CS = _chip_smoke()
SUITE = {row[0]: row for row in CS.CONV_SUITE}
SUITE_CASES = [(fmt, name) for fmt, prefix in CS.CONV_FORMATS.items()
               for name in SUITE if name.startswith(prefix)]


def test_the_suite_is_the_benchmarks_list():
    """chip_smoke.py's 75 layers (its own list: the script imports
    nothing of ``benchmarks/``) are ``benchmarks/workloads.py``'s, field
    for field and in order."""
    wl = _load("_paper_workloads", ROOT / "benchmarks" / "workloads.py")
    mine = [(s.name, s.n, s.h, s.w, s.ic, s.oc, s.kh, s.kw, s.stride, s.pad)
            for s in CS.conv_specs()]
    theirs = [(s.name, s.n, s.h, s.w, s.ic, s.oc, s.kh, s.kw, s.stride,
               s.pad) for s in wl.CONVOLUTIONS]
    assert len(mine) == 75 and mine == theirs
    assert [tuple(g) for g in CS.TRANSFORMER_GEMMS] == [
        (g.name, g.m, g.n, g.k) for g in wl.TRANSFORMER_GEMMS]


@pytest.mark.parametrize("fmt,name", SUITE_CASES,
                         ids=[f"{f}-{nm}" for f, nm in SUITE_CASES])
def test_suite_layer_plans_a_b3_engine_unless_unaligned(fmt, name):
    """At minibatch 16 every layer whose channels an engine takes (IC and
    OC multiples of 4 for fp32 and 8 for bf16; K % 16 and N % 8 for
    int8) is granted a tile B3's SIMT, wgmma or s8 engine runs; only
    chip_smoke.py's unaligned layers get the tile loop, and its grid
    (M tiles on grid.y) stays within 65535."""
    spec = next(s for s in CS.conv_specs() if s.name == name)
    m, n_, k = tconv.conv_gemm_dims(spec)
    g = spec.kh * spec.kw
    grant = tdispatch.plan_gemm(m, n_, k, format_policy=fmt, group=g,
                                profile=tgeometry.H100_SPEC)
    geom = grant.geometry
    f = tformats.resolve_format(fmt)
    dt = torch.int8 if f.quantized else f.operand_torch
    engine = tgeometry.grouped_engine(dt, m, n_, k, tile=(geom.bm, geom.bn))
    align_k, align_n = {"fp32": (4, 4), "bf16": (8, 8), "int8": (16, 8)}[fmt]
    aligned = k % align_k == 0 and n_ % align_n == 0
    assert aligned == (name not in CS.CONV_UNALIGNED)
    assert (engine != "tile") == aligned, grant.plan.describe()
    want = {"fp32": "simt", "bf16": "wgmma", "int8": "wgmma"}[fmt]
    assert engine in ("tile", want)
    if engine == "tile":
        assert (geom.bm, geom.bn) == (64, 64)
        assert tgeometry.cdiv(m, geom.bm) <= 65535
    tgeometry.check_kernel_tile(geom, g)


@pytest.mark.parametrize("m,n_,k,group,fmt", [
    (48, 128, 128, 3, "fp32"), (64, 256, 128, 2, "fp32"),
    (512, 256, 128, 2, "fp32"), (4096, 256, 128, 1, "fp32"),
    (512, 16384, 2048, 2, "bf16"), (512, 2560, 2560, 3, "bf16acc"),
    (160, 512, 1024, 32, "int8"), (4, 2048, 2048, 3, "bf16")])
def test_served_signatures_keep_their_candidates_and_price(m, n_, k, group,
                                                           fmt):
    """The plan cache grants the cheapest candidate by price, and the
    floor of the f32 tile loop's full-card rate (``tile_fp32_flops``)
    binds only where its grid fills a tenth of the card: the reduced
    models' f32 programs and chunks and every bf16, bf16acc and int8
    signature of the served paths keep the grant and the price they had
    without it, so no grouping decision of theirs moves."""
    spec = tgeometry.H100_SPEC
    dt = {"fp32": "float32", "bf16": "bfloat16", "bf16acc": "bfloat16",
          "int8": "int8"}[fmt]
    sig = tautotune.GemmSignature.make(m, n_, k, dt,
                                       "int32" if fmt == "int8" else dt,
                                       group=group, fmt=fmt)
    plan = tautotune.PlanCache(profile=spec).plan(sig)
    cands = tautotune.enumerate_candidates(sig, spec)
    assert plan.predicted_s == min(tautotune.score_geometry(sig, g, spec)
                                   for g in cands)
    old = dataclasses.replace(spec, tile_fp32_flops=spec.peak_fp32_flops)
    assert plan == tautotune.PlanCache(profile=old).plan(sig)


@pytest.mark.parametrize("m,n_,k,group,tile", [
    (50176, 64, 64, 9, (128, 64)), (802816, 64, 64, 9, (128, 64)),
    (784, 512, 512, 9, (128, 128)), (50176, 16, 64, 1, (128, 64)),
    (10816, 256, 512, 1, (128, 128)), (12544, 192, 64, 1, (128, 64))])
def test_f32_filling_the_card_is_granted_a_simt_tile(m, n_, k, group, tile):
    """Where the SIMT engine's tiles fill the card, f32 is granted its
    cheapest SIMT tile, never the tile loop (priced at its measured rate,
    ``tile_fp32_flops``: it ran ~6x slower than the SIMT engine on an
    H100); 128 x 64 is offered where it pads N less than 128 x 128."""
    spec = tgeometry.H100_SPEC
    sig = tautotune.GemmSignature.make(m, n_, k, "float32", "float32",
                                       group=group, fmt="fp32")
    plan = tautotune.PlanCache(profile=spec).plan(sig)
    assert tautotune.plan_engine(sig, plan.geometry) == "simt"
    assert (plan.geometry.bm, plan.geometry.bn) == tile
    cands = tautotune.enumerate_candidates(sig, spec)
    assert (cands[0].bm, cands[0].bn) == (64, 64)
    base = cands[0]
    flops = (2.0 * group * tgeometry.round_up(m, base.bm)
             * tgeometry.round_up(n_, base.bn) * k)
    assert tautotune.score_geometry(sig, base, spec) >= (
        flops / spec.tile_fp32_flops)
