"""The port's host-side core against the JAX package's: the MTE CSR
(``core/tile_state.py``: ``TileState`` words bit for bit, the tss
grants), the paper's CPU profiles with Formulas 2/3 and the unroll solver
(``core/geometry.py``), the retired-instruction accounting of Table IX
(``core/isa.py``) and the §V-E machine model (``core/perfmodel.py``), on
the cases of ``tests/test_tile_state.py`` and ``tests/test_geometry.py``
and on the GEMM shapes of the paper's suite; plus the port's own
``analytic_seconds``, ``tile_state_for`` and ``dispatch.plan_gemm``.  All
of it is host arithmetic: equal means equal (the model to 1e-12
relative).  Last, ``dispatch.mte_gemm`` on each backend against JAX's:
the port's ``"kernels"`` (the plain versions on the CPU) against
``"pallas"`` (interpret mode), ``"torch"`` against ``"xla"``,
``"reference"`` against ``"reference"``, in fp32 (1e-5), bf16 (2e-2) and
int8 (1e-5 through an epilogue; with none, outputs exactly equal: each
is the int32 sum times the two scales)."""
try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:  # hermetic env: run properties via the local shim
    from _hypothesis_fallback import given, settings, strategies as st
import dataclasses
import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import autotune as jautotune
from repro.core import dispatch as jdispatch
from repro.core import geometry as jgeo
from repro.core import isa as jisa
from repro.core import perfmodel as jperf
from repro.core import tile_state as jts

from repro.core.epilogue import Epilogue as JEpilogue

from torch_lazy import LazyModule, torch
from torch_parity import n, t

tts = LazyModule("repro_torch.core.tile_state")
tgeo = LazyModule("repro_torch.core.geometry")
tisa = LazyModule("repro_torch.core.isa")
tperf = LazyModule("repro_torch.core.perfmodel")
tautotune = LazyModule("repro_torch.core.autotune")
tdispatch = LazyModule("repro_torch.core.dispatch")
tepilogue = LazyModule("repro_torch.core.epilogue")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list(jgeo.PROFILES)
# (SEW_i, SEW_o) pairs: uniform and widening, as the formats use them.
SEW_PAIRS = [(8, 8), (16, 16), (32, 32), (64, 64), (8, 32), (16, 32),
             (8, 16)]
MODEL_SEWS = [(32, 32), (16, 32), (8, 32)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_for_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gemm_shapes():
    """(label, M, N, K): ``conv_gemm_dims`` of the first layer of each
    (kernel, stride, pad) kind in the paper's suite (chip_smoke.py's
    list), and the 18 transformer GEMMs."""
    from repro.core.conv import ConvSpec, conv_gemm_dims
    cs = _chip_smoke()
    kinds = {}
    for name, h, ic, oc, k, stride, pad, w in cs.CONV_SUITE:
        p = k // 2 if pad is None else pad
        spec = ConvSpec(name, cs.CONV_MB, h, w or h, ic, oc, k, k, stride, p)
        kinds.setdefault((k, stride, p), (name, *conv_gemm_dims(spec)))
    return sorted(kinds.values()) + [tuple(g)
                                     for g in cs.TRANSFORMER_GEMMS]


SHAPES = _gemm_shapes()


def _sew(pkg, bits):
    return pkg.SEW.from_bits(bits)


def _port_state(js):
    return tts.TileState(tm=js.tm, tn=js.tn, tk=js.tk,
                         sew_i=tts.SEW(int(js.sew_i)),
                         sew_o=tts.SEW(int(js.sew_o)),
                         policy_i=tts.TailPolicy(int(js.policy_i)),
                         policy_o=tts.TailPolicy(int(js.policy_o)),
                         rlenb=js.rlenb)


def _fields(ts):
    return (ts.tm, ts.tn, ts.tk, int(ts.sew_i), int(ts.sew_o),
            int(ts.policy_i), int(ts.policy_o), ts.rlenb)


# -- the CSR ------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(
    tm=st.integers(1, jts.MAX_DIM), tn=st.integers(1, jts.MAX_DIM),
    tk=st.integers(1, jts.MAX_DIM),
    sew_i=st.sampled_from(list(jts.SEW)), sew_o=st.sampled_from(list(jts.SEW)),
    pol_i=st.sampled_from(list(jts.TailPolicy)),
    pol_o=st.sampled_from(list(jts.TailPolicy)),
    rlenb=st.integers(0, 4095),
)
def test_csr_words_equal_jax(tm, tn, tk, sew_i, sew_o, pol_i, pol_o, rlenb):
    js = jts.TileState(tm=tm, tn=tn, tk=tk, sew_i=sew_i, sew_o=sew_o,
                       policy_i=pol_i, policy_o=pol_o, rlenb=rlenb)
    ts = _port_state(js)
    word = ts.encode()
    assert word == js.encode()
    assert tts.TileState.decode(word) == ts
    assert _fields(tts.TileState.decode(word)) == _fields(
        jts.TileState.decode(word))


@settings(max_examples=200, deadline=None)
@given(word=st.integers(0, (1 << 64) - 1))
def test_any_word_decodes_as_jax_decodes_it(word):
    """Every 64-bit word decodes (the policy bits masked as JAX masks
    them) to the same fields, and re-encodes to the same word."""
    js, ts = jts.TileState.decode(word), tts.TileState.decode(word)
    assert _fields(ts) == _fields(js)
    assert ts.encode() == js.encode()


@settings(max_examples=100, deadline=None)
@given(request=st.integers(0, 10_000), hw_max=st.integers(1, 4096))
def test_tss_grants_equal_jax(request, hw_max):
    js, ts = jts.TileState(), tts.TileState()
    for op in ("tssm", "tssn", "tssk"):
        jg, js = getattr(js, op)(request, hw_max)
        tg, ts = getattr(ts, op)(request, hw_max)
        assert tg == jg == min(request, hw_max, jts.MAX_DIM)
        assert _fields(ts) == _fields(js)


def test_paper_field_budget_and_range():
    """Table II: the fields fit below the reserved byte; out-of-range
    dimensions and rlenb are refused, as in JAX."""
    ts = tts.TileState(tm=4096, tn=4096, tk=4096, rlenb=4095)
    assert ts.encode() < (1 << 56)
    assert ts.rlen_bits == 4095 * 8
    for kw in (dict(tm=5000), dict(tm=0), dict(rlenb=5000)):
        with pytest.raises(ValueError):
            tts.TileState(**kw)
        with pytest.raises(ValueError):
            jts.TileState(**kw)
    with pytest.raises(ValueError):
        tts.TileState.decode(1 << 64)


@pytest.mark.parametrize("dtype,bits", [
    ("float32", 32), ("bfloat16", 16), ("int8", 8), ("int32", 32),
    ("float64", 64), ("float16", 16)])
def test_sew_from_torch_dtypes_and_names(dtype, bits):
    want = jts.SEW.from_dtype(dtype)
    assert int(tts.SEW.from_dtype(dtype)) == int(want)
    assert int(tts.SEW.from_dtype(getattr(torch, dtype))) == int(want)
    assert tts.SEW.from_bits(bits).bits == bits
    with pytest.raises(ValueError):
        tts.SEW.from_bits(12)


# -- the paper's CPU geometry ----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits_i,bits_o", SEW_PAIRS)
def test_register_tiles_equal_jax(arch, bits_i, bits_o):
    """Formulas 2/3 (and the SiFiveInt geometry) on every Table VII row
    and SEW pair, and a SEW_i wider than SEW_o refused as JAX refuses
    it."""
    jp, tp = jgeo.PROFILES[arch], tgeo.PROFILES[arch]
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    ji, jo = _sew(jts, bits_i), _sew(jts, bits_o)
    ti, to = _sew(tts, bits_i), _sew(tts, bits_o)
    jt = jgeo.max_tile_dims(jp, ji, jo)
    tt = tgeo.max_tile_dims(tp, ti, to)
    assert (tt.mnk, tt.transposed_b, tt.flops) == (jt.mnk, jt.transposed_b,
                                                   jt.flops)
    js, ts = jgeo.sifive_tile_dims(jp, ji), tgeo.sifive_tile_dims(tp, ti)
    assert (ts.mnk, ts.macs) == (js.mnk, js.macs)
    # SEW_i wider than SEW_o: refused where tiles have rows, as in JAX
    # (an E8 SEW_o is falsy, so both take it as "uniform").
    assert _tile_or_error(lambda: tgeo.max_tile_dims(tp, _sew(tts, 64), to)) \
        == _tile_or_error(lambda: jgeo.max_tile_dims(jp, _sew(jts, 64), jo))


def _tile_or_error(solve):
    try:
        t = solve()
    except ValueError:
        return "ValueError"
    return t.mnk, t.transposed_b


def test_paper_examples_of_formulas_2_and_3():
    """§III-A2 and §V-C, on the port: 16×16×16 uniform, 16×16×32
    widening with B transposed, 1×VL×1 vector, SiFiveInt 4×64×4."""
    p = tgeo.PROFILES
    assert tgeo.max_tile_dims(p["mte32s"], tts.SEW.E32).mnk == (16, 16, 16)
    t = tgeo.max_tile_dims(p["mte32s"], tts.SEW.E16, tts.SEW.E32)
    assert t.mnk == (16, 16, 32) and t.transposed_b
    assert tgeo.max_tile_dims(p["vector2k"], tts.SEW.E32).mnk == (1, 512, 1)
    assert tgeo.sifive_tile_dims(p["sifiveint"],
                                 tts.SEW.E32).mnk == (4, 64, 4)


def _unroll_pair(arch, m, n, k, bits):
    jp, tp = jgeo.PROFILES[arch], tgeo.PROFILES[arch]
    if arch == "sifiveint":
        jt = jgeo.sifive_tile_dims(jp, _sew(jts, bits))
        tt = tgeo.sifive_tile_dims(tp, _sew(tts, bits))
    else:
        jt = jgeo.max_tile_dims(jp, _sew(jts, bits))
        tt = tgeo.max_tile_dims(tp, _sew(tts, bits))
    return (jgeo.solve_unroll(jp, jt, m, n, k),
            tgeo.solve_unroll(tp, tt, m, n, k))


@settings(max_examples=150, deadline=None)
@given(m=st.integers(1, 8192), n=st.integers(1, 8192), k=st.integers(1, 8192),
       arch=st.sampled_from(ARCHS), bits=st.sampled_from([8, 16, 32]))
def test_unroll_plans_equal_jax(m, n, k, arch, bits):
    jp, tp = _unroll_pair(arch, m, n, k, bits)
    assert (tp.um, tp.un, tp.live_regs, tp.indep_chains, tp.macro_m,
            tp.macro_n) == (jp.um, jp.un, jp.live_regs, jp.indep_chains,
                            jp.macro_m, jp.macro_n)
    assert tp.live_regs <= tgeo.PROFILES[arch].arch_regs


def test_amx_register_budget_forces_smaller_unroll():
    """The 8-register budget cannot reach the 32-register unroll (the
    mechanism behind the paper's 1.35x, §VI-A), on the port as in JAX."""
    _, p8 = _unroll_pair("mte8s", 2048, 2048, 2048, 32)
    _, p32 = _unroll_pair("mte32s", 2048, 2048, 2048, 32)
    assert p8.indep_chains < p32.indep_chains and p8.live_regs <= 8


# -- Table IX and the §V-E model --------------------------------------------------

@pytest.mark.parametrize("label,m,n,k", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("bits_i,bits_o", MODEL_SEWS)
def test_instruction_counts_equal_jax(label, m, n, k, bits_i, bits_o):
    ji, jo = _sew(jts, bits_i), _sew(jts, bits_o)
    ti, to = _sew(tts, bits_i), _sew(tts, bits_o)
    for arch in ARCHS:
        for beta in (True, False):
            j = jisa.count_instructions(arch, m, n, k, ji, jo, beta)
            t = tisa.count_instructions(arch, m, n, k, ti, to, beta)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.total == j.total
            assert dataclasses.asdict(t.scaled(3)) == dataclasses.asdict(
                j.scaled(3))
    jall, tall = jisa.count_all(m, n, k, ji, jo), tisa.count_all(m, n, k,
                                                                ti, to)
    assert {a: dataclasses.asdict(c) for a, c in tall.items()} == \
        {a: dataclasses.asdict(c) for a, c in jall.items()}


@pytest.mark.parametrize("label,m,n,k", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("bits_i,bits_o", MODEL_SEWS)
def test_machine_model_equals_jax(label, m, n, k, bits_i, bits_o):
    ji, jo = _sew(jts, bits_i), _sew(jts, bits_o)
    ti, to = _sew(tts, bits_i), _sew(tts, bits_o)
    jall, tall = jperf.model_all(m, n, k, ji, jo), tperf.model_all(m, n, k,
                                                                  ti, to)
    assert list(tall) == list(jall)
    for arch, j in jall.items():
        for t in (tall[arch], tperf.model_gemm(arch, m, n, k, ti, to,
                                               with_beta=False)):
            j = j if t is tall[arch] else jperf.model_gemm(
                arch, m, n, k, ji, jo, with_beta=False)
            for f in ("cycles", "compute_cycles", "memory_cycles",
                      "issue_cycles", "seconds", "efficiency", "gflops"):
                assert math.isclose(getattr(t, f), getattr(j, f),
                                    rel_tol=1e-12), (arch, f)
            assert (t.useful_flops, t.padded_flops, t.bottleneck) == \
                (j.useful_flops, j.padded_flops, j.bottleneck)


def test_sew_sweep_equals_jax():
    """Table IX extended to E8/E16 (``count_sew_sweep``)."""
    m, n, k = 3136, 64, 288
    j = jisa.count_sew_sweep(m, n, k)
    t = tisa.count_sew_sweep(m, n, k)
    assert list(t) == list(j)
    for sew in j:
        assert {a: c.total for a, c in t[sew].items()} == \
            {a: c.total for a, c in j[sew].items()}


def test_instruction_reduction_ordering_matches_table_ix():
    """Table IX's ordering on the port: mte32 retires the fewest, then
    mte8s, SiFiveInt, the vector ISA (``test_substrates.py:275-282``)."""
    c = tisa.count_all(3136, 64, 288)
    assert c["mte32s"].total <= c["mte8s"].total
    assert c["mte8s"].total < c["sifiveint"].total
    assert c["sifiveint"].total < c["vector1k"].total
    a = tisa.count_instructions("mte32s", 256, 256, 256)
    b = tisa.count_instructions("mte32s", 512, 256, 256)
    assert b.total > a.total and b.mma >= 2 * a.mma * 0.9


def test_machine_model_reproduces_headline_ordering():
    """MTE32s ≥ MTE32v ≥ MTE8s and MTE beats vector on small-N shapes,
    efficiencies in (0, 1] (``test_substrates.py:285-300``)."""
    for arch, t in tperf.model_all(1024, 256, 512).items():
        assert 0 < t.efficiency <= 1.0 + 1e-6, arch
    m, n, k = 3136, 64, 288
    t = {a: tperf.model_gemm(a, m, n, k).seconds for a in
         ("vector1k", "vector2k", "mte8s", "mte32s", "mte32v")}
    assert t["mte32s"] <= t["mte32v"] <= t["mte8s"]
    assert t["mte32s"] < t["vector1k"] and t["mte32s"] < t["vector2k"]


def test_calibration_table_as_jax():
    tperf.clear_calibration()
    try:
        assert tperf.calibrated_seconds(2.0, "decode", "bf16") == 2.0
        tperf.set_calibration("decode", "bf16", 1.5)
        assert tperf.calibration() == {"decode/bf16": 1.5}
        assert tperf.calibrated_seconds(2.0, "decode", "bf16") == 3.0
        for bad in (0.0, -1.0, float("nan"), float("inf")):
            with pytest.raises(ValueError):
                tperf.set_calibration("decode", "bf16", bad)
    finally:
        tperf.clear_calibration()
    assert tperf.calibration() == {}


# -- the card's side: the planner's model, the CSR word of a plan -----------------

@pytest.mark.parametrize("m,n,k,fmt,policy,group", [
    (512, 16384, 2048, "bf16", "mte", 1), (4, 2048, 2048, "bf16", "mte", 1),
    (512, 2048, 2048, "int8", "mte", 1), (4096, 256, 128, "fp32", "mte", 1),
    (512, 16384, 2048, "bf16", "amx", 1), (50176, 64, 64, "fp32", "mte", 9),
    (200, 768, 768, "fp32", "sifive", 1)])
def test_analytic_seconds_is_the_planners_base_price(m, n, k, fmt, policy,
                                                     group):
    spec = tgeo.H100_SPEC
    fp = tautotune.GemmSignature.make(1, 1, 1, "float32", "float32",
                                      fmt=fmt).format_policy
    pol = policy if policy in ("mte", "amx") else "mte"
    sig = tautotune.GemmSignature.make(m, n, k, fp.operand_dtype,
                                       fp.accum_dtype, policy=pol,
                                       group=group, fmt=fmt)
    base = tgeo.solve_block_geometry(m, n, k, sig.sew_i, sig.sew_o,
                                     profile=spec, policy=pol)
    want = tautotune.score_geometry(sig, base, spec)
    got = tperf.analytic_seconds(m, n, k, fmt=fmt, policy=policy,
                                 group=group, profile=spec)
    assert got == want > 0


@pytest.mark.parametrize("bm,bn,bk,m,n,k,bits_i,bits_o", [
    (64, 64, 256, 512, 2048, 2048, 16, 32), (16, 128, 32, 4, 2048, 2048,
                                             16, 32),
    (128, 128, 128, 5000, 5000, 5000, 8, 32), (128, 64, 16, 17, 36, 4,
                                               32, 32)])
def test_tile_state_for_equals_jax(bm, bn, bk, m, n, k, bits_i, bits_o):
    kw = dict(bm=bm, bn=bn, bk=bk, split_k=1, n_acc=1, transposed_b=False,
              policy="mte")
    jg = jgeo.BlockGeometry(sew_i=_sew(jts, bits_i), sew_o=_sew(jts, bits_o),
                            **kw)
    tg = tgeo.BlockGeometry(sew_i=_sew(tts, bits_i), sew_o=_sew(tts, bits_o),
                            **kw)
    assert tgeo.tile_state_for(tg, m, n, k).encode() == \
        jgeo.tile_state_for(jg, m, n, k).encode()


@pytest.mark.parametrize("m,n,k,fmt,policy,group", [
    (512, 16384, 2048, "bf16", "mte", 1), (4, 2048, 2048, "bf16acc", "mte",
                                           1),
    (512, 2048, 2048, "int8", "mte", 1), (200, 768, 768, "fp32", "amx", 1),
    (50176, 64, 576 // 9, "fp32", "mte", 9)])
def test_plan_gemm_reports_the_grant_a_call_would_get(m, n, k, fmt, policy,
                                                      group):
    """``plan_gemm`` is the dry handshake: the plan cache's grant for the
    signature ``kernels/ops.py`` makes (int8: the int8 product into
    int32), the analytic base price, and the CSR word of one block step
    with the format's SEW pair; nothing runs."""
    tautotune.reset_cache(profile=tgeo.H100_SPEC)
    try:
        g = tdispatch.plan_gemm(m, n, k, format_policy=fmt, policy=policy,
                                group=group)
        fp = g.plan.signature.format_policy
        if fp.quantized:
            dt_in, dt_out = torch.int8, torch.int32
        else:
            dt_in, dt_out = fp.operand_torch, torch.float32
        want = tautotune.get_plan(m, n, k, dt_in, dt_out, policy=policy,
                                  group=group, fmt=fmt)
        assert g.plan == want and g.seconds == want.predicted_s
        assert tautotune.cache_stats().misses == 1
        assert g.analytic_s == tperf.analytic_seconds(
            m, n, k, fmt=fmt, policy=policy, group=group)
        ts = g.tile_state
        assert (ts.tm, ts.tn, ts.tk) == (min(g.geometry.bm, m),
                                         min(g.geometry.bn, n),
                                         min(g.geometry.bk, k))
        assert (ts.sew_i, ts.sew_o) == (fp.sew_i, fp.sew_o)
        assert tts.TileState.decode(ts.encode()) == ts
        assert g.engine == tautotune.plan_engine(want.signature,
                                                 want.geometry)
    finally:
        tautotune.reset_cache()


RNG = np.random.default_rng(34)
FMTS = ["fp32", "bf16", "int8"]
TOL = {"fp32": 1e-5, "bf16": 2e-2, "int8": 1e-5}
# (port backend, JAX backend).
PAIRS = [("kernels", "pallas"), ("torch", "xla"),
         ("reference", "reference")]


@pytest.fixture
def fresh_caches():
    tautotune.reset_cache(profile=tautotune.H100_SPEC)
    jautotune.reset_cache()
    yield
    tautotune.reset_cache()
    jautotune.reset_cache()


def _t_epi(kw):
    return tepilogue.Epilogue(**kw)


# -- dispatch.mte_gemm -----------------------------------------------------------

GEMM_CASES = {
    "bias_gelu": ((40, 72, 96), dict(has_bias=True, activation="gelu")),
    "decode_rows": ((8, 64, 256), dict(alpha=0.5)),
    "ragged_beta": ((33, 130, 70), dict(beta=1.0, has_bias=True)),
}


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_dispatch_mte_gemm_matches_jax(pair, fmt, case, fresh_caches):
    (m, n_, k), epi = GEMM_CASES[case]
    a = (RNG.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    b = RNG.standard_normal((k, n_)).astype(np.float32)
    c = RNG.standard_normal((m, n_)).astype(np.float32)
    bias = RNG.standard_normal(n_).astype(np.float32)
    extra = {}
    if epi.get("beta"):
        extra["c"] = c
    if epi.get("has_bias"):
        extra["bias"] = bias
    pb, jb = pair
    got = tdispatch.mte_gemm(t(a), t(b), **{k_: t(v) for k_, v in
                                            extra.items()},
                             epilogue=_t_epi(epi), backend=pb,
                             format_policy=fmt)
    want = jdispatch.mte_gemm(jnp.asarray(a), jnp.asarray(b),
                              **{k_: jnp.asarray(v)
                                 for k_, v in extra.items()},
                              epilogue=JEpilogue(**epi), backend=jb,
                              format_policy=fmt)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(n(got), n(want), rtol=TOL[fmt], atol=TOL[fmt])


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("policy", ["mte", "amx"])
def test_int8_gemm_outputs_equal_jax_exactly(pair, policy, fresh_caches):
    """int8 under the identity epilogue: each output is the int32 sum
    times the two scales, so equal outputs are equal sums and scales."""
    a = RNG.standard_normal((24, 96)).astype(np.float32)
    b = RNG.standard_normal((96, 48)).astype(np.float32)
    pb, jb = pair
    got = tdispatch.mte_gemm(t(a), t(b), backend=pb, policy=policy,
                             format_policy="int8")
    want = jdispatch.mte_gemm(jnp.asarray(a), jnp.asarray(b), backend=jb,
                              policy=policy, format_policy="int8")
    np.testing.assert_array_equal(n(got), n(want))


def test_dispatch_defaults_and_refusals_mirror_jax():
    """The default backend is the plain formulation (JAX's ``"xla"``), the
    output dtype JAX's rule (f32 for bf16 operands, the input's dtype for
    fp32), a contraction mismatch and an unknown backend raise."""
    a = torch.randn(4, 8, dtype=torch.bfloat16)
    b = torch.randn(8, 16, dtype=torch.bfloat16)
    out = tdispatch.mte_gemm(a, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, tdispatch.mte_gemm(a, b,
                                                       backend="torch"))
    assert tdispatch.mte_gemm(a.float(), b.float()).dtype == torch.float32
    with pytest.raises(ValueError):
        tdispatch.mte_gemm(a, b[:4])
    with pytest.raises(ValueError, match="'kernels'"):
        tdispatch.mte_gemm(a, b, backend="pallas")
