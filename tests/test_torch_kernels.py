"""The port's kernels (plain versions on the CPU) against the JAX package's
Pallas kernels (interpret mode), on the same numpy inputs.  The CUDA
kernels against their plain versions are in test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import formats as jformats
from repro.core.epilogue import Epilogue as JEpilogue
from repro.core.geometry import BlockGeometry as JGeom, cdiv as jcdiv
from repro.kernels import ops as jops
from repro.kernels.flash_decode import flash_decode_paged_pallas
from repro.kernels.mte_gemm import mte_gemm_pallas
from repro.kernels.splitk_gemm import mte_gemm_splitk_pallas
from repro.models.attention import _quantize_kv as j_quantize_kv

from torch_lazy import LazyModule, torch
from torch_parity import TOL, n, t

# The port, imported at first use (see torch_lazy).
tformats = LazyModule("repro_torch.core.formats")
tautotune = LazyModule("repro_torch.core.autotune")
tepilogue = LazyModule("repro_torch.core.epilogue")
tgeometry = LazyModule("repro_torch.core.geometry")
tops = LazyModule("repro_torch.kernels.ops")
tref = LazyModule("repro_torch.kernels.ref")
tdecode = LazyModule("repro_torch.kernels.flash_decode")
tgemm = LazyModule("repro_torch.kernels.mte_gemm")
tsplitk = LazyModule("repro_torch.kernels.splitk_gemm")
tattention = LazyModule("repro_torch.models.attention")

RNG = np.random.default_rng(0)

# The shape families of tests/test_kernels_gemm.py: ragged M/N/K,
# tall/skinny M <= 8, tiny M/N with deep K.
SHAPES = [(100, 70, 130), (33, 257, 65), (8, 2048, 8), (1024, 16, 64),
          (300, 33, 7), (7, 9, 1000), (4, 256, 512)]
EPILOGUES = [
    JEpilogue(has_bias=True),
    JEpilogue(alpha=0.5, beta=1.5),
    JEpilogue(softcap=30.0),
    JEpilogue(activation="gelu", has_bias=True),
    JEpilogue(alpha=0.3, beta=2.0, has_bias=True, activation="silu"),
]


def _mats(m, n_, k):
    """A scaled by 1/sqrt(K), so outputs are O(1) at every depth and the
    f32 tolerance measures the algorithm, not the summation order of
    K-deep sums."""
    a = RNG.standard_normal((m, k)) / np.sqrt(k)
    return (a.astype(np.float32),
            RNG.standard_normal((k, n_)).astype(np.float32))


def _tepi(e: JEpilogue):
    return tepilogue.Epilogue(**dataclasses.asdict(e))


def _tgeom(g: JGeom, **kw):
    sew = tgeometry.SEW
    return tgeometry.BlockGeometry(
        bm=g.bm, bn=g.bn, bk=g.bk, split_k=g.split_k, n_acc=g.n_acc,
        transposed_b=g.transposed_b, sew_i=sew[g.sew_i.name],
        sew_o=sew[g.sew_o.name], policy=g.policy, **kw)


def _jgeom(bm=64, bn=128, bk=64, transposed=False, sew_i="E32",
           sew_o="E32"):
    from repro.core.tile_state import SEW as JSEW
    return JGeom(bm=bm, bn=bn, bk=bk, split_k=1, n_acc=1,
                 transposed_b=transposed, sew_i=JSEW[sew_i],
                 sew_o=JSEW[sew_o], policy="mte")


@pytest.mark.parametrize("m,n_,k", SHAPES)
def test_mte_gemm_fp32_matches_jax(m, n_, k):
    a, b = _mats(m, n_, k)
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b))
    got = tops.mte_gemm(t(a), t(b))
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])


@pytest.mark.parametrize("m,n_,k", [(100, 70, 130), (16, 512, 96),
                                    (4, 256, 512)])
def test_mte_gemm_bf16_matches_jax(m, n_, k):
    a, b = _mats(m, n_, k)
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b),
                         format_policy="bf16")
    got = tops.mte_gemm(t(a), t(b), format_policy="bf16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["bf16"],
                               atol=TOL["bf16"])


@pytest.mark.parametrize("epi", EPILOGUES, ids=lambda e: repr(e)[9:40])
def test_mte_gemm_epilogues_match_jax(epi):
    m, n_, k = 96, 144, 48
    a, b = _mats(m, n_, k)
    c = RNG.standard_normal((m, n_)).astype(np.float32)
    bias = RNG.standard_normal(n_).astype(np.float32)
    cj = jnp.asarray(c) if epi.needs_c_input else None
    bj = jnp.asarray(bias) if epi.has_bias else None
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b), cj, bj,
                         epilogue=epi)
    got = tops.mte_gemm(t(a), t(b), t(c) if cj is not None else None,
                        t(bias) if bj is not None else None,
                        epilogue=_tepi(epi))
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])


def test_mte_gemm_transposed_b_matches_jax():
    """The Formula-3 (N, K) B layout at kernel level."""
    m, n_, k = 70, 90, 130
    a, b = _mats(m, n_, k)
    bt = np.ascontiguousarray(b.T)
    g = _jgeom(transposed=True)
    epi = JEpilogue(activation="gelu")
    want = mte_gemm_pallas(jnp.asarray(a), jnp.asarray(bt), geom=g,
                           epilogue=epi, interpret=True)
    got = tgemm.mte_gemm_torch(t(a), t(bt), geom=_tgeom(g),
                               epilogue=_tepi(epi))
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])


@pytest.mark.parametrize("m,n_,k", [(100, 70, 130), (4, 256, 512),
                                    (7, 9, 1000)])
def test_int8_accumulator_exactly_equal(m, n_, k):
    """int8: operands quantize bit-equal and the int32 accumulator is
    exactly equal, compared before the dequant."""
    a, b = _mats(m, n_, k)
    aq, bq, sa, sb = jformats.quantize_operands(jnp.asarray(a),
                                                jnp.asarray(b))
    taq, tbq, tsa, tsb = tformats.quantize_operands(t(a), t(b))
    np.testing.assert_array_equal(taq.numpy(), np.asarray(aq))
    np.testing.assert_array_equal(tbq.numpy(), np.asarray(bq))
    np.testing.assert_array_equal(tsa.numpy(), np.asarray(sa))
    np.testing.assert_array_equal(tsb.numpy(), np.asarray(sb))
    g = _jgeom(sew_i="E8", sew_o="E32")
    want = mte_gemm_pallas(aq, bq, geom=g, out_dtype=jnp.int32,
                           interpret=True)
    got = tgemm.mte_gemm_torch(taq, tbq, geom=_tgeom(g),
                               out_dtype=torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full_j = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b),
                           format_policy="int8")
    full_t = tops.mte_gemm(t(a), t(b), format_policy="int8")
    np.testing.assert_allclose(n(full_t), n(full_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n_,k", [(64, 96, 300), (4, 256, 512)])
def test_bf16acc_matches_jax_at_the_jax_plan_bk(m, n_, k):
    """bf16acc rounds the running sum once per K block, so the result
    depends on bk: the port's plain version runs at the bk of the JAX
    plan (clipped as the JAX kernel clips it).  Tolerance: bf16-level
    (1e-2), because a block partial that lands on a bf16 rounding tie can
    round one ulp apart when the two f32 dot products sum in another
    order."""
    from repro.core import autotune as jautotune
    a, b = _mats(m, n_, k)
    ab = jnp.asarray(a).astype(jnp.bfloat16)
    bb = jnp.asarray(b).astype(jnp.bfloat16)
    plan = jautotune.get_plan(m, n_, k, jnp.bfloat16, jnp.float32,
                              fmt="bf16acc")
    g = dataclasses.replace(plan.geometry, split_k=1, transposed_b=False)
    jbk = min(g.bk, max(8, jcdiv(k, 8) * 8))
    want = mte_gemm_pallas(ab, bb, geom=g, out_dtype=jnp.float32,
                           acc_dtype=jnp.bfloat16, interpret=True)
    got = tgemm.mte_gemm_torch(t(ab), t(bb),
                               geom=dataclasses.replace(_tgeom(g), bk=jbk),
                               out_dtype=torch.float32,
                               acc_dtype=torch.bfloat16)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("n_split", [2, 4])
@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_splitk_matches_jax(n_split, dtype):
    m, n_, k = 8, 200, 777
    a, b = _mats(m, n_, k)
    epi = JEpilogue(has_bias=True, activation="silu")
    bias = RNG.standard_normal(n_).astype(np.float32)
    g = _jgeom(bm=8, bn=128, bk=64)
    if dtype == "int8":
        aq, bq, _, _ = jformats.quantize_operands(jnp.asarray(a),
                                                  jnp.asarray(b))
        g = _jgeom(bm=8, bn=128, bk=64, sew_i="E8")
        want = mte_gemm_splitk_pallas(aq, bq, geom=g, n_split=n_split,
                                      out_dtype=jnp.int32, interpret=True)
        got = tsplitk.mte_gemm_splitk_torch(t(aq), t(bq), geom=_tgeom(g),
                                            n_split=n_split,
                                            out_dtype=torch.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    want = mte_gemm_splitk_pallas(jnp.asarray(a), jnp.asarray(b),
                                  bias=jnp.asarray(bias), geom=g,
                                  n_split=n_split, epilogue=epi,
                                  interpret=True)
    got = tsplitk.mte_gemm_splitk_torch(t(a), t(b), bias=t(bias),
                                        geom=_tgeom(g), n_split=n_split,
                                        epilogue=_tepi(epi))
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])


# -- paged flash decode (the cases of tests/test_flash_decode.py) ----------

B, H, HKV, D = 3, 4, 2, 32
SEQ_LENS = np.array([5, 17, 25], np.int32)


def _paged_inputs(page=8, dtype=np.float32, seed=0, stale=False):
    rng = np.random.default_rng(seed)
    maxp = -(-int(SEQ_LENS.max()) // page) + 1
    total = 1 + sum(-(-int(s) // page) for s in SEQ_LENS) + 2
    kp = rng.standard_normal((total, page, HKV, D)).astype(dtype)
    vp = rng.standard_normal((total, page, HKV, D)).astype(dtype)
    table = np.full((B, maxp), -1, np.int32)
    nxt = 1
    for bi, s in enumerate(SEQ_LENS):
        for i in range(-(-int(s) // page)):
            table[bi, i] = nxt
            nxt += 1
    if stale:
        # A mapped page past seq_len holding garbage, and an unmapped
        # page in the middle of a row (its slots must be masked).
        table[0, 1] = total - 1
        table[2, 1] = -1
    q = rng.standard_normal((B, H, D)).astype(dtype)
    return q, kp, vp, table


@pytest.mark.parametrize("case", ["ragged", "stale", "window_softcap",
                                  "int8", "small_page"])
def test_flash_decode_paged_matches_jax(case):
    page = 4 if case == "small_page" else 8
    q, kp, vp, table = _paged_inputs(page=page, stale=case == "stale")
    kw = {}
    if case == "window_softcap":
        kw = dict(window=6, softcap=5.0)
    ks = vs = None
    if case == "int8":
        kq, ksc = j_quantize_kv(jnp.asarray(kp))
        vq, vsc = j_quantize_kv(jnp.asarray(vp))
        tkq, tksc = tattention._quantize_kv(t(kp))
        np.testing.assert_array_equal(tkq.numpy(), np.asarray(kq))
        np.testing.assert_array_equal(tksc.numpy(), np.asarray(ksc))
        kp, vp, ks, vs = np.asarray(kq), np.asarray(vq), ksc, vsc
    want = flash_decode_paged_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(SEQ_LENS), ks, vs, interpret=True, **kw)
    got = tdecode.flash_decode_paged_torch(
        t(q), t(kp), t(vp), t(table), t(SEQ_LENS),
        t(ks) if ks is not None else None, t(vs) if vs is not None else None,
        **kw)
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])


def test_flash_decode_paged_empty_row_is_zero():
    q, kp, vp, table = _paged_inputs()
    lens = SEQ_LENS.copy()
    lens[1] = 0
    table[1] = -1
    got = tdecode.flash_decode_paged_torch(t(q), t(kp), t(vp), t(table),
                                           t(lens))
    assert torch.count_nonzero(got[1]) == 0
    assert torch.isfinite(got).all()


# -- flash attention (the cases of tests/test_kernels_attention.py) --------

@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window,softcap", [
    (1, 4, 4, 64, 64, 32, True, None, None),
    (2, 8, 2, 48, 48, 32, True, None, None),      # GQA
    (1, 4, 1, 40, 40, 32, True, 16, None),        # MQA + window
    (1, 2, 2, 32, 32, 16, True, None, 20.0),      # softcap
    (1, 4, 2, 16, 80, 32, True, None, None),      # Sq < Skv (right-aligned)
    (1, 2, 1, 24, 56, 32, False, None, None),     # non-causal
])
def test_flash_attention_matches_jax(b, h, hkv, sq, skv, d, causal, window,
                                     softcap):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                softcap=softcap)
    got = tops.flash_attention(t(q), t(k), t(v), causal=causal,
                               window=window, softcap=softcap)
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])


# -- the oracles of kernels/ref.py ------------------------------------------

@pytest.mark.parametrize("fmt,transposed", [(None, False), (None, True),
                                            ("bf16", False),
                                            ("int8", False)])
def test_ref_gemm_oracle_matches_jax(fmt, transposed):
    from repro.kernels import ref as jref
    a, b = _mats(40, 72, 96)
    b = np.ascontiguousarray(b.T) if transposed else b
    bias = RNG.standard_normal(72).astype(np.float32)
    epi = JEpilogue(has_bias=True, activation="gelu")
    want = jref.mte_gemm(jnp.asarray(a), jnp.asarray(b),
                         bias=jnp.asarray(bias), epilogue=epi,
                         b_transposed=transposed, format_policy=fmt)
    got = tref.mte_gemm(t(a), t(b), bias=t(bias), epilogue=_tepi(epi),
                        b_transposed=transposed, format_policy=fmt)
    tol = TOL["bf16"] if fmt == "bf16" else TOL["fp32"]
    np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol)


def test_ref_attention_oracles_match_jax():
    from repro.kernels import ref as jref
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4, 12, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 20, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 20, 16)).astype(np.float32)
    kw = dict(window=8, softcap=10.0)
    np.testing.assert_allclose(
        n(tref.flash_attention(t(q), t(k), t(v), **kw)),
        n(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)),
        rtol=TOL["fp32"], atol=TOL["fp32"])
    qd = q[:, :, 0]
    kv_pos = np.tile(np.arange(20, dtype=np.int32), (1, 1))
    kv_pos[0, 15:] = -1                         # unwritten slots
    q_pos = np.array([13], np.int32)
    np.testing.assert_allclose(
        n(tref.flash_decode(t(qd), t(k), t(v), t(kv_pos), t(q_pos), **kw)),
        n(jref.flash_decode(jnp.asarray(qd), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(kv_pos), jnp.asarray(q_pos), **kw)),
        rtol=TOL["fp32"], atol=TOL["fp32"])


# -- formats -----------------------------------------------------------------

@pytest.mark.parametrize("shape,axis,per_channel", [
    ((37, 53), 1, True), ((37, 53), 0, True), ((4, 9, 16), 2, True),
    ((64, 32), 1, False), ((5, 7), 1, True)])
def test_quantize_bit_equal(shape, axis, per_channel):
    x = (RNG.standard_normal(shape) * 3).astype(np.float32)
    x[0] = 0.0                    # an all-zero channel: scale becomes 1
    x.flat[5] = 0.5 * (np.abs(x).max() / 127.0)  # a half-way rounding case
    jq, js = jformats.quantize(jnp.asarray(x), contract_axis=axis,
                               per_channel=per_channel)
    tq, ts = tformats.quantize(t(x), contract_axis=axis,
                               per_channel=per_channel)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tformats.dequantize(tq.to(torch.int32), ts, None).numpy(),
        np.asarray(jformats.dequantize(jq.astype(jnp.int32), js, None)))


# -- planner -----------------------------------------------------------------

def test_planner_sends_decode_to_splitk_and_prefill_to_mte():
    """gemma_2b at full width on 132 SMs: every decode GEMM (M = 4 slots)
    underfills the card and goes split-K; the 512-token prefill chunk's
    gate/up GEMMs (N = 16384) fill it and go to the MTE kernel."""
    spec = tgeometry.H100_SPEC
    cache = tautotune.PlanCache(profile=spec)

    def sig(m, n_, k):
        return tautotune.GemmSignature.make(m, n_, k, "bfloat16",
                                            "bfloat16", fmt="bf16")

    for n_, k in [(2048, 2048), (256, 2048), (16384, 2048), (2048, 16384)]:
        assert cache.plan(sig(4, n_, k)).route == "splitk", (n_, k)
    for n_, k in [(16384, 2048), (2048, 16384), (2048, 2048)]:
        assert cache.plan(sig(512, n_, k)).route == "mte", (n_, k)
    decode_gate = sig(4, 16384, 2048)
    cands = tautotune.enumerate_candidates(decode_gate, spec)
    assert all(c.bk % 32 == 0 for c in cands)
    assert min(tautotune.score_geometry(decode_gate, c, spec)
               for c in cands) > 0


def test_plan_cache_hits_and_keys_formats():
    tautotune.reset_cache()
    p1 = tautotune.get_plan(64, 64, 64, torch.float32, fmt="fp32")
    p2 = tautotune.get_plan(64, 64, 64, torch.float32, fmt="fp32")
    p3 = tautotune.get_plan(64, 64, 64, torch.bfloat16, torch.float32,
                            fmt="bf16")
    stats = tautotune.cache_stats()
    assert p1 is p2 and p3.signature.fmt == "bf16"
    assert stats.hits == 1 and stats.misses == 2


def test_cuda_tensor_never_falls_back_to_plain():
    """A wrapper given a tensor that is not on the CPU launches or raises;
    the meta device stands in for a card here."""
    a = torch.empty(4, 8, device="meta")
    sew = tgeometry.SEW.E32
    g = tgeometry.BlockGeometry(16, 128, 32, 1, 1, False, sew, sew, "mte")
    with pytest.raises(ValueError):
        tgemm.mte_gemm_kernel(a, a.t(), geom=g)
