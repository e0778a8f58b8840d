"""B3 (grouped GEMM) and B8 (rigid baseline: fixed-tile product + separate
epilogue pass) of the port — their plain versions on the CPU — against the
JAX package's Pallas kernels in interpret mode and its ``ops`` routes, on
the same numpy inputs.  The CUDA kernels against these plain versions are
in test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import formats as jformats
from repro.core.epilogue import Epilogue as JEpilogue
from repro.core.geometry import BlockGeometry as JGeom, cdiv as jcdiv
from repro.core.tile_state import SEW as JSEW
from repro.kernels import ops as jops
from repro.kernels.grouped_gemm import grouped_gemm_pallas
from repro.kernels.rigid_gemm import epilogue_pass_pallas, rigid_gemm_pallas

from torch_lazy import LazyModule, torch
from torch_parity import TOL, n, t

# The port, imported at first use (see torch_lazy).
tepilogue = LazyModule("repro_torch.core.epilogue")
tformats = LazyModule("repro_torch.core.formats")
tgeometry = LazyModule("repro_torch.core.geometry")
tautotune = LazyModule("repro_torch.core.autotune")
tops = LazyModule("repro_torch.kernels.ops")
tref = LazyModule("repro_torch.kernels.ref")
tgrouped = LazyModule("repro_torch.kernels.grouped_gemm")
trigid = LazyModule("repro_torch.kernels.rigid_gemm")

RNG = np.random.default_rng(11)

# (G, C, K, N): ragged C and N, K tails (K not a multiple of any bk), the
# decode q/k/v layout (C = slots) and a prefill-like C.
GROUP_SHAPES = [(3, 4, 130, 300), (2, 70, 1000, 90), (3, 8, 64, 256),
                (2, 33, 65, 129)]


def _tepi(e):
    return tepilogue.Epilogue(**dataclasses.asdict(e))


def _geoms(bk=64, sew_i="E32", sew_o="E32"):
    """The same block geometry in both packages (64 x 128 tiles)."""
    j = JGeom(bm=64, bn=128, bk=bk, split_k=1, n_acc=1, transposed_b=False,
              sew_i=JSEW[sew_i], sew_o=JSEW[sew_o], policy="mte")
    s = tgeometry.SEW
    p = tgeometry.BlockGeometry(bm=64, bn=64, bk=bk, split_k=1, n_acc=1,
                                transposed_b=False, sew_i=s[sew_i],
                                sew_o=s[sew_o], policy="mte")
    return j, p


def _group(g, c, k, n_):
    x = (RNG.standard_normal((g, c, k)) / np.sqrt(k)).astype(np.float32)
    w = RNG.standard_normal((g, k, n_)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("g,c,k,n_", GROUP_SHAPES)
@pytest.mark.parametrize("epi", [JEpilogue(),
                                 JEpilogue(alpha=0.5, activation="gelu"),
                                 JEpilogue(softcap=3.0, activation="silu")],
                         ids=["identity", "alpha_gelu", "softcap_silu"])
def test_grouped_fp32_matches_pallas(g, c, k, n_, epi):
    x, w = _group(g, c, k, n_)
    jg, tg = _geoms()
    want = grouped_gemm_pallas(jnp.asarray(x), jnp.asarray(w), geom=jg,
                               epilogue=epi, interpret=True)
    got = tgrouped.grouped_gemm_torch(t(x), t(w), geom=tg,
                                      epilogue=_tepi(epi))
    assert got.shape == (g, c, n_)
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])


@pytest.mark.parametrize("g,c,k,n_", GROUP_SHAPES)
def test_grouped_bf16_and_bf16acc_match_pallas(g, c, k, n_):
    """bf16 operands into an f32 accumulator (products of bf16 values are
    exact in f32: 1e-5), and into a bf16 accumulator rounded once per K
    block, with JAX's block depth pinned as the slice-1 B1 test pins it
    (a partial on a bf16 rounding tie can land one ulp apart: 1e-2)."""
    x, w = _group(g, c, k, n_)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    jg, tg = _geoms(sew_i="E16")
    want = grouped_gemm_pallas(xb, wb, geom=jg, interpret=True)
    got = tgrouped.grouped_gemm_torch(t(xb), t(wb), geom=tg)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
    jbk = min(jg.bk, max(8, jcdiv(k, 8) * 8))
    want = grouped_gemm_pallas(xb, wb, geom=jg, acc_dtype=jnp.bfloat16,
                               interpret=True)
    got = tgrouped.grouped_gemm_torch(
        t(xb), t(wb), geom=dataclasses.replace(tg, bk=jbk),
        acc_dtype=torch.bfloat16)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("g,c,k,n_", GROUP_SHAPES)
def test_grouped_int8_accumulator_exactly_equal(g, c, k, n_):
    """Per-group per-channel quantization bit-equal, int32 accumulator
    exactly equal."""
    x, w = _group(g, c, k, n_)
    xq, wq, sx, sw = jformats.quantize_operands(jnp.asarray(x),
                                                jnp.asarray(w))
    txq, twq, tsx, tsw = tformats.quantize_operands(t(x), t(w))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(sw))
    jg, tg = _geoms(sew_i="E8")
    want = grouped_gemm_pallas(xq, wq, geom=jg, out_dtype=jnp.int32,
                               interpret=True)
    got = tgrouped.grouped_gemm_torch(txq, twq, geom=tg,
                                      out_dtype=torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8", "int8pt"])
def test_ops_grouped_gemm_matches_jax_per_format(fmt):
    """The public wrapper (cast / quantize, plan, launch, dequantize):
    fp32 and the exact-accumulator int8 routes at 1e-5, bf16 at 1e-5
    (exact products, f32 sums)."""
    x, w = _group(3, 8, 96, 144)
    epi = JEpilogue(activation="gelu")
    want = jops.grouped_gemm(jnp.asarray(x), jnp.asarray(w), epilogue=epi,
                             format_policy=fmt)
    got = tops.grouped_gemm(t(x), t(w), epilogue=_tepi(epi),
                            format_policy=fmt)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
    oracle = tref.grouped_gemm(t(x), t(w), epilogue=_tepi(epi),
                               format_policy=fmt)
    np.testing.assert_allclose(n(got), n(oracle), rtol=1e-5, atol=1e-5)


def test_grouped_widths_zero_the_padding_and_keep_the_rest():
    """A shared x (group stride 0) over members padded to one width: the
    kept columns equal the unpadded per-member products and the padding
    comes back as zeros, in the plain version and through ops."""
    x = t(_group(1, 4, 200, 1)[0][0])
    ws = [t(RNG.standard_normal((200, wd)).astype(np.float32))
          for wd in (256, 64, 100)]
    from repro_torch.graph import stack_group_weights
    wstack = stack_group_weights(ws)
    assert wstack.shape == (3, 200, 256)
    xg = x[None].expand(3, *x.shape)
    assert xg.stride(0) == 0
    widths = [256, 64, 100]
    out = tops.grouped_gemm(xg, wstack, widths=widths)
    for i, w_ in enumerate(ws):
        np.testing.assert_allclose(n(out[i, :, :widths[i]]), n(x @ w_),
                                   rtol=1e-5, atol=1e-5)
        assert torch.count_nonzero(out[i, :, widths[i]:]) == 0
    with pytest.raises(ValueError, match="widths"):
        tops.grouped_gemm(xg, wstack, widths=[256, 64])


# -- B8: the rigid baseline ---------------------------------------------------

RIGID_EPILOGUES = [
    JEpilogue(),
    JEpilogue(has_bias=True, activation="relu"),
    JEpilogue(alpha=0.5, beta=1.5, activation="gelu"),
    JEpilogue(softcap=30.0, activation="silu"),
    JEpilogue(alpha=0.3, beta=2.0, has_bias=True, softcap=5.0,
              activation="tanh"),
]


@pytest.mark.parametrize("epi", RIGID_EPILOGUES, ids=lambda e: repr(e)[9:40])
@pytest.mark.parametrize("m,n_,k", [(100, 70, 130), (4, 300, 257)])
def test_rigid_gemm_matches_pallas(epi, m, n_, k):
    a = (RNG.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    b = RNG.standard_normal((k, n_)).astype(np.float32)
    c = RNG.standard_normal((m, n_)).astype(np.float32)
    bias = RNG.standard_normal(n_).astype(np.float32)
    cj = jnp.asarray(c) if epi.needs_c_input else None
    bj = jnp.asarray(bias) if epi.has_bias else None
    want = rigid_gemm_pallas(jnp.asarray(a), jnp.asarray(b), cj, bj,
                             epilogue=epi, interpret=True)
    args = (t(c) if cj is not None else None,
            t(bias) if bj is not None else None)
    got = trigid.rigid_gemm_torch(t(a), t(b), *args, epilogue=_tepi(epi))
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])
    oracle = tref.rigid_gemm(t(a), t(b), *args, epilogue=_tepi(epi))
    np.testing.assert_allclose(n(got), n(oracle), rtol=1e-6, atol=1e-6)


# Stage 2's cases: (activation, beta*C, row bias, softcap, out dtype, N).
# The first five (every activation with every option, f32 out) draw from
# the module's generator; the rest (each option alone or none, bf16 out,
# N odd and not a multiple of the kernel's 8-column groups) from their
# own, so the module's stream of draws that later tests share is as it
# was.
_ACTS = ("none", "relu", "gelu", "silu", "tanh")
PASS_CASES = {act: (act, True, True, True, "float32", 300) for act in _ACTS}
PASS_CASES.update({
    "gelu-bare-bf16": ("gelu", False, False, False, "bfloat16", 256),
    "gelu-every-option-bf16-n301": ("gelu", True, True, True, "bfloat16",
                                    301),
    "c-only-f32-n17": ("none", True, False, False, "float32", 17),
    "bias-silu-bf16-n301": ("silu", False, True, False, "bfloat16", 301),
    "softcap-tanh-f32-n33": ("tanh", False, False, True, "float32", 33),
    "relu-every-option-bf16-n8": ("relu", True, True, True, "bfloat16", 8),
})


@pytest.mark.parametrize("case", list(PASS_CASES))
def test_epilogue_pass_matches_pallas(case):
    """Stage 2 alone on an f32 accumulator against JAX's Pallas pass:
    1e-6 in f32 out (the same f32 arithmetic), 1e-2 in bf16 out (one bf16
    ulp: the f32 results may round to neighbouring bf16 values)."""
    act, with_c, with_bias, with_cap, out, n_ = PASS_CASES[case]
    rng = RNG if case in _ACTS else np.random.default_rng(len(case) * n_)
    acc = (rng.standard_normal((37, n_)) * 3).astype(np.float32)
    c = rng.standard_normal((37, n_)).astype(np.float32)
    bias = rng.standard_normal(n_).astype(np.float32)
    epi = JEpilogue(alpha=0.7, beta=0.5 if with_c else 0.0,
                    has_bias=with_bias, softcap=4.0 if with_cap else None,
                    activation=act)
    want = epilogue_pass_pallas(
        jnp.asarray(acc), jnp.asarray(c) if with_c else None,
        jnp.asarray(bias) if with_bias else None, epilogue=epi,
        out_dtype=getattr(jnp, out), interpret=True)
    got = trigid.epilogue_pass_torch(
        t(acc), t(c) if with_c else None, t(bias) if with_bias else None,
        epilogue=_tepi(epi), out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    tol = 1e-6 if out == "float32" else 1e-2
    np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "bf16acc", "int8"])
def test_ops_amx_policy_matches_jax_per_format(fmt):
    """``mte_gemm(policy="amx")``: the format's arithmetic on the rigid
    route (bf16acc accumulates in f32 there, as in JAX; int8 quantizes,
    accumulates in int32, dequantizes outside).  1e-5: exact products
    and f32 sums in both packages."""
    m, n_, k = 40, 200, 96
    a = (RNG.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    b = RNG.standard_normal((k, n_)).astype(np.float32)
    bias = RNG.standard_normal(n_).astype(np.float32)
    epi = JEpilogue(has_bias=True, activation="gelu")
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b),
                         bias=jnp.asarray(bias), epilogue=epi, policy="amx",
                         format_policy=fmt)
    got = tops.mte_gemm(t(a), t(b), bias=t(bias), epilogue=_tepi(epi),
                        policy="amx", format_policy=fmt)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def test_amx_policy_plans_the_rigid_tile_and_refuses_other_pins():
    """The rigid policy is granted one geometry whatever the shape, routes
    to ``rigid``, and a pinned geometry no kernel is compiled for raises
    instead of being replanned."""
    cache = tautotune.PlanCache(profile=tgeometry.H100_SPEC)
    for m, n_, k in [(4, 2048, 2048), (512, 16384, 2048), (7, 9, 13)]:
        sig = tautotune.GemmSignature.make(m, n_, k, "bfloat16",
                                           "bfloat16", policy="amx",
                                           fmt="bf16")
        plan = cache.plan(sig)
        g = plan.geometry
        assert plan.route == "rigid"
        assert (g.bm, g.bn, g.bk, g.split_k) == (128, 128, 128, 1)
    grouped = tautotune.GemmSignature.make(4, 2048, 2048, "bfloat16",
                                           "bfloat16", group=3, fmt="bf16")
    assert cache.plan(grouped).route == "grouped"
    assert cache.plan(grouped).geometry.split_k == 1
    a, b = torch.zeros(8, 16), torch.zeros(16, 8)
    bad = dataclasses.replace(cache.plan(grouped).geometry, bm=32)
    with pytest.raises(ValueError, match="no 'mte' kernel"):
        tops.mte_gemm(a, b, geometry=bad)
    rigid = dataclasses.replace(bad, bm=64, bn=64, policy="amx")
    with pytest.raises(ValueError, match="no 'amx' kernel"):
        tops.mte_gemm(a, b, policy="amx", geometry=rigid)
