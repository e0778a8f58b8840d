"""B8's int8 stage 1 on the s8 path of the wgmma mainloop (counter
``rigid_gemm_wgmma_s8``): the rigid engine rule (``geometry.gemm_engine``
with ``rigid=True``: int8 at every M with K % 16 == 0, N % 8 == 0 and K up
to ``S8_MAX_K``, the tile loop otherwise), gemma_2b's plans under
``gemm_policy="amx"`` and ``format_policy="int8"`` and their price,
``ops.mte_gemm(policy="amx")`` under int8 and int8pt against the JAX
package's rigid path in interpret mode, and reduced gemma_2b served under
amx x int8 against the JAX engine on its pallas backend.  On the CPU the
wrappers run their plain versions; the CUDA kernel against those is in
test_torch_cuda.py.

The JAX rigid stage 1 (``rigid_gemm_pallas``) writes its int32
accumulator through f32 (``mte_gemm_pallas(..., out_dtype=f32)``, then a
cast), so sums past 2^24 come back rounded to an f32 value; the port's
stage 1 keeps int32 and is exact.  ``formats.dequantize`` converts the
int32 sum to f32 (round to nearest even) before it scales, which gives the
same f32 as JAX's rounded sum.  So the raw accumulators are held equal
only below 2^24, and the dequantized outputs equal everywhere: the
difference is not a fault of either."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import formats as jformats
from repro.kernels import ops as jops
from repro.kernels.rigid_gemm import rigid_gemm_pallas
from repro.serving.engine import Request as JRequest

from torch_lazy import LazyModule, torch
from torch_parity import jax_cfg, jax_params, n, t, torch_cfg
from test_torch_graph_serving import _serve
from test_torch_serving import _COUNTERS, _KW, _jax_engine, _prompts

tautotune = LazyModule("repro_torch.core.autotune")
tbuild = LazyModule("repro_torch.kernels.build")
tengine = LazyModule("repro_torch.serving.engine")
tepilogue = LazyModule("repro_torch.core.epilogue")
tformats = LazyModule("repro_torch.core.formats")
tgeometry = LazyModule("repro_torch.core.geometry")
tops = LazyModule("repro_torch.kernels.ops")
trigid = LazyModule("repro_torch.kernels.rigid_gemm")

RNG = np.random.default_rng(31)

# gemma_2b's projections (N, K): q/o, k/v, gate = up, down.
GEMMA_PROJ = [(2048, 2048), (256, 2048), (16384, 2048), (2048, 16384)]


@pytest.fixture(autouse=True)
def fresh_cache():
    tautotune.reset_cache(profile=tautotune.H100_SPEC)
    yield
    tautotune.reset_cache()


def _engine(m, n_, k):
    return tgeometry.gemm_engine(torch.int8, 128, 128, n_, k, m=m,
                                 rigid=True)


# -- the engine rule ------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 16, 512, 4096])
@pytest.mark.parametrize("n_,k", [(2048, 2048), (16384, 2048),
                                  (2048, 16384), (72, 144), (2056, 1040)])
def test_rigid_int8_takes_the_s8_engine_at_every_m(m, n_, k):
    assert _engine(m, n_, k) == "wgmma"


@pytest.mark.parametrize("m", [1, 4, 16, 512, 4096])
@pytest.mark.parametrize("n_,k,why", [
    (2048, 2040, "K % 16"), (2052, 2048, "N % 8"), (257, 65, "both"),
    (128, 131072 + 16, "K past S8_MAX_K")])
def test_rigid_int8_off_the_rule_stays_on_the_tile_loop(m, n_, k, why):
    assert _engine(m, n_, k) == "tile", why


@pytest.mark.parametrize("m,want", [(4, None), (16, None), (17, "wgmma"),
                                    (512, "wgmma")])
def test_b1_s8_rule_is_unchanged(m, want):
    """B1 keeps its rule: int8 at a wgmma tile only past 16 rows (no
    128 x 128 kernel runs at M <= 16 off the rigid route)."""
    call = lambda: tgeometry.gemm_engine(  # noqa: E731
        torch.int8, 128, 128, 2048, 2048, m=m)
    if want is None:
        with pytest.raises(ValueError, match="GEMM engine"):
            call()
    else:
        assert call() == want


def test_the_rigid_s8_counter_exists():
    assert "rigid_gemm_wgmma_s8" in tbuild.KERNEL_NAMES
    assert tbuild.launch_counts()["rigid_gemm_wgmma_s8"] == 0


# -- gemma_2b's plans under amx x int8 ----------------------------------------

@pytest.mark.parametrize("m", [4, 512], ids=["decode", "prefill"])
@pytest.mark.parametrize("n_,k", GEMMA_PROJ,
                         ids=["q-o", "k-v", "gate-up", "down"])
@pytest.mark.parametrize("fmt", ["int8", "int8pt"])
def test_gemma_amx_int8_plans_run_rigid_on_wgmma(m, n_, k, fmt):
    plan = tautotune.get_plan(m, n_, k, torch.int8, torch.int32,
                              policy="amx", fmt=fmt)
    g = plan.geometry
    assert plan.route == "rigid"
    assert (g.bm, g.bn, g.bk, g.split_k) == (128, 128, 128, 1)
    assert tautotune.plan_engine(plan.signature, g) == "wgmma"


@pytest.mark.parametrize("m,n_,k", [(512, 16384, 2048), (4, 2048, 16384),
                                    (512, 2056, 1040), (4, 72, 144)])
def test_rigid_int8_price_is_the_wgmma_branch(m, n_, k):
    """The rigid int8 plan is priced on the wgmma engine: tile waves at
    the int8 peak over K padded to the 128-deep stage, plus the
    accumulator's write and read back, plus one launch."""
    spec = tgeometry.H100_SPEC
    sig = tautotune.GemmSignature.make(m, n_, k, "int8", "int32",
                                       policy="amx", fmt="int8")
    geom = tgeometry.solve_block_geometry(m, n_, k, tgeometry.SEW.E8,
                                          tgeometry.SEW.E32, policy="amx")
    assert tautotune.plan_engine(sig, geom) == "wgmma"
    depth = -(-k // 128) * 128
    want = (tautotune._wave_seconds(sig, geom, spec, depth,
                                    2.0 * m * n_ * 4) + spec.launch_s)
    assert tautotune.score_geometry(sig, geom, spec) == want


# -- the wrappers on the CPU ----------------------------------------------------

def _ints(*shape):
    return RNG.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("m,n_,k", [(1, 72, 144), (4, 2056, 1040),
                                    (16, 264, 160), (130, 72, 2048)])
def test_rigid_int8_accumulate_is_exact(m, n_, k):
    """On CPU tensors stage 1 returns the exact int32 product, as the
    kernel must on the card (rows below the 128-row tile, K tails)."""
    a, b = _ints(m, k), _ints(k, n_)
    got = trigid.rigid_accumulate_kernel(t(a), t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_rigid_int8_refuses_a_non_identity_epilogue():
    a, b = t(_ints(4, 144)), t(_ints(144, 72))
    with pytest.raises(ValueError, match="identity epilogue"):
        trigid.rigid_gemm_kernel(a, b, epilogue=tepilogue.Epilogue(
            activation="gelu"))


# -- parity with JAX (interpret mode) through ops ------------------------------

def _past_2_24(m, k, n_):
    """f32 operands whose int8 quantization is ±127 (and a few small
    values), so the int32 sums pass 2^24 and some are not f32 values."""
    a = np.ones((m, k), np.float32)
    b = np.full((k, n_), -1.0, np.float32)
    b[::2, 1::2] = 1.0
    b[:3, ::3] = 1.0 / 127
    b[3, ::3] = 2.0 / 127
    return a, b


@pytest.mark.parametrize("fmt", ["int8", "int8pt"])
def test_ops_amx_int8_accumulators_match_jax_below_2_24(fmt):
    m, n_, k = 130, 264, 272
    a = RNG.standard_normal((m, k)).astype(np.float32)
    b = RNG.standard_normal((k, n_)).astype(np.float32)
    jfmt, tfmt = jformats.FORMATS[fmt], tformats.FORMATS[fmt]
    jaq, jbq, _, _ = jformats.quantize_operands(jnp.asarray(a),
                                                jnp.asarray(b), jfmt)
    aq, bq, _, _ = tformats.quantize_operands(t(a), t(b), tfmt)
    np.testing.assert_array_equal(aq.numpy(), np.asarray(jaq))
    np.testing.assert_array_equal(bq.numpy(), np.asarray(jbq))
    plan = tautotune.get_plan(m, n_, k, torch.int8, torch.int32,
                              policy="amx", fmt=fmt)
    acc = tautotune.execute_plan(plan, aq, bq)
    want_acc = rigid_gemm_pallas(jaq, jbq, out_dtype=jnp.int32,
                                 interpret=True)
    assert np.abs(np.asarray(want_acc)).max() < 2 ** 24
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    got = tops.mte_gemm(t(a), t(b), policy="amx", format_policy=fmt)
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b), policy="amx",
                         format_policy=fmt)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", ["int8", "int8pt"])
def test_ops_amx_int8_outputs_match_jax_past_2_24(fmt):
    """Past 2^24 the port's accumulator is exact and JAX's rounded
    through f32; the dequantized outputs are the same f32 values."""
    m, n_, k = 64, 64, 4096
    a, b = _past_2_24(m, k, n_)
    aq, bq, _, _ = tformats.quantize_operands(t(a), t(b),
                                              tformats.FORMATS[fmt])
    acc = trigid.rigid_accumulate_kernel(aq, bq)
    exact = aq.numpy().astype(np.int64) @ bq.numpy().astype(np.int64)
    np.testing.assert_array_equal(acc.numpy(), exact)
    assert np.abs(exact).max() > 2 ** 24
    jacc = np.asarray(rigid_gemm_pallas(jnp.asarray(aq.numpy()),
                                        jnp.asarray(bq.numpy()),
                                        out_dtype=jnp.int32, interpret=True))
    # JAX's sums went through f32: where the exact sum is not an f32
    # value they differ, and equal the exact sum rounded to f32.
    assert (jacc != exact).any()
    np.testing.assert_array_equal(
        jacc, exact.astype(np.float32).astype(np.int64))
    got = tops.mte_gemm(t(a), t(b), policy="amx", format_policy=fmt)
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b), policy="amx",
                         format_policy=fmt)
    np.testing.assert_array_equal(n(got), n(want))


# -- reduced gemma_2b served under amx x int8 ----------------------------------

def test_amx_int8_engine_matches_jax_engine():
    """The port's engine (graph programs on; amx keeps its three rigid
    q/k/v GEMMs) against the JAX engine on its pallas backend, both
    under ``gemm_policy="amx"`` and ``format_policy="int8"``: equal greedy
    tokens per request, page tables after every step, prefix-hash
    registrations and scheduler counters."""
    jcfg = dataclasses.replace(jax_cfg(), use_graph=True, gemm_policy="amx",
                               format_policy="int8")
    jp, tp = jax_params(jcfg)
    prompts = _prompts(jcfg.vocab)
    jeng = _jax_engine(jp, jcfg, async_steps=False, **_KW)
    tcfg = torch_cfg(use_graph=True, gemm_policy="amx", format_policy="int8")
    teng = tengine.ServingEngine(tp, tcfg, device="cpu", async_steps=False,
                                 **_KW)
    assert "qkv" not in teng.params["layers"][0]["mixer"]
    jout, jtables = _serve(jeng, JRequest, prompts)
    tout, ttables = _serve(teng, tengine.Request, prompts)
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        assert list(tout[rid]) == list(jout[rid]), rid
        assert tout[rid].status == jout[rid].status == "ok"
    assert ttables == jtables
    assert (teng.sched.pool.registrations()
            == jeng.sched.pool.registrations())
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["prefix_hit_pages"] > 0
    assert {k: tm[k] for k in _COUNTERS} == {k: jm[k] for k in _COUNTERS}
    plans = tautotune.plan_cache()._plans.values()
    assert plans and {p.route for p in plans} == {"rigid"}
    teng.sched.pool.audit()
