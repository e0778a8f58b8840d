"""The port's SIMT f32 engine (``csrc/simt_f32_mainloop.cuh``) on the plan
side: which launches ``geometry.gemm_engine`` and ``geometry.splitk_engine``
send to it, that every backward GEMM of a full-width gemma_2b layer plans
onto it within the block's shared memory, that the plan is a pure
function of the signature, and the JAX package's f32 products and
gradients through plans on it (plain versions on the CPU; the kernel
itself is held to the tile loop bit for bit in test_torch_cuda.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.epilogue import Epilogue as JEpilogue
from repro.kernels import ops as jops

from torch_lazy import LazyModule, torch
from torch_parity import n, t

tautotune = LazyModule("repro_torch.core.autotune")
tbuild = LazyModule("repro_torch.kernels.build")
tepilogue = LazyModule("repro_torch.core.epilogue")
tgeometry = LazyModule("repro_torch.core.geometry")
tgemm = LazyModule("repro_torch.kernels.mte_gemm")
tops = LazyModule("repro_torch.kernels.ops")
tsplitk = LazyModule("repro_torch.kernels.splitk_gemm")

SIMT = [(128, 128), (128, 64)]
SMEM_LIMIT = 227 * 1024

# gemma_2b at its published widths over a 4096-token training batch: d
# 2048, 8 heads x 256 (q and o 2048 wide), one 256-wide kv head, d_ff
# 16384.  Each projection (d_in -> d_out) gives dA = dacc @ W^T (T x d_in
# x d_out, W read transposed) and dB = A^T @ dacc (d_in x d_out x T); the
# gate also its accumulator's recompute (its gelu reads it).
TOKENS = 4096
PROJECTIONS = {"q": (2048, 2048), "k": (2048, 256), "v": (2048, 256),
               "o": (2048, 2048), "gate": (2048, 16384),
               "up": (2048, 16384), "down": (16384, 2048)}


def _backward_gemms():
    out = []
    for name, (d_in, d_out) in PROJECTIONS.items():
        if name == "gate":
            out.append((f"{name} recompute", TOKENS, d_out, d_in))
        out.append((f"{name} dA", TOKENS, d_in, d_out))
        out.append((f"{name} dB", d_in, d_out, TOKENS))
    return out


@pytest.fixture(autouse=True)
def fresh_cache():
    tautotune.reset_cache()
    yield
    tautotune.reset_cache()


@pytest.mark.parametrize("dtype,bm,bn,m,n_,k,rigid,want", [
    ("float32", 128, 128, 4096, 16384, 2048, False, "simt"),
    ("float32", 128, 64, 2048, 256, 4096, False, "simt"),
    ("float32", 128, 128, 17, 256, 128, False, "simt"),     # M > 16
    ("float32", 128, 128, 100, 72, 132, False, "simt"),     # K % 16 != 0
    ("float32", 128, 128, 4096, 2048, 2046, False, None),   # K % 4
    ("float32", 128, 128, 4096, 2050, 2048, False, None),   # N % 4
    ("float32", 64, 64, 4096, 2050, 2046, False, "tile"),   # unaligned
    ("float32", 64, 64, 4096, 2048, 2048, False, "tile"),   # pinned loop
    ("float32", 128, 128, 16, 2048, 2048, False, None),     # M <= 16
    ("float32", 16, 128, 16, 2048, 2048, False, "tile"),    # decode
    ("float32", 128, 256, 4096, 2048, 2048, False, None),
    ("int8", 128, 128, 4096, 2048, 2048, False, "wgmma"),   # s8
    ("int8", 64, 64, 4096, 2048, 2048, False, "wgmma"),
    ("int8", 64, 64, 4096, 2048, 2040, False, "tile"),      # K % 16
    ("int8", 128, 128, 16, 2048, 2048, False, None),        # M <= 16
    ("bfloat16", 128, 128, 4096, 2048, 2048, False, "wgmma"),
    ("bfloat16", 128, 128, 4096, 2044, 2048, False, None),  # N % 8
    ("float32", 128, 128, 4096, 2048, 2048, True, "simt"),  # rigid tile
])
def test_gemm_engine_table(dtype, bm, bn, m, n_, k, rigid, want):
    call = lambda: tgeometry.gemm_engine(  # noqa: E731
        getattr(torch, dtype), bm, bn, n_, k, m=m, rigid=rigid)
    if want is None:
        with pytest.raises(ValueError, match="GEMM engine"):
            call()
    else:
        assert call() == want


@pytest.mark.parametrize("dtype,tile,m,n_,k,want", [
    ("float32", (128, 128), 2048, 256, 4096, "simt"),
    ("float32", (128, 64), 2048, 256, 4096, "simt"),
    ("float32", (128, 128), 2048, 258, 4096, "tile"),       # N % 4
    ("float32", (128, 128), 2048, 256, 4094, "tile"),       # K % 4
    ("float32", (64, 64), 2048, 256, 4096, "tile"),         # pinned loop
    ("float32", (128, 128), 16, 256, 4096, "tile"),         # M <= 16
    ("float32", (16, 128), 4, 2048, 2048, "tile"),          # decode
    ("float32", None, 2048, 256, 4096, "tile"),             # no tile
    ("int8", (128, 128), 2048, 256, 4096, "tile"),
    ("bfloat16", (16, 128), 4, 2048, 2048, "cluster"),
    ("bfloat16", (128, 128), 2048, 256, 4096, "tile"),
])
def test_splitk_engine_table(dtype, tile, m, n_, k, want):
    assert tgeometry.splitk_engine(getattr(torch, dtype), m, n_, k,
                                   tile=tile) == want


def test_a_split_tile_no_engine_takes_raises_on_the_cpu_too():
    """bf16 past 16 rows splits on the tile loop only: a SIMT tile is
    refused, not replanned (the f32 operands it takes run)."""
    sew = tgeometry.SEW.E16
    geom = tgeometry.BlockGeometry(128, 128, 64, 4, 1, False, sew, sew,
                                   "mte")
    a, b = torch.zeros(32, 256), torch.zeros(256, 64)
    with pytest.raises(ValueError, match="no engine takes the tile"):
        tsplitk.mte_gemm_splitk_kernel(a.bfloat16(), b.bfloat16(),
                                       geom=geom, n_split=4)
    got = tsplitk.mte_gemm_splitk_kernel(a, b, geom=geom, n_split=4)
    assert got.shape == (32, 64)


def test_an_m16_launch_on_a_simt_tile_raises_on_the_cpu_too():
    sew = tgeometry.SEW.E32
    geom = tgeometry.BlockGeometry(128, 128, 64, 1, 1, False, sew, sew,
                                   "mte")
    with pytest.raises(ValueError, match="no mte GEMM engine"):
        tgemm.mte_gemm_kernel(torch.zeros(16, 64), torch.zeros(64, 128),
                              geom=geom)
    assert tgemm.mte_gemm_kernel(torch.zeros(17, 64), torch.zeros(64, 128),
                                 geom=geom).shape == (17, 128)


@pytest.mark.parametrize("bm,bn", SIMT)
def test_simt_tiles_fit_shared_memory_twice(bm, bn):
    """The ring of 4 stages of 16 K rows, each row 4 floats past the
    tile, fits a block's 227 KB, and two blocks fit an SM's 228 KB (1 KB
    of each reserved)."""
    sew = tgeometry.SEW.E32
    g = tgeometry.BlockGeometry(bm, bn, 256, 1, 1, False, sew, sew, "mte")
    smem = g.smem_bytes("simt")
    assert smem == 4 * 16 * (bm + 4 + bn + 4) * 4
    assert g.smem_bytes() == smem          # an f32 SIMT tile by default
    assert 2 * (smem + 1024) <= 228 * 1024
    tgeometry.check_kernel_tile(dataclasses.replace(g, split_k=4))


@pytest.mark.parametrize("label,m,n_,k", _backward_gemms(),
                         ids=[g[0] for g in _backward_gemms()])
def test_every_backward_gemm_of_a_full_width_layer_plans_the_simt_engine(
        label, m, n_, k):
    """Every backward GEMM of a full-width gemma_2b layer (f32: the
    parameters are f32) plans onto the SIMT engine, on B1, or on B2 where
    the plan splits K (the k/v dB: 2048 x 256 makes 32 tiles of 128 x
    128), within the block's shared memory; none on the tile loop."""
    plan = tautotune.get_plan(m, n_, k, torch.float32, torch.float32)
    engine = tautotune.plan_engine(plan.signature, plan.geometry)
    assert engine == "simt", plan.describe()
    assert (plan.geometry.bm, plan.geometry.bn) in SIMT
    assert plan.route == ("splitk" if label in ("k dB", "v dB") else "mte")
    assert plan.geometry.smem_bytes(engine) <= SMEM_LIMIT


def test_a_full_width_step_counts_its_backward_gemms_per_engine():
    """18 layers x 15 backward GEMMs: 234 on B1's SIMT engine, 36 split
    on B2's (chip_smoke.py's launch check reads the same split)."""
    per = {"mte": 0, "splitk": 0}
    for _, m, n_, k in _backward_gemms():
        per[tautotune.get_plan(m, n_, k, torch.float32,
                               torch.float32).route] += 1
    assert {r: 18 * c for r, c in per.items()} == {"mte": 234, "splitk": 36}


@pytest.mark.parametrize("m,n_,k", [(4096, 16384, 2048), (2048, 256, 4096),
                                    (17, 260, 36), (520, 2056, 1032)])
def test_the_plan_is_a_pure_function_of_the_signature(m, n_, k):
    """Two caches, each asked after a different history, grant the same
    plan; candidates and prices depend on the signature (and the card's
    profile) alone."""
    spec = tgeometry.H100_SPEC
    one = tautotune.PlanCache(profile=spec)
    two = tautotune.PlanCache(profile=spec)
    for sig in (tautotune.GemmSignature.make(64, 64, 64, "float32",
                                             "float32"),
                tautotune.GemmSignature.make(4096, 256, 128, "bfloat16",
                                             "bfloat16")):
        two.plan(sig)
    sig = tautotune.GemmSignature.make(m, n_, k, "float32", "float32")
    a, b = one.plan(sig), two.plan(sig)
    assert a.geometry == b.geometry and a.route == b.route
    assert a.predicted_s == b.predicted_s
    cands = tautotune.enumerate_candidates(sig, spec)
    assert cands == tautotune.enumerate_candidates(sig, spec)
    assert [tautotune.score_geometry(sig, g, spec) for g in cands] == \
        [tautotune.score_geometry(sig, g, spec) for g in cands]


def test_simt_tiles_are_priced_without_the_load_stretch():
    """``blocks_per_sm`` models the tile loop's missing load pipeline: it
    moves the price of a tile-loop plan and leaves a SIMT plan's, which
    is tile waves at one SM's share of 67 TFLOP/s."""
    spec = tgeometry.H100_SPEC
    deep = dataclasses.replace(spec, blocks_per_sm=16)
    sig = tautotune.GemmSignature.make(4096, 16384, 2048, "float32",
                                       "float32")
    sew = tgeometry.SEW.E32
    simt = tgeometry.BlockGeometry(128, 128, 256, 1, 1, False, sew, sew,
                                   "mte")
    assert tautotune.plan_engine(sig, simt) == "simt"
    price = tautotune.score_geometry(sig, simt, spec)
    assert price == tautotune.score_geometry(sig, simt, deep)
    waves = -(-(32 * 128) // spec.sm_count)
    tile = 2.0 * 128 * 128 * 2048 / (spec.peak_fp32_flops / spec.sm_count)
    assert price == pytest.approx(waves * tile + spec.launch_s)
    small = tautotune.GemmSignature.make(512, 2048, 2048, "float32",
                                         "float32")
    loop = dataclasses.replace(simt, bm=64, bn=64)
    assert tautotune.score_geometry(small, loop, spec) < \
        tautotune.score_geometry(small, loop, deep)
    assert tautotune.score_geometry(small, simt, spec) == \
        tautotune.score_geometry(small, simt, deep)


@pytest.mark.parametrize("m,n_,k", [(136, 264, 200), (300, 72, 1036)])
def test_f32_through_a_simt_plan_matches_jax(m, n_, k):
    """f32 GEMMs whose plan runs on the SIMT engine give JAX's result
    with a full epilogue (plain version here)."""
    rng = np.random.default_rng(m)
    a = (rng.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal((k, n_)).astype(np.float32)
    c = rng.standard_normal((m, n_)).astype(np.float32)
    bias = rng.standard_normal(n_).astype(np.float32)
    kw = dict(alpha=0.7, beta=0.5, has_bias=True, softcap=20.0,
              activation="gelu")
    plan = tautotune.get_plan(m, n_, k, torch.float32, torch.float32,
                              epilogue=tepilogue.Epilogue(**kw), fmt="fp32")
    assert tautotune.plan_engine(plan.signature, plan.geometry) == "simt"
    want = jops.mte_gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                         jnp.asarray(bias), epilogue=JEpilogue(**kw),
                         format_policy="fp32")
    got = tops.mte_gemm(t(a), t(b), t(c), t(bias),
                        epilogue=tepilogue.Epilogue(**kw),
                        format_policy="fp32")
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def test_backward_on_simt_plans_matches_jax():
    """The gradients of a bf16-format projection of f32 parameters whose
    backward GEMMs (recompute, dA with W read transposed, dB split on B2)
    all plan onto the SIMT engine, against JAX's custom VJP: within 1e-5
    of the largest entry, as ``test_torch_autodiff.py`` holds them."""
    m, k, n_ = 128, 256, 64
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((m, k)) / 16).astype(np.float32)
    w = (rng.standard_normal((k, n_)) / 16).astype(np.float32)
    ct = rng.standard_normal((m, n_)).astype(np.float32)
    for mm, nn, kk in ((m, n_, k), (m, k, n_), (k, n_, m)):
        plan = tautotune.get_plan(mm, nn, kk, torch.float32, torch.float32)
        assert tautotune.plan_engine(plan.signature,
                                     plan.geometry) == "simt"
    jepi = JEpilogue(activation="gelu")

    def jloss(a_, w_):
        return jnp.sum(jops.mte_gemm(a_, w_, epilogue=jepi,
                                     format_policy="fp32") * ct)

    jgrads = jax.grad(jloss, argnums=(0, 1))(a, w)
    leaves = [t(a).requires_grad_(), t(w).requires_grad_()]
    out = (tops.mte_gemm(*leaves, epilogue=tepilogue.Epilogue(
        activation="gelu"), format_policy="fp32") * t(ct)).sum()
    tgrads = torch.autograd.grad(out, leaves)
    for got, want in zip(tgrads, jgrads):
        got, want = n(got), n(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_the_new_counters_exist():
    names = tbuild.KERNEL_NAMES
    assert "mte_gemm_simt" in names and "splitk_gemm_simt" in names
    assert tbuild.launch_counts()["mte_gemm_simt"] == 0
