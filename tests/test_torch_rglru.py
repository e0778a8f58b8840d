"""The port's B7 and B6 plain versions and its RG-LRU block against the
JAX package, on the CPU: the same numpy inputs through the Pallas kernels
(interpret mode) and ``repro.models.rglru`` on one side, the port's plain
versions and ``repro_torch.models.rglru`` on the other.  The CUDA kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode_pallas
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro.models import rglru as jrglru

from torch_lazy import LazyModule, torch
from torch_parity import TOL, n, t

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")
tref = LazyModule("repro_torch.kernels.ref")
tscan = LazyModule("repro_torch.kernels.rglru_scan")
tdecode = LazyModule("repro_torch.kernels.flash_decode")
trglru = LazyModule("repro_torch.models.rglru")


def test_config_matches_jax_and_reduces_like_it():
    full = tconfigs.get_config("recurrentgemma_9b")
    jfull = jget_config("recurrentgemma_9b")
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "hd",
                  "d_ff", "vocab", "window", "pattern", "mlp_type",
                  "rope_theta", "embed_scale", "tied_embeddings"):
        assert getattr(full, field) == getattr(jfull, field), field
    assert dataclasses.asdict(full.rglru) == dataclasses.asdict(jfull.rglru)
    red, jred = full.reduced(), jfull.reduced()
    assert (red.window, red.rglru.width, red.n_layers) == (16, 128, 6)
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "hd",
                  "d_ff", "vocab", "window", "compute_dtype"):
        assert getattr(red, field) == getattr(jred, field), field
    assert dataclasses.asdict(red.rglru) == dataclasses.asdict(jred.rglru)
    assert full.layer_kinds == jfull.layer_kinds


# -- B7: the RG-LRU scan -----------------------------------------------------

def _scan_inputs(s, w=48, b=2, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, x


@pytest.mark.parametrize("s", [1, 63, 64, 100])
def test_rglru_scan_plain_matches_pallas(s):
    a, b = _scan_inputs(s, seed=s)
    want = rglru_scan_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = tscan.rglru_scan_torch(t(a), t(b))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)
    if s == 64:
        np.testing.assert_allclose(
            n(tref.rglru_scan(t(a), t(b))),
            n(jref.rglru_scan(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-6, atol=1e-6)


def test_rglru_scan_refuses_other_dtypes():
    a, b = _scan_inputs(4)
    with pytest.raises(TypeError):
        tscan.rglru_scan_kernel(t(a).double(), t(b).double())


def _h0(b=2, w=48, seed=0):
    rng = np.random.default_rng(1000 + seed)
    return rng.standard_normal((b, w)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 63, 64, 100, 512])
def test_rglru_scan_from_h0_matches_pallas_and_fold(s):
    """The scan from h0 against JAX's resumed chunk: the zero-state Pallas
    scan plus exp(cumsum(log a))·h0 (``repro/models/rglru.py``), up to
    the served chunk's 512 steps.  The two round differently (a product
    of the a's against the exp of a sum of their logs): within 1e-5
    (``TOL["fp32"]``)."""
    a, b = _scan_inputs(s, seed=s)
    h0 = _h0(seed=s)
    ja = jnp.asarray(a)
    want = (rglru_scan_pallas(ja, jnp.asarray(b), interpret=True)
            + jnp.exp(jnp.cumsum(jnp.log(ja), axis=1))
            * jnp.asarray(h0)[:, None])
    got = tscan.rglru_scan_torch(t(a), t(b), t(h0))
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])
    # On CPU tensors the kernel wrapper is the plain version.
    assert torch.equal(tscan.rglru_scan_kernel(t(a), t(b), t(h0)), got)


@pytest.mark.parametrize("lo", [0.9, 0.99, 0.999])
def test_rglru_scan_from_h0_matches_fold_at_served_chunk(lo):
    """The same comparison at the served chunk's 512 steps with the decay
    near 1, as RG-LRU's gates give it, and the input scaled by
    sqrt(1 - a²) as ``models/rglru.py:_scan_inputs`` scales it (so h
    stays O(1)): within 1e-5 (``TOL["fp32"]``).  Unscaled inputs let h
    grow far past 1 there, and the two then differ by a few ulps of h
    (ROADMAP §C)."""
    rng = np.random.default_rng(512)
    a = rng.uniform(lo, 1.0, (2, 512, 48)).astype(np.float32)
    b = (rng.standard_normal((2, 512, 48))
         * np.sqrt(1.0 - a.astype(np.float64) ** 2)).astype(np.float32)
    h0 = _h0(seed=512)
    ja = jnp.asarray(a)
    want = (rglru_scan_pallas(ja, jnp.asarray(b), interpret=True)
            + jnp.exp(jnp.cumsum(jnp.log(ja), axis=1))
            * jnp.asarray(h0)[:, None])
    got = tscan.rglru_scan_torch(t(a), t(b), t(h0))
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])


@pytest.mark.parametrize("s", [1, 63, 64, 100])
def test_rglru_scan_zero_state_is_unchanged(s):
    """Without h0 the plain version gives the zero-state scan bit for bit:
    the oracle's (``kernels/ref.py``, one step per position from zeros)
    and an explicit zero h0's."""
    a, b = _scan_inputs(s, seed=s)
    got = tscan.rglru_scan_torch(t(a), t(b))
    assert torch.equal(got, tref.rglru_scan(t(a), t(b)))
    assert torch.equal(got, tscan.rglru_scan_torch(t(a), t(b),
                                                   torch.zeros(2, 48)))


@pytest.mark.parametrize("cut", [1, 37, 64, 99])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_chained_equals_one_scan(cut, with_h0):
    """Two chained calls, the second from the first's last row, give one
    call's states bit for bit: a chunked prefill carries exactly the
    state of one scan."""
    a, b = _scan_inputs(100, seed=cut)
    ta, tb = t(a), t(b)
    h0 = t(_h0(seed=cut)) if with_h0 else None
    whole = tscan.rglru_scan_torch(ta, tb, h0)
    first = tscan.rglru_scan_torch(ta[:, :cut], tb[:, :cut], h0)
    second = tscan.rglru_scan_torch(ta[:, cut:], tb[:, cut:], first[:, -1])
    assert torch.equal(torch.cat([first, second], dim=1), whole)


@pytest.mark.parametrize("shape,bad", [((2, 47), ValueError),
                                       ((48,), ValueError),
                                       ((2, 48), TypeError)])
def test_rglru_scan_refuses_bad_h0(shape, bad):
    a, b = _scan_inputs(4)
    h0 = torch.zeros(shape, dtype=torch.float64 if bad is TypeError
                     else torch.float32)
    with pytest.raises(bad):
        tscan.rglru_scan_kernel(t(a), t(b), h0)


@pytest.mark.parametrize("dtype,b,s,w,aligned,want", [
    ("float32", 1, 512, 4096, True, "staged"),     # the serving chunk
    ("float32", 1, 4096, 4096, True, "staged"),    # a 4096-token chunk
    ("float32", 1, 8, 128, True, "staged"),        # reduced recurrentgemma
    ("float32", 2, 1, 48, True, "staged"),
    ("float32", 1, 70, 4100, True, "staged"),      # a partial last slab
    ("float32", 1, 8, 126, True, "direct"),        # W not a multiple of 4
    ("float32", 1, 70, 4098, True, "direct"),
    ("float32", 1, 512, 4096, False, "direct"),    # unaligned bases
    ("bfloat16", 1, 512, 4096, True, "direct"),
    ("float32", 70000, 4, 48, True, "direct"),     # past the grid's B
])
def test_scan_engine_table(dtype, b, s, w, aligned, want):
    from repro_torch.core import geometry
    assert geometry.scan_engine(getattr(torch, dtype), b, s, w,
                                aligned) == want


# -- B6: flat / ring flash decode (the cases of tests/test_flash_decode.py) --

def _decode_case(case, seed=0):
    """q (B,H,D), k/v (B,Hkv,S,D), kv_positions (B,S), q_pos (B,) and the
    kernel options for one case."""
    rng = np.random.default_rng(seed)
    b, h, hkv, d = 3, 8, 2, 32                 # G = 4
    lens = np.array([5, 17, 25], np.int32)     # ragged: straddles blocks
    s = int(lens.max())
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    idx = np.arange(s)[None]
    kvpos = np.where(idx < lens[:, None], idx, -1).astype(np.int32)
    qpos = (lens - 1).astype(np.int32)
    kw = {}
    if case == "window_softcap":
        kw = dict(window=8, softcap=30.0)
    elif case == "ring":
        # A 16-slot ring at positions past one wrap, one row not yet full:
        # slot i holds pos - ((pos - i) mod 16), unwritten slots -1.
        length = 16
        k, v = k[:, :, :length], v[:, :, :length]
        qpos = np.array([37, 16, 9], np.int32)
        ring = qpos[:, None] - (qpos[:, None] - np.arange(length)) % length
        kvpos = np.where(ring >= 0, ring, -1).astype(np.int32)
        kw = dict(window=16)
    elif case == "empty_row":
        kvpos[1] = -1
    return q, k, v, kvpos, qpos, kw


@pytest.mark.parametrize("case", ["ragged", "window_softcap", "ring",
                                  "empty_row"])
def test_flash_decode_plain_matches_pallas(case):
    q, k, v, kvpos, qpos, kw = _decode_case(case)
    want = flash_decode_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(kvpos),
                               jnp.asarray(qpos), interpret=True, **kw)
    got = tdecode.flash_decode_torch(t(q), t(k), t(v), t(kvpos), t(qpos),
                                     **kw)
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["fp32"],
                               atol=TOL["fp32"])
    if case == "empty_row":
        assert torch.count_nonzero(got[1]) == 0


def test_flash_decode_plain_bf16_storage_and_strided_ring():
    """bf16 storage, read through the (B, L, Hkv, D) ring layout's
    transposed view; NaN in an unwritten slot must not reach the output
    (the Pallas kernel zeroes V rows with kvpos < 0)."""
    q, k, v, kvpos, qpos, kw = _decode_case("ring", seed=1)
    v[2, :, 12] = np.nan                       # row 2 has never reached 12
    assert kvpos[2, 12] == -1
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = flash_decode_pallas(qb, kb, vb, jnp.asarray(kvpos),
                               jnp.asarray(qpos), interpret=True, **kw)
    ring_k = t(np.asarray(kb)).transpose(1, 2).contiguous()
    ring_v = t(np.asarray(vb)).transpose(1, 2).contiguous()
    got = tdecode.flash_decode_torch(
        t(np.asarray(qb)), ring_k.transpose(1, 2), ring_v.transpose(1, 2),
        t(kvpos), t(qpos), **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    np.testing.assert_allclose(n(got), n(want), rtol=TOL["bf16"],
                               atol=TOL["bf16"])


# -- the RG-LRU block -----------------------------------------------------------

def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config("recurrentgemma_9b").reduced(),
                               gemm_backend="pallas", **kw)
    tcfg = dataclasses.replace(
        tconfigs.get_config("recurrentgemma_9b").reduced(), **kw)
    return jcfg, tcfg


def _block_params(jcfg, seed=0):
    from repro_torch.tree import tree_map
    jp = jrglru.init_rglru(jax.random.PRNGKey(seed), jcfg)
    # lam away from its constant init, so the gates see distinct values
    jp["lam"] = jnp.linspace(-1.0, 2.0, jp["lam"].shape[0])
    tp = tree_map(lambda a: t(np.asarray(a, np.float32)),
                  jax.tree.map(np.asarray, jax.device_get(jp)))
    return jp, tp


def _close_tree(got, want, tol):
    for name in want:
        np.testing.assert_allclose(n(got[name]), n(want[name]), rtol=tol,
                                   atol=tol, err_msg=name)


def test_rglru_forward_matches_jax_whole_and_resumed():
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (1, 24, jcfg.d_model)).astype(np.float32)
    jout, jcache = jrglru.rglru_forward(jnp.asarray(x), jp, jcfg,
                                        return_cache=True)
    tout, tcache = trglru.rglru_forward(t(x), tp, tcfg)
    np.testing.assert_allclose(n(tout), n(jout), rtol=TOL["fp32"],
                               atol=TOL["fp32"])
    _close_tree(tcache, jcache, TOL["fp32"])
    # Two chunks: the second resumes the first's state.
    outs = []
    jc = tc = None
    for lo, hi in ((0, 12), (12, 24)):
        jo, jc = jrglru.rglru_forward(jnp.asarray(x[:, lo:hi]), jp, jcfg,
                                      return_cache=True, cache=jc)
        to, tc = trglru.rglru_forward(t(x[:, lo:hi]), tp, tcfg, cache=tc)
        np.testing.assert_allclose(n(to), n(jo), rtol=TOL["fp32"],
                                   atol=TOL["fp32"])
        outs.append(to)
    _close_tree(tc, jc, TOL["fp32"])
    np.testing.assert_allclose(n(torch.cat(outs, dim=1)), n(tout),
                               rtol=TOL["fp32"], atol=TOL["fp32"])


def test_rglru_decode_matches_jax_and_keeps_invalid_rows():
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    w = jcfg.rglru.width
    cache = {"h": rng.standard_normal((3, w)).astype(np.float32),
             "conv": rng.standard_normal((3, 4, w)).astype(np.float32)}
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    jout, jc = jrglru.rglru_decode(jnp.asarray(x), jp, jcfg,
                                   {k: jnp.asarray(v)
                                    for k, v in cache.items()})
    tc = {k: t(v) for k, v in cache.items()}
    tout, tc = trglru.rglru_decode(t(x), tp, tcfg, tc)
    np.testing.assert_allclose(n(tout), n(jout), rtol=TOL["fp32"],
                               atol=TOL["fp32"])
    _close_tree(tc, jc, TOL["fp32"])
    # With row_valid, rows marked False keep their state exactly.
    tc = {k: t(v) for k, v in cache.items()}
    _, tc = trglru.rglru_decode(t(x), tp, tcfg, tc,
                                row_valid=torch.tensor([True, False, True]))
    for name in cache:
        np.testing.assert_array_equal(tc[name][1].numpy(), cache[name][1])
        np.testing.assert_allclose(n(tc[name][[0, 2]]),
                                   n(jc[name])[[0, 2]], rtol=TOL["fp32"],
                                   atol=TOL["fp32"])
