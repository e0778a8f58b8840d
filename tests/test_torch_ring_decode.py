"""The engine choice of the port's B6 (one-token attention over a flat or
ring cache): ``repro_torch.core.geometry.flat_decode_engine`` (B4's
mma.sync engine over 16-slot tiles for a bf16 cache TMA can read, else
the SIMT kernel), the TMA stride test the wrapper feeds it, B6's kv split
at recurrentgemma_9b's decode, and B6's plain version -- what the mma
engine is held to on the card -- against the JAX package's Pallas kernel
(interpret mode) in bf16 at the engine's shapes.  The kernels themselves
are held in test_torch_cuda.py; B8's epilogue pass against its Pallas
kernel is in test_torch_grouped_rigid.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.flash_decode import flash_decode_pallas

from torch_lazy import LazyModule, torch
from torch_parity import n, t

# The port, imported at first use (see torch_lazy).
tbuild = LazyModule("repro_torch.kernels.build")
tdecode = LazyModule("repro_torch.kernels.flash_decode")
tepilogue = LazyModule("repro_torch.core.epilogue")
tgeometry = LazyModule("repro_torch.core.geometry")
trigid = LazyModule("repro_torch.kernels.rigid_gemm")


# -- engine choice ------------------------------------------------------------

@pytest.mark.parametrize("kv,q,g,d,aligned,want", [
    ("bfloat16", "bfloat16", 16, 256, True, "mma"),   # recurrentgemma_9b
    ("bfloat16", "bfloat16", 2, 128, True, "mma"),    # gemma2_27b's GQA
    ("bfloat16", "bfloat16", 1, 64, True, "mma"),
    ("bfloat16", "bfloat16", 16, 256, False, "simt"),  # strides TMA refuses
    ("bfloat16", "bfloat16", 17, 64, True, "simt"),    # G > 16
    ("bfloat16", "bfloat16", 4, 32, True, "simt"),     # the reduced D
    ("bfloat16", "float32", 4, 64, True, "simt"),
    ("float32", "float32", 16, 256, True, "simt"),     # the reduced fp32
])
def test_flat_decode_engine_table(kv, q, g, d, aligned, want):
    assert tgeometry.flat_decode_engine(getattr(torch, kv),
                                        getattr(torch, q), g, d,
                                        aligned) == want
    assert tgeometry.flat_decode_engine(kv, q, g, d, aligned) == want


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,want", [
    ("ring view", True),          # the serving ring's (B, L, Hkv, D) storage
    ("ring view hkv=2", True),
    ("contiguous", True),
    ("padded rows", False),       # a row stride of 68 bf16: not 16 bytes
    ("odd offset", False),        # a base 2 bytes past 16-byte alignment
    ("d not contiguous", False),
    ("expanded", False),          # a stride of 0 over 4 rows
])
def test_tma_strided(case, want):
    """``aligned`` as the wrapper computes it from the cache's views."""
    if case == "ring view":
        x = _bf16(4, 2048, 1, 256).transpose(1, 2)
    elif case == "ring view hkv=2":
        x = _bf16(4, 37, 2, 64).transpose(1, 2)
    elif case == "contiguous":
        x = _bf16(4, 2, 37, 64)
    elif case == "padded rows":
        x = _bf16(4, 2, 37, 68)[..., :64]
    elif case == "odd offset":
        x = _bf16(4 * 2 * 37 * 64 + 1)[1:].view(4, 2, 37, 64)
    elif case == "d not contiguous":
        x = _bf16(4, 2, 64, 37).transpose(2, 3)
    else:
        x = _bf16(1, 2, 37, 64).expand(4, 2, 37, 64)
    assert tdecode.tma_strided(x, x) is want
    engine = tgeometry.flat_decode_engine(x.dtype, x.dtype, 4, 64,
                                          tdecode.tma_strided(x, x))
    assert engine == ("mma" if want else "simt")


@pytest.mark.parametrize("rows,tiles,want", [
    (4, 128, 8),      # recurrentgemma_9b: 4 slots, one kv head, 2048 slots
    (4, 3, 2),        # S = 37: no more slices than tiles
    (4, 1, 1),
    (8, 128, 8),
    (66, 128, 2),
    (132, 128, 1),
])
def test_ring_decode_kv_split(rows, tiles, want):
    assert tgeometry.decode_kv_split(rows, tiles, 132) == want


# -- the plain version against JAX in bf16 ------------------------------------

def _ring_case(case, g, d, seed):
    """q (B, H, D), the (B, L, Hkv, D) ring storage, kv_positions (B, L),
    q_pos (B,) and the options of one case, over one kv head (G = H)."""
    rng = np.random.default_rng(seed)
    b, hkv, length = 4, 1, 37              # L: not a multiple of 16
    q = rng.standard_normal((b, g * hkv, d)).astype(np.float32)
    k = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
    # Slot i holds the newest position = i (mod L) at or before q_pos:
    # rows 0 and 3 have wrapped, rows 1 and 2 have unwritten slots (-1).
    qpos = np.array([60, 20, 5, 36], np.int32)
    ring = qpos[:, None] - (qpos[:, None] - np.arange(length)) % length
    kvpos = np.where(ring >= 0, ring, -1).astype(np.int32)
    kw = {}
    if case == "window_softcap":
        kw = dict(window=9, softcap=5.0)
    elif case == "empty_row":
        kvpos[2] = -1
    return q, k, v, kvpos, qpos, kw


@pytest.mark.parametrize("case", ["wrapped", "window_softcap", "empty_row"])
@pytest.mark.parametrize("g,d", [(16, 256), (4, 64)])
def test_ring_decode_plain_matches_pallas_in_bf16(g, d, case):
    """B6's plain version at the mma engine's shapes (recurrentgemma_9b's
    G 16 x D 256, and G 4 x D 64) against JAX's Pallas kernel in bf16: a
    37-slot ring read through its (B, L, Hkv, D) storage's transposed
    view, wrapped rows, unwritten slots, window + softcap, an empty row
    (zeros out); within 1e-2 (both round the output to bf16)."""
    q, k, v, kvpos, qpos, kw = _ring_case(case, g, d, seed=g * d)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = flash_decode_pallas(qb, kb.transpose(0, 2, 1, 3),
                               vb.transpose(0, 2, 1, 3), jnp.asarray(kvpos),
                               jnp.asarray(qpos), interpret=True, **kw)
    tq = t(np.asarray(qb))
    tk, tv = (t(np.asarray(x)).transpose(1, 2) for x in (kb, vb))
    assert tgeometry.flat_decode_engine(
        tk.dtype, tq.dtype, g, d, tdecode.tma_strided(tk, tv)) == "mma"
    before = tbuild.launch_counts()
    got = tdecode.flash_decode_kernel(tq, tk, tv, t(kvpos), t(qpos),
                                      kv_split=2, **kw)
    assert tbuild.launch_counts() == before        # CPU: the plain version
    assert got.dtype == torch.bfloat16
    if case == "empty_row":
        assert torch.count_nonzero(got[2]) == 0
    np.testing.assert_allclose(n(got), n(want), rtol=1e-2, atol=1e-2)


def test_meta_tensors_never_reach_a_plain_version():
    """A tensor that is not on the CPU launches or raises in both
    redesigned wrappers; the meta device stands in for a card here."""
    q = torch.empty(4, 16, 256, dtype=torch.bfloat16, device="meta")
    ring = torch.empty(4, 2048, 1, 256, dtype=torch.bfloat16,
                       device="meta").transpose(1, 2)
    kvp = torch.zeros(4, 2048, dtype=torch.int32, device="meta")
    qp = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdecode.flash_decode_kernel(q, ring, ring, kvp, qp, window=2048)
    acc = torch.empty(512, 16384, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trigid.epilogue_pass_kernel(
            acc, epilogue=tepilogue.Epilogue(activation="gelu"),
            out_dtype=torch.bfloat16)
