"""Each CUDA kernel of the port against its plain PyTorch version, on a
Hopper card.  Imports torch and the port only (no JAX), so it runs on a
machine with the card: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_cuda.py``.  Elsewhere every test skips, naming what is
missing."""
import dataclasses
import os
import shutil

import numpy as np
import pytest

from torch_lazy import LazyModule, torch

# The port, imported at first use (see torch_lazy).
build = LazyModule("repro_torch.kernels.build")
tepilogue = LazyModule("repro_torch.core.epilogue")
tgeometry = LazyModule("repro_torch.core.geometry")
tattn = LazyModule("repro_torch.kernels.flash_attention")
tdecode = LazyModule("repro_torch.kernels.flash_decode")
tgemm = LazyModule("repro_torch.kernels.mte_gemm")
tsplitk = LazyModule("repro_torch.kernels.splitk_gemm")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The card, or a skip naming what is missing."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("no Hopper (sm_90) device")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc")
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,acc", [("float32", None),
                                       ("bfloat16", None),
                                       ("bfloat16", "bfloat16"),
                                       ("int8", None)])
def test_gemm_kernels_match_plain(card, dtype, acc):
    dt = getattr(torch, dtype)
    acc = getattr(torch, acc) if acc else None
    before = build.launch_counts()
    for m, n, k in [(100, 70, 130), (4, 300, 1000)]:
        if dt == torch.int8:
            a = torch.randint(-127, 128, (m, k), dtype=dt)
            b = torch.randint(-127, 128, (k, n), dtype=dt)
            epi, out_dt, tol = tepilogue.Epilogue(), torch.int32, 0.0
        else:
            a = (torch.randn(m, k) / k ** 0.5).to(dt)
            b = torch.randn(k, n).to(dt)
            epi = tepilogue.Epilogue(activation="gelu")
            out_dt = torch.float32
            tol = 1e-4 if dt == torch.float32 else 3e-2
        bm, bn = (16, 128) if m <= 16 else (64, 64)
        sew = tgeometry.SEW.E32
        g = tgeometry.BlockGeometry(bm, bn, 64, 1, 1, False, sew, sew, "mte")
        kw = dict(geom=g, epilogue=epi, out_dtype=out_dt, acc_dtype=acc)
        want = tgemm.mte_gemm_torch(a, b, **kw)
        got = tgemm.mte_gemm_kernel(a.to(card), b.to(card), **kw)
        _close(got, want, tol)
        want = tsplitk.mte_gemm_splitk_torch(a, b, n_split=4, **kw)
        got = tsplitk.mte_gemm_splitk_kernel(a.to(card), b.to(card),
                                             n_split=4, **kw)
        _close(got, want, tol)
    after = build.launch_counts()
    assert after["mte_gemm"] == before["mte_gemm"] + 2
    assert after["splitk_gemm"] == before["splitk_gemm"] + 2


def test_attention_kernels_match_plain(card):
    gen = torch.Generator().manual_seed(0)
    page, hkv, d = 8, 2, 32
    lens = torch.tensor([5, 17, 25], dtype=torch.int32)
    kp = torch.randn(12, page, hkv, d, generator=gen)
    vp = torch.randn(12, page, hkv, d, generator=gen)
    table = torch.tensor([[1, 11, -1, -1, -1], [2, 3, 4, -1, -1],
                          [5, -1, 6, 7, -1]], dtype=torch.int32)
    q = torch.randn(3, 4, d, generator=gen)
    for kw in ({}, {"window": 6, "softcap": 5.0}):
        want = tdecode.flash_decode_paged_torch(q, kp, vp, table, lens, **kw)
        got = tdecode.flash_decode_paged_kernel(
            *(x.to(card) for x in (q, kp, vp, table, lens)), **kw)
        _close(got, want, 1e-5)
    qa = torch.randn(1, 4, 40, 32, generator=gen)
    ka = torch.randn(1, 2, 72, 32, generator=gen)
    va = torch.randn(1, 2, 72, 32, generator=gen)
    for kw in ({}, {"window": 16, "softcap": 20.0}, {"causal": False}):
        want = tattn.flash_attention_torch(qa, ka, va, **kw)
        got = tattn.flash_attention_kernel(qa.to(card), ka.to(card),
                                           va.to(card), **kw)
        _close(got, want, 1e-5)


tgrouped = LazyModule("repro_torch.kernels.grouped_gemm")
trigid = LazyModule("repro_torch.kernels.rigid_gemm")


@pytest.mark.parametrize("dtype,acc", [("float32", None),
                                       ("bfloat16", None),
                                       ("bfloat16", "bfloat16"),
                                       ("int8", None)])
def test_grouped_gemm_kernel_matches_plain(card, dtype, acc):
    """B3 against its plain version: ragged C/N/K, a shared x (group
    stride 0) with member widths, and a per-group x."""
    dt = getattr(torch, dtype)
    acc = getattr(torch, acc) if acc else None
    gen = torch.Generator().manual_seed(3)
    before = build.launch_counts()["grouped_gemm"]
    for g, c, n, k, shared in [(3, 4, 300, 130, True), (2, 70, 90, 1000,
                                                        False)]:
        if dt == torch.int8:
            x = torch.randint(-127, 128, (g, c, k), generator=gen,
                              dtype=dt)
            w = torch.randint(-127, 128, (g, k, n), generator=gen,
                              dtype=dt)
            epi, out_dt, tol = tepilogue.Epilogue(), torch.int32, 0.0
        else:
            x = (torch.randn(g, c, k, generator=gen) / k ** 0.5).to(dt)
            w = torch.randn(g, k, n, generator=gen).to(dt)
            epi = tepilogue.Epilogue(activation="gelu", softcap=20.0)
            out_dt = torch.float32
            tol = 1e-4 if dt == torch.float32 else 3e-2
        widths = None
        if shared:
            x = x[:1].expand(g, c, k)
            widths = [n, 40, 129]
        bm, bn = (16, 128) if c <= 16 else (64, 64)
        sew = tgeometry.SEW.E32
        geo = tgeometry.BlockGeometry(bm, bn, 64, 1, 1, False, sew, sew,
                                      "mte")
        kw = dict(geom=geo, epilogue=epi, out_dtype=out_dt, acc_dtype=acc,
                  widths=widths)
        want = tgrouped.grouped_gemm_torch(x, w, **kw)
        got = tgrouped.grouped_gemm_kernel(x.to(card), w.to(card), **kw)
        _close(got, want, tol)
    assert build.launch_counts()["grouped_gemm"] == before + 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_rigid_gemm_kernels_match_plain(card, dtype):
    """Both halves of B8 against their plain versions, with C, bias,
    softcap and an activation (int8: identity epilogue, int32 exact)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(4)
    counts = build.launch_counts()
    for m, n, k in [(4, 300, 1000), (130, 257, 65)]:
        if dt == torch.int8:
            a = torch.randint(-127, 128, (m, k), generator=gen, dtype=dt)
            b = torch.randint(-127, 128, (k, n), generator=gen, dtype=dt)
            want = trigid.rigid_gemm_torch(a, b, out_dtype=torch.int32)
            got = trigid.rigid_gemm_kernel(a.to(card), b.to(card),
                                           out_dtype=torch.int32)
            _close(got, want, 0.0)
            continue
        a = (torch.randn(m, k, generator=gen) / k ** 0.5).to(dt)
        b = torch.randn(k, n, generator=gen).to(dt)
        c = torch.randn(m, n, generator=gen)
        bias = torch.randn(n, generator=gen)
        epi = tepilogue.Epilogue(alpha=0.7, beta=0.5, has_bias=True,
                                 softcap=20.0, activation="silu")
        want = trigid.rigid_gemm_torch(a, b, c, bias, epilogue=epi)
        got = trigid.rigid_gemm_kernel(a.to(card), b.to(card), c.to(card),
                                       bias.to(card), epilogue=epi)
        _close(got, want, 1e-4 if dt == torch.float32 else 1e-3)
    after = build.launch_counts()
    stage1 = ("rigid_gemm", "rigid_gemm_simt", "rigid_gemm_wgmma")
    assert sum(after[k] - counts[k] for k in stage1) == 2
    # f32 at (4, 300, 1000) runs the SIMT engine; the rest the tile loop.
    assert after["rigid_gemm_simt"] - counts["rigid_gemm_simt"] == (
        1 if dt == torch.float32 else 0)
    assert after["epilogue_pass"] == counts["epilogue_pass"] + (
        0 if dt == torch.int8 else 2)


tscan = LazyModule("repro_torch.kernels.rglru_scan")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_decode_kernel_matches_plain(card, dtype):
    """B6 against its plain version: G = 4, a ragged S that is not a
    multiple of the 16-slot chunk, -1 slots, window and softcap, and a
    wrapped ring read through its (B, L, Hkv, D) storage's strided view."""
    dt = getattr(torch, dtype)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    gen = torch.Generator().manual_seed(6)
    b, h, hkv, s, d = 3, 8, 2, 37, 32
    q = torch.randn(b, h, d, generator=gen).to(dt)
    ring_k = torch.randn(b, s, hkv, d, generator=gen).to(dt)
    ring_v = torch.randn(b, s, hkv, d, generator=gen).to(dt)
    q_pos = torch.tensor([60, 20, 5], dtype=torch.int32)
    idx = torch.arange(s)
    kv_pos = q_pos[:, None] - (q_pos[:, None] - idx) % s
    kv_pos = torch.where(kv_pos >= 0, kv_pos, -1).to(torch.int32)
    before = build.launch_counts()["flash_decode"]
    for kw in ({}, {"window": 9, "softcap": 5.0}):
        args = (q, ring_k.transpose(1, 2), ring_v.transpose(1, 2), kv_pos,
                q_pos)
        want = tdecode.flash_decode_torch(*args, **kw)
        got = tdecode.flash_decode_kernel(*(x.to(card) for x in args), **kw)
        _close(got, want, tol)
    empty = torch.full_like(kv_pos, -1)
    got = tdecode.flash_decode_kernel(q.to(card), *(
        x.transpose(1, 2).to(card) for x in (ring_k, ring_v)),
        empty.to(card), q_pos.to(card))
    assert torch.count_nonzero(got) == 0
    assert build.launch_counts()["flash_decode"] == before + 3


def _scan_case(s, w, with_h0, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand(2, s, w, generator=gen) * 0.5 + 0.5
    b = torch.randn(2, s, w, generator=gen)
    h0 = torch.randn(2, w, generator=gen) if with_h0 else None
    return a, b, h0


@pytest.mark.parametrize("engine", ["staged", "direct"])
@pytest.mark.parametrize("s", [1, 63, 64, 100, 4096])
@pytest.mark.parametrize("w", [48, 4096])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_kernel_matches_plain_bit_for_bit(card, engine, s, w,
                                                     with_h0):
    """Both B7 engines against the plain version, bit for bit, from zero and from h0; the counter of the
    engine that ran moves by one."""
    a, b, h0 = _scan_case(s, w, with_h0, seed=s + w)
    counter = "rglru_scan_staged" if engine == "staged" else "rglru_scan"
    before = build.launch_counts()
    got = tscan.rglru_scan_kernel(
        a.to(card), b.to(card), None if h0 is None else h0.to(card),
        engine=engine)
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert torch.equal(got.cpu(), tscan.rglru_scan_torch(a, b, h0))
    for name in ("rglru_scan", "rglru_scan_staged"):
        assert after[name] == before[name] + (name == counter)


@pytest.mark.parametrize("w,counter", [(4096, "rglru_scan_staged"),
                                       (4100, "rglru_scan_staged"),
                                       (4098, "rglru_scan")])
def test_rglru_scan_kernel_runs_the_chosen_engine(card, w, counter):
    """Unpinned, the wrapper launches the engine ``scan_engine`` names (a
    partial last slab at W = 4100; W = 4098 is not a multiple of 4), and
    the staged engine cannot be pinned where it does not apply."""
    a, b, h0 = _scan_case(70, w, True, seed=w)
    before = build.launch_counts()[counter]
    got = tscan.rglru_scan_kernel(a.to(card), b.to(card), h0.to(card))
    assert torch.equal(got.cpu(), tscan.rglru_scan_torch(a, b, h0))
    assert build.launch_counts()[counter] == before + 1
    if counter == "rglru_scan":
        with pytest.raises(ValueError):
            tscan.rglru_scan_kernel(a.to(card), b.to(card), engine="staged")


# -- the wgmma engine of B1 and B8 stage 1 ------------------------------------

tops = LazyModule("repro_torch.kernels.ops")

# Ragged but TMA-aligned shapes: M, N, K are multiples of 8 but not of the
# tiles, so every edge of the grid and the K loop is partial.
WGMMA_SHAPES = [(520, 2056, 1032), (64, 64, 64)]
WGMMA_TILES = [(64, 64), (64, 128), (64, 256), (128, 64), (128, 128),
               (128, 256)]


def _wg_operands(m, n, k, gen):
    a = (torch.randn(m, k, generator=gen) / k ** 0.5).to(torch.bfloat16)
    b = torch.randn(k, n, generator=gen).to(torch.bfloat16)
    return a, b


@pytest.mark.parametrize("transposed", [False, True], ids=["kn", "nk"])
@pytest.mark.parametrize("tile", WGMMA_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_wgmma_gemm_matches_plain(card, tile, transposed):
    """B1 on the wgmma engine against its plain version at every compiled
    tile, with both B layouts and every epilogue field (alpha, beta * C,
    row bias, softcap, activation), bf16 out (tolerance 2e-2, bf16's
    rounding of O(1) outputs); the counters show the engine that ran."""
    gen = torch.Generator().manual_seed(7)
    before = build.launch_counts()
    epi = tepilogue.Epilogue(alpha=0.7, beta=0.5, has_bias=True,
                             softcap=20.0, activation="gelu")
    sew = tgeometry.SEW.E16
    geom = tgeometry.BlockGeometry(*tile, 128, 1, 1, transposed, sew, sew,
                                   "mte")
    for m, n, k in WGMMA_SHAPES:
        a, b = _wg_operands(m, n, k, gen)
        c = torch.randn(m, n, generator=gen)
        bias = torch.randn(n, generator=gen)
        want = tgemm.mte_gemm_torch(a, b, c, bias, geom=dataclasses.replace(
            geom, transposed_b=False), epilogue=epi,
            out_dtype=torch.bfloat16)
        bk = b.t().contiguous() if transposed else b
        got = tgemm.mte_gemm_kernel(a.to(card), bk.to(card), c.to(card),
                                    bias.to(card), geom=geom, epilogue=epi,
                                    out_dtype=torch.bfloat16)
        _close(got, want, 2e-2)
    after = build.launch_counts()
    assert after["mte_gemm_wgmma"] == before["mte_gemm_wgmma"] + 2
    assert after["mte_gemm"] == before["mte_gemm"]


@pytest.mark.parametrize("transposed", [False, True], ids=["kn", "nk"])
@pytest.mark.parametrize("rbk", [32, 96, 256])
@pytest.mark.parametrize("tile", [(64, 128), (128, 64), (128, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_wgmma_bf16acc_matches_plain(card, tile, rbk, transposed):
    """bf16acc on the wgmma engine: the running sum is rounded to bf16 at
    every rbk-deep K block boundary, including the ones that fall inside a
    64-deep stage (rbk 32, 96); tolerance 3e-2 as for the tile loop."""
    gen = torch.Generator().manual_seed(rbk)
    before = build.launch_counts()["mte_gemm_wgmma"]
    epi = tepilogue.Epilogue(alpha=0.5, has_bias=True, activation="silu")
    sew = tgeometry.SEW.E16
    geom = tgeometry.BlockGeometry(*tile, rbk, 1, 1, transposed, sew, sew,
                                   "mte")
    m, n, k = 520, 264, 1032
    a, b = _wg_operands(m, n, k, gen)
    bias = torch.randn(n, generator=gen)
    kw = dict(epilogue=epi, out_dtype=torch.float32,
              acc_dtype=torch.bfloat16)
    want = tgemm.mte_gemm_torch(a, b, None, bias, geom=dataclasses.replace(
        geom, transposed_b=False), **kw)
    bk = b.t().contiguous() if transposed else b
    got = tgemm.mte_gemm_kernel(a.to(card), bk.to(card), None, bias.to(card),
                                geom=geom, **kw)
    _close(got, want, 3e-2)
    assert build.launch_counts()["mte_gemm_wgmma"] == before + 1


@pytest.mark.parametrize("m,n,k", [(520, 2056, 1032), (64, 64, 64),
                                   (4, 16384, 2048)])
def test_rigid_wgmma_matches_plain(card, m, n, k):
    """B8 stage 1 on the wgmma engine: always the 128 x 128 tile (M = 4
    pays a 128-row tile), the raw f32 accumulator in device memory within
    1e-4 of the plain f32 product; then the separate epilogue pass."""
    gen = torch.Generator().manual_seed(m)
    a, b = _wg_operands(m, n, k, gen)
    before = build.launch_counts()
    acc = trigid.rigid_accumulate_kernel(a.to(card), b.to(card))
    assert acc.dtype == torch.float32
    _close(acc, trigid.rigid_accumulate_torch(a, b), 1e-4)
    epi = tepilogue.Epilogue(activation="gelu", softcap=30.0)
    got = trigid.rigid_gemm_kernel(a.to(card), b.to(card), epilogue=epi,
                                   out_dtype=torch.bfloat16)
    _close(got, trigid.rigid_gemm_torch(a, b, epilogue=epi,
                                        out_dtype=torch.bfloat16), 2e-2)
    after = build.launch_counts()
    assert after["rigid_gemm_wgmma"] == before["rigid_gemm_wgmma"] + 2
    assert after["rigid_gemm"] == before["rigid_gemm"]
    assert after["epilogue_pass"] == before["epilogue_pass"] + 1


def test_wgmma_refuses_what_it_cannot_take(card):
    """A pinned tile no engine takes raises before anything launches:
    a wgmma-only tile for fp32 operands, for a K that TMA cannot stride,
    and BN = 256 under bf16acc."""
    gen = torch.Generator().manual_seed(9)
    before = build.launch_counts()
    sew = tgeometry.SEW.E16
    big = tgeometry.BlockGeometry(128, 256, 128, 1, 1, False, sew, sew,
                                  "mte")
    a, b = _wg_operands(128, 256, 128, gen)
    with pytest.raises(ValueError, match="no mte GEMM engine"):
        tops.mte_gemm(a.float().to(card), b.float().to(card), geometry=big)
    a7, b7 = _wg_operands(128, 256, 100, gen)
    with pytest.raises(ValueError, match="no mte GEMM engine"):
        tops.mte_gemm(a7.to(card), b7.to(card), format_policy="bf16",
                      geometry=big)
    with pytest.raises(ValueError, match="no mte GEMM engine"):
        tops.mte_gemm(a.to(card), b.to(card), format_policy="bf16acc",
                      geometry=big)
    assert build.launch_counts() == before


# -- B3's cluster split-K engine and B5's wgmma engine ------------------------

# (G, K, N, shared x, widths): the gemma_2b decode group, eight members
# of a per-group x whose widths straddle the 128-column tile (one width
# 0, one past N) over a K the slice depth does not divide, and
# recurrentgemma_9b's decode group.
SPLITK_CASES = [(3, 2048, 2048, True, (2048, 256, 256)),
                (8, 1000, 392, False, (392, 40, 129, 0, 8, 300, 256, 500)),
                (3, 4096, 4096, True, (4096, 256, 256))]


@pytest.mark.parametrize("c", [1, 4, 16])
def test_grouped_splitk_matches_plain(card, c):
    """B3's split-K engine against its plain version (bf16 operands, f32
    accumulator; tolerance 2e-2, bf16's rounding of O(1) outputs), with
    the epilogue and both output types; two calls are bit-equal (the
    cluster reduction sums the slices in rank order); the counters show
    that only the split-K engine ran."""
    gen = torch.Generator().manual_seed(c)
    before = build.launch_counts()
    epi = tepilogue.Epilogue(alpha=0.7, softcap=20.0, activation="gelu")
    sew = tgeometry.SEW.E16
    geo = tgeometry.BlockGeometry(16, 128, 64, 1, 1, False, sew, sew, "mte")
    for (g, k, n, shared, widths), out_dt in zip(
            SPLITK_CASES, (torch.bfloat16, torch.float32, torch.bfloat16)):
        assert tgeometry.grouped_engine(torch.bfloat16, c, n, k) == "splitk"
        x = (torch.randn(g, c, k, generator=gen) / k ** 0.5).to(
            torch.bfloat16)
        if shared:
            x = x[:1].expand(g, c, k)
        w = torch.randn(g, k, n, generator=gen).to(torch.bfloat16)
        kw = dict(geom=geo, epilogue=epi, out_dtype=out_dt,
                  widths=list(widths))
        want = tgrouped.grouped_gemm_torch(x, w, **kw)
        xd, wd = x.to(card), w.to(card)
        got = tgrouped.grouped_gemm_kernel(xd, wd, **kw)
        _close(got, want, 2e-2)
        again = tgrouped.grouped_gemm_kernel(xd, wd, **kw)
        assert torch.equal(got, again)
    after = build.launch_counts()
    assert after["grouped_gemm_splitk"] == (before["grouped_gemm_splitk"]
                                            + 2 * len(SPLITK_CASES))
    assert after["grouped_gemm"] == before["grouped_gemm"]


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
def test_grouped_splitk_every_split_matches_plain(card, n_split):
    """Every cluster size the split-K engine takes, pinned, at gemma_2b's
    decode group: the same sums within 2e-2 of the plain version."""
    gen = torch.Generator().manual_seed(n_split)
    g, k, n, widths = 3, 2048, 2048, [2048, 256, 256]
    x = (torch.randn(1, 4, k, generator=gen) / k ** 0.5).to(
        torch.bfloat16).expand(g, 4, k)
    w = torch.randn(g, k, n, generator=gen).to(torch.bfloat16)
    sew = tgeometry.SEW.E16
    geo = tgeometry.BlockGeometry(16, 128, 64, 1, 1, False, sew, sew, "mte")
    kw = dict(geom=geo, out_dtype=torch.float32, widths=widths)
    before = build.launch_counts()["grouped_gemm_splitk"]
    got = tgrouped.grouped_gemm_kernel(x.to(card), w.to(card),
                                       n_split=n_split, **kw)
    _close(got, tgrouped.grouped_gemm_torch(x, w, **kw), 2e-2)
    assert build.launch_counts()["grouped_gemm_splitk"] == before + 1


def test_grouped_engines_split_by_rows_and_format(card):
    """C = 17 at the 64 x 64 tile goes to the wgmma engine (bf16acc too),
    C = 16 and C = 4 under bf16acc go to split-K: each launch counts on
    its own engine's counter only, each held to its engine's plain
    version."""
    gen = torch.Generator().manual_seed(17)
    sew = tgeometry.SEW.E16
    k, n = 256, 384
    w = torch.randn(2, k, n, generator=gen).to(torch.bfloat16)
    for c, acc, counter in [(17, None, "grouped_gemm_wgmma"),
                            (17, torch.bfloat16, "grouped_gemm_wgmma"),
                            (4, torch.bfloat16, "grouped_gemm_splitk"),
                            (16, None, "grouped_gemm_splitk")]:
        x = (torch.randn(2, c, k, generator=gen) / k ** 0.5).to(
            torch.bfloat16)
        bm, bn = (16, 128) if c <= 16 else (64, 64)
        geo = tgeometry.BlockGeometry(bm, bn, 64, 1, 1, False, sew, sew,
                                      "mte")
        kw = dict(geom=geo, out_dtype=torch.float32, acc_dtype=acc)
        before = build.launch_counts()
        got = tgrouped.grouped_gemm_kernel(x.to(card), w.to(card), **kw)
        after = build.launch_counts()
        if counter == "grouped_gemm_splitk" and acc is not None:
            slices, depth = tgrouped.split_layout(
                x, w, sm_count=torch.cuda.get_device_properties(
                    card).multi_processor_count)
            want = tgrouped.grouped_splitk_torch(
                x, w, n_split=slices, depth=depth, rbk=64,
                out_dtype=torch.float32, acc_dtype=acc)
        else:
            want = tgrouped.grouped_gemm_torch(x, w, **kw)
        _close(got, want, 3e-2)
        assert {name for name in after if after[name] != before[name]} \
            == {counter}


# (B, H, Hkv, Sq, Skv, options): causal GQA 8:1 at the first prefill
# chunk, 2:1 with Sq < Skv and a ragged Skv, a window, a softcap,
# non-causal over a ragged Skv, and a ragged Sq.
WGMMA_ATTN_CASES = [(1, 8, 1, 512, 512, {}),
                    (2, 4, 2, 100, 333, {}),
                    (1, 2, 1, 128, 200, {"window": 48}),
                    (1, 2, 2, 64, 130, {"softcap": 20.0}),
                    (1, 2, 1, 70, 90, {"causal": False}),
                    (1, 2, 1, 33, 97, {"window": 40, "softcap": 30.0})]


@pytest.mark.parametrize("kv_split", [1, 2])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_wgmma_matches_plain(card, d, kv_split):
    """B5's wgmma engine against its plain version (bf16; tolerance 1e-2:
    P is rounded to bf16 before P V, where the plain version keeps it in
    f32), with each query tile's kv range on one CTA or split over a
    cluster of two; the counters show that only the wgmma engine ran."""
    gen = torch.Generator().manual_seed(d)
    before = build.launch_counts()
    for b, h, hkv, sq, skv, kw in WGMMA_ATTN_CASES:
        q = torch.randn(b, h, sq, d, generator=gen).to(torch.bfloat16)
        k = torch.randn(b, hkv, skv, d, generator=gen).to(torch.bfloat16)
        v = torch.randn(b, hkv, skv, d, generator=gen).to(torch.bfloat16)
        want = tattn.flash_attention_torch(q, k, v, **kw)
        got = tattn.flash_attention_kernel(q.to(card), k.to(card),
                                           v.to(card), kv_split=kv_split,
                                           **kw)
        _close(got, want, 1e-2)
    after = build.launch_counts()
    assert after["flash_attention_wgmma"] == (
        before["flash_attention_wgmma"] + len(WGMMA_ATTN_CASES))
    assert after["flash_attention"] == before["flash_attention"]


def test_flash_attention_engines_split_by_type_and_dim(card):
    """fp32 and D = 32 stay on the SIMT kernel, bf16 at D = 128 goes to
    wgmma; D = 320 raises before anything launches."""
    gen = torch.Generator().manual_seed(32)
    for dt, d, counter in [(torch.float32, 128, "flash_attention"),
                           (torch.bfloat16, 32, "flash_attention"),
                           (torch.bfloat16, 128, "flash_attention_wgmma")]:
        q, k, v = (torch.randn(1, 2, 40, d, generator=gen).to(dt)
                   for _ in range(3))
        before = build.launch_counts()
        got = tattn.flash_attention_kernel(q.to(card), k.to(card),
                                           v.to(card))
        after = build.launch_counts()
        _close(got, tattn.flash_attention_torch(q, k, v),
               1e-5 if dt == torch.float32 else 1e-2)
        assert {name for name in after if after[name] != before[name]} \
            == {counter}
    q = torch.randn(1, 2, 8, 320).to(torch.bfloat16).to(card)
    before = build.launch_counts()
    with pytest.raises(ValueError, match="D=320"):
        tattn.flash_attention_kernel(q, q, q)
    assert build.launch_counts() == before


# -- B2's cluster engine and B4's mma engine ----------------------------------

# (N, K): gemma_2b's o (2048 x 2048), a ragged K the slice depth does not
# divide with N a multiple of 8 but not of the 128-column tile, and a K
# shorter than one 64-deep stage.
CLUSTER_CASES = [(2048, 2048), (392, 1000), (136, 40)]


@pytest.mark.parametrize("m", [1, 4, 9, 16])
def test_splitk_cluster_matches_plain(card, m):
    """B2's cluster engine against its plain version at the engine's split
    (bf16 operands, f32 accumulator; tolerance 2e-2, bf16's rounding of
    O(1) outputs) with every epilogue term -- alpha, beta * C (C in f32 and
    in bf16), a row or a column bias, softcap, gelu -- and both output
    types; two calls are bit-equal (the cluster reduction sums the slices
    in rank order); the counters show that only the cluster engine ran."""
    gen = torch.Generator().manual_seed(m)
    sew = tgeometry.SEW.E16
    geo = tgeometry.BlockGeometry(16, 128, 64, 4, 1, False, sew, sew, "mte")
    before = build.launch_counts()
    calls = 0
    for (n, k), out_dt, c_dt, axis in [
            (CLUSTER_CASES[0], torch.bfloat16, torch.float32, "row"),
            (CLUSTER_CASES[1], torch.float32, torch.bfloat16, "row"),
            (CLUSTER_CASES[2], torch.bfloat16, torch.bfloat16, "col")]:
        assert tgeometry.splitk_engine(torch.bfloat16, m, n, k) == "cluster"
        a = (torch.randn(m, k, generator=gen) / k ** 0.5).to(torch.bfloat16)
        b = torch.randn(k, n, generator=gen).to(torch.bfloat16)
        c = torch.randn(m, n, generator=gen).to(c_dt)
        bias = torch.randn(n if axis == "row" else m, generator=gen)
        epi = tepilogue.Epilogue(alpha=0.7, beta=0.5, has_bias=True,
                                 bias_axis=axis, softcap=20.0,
                                 activation="gelu")
        s, _ = tgeometry.splitk_cluster_split(
            tgeometry.cdiv(n, 128), k, m,
            torch.cuda.get_device_properties(card).multi_processor_count)
        kw = dict(geom=geo, epilogue=epi, out_dtype=out_dt)
        want = tsplitk.mte_gemm_splitk_torch(a, b, c, bias, n_split=s, **kw)
        args = [x.to(card) for x in (a, b, c, bias)]
        got = tsplitk.mte_gemm_splitk_kernel(*args, n_split=4, **kw)
        assert got.dtype == out_dt
        _close(got, want, 2e-2)
        assert torch.equal(got, tsplitk.mte_gemm_splitk_kernel(
            *args, n_split=4, **kw))
        calls += 2
    after = build.launch_counts()
    assert after["splitk_gemm_cluster"] == (before["splitk_gemm_cluster"]
                                            + calls)
    assert after["splitk_gemm"] == before["splitk_gemm"]


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 6, 7, 8])
def test_splitk_cluster_every_split_matches_plain(card, n_split):
    """Every cluster size the engine takes, pinned, at gemma_2b's o
    projection (4 x 2048 x 2048) with a gelu and a row bias: within 2e-2
    of the plain version at the same split, bit-equal from call to call."""
    gen = torch.Generator().manual_seed(100 + n_split)
    m, n, k = 4, 2048, 2048
    a = (torch.randn(m, k, generator=gen) / k ** 0.5).to(torch.bfloat16)
    b = torch.randn(k, n, generator=gen).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen).to(torch.bfloat16)
    sew = tgeometry.SEW.E16
    geo = tgeometry.BlockGeometry(16, 128, 64, 2, 1, False, sew, sew, "mte")
    kw = dict(geom=geo, epilogue=tepilogue.Epilogue(
        has_bias=True, activation="gelu"), out_dtype=torch.bfloat16)
    before = build.launch_counts()["splitk_gemm_cluster"]
    ad, bd, biasd = a.to(card), b.to(card), bias.to(card)
    got = tsplitk.mte_gemm_splitk_kernel(ad, bd, None, biasd,
                                         cluster_split=n_split, **kw)
    _close(got, tsplitk.mte_gemm_splitk_torch(a, b, None, bias,
                                              n_split=n_split, **kw), 2e-2)
    assert torch.equal(got, tsplitk.mte_gemm_splitk_kernel(
        ad, bd, None, biasd, cluster_split=n_split, **kw))
    assert build.launch_counts()["splitk_gemm_cluster"] == before + 2


# starcoder2_7b's MLP GEMMs, each with its f32 bias: (M, N, K, activation)
# -- the prefill chunk's up and down (M = 512, B1's wgmma engine) and the
# decode step's (M = 4 slots, B2's cluster engine).
STARCODER2_MLP = [(512, 18432, 4608, "gelu"), (512, 4608, 18432, "none"),
                  (4, 18432, 4608, "gelu"), (4, 4608, 18432, "none")]


@pytest.mark.parametrize("m,n,k,act", STARCODER2_MLP)
def test_bias_gelu_epilogue_at_starcoder2_shapes(card, m, n, k, act):
    """B1 and B2 with the bias joining the epilogue before the tanh-GELU,
    through the plans the serving run gets: within 2e-2 x (1 + |ref|) of
    the plain version of the engine that ran (B2's at its slices), on
    that engine's counter only; B2's two calls bit-equal."""
    from repro_torch.core import autotune
    gen = torch.Generator().manual_seed(m + n)
    a, b = _wg_operands(m, n, k, gen)
    bias = 0.5 * torch.randn(n, generator=gen)
    epi = tepilogue.Epilogue(has_bias=True, activation=act)
    sig = autotune.GemmSignature.make(m, n, k, "bfloat16", "bfloat16", epi,
                                      fmt="bf16")
    plan = autotune.PlanCache().plan(sig)
    engine = autotune.plan_engine(sig, plan.geometry)
    kw = dict(epilogue=epi, out_dtype=torch.bfloat16)
    args = [x.to(card) for x in (a, b)] + [None, bias.to(card)]
    before = build.launch_counts()
    if m <= 16:
        assert engine == "cluster"
        slices, depth = tsplitk.cluster_layout(m, n, k, card)
        want = tsplitk.splitk_cluster_torch(a, b, None, bias, n_split=slices,
                                            depth=depth, **kw)
        got = tsplitk.mte_gemm_splitk_kernel(*args, geom=plan.geometry,
                                             n_split=plan.n_split, **kw)
        assert torch.equal(got, tsplitk.mte_gemm_splitk_kernel(
            *args, geom=plan.geometry, n_split=plan.n_split, **kw))
        counter = "splitk_gemm_cluster"
    else:
        assert engine == "wgmma"
        want = tgemm.mte_gemm_torch(a, b, None, bias, geom=plan.geometry,
                                    **kw)
        got = tgemm.mte_gemm_kernel(*args, geom=plan.geometry, **kw)
        counter = "mte_gemm_wgmma"
    diff = (got.float().cpu() - want.float()).abs()
    assert bool((diff <= 2e-2 * (1 + want.float().abs())).all()), \
        float(diff.max())
    after = build.launch_counts()
    assert {name for name in after if after[name] != before[name]} == {
        counter}


# qwen15_4b's decode GEMMs under bf16acc: (N, K, activation).
QWEN_DECODE = [(2560, 2560, "none"), (6912, 2560, "silu"),
               (2560, 6912, "none")]


@pytest.mark.parametrize("n,k,act", QWEN_DECODE)
@pytest.mark.parametrize("n_split", [None, 1, 2, 3, 8])
def test_splitk_cluster_bf16acc_matches_plain(card, n, k, act, n_split):
    """B2's cluster engine with the bf16 accumulator at qwen15_4b's decode
    shapes (4 rows; the planned split, then pinned ones), the running
    sum rounded once per 160 rows of each slice, with a row bias (the
    QKV-bias path) and the activation: within 2e-2 x (1 + |ref|) of
    ``splitk_cluster_torch`` at the same slices and blocks (a block
    partial on a rounding tie can land one bf16 ulp apart), bit-equal
    from call to call, on the cluster counter only."""
    gen = torch.Generator().manual_seed(n + k)
    m = 4
    a = (torch.randn(m, k, generator=gen) / k ** 0.5).to(torch.bfloat16)
    b = torch.randn(k, n, generator=gen).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen)
    sew = tgeometry.SEW.E16
    geo = tgeometry.BlockGeometry(16, 128, 160, 16, 1, False, sew, sew,
                                  "mte")
    epi = tepilogue.Epilogue(has_bias=True, activation=act)
    kw = dict(epilogue=epi, out_dtype=torch.bfloat16,
              acc_dtype=torch.bfloat16)
    slices, depth = tsplitk.cluster_layout(m, n, k, card, n_split)
    want = tsplitk.splitk_cluster_torch(a, b, None, bias, n_split=slices,
                                        depth=depth, rbk=160, **kw)
    ad, bd, biasd = a.to(card), b.to(card), bias.to(card)
    before = build.launch_counts()
    got = tsplitk.mte_gemm_splitk_kernel(ad, bd, None, biasd, geom=geo,
                                         cluster_split=n_split, **kw)
    again = tsplitk.mte_gemm_splitk_kernel(ad, bd, None, biasd, geom=geo,
                                           cluster_split=n_split, **kw)
    after = build.launch_counts()
    diff = (got.float().cpu() - want.float()).abs()
    assert bool((diff <= 2e-2 * (1 + want.float().abs())).all()), \
        float(diff.max())
    assert torch.equal(got, again)
    assert {name for name in after if after[name] != before[name]} == {
        "splitk_gemm_cluster"}


@pytest.mark.parametrize("n_split", [None, 1, 2, 4, 8])
def test_grouped_splitk_bf16acc_matches_plain(card, n_split):
    """B3's split-K engine with the bf16 accumulator at qwen15_4b's decode
    group (3 x 4 x 2560, members 2560 wide, no padding; the planned split
    and pinned ones), rounded once per 256 rows of each slice: within
    2e-2 x (1 + |ref|) of ``grouped_splitk_torch`` at the same slices
    and blocks, bit-equal from call to call, on the split-K counter only."""
    gen = torch.Generator().manual_seed(2560 + (n_split or 0))
    g, c, k, n = 3, 4, 2560, 2560
    x = (torch.randn(1, c, k, generator=gen) / k ** 0.5).to(
        torch.bfloat16).expand(g, c, k)
    w = torch.randn(g, k, n, generator=gen).to(torch.bfloat16)
    sew = tgeometry.SEW.E16
    geo = tgeometry.BlockGeometry(16, 128, 256, 1, 1, False, sew, sew, "mte")
    kw = dict(out_dtype=torch.bfloat16, acc_dtype=torch.bfloat16,
              widths=[n] * g)
    slices, depth = tgrouped.split_layout(
        x, w, widths=kw["widths"], n_split=n_split,
        sm_count=torch.cuda.get_device_properties(card).multi_processor_count)
    want = tgrouped.grouped_splitk_torch(x, w, n_split=slices, depth=depth,
                                         rbk=256, **kw)
    xd, wd = x.to(card), w.to(card)
    before = build.launch_counts()
    got = tgrouped.grouped_gemm_kernel(xd, wd, geom=geo, n_split=n_split,
                                       **kw)
    again = tgrouped.grouped_gemm_kernel(xd, wd, geom=geo, n_split=n_split,
                                         **kw)
    after = build.launch_counts()
    diff = (got.float().cpu() - want.float()).abs()
    assert bool((diff <= 2e-2 * (1 + want.float().abs())).all()), \
        float(diff.max())
    assert torch.equal(got, again)
    assert {name for name in after if after[name] != before[name]} == {
        "grouped_gemm_splitk"}


def test_splitk_engines_split_by_rows_and_format(card):
    """M = 17 (bf16acc too) and fp32 stay on the tile loop, M = 16 bf16
    and M = 4 under bf16acc go to the cluster engine: each launch counts
    on its own engine's counter only, each held to its engine's plain
    version; a pinned cluster split on the tile loop raises."""
    gen = torch.Generator().manual_seed(17)
    k, n = 512, 384
    sew = tgeometry.SEW.E16
    geo = tgeometry.BlockGeometry(16, 128, 64, 4, 1, False, sew, sew, "mte")
    for m, dt, acc, counter in [
            (17, torch.bfloat16, None, "splitk_gemm"),
            (17, torch.bfloat16, torch.bfloat16, "splitk_gemm"),
            (4, torch.bfloat16, torch.bfloat16, "splitk_gemm_cluster"),
            (4, torch.float32, None, "splitk_gemm"),
            (16, torch.bfloat16, None, "splitk_gemm_cluster")]:
        a = (torch.randn(m, k, generator=gen) / k ** 0.5).to(dt)
        b = torch.randn(k, n, generator=gen).to(dt)
        kw = dict(geom=geo, n_split=4, out_dtype=torch.float32,
                  acc_dtype=acc)
        before = build.launch_counts()
        got = tsplitk.mte_gemm_splitk_kernel(a.to(card), b.to(card), **kw)
        after = build.launch_counts()
        if counter == "splitk_gemm_cluster" and acc is not None:
            slices, depth = tsplitk.cluster_layout(m, n, k, card)
            want = tsplitk.splitk_cluster_torch(
                a, b, n_split=slices, depth=depth, rbk=64,
                out_dtype=torch.float32, acc_dtype=acc)
        else:
            want = tsplitk.mte_gemm_splitk_torch(a, b, **kw)
        _close(got, want, 3e-2)
        assert {name for name in after if after[name] != before[name]} \
            == {counter}
    a = torch.randn(17, k).to(torch.bfloat16).to(card)
    with pytest.raises(ValueError, match="cluster_split"):
        tsplitk.mte_gemm_splitk_kernel(a, a.new_zeros(k, n), geom=geo,
                                       cluster_split=2)


def _mma_pages(b, g, hkv, d, lens, gen, page=16):
    """bf16 pages for rows of the given lengths: each row's pages in a
    shuffled order, one -1 page inside every row longer than 3 pages, and a
    mapped stale page past the length of every other row."""
    maxp = max(-(-s // page) for s in lens) + 2
    table = torch.full((b, maxp), -1, dtype=torch.int32)
    nxt = 1
    for bi, s in enumerate(lens):
        used = -(-s // page)
        for i in range(used):
            table[bi, i] = nxt
            nxt += 1
        if used > 3:
            table[bi, 2] = -1
        if bi % 2 and used < maxp:
            table[bi, used] = nxt
            nxt += 1
    perm = torch.randperm(nxt, generator=gen)
    table = torch.where(table >= 0, perm[table.clamp(min=0).long()].int(),
                        table)
    kp = torch.randn(nxt, page, hkv, d, generator=gen).to(torch.bfloat16)
    vp = torch.randn(nxt, page, hkv, d, generator=gen).to(torch.bfloat16)
    q = torch.randn(b, g * hkv, d, generator=gen).to(torch.bfloat16)
    return q, kp, vp, table, torch.tensor(lens, dtype=torch.int32)


MMA_LENS = [0, 1, 15, 16, 17, 1037]


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 8, 16])
def test_paged_decode_mma_matches_plain(card, g, d):
    """B4's mma engine against its plain version (bf16; tolerance 1e-2:
    P is rounded to bf16 before P V, where the plain version keeps it in
    f32) at lengths 0, 1, 15, 16, 17 and over 1000, with -1 pages inside
    rows and stale pages past them, plain and with a window and a softcap,
    over two kv heads; a zero-length row gives zeros; the counters show
    that only the mma engine ran."""
    gen = torch.Generator().manual_seed(g * 1000 + d)
    hkv = 2
    q, kp, vp, table, lens = _mma_pages(len(MMA_LENS), g, hkv, d, MMA_LENS,
                                        gen)
    assert tgeometry.decode_engine(kp.dtype, q.dtype, g, d) == "mma"
    before = build.launch_counts()
    args = [x.to(card) for x in (q, kp, vp, table, lens)]
    for kw in ({}, {"window": 40, "softcap": 30.0}):
        want = tdecode.flash_decode_paged_torch(q, kp, vp, table, lens, **kw)
        got = tdecode.flash_decode_paged_kernel(*args, **kw)
        assert got.dtype == torch.bfloat16
        _close(got, want, 1e-2)
        assert torch.count_nonzero(got[0]) == 0
    after = build.launch_counts()
    assert after["flash_decode_paged_mma"] == (
        before["flash_decode_paged_mma"] + 2)
    assert after["flash_decode_paged"] == before["flash_decode_paged"]


@pytest.mark.parametrize("kv_split", [1, 2, 3, 4, 8])
def test_paged_decode_mma_every_split(card, kv_split):
    """Each cluster size, pinned, at gemma_2b's decode (4 slots, 8 heads on
    one kv head, D = 256, ~1035 tokens): within 1e-2 of the plain version,
    bit-equal from call to call."""
    gen = torch.Generator().manual_seed(kv_split)
    q, kp, vp, table, lens = _mma_pages(4, 8, 1, 256,
                                        [1030, 1041, 1024, 1047], gen)
    args = [x.to(card) for x in (q, kp, vp, table, lens)]
    got = tdecode.flash_decode_paged_kernel(*args, kv_split=kv_split)
    _close(got, tdecode.flash_decode_paged_torch(q, kp, vp, table, lens),
           1e-2)
    assert torch.equal(got, tdecode.flash_decode_paged_kernel(
        *args, kv_split=kv_split))


def test_paged_decode_engines_split_by_type(card):
    """f32 pages, int8 pages and D = 32 stay on the SIMT kernel, bf16 at
    D = 64 goes to the mma engine: each launch counts on its own engine's
    counter only."""
    from repro_torch.models.attention import _quantize_kv
    gen = torch.Generator().manual_seed(64)
    for dt, d, counter in [(torch.float32, 64, "flash_decode_paged"),
                           (torch.bfloat16, 32, "flash_decode_paged"),
                           ("int8", 64, "flash_decode_paged"),
                           (torch.bfloat16, 64, "flash_decode_paged_mma")]:
        q, kp, vp, table, lens = _mma_pages(3, 4, 1, d, [5, 17, 40], gen)
        scales = ()
        if dt == "int8":
            q, kp, vp = q.float(), kp.float(), vp.float()
            kp, ks = _quantize_kv(kp)
            vp, vs = _quantize_kv(vp)
            scales = (ks, vs)
        elif dt == torch.float32:
            q, kp, vp = q.float(), kp.float(), vp.float()
        before = build.launch_counts()
        got = tdecode.flash_decode_paged_kernel(
            *(x.to(card) for x in (q, kp, vp, table, lens, *scales)))
        after = build.launch_counts()
        _close(got, tdecode.flash_decode_paged_torch(
            q, kp, vp, table, lens, *scales),
            1e-5 if q.dtype == torch.float32 else 1e-2)
        assert {name for name in after if after[name] != before[name]} \
            == {counter}


# -- B6's mma engine and B8's streaming epilogue pass -------------------------

def _ring(b, length, g, hkv, d, q_pos, gen, strided=True):
    """bf16 q and a (B, Hkv, L, D) cache -- the ring's (B, L, Hkv, D)
    storage seen through transpose(1, 2), or contiguous -- with slot i
    holding the newest position = i (mod L) at or before q_pos (-1 where
    none has been written yet)."""
    q = torch.randn(b, g * hkv, d, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(b, length, hkv, d, generator=gen).to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    if not strided:
        k, v = k.contiguous(), v.contiguous()
    qp = torch.tensor(q_pos, dtype=torch.int32)
    kvp = qp[:, None] - (qp[:, None] - torch.arange(length)) % length
    return q, k, v, torch.where(kvp >= 0, kvp, -1).to(torch.int32), qp


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 4, 9, 16])
def test_ring_decode_mma_every_split_matches_plain(card, g, d):
    """B6's mma engine against its plain version (bf16; 1e-2 x (1 +
    |ref|): P is rounded to bf16 before P V) at every cluster size 1-8,
    over a 37-slot ring (not a multiple of the 16-slot tile) and a wrapped
    2048-slot one, read through the ring's strided view and from a
    contiguous cache, with -1 slots, plain and with a window and a
    softcap, and an empty row (zeros out); bit-equal from call to call;
    only the mma engine's counter moves."""
    gen = torch.Generator().manual_seed(g * 1000 + d)
    before = build.launch_counts()
    launches = 0
    for length, q_pos in [(37, [60, 20, 5, 36]),
                          (2048, [2570, 1000, 2564, 2047])]:
        for strided in (True, False):
            q, k, v, kvp, qp = _ring(4, length, g, 2, d, q_pos, gen,
                                     strided)
            kvp[2] = -1                              # an empty row
            assert tgeometry.flat_decode_engine(
                k.dtype, q.dtype, g, d, tdecode.tma_strided(k, v)) == "mma"
            args = [x.to(card) for x in (q, k, v, kvp, qp)]
            for kw in ({}, {"window": 300, "softcap": 30.0}):
                want = tdecode.flash_decode_torch(q, k, v, kvp, qp, **kw)
                for split in range(1, 9):
                    got = tdecode.flash_decode_kernel(*args, kv_split=split,
                                                      **kw)
                    assert got.dtype == torch.bfloat16
                    _close(got, want, 1e-2)
                    assert torch.count_nonzero(got[2]) == 0
                    assert torch.equal(got, tdecode.flash_decode_kernel(
                        *args, kv_split=split, **kw))
                    launches += 2
    after = build.launch_counts()
    assert after["flash_decode_mma"] == before["flash_decode_mma"] + launches
    assert after["flash_decode"] == before["flash_decode"]


def test_ring_decode_mma_at_starcoder2_shape(card):
    """B6's mma engine at starcoder2_7b's decode: 4 slots x 36 query heads
    on 4 kv heads (G = 9: rows 9-15 of the A fragment are padding) x D 128
    over a wrapped 4096-slot ring in its serving (B, L, Hkv, D) storage,
    the window 4096, at the planned cluster size and every other: within
    1e-2 x (1 + |ref|) of ``flash_decode_torch``, bit-equal from call to
    call, on the mma counter only."""
    gen = torch.Generator().manual_seed(9)
    q, k, v, kvp, qp = _ring(4, 4096, 9, 4, 128, [4614, 4625, 4608, 4631],
                             gen, True)
    assert tgeometry.flat_decode_engine(k.dtype, q.dtype, 9, 128,
                                        tdecode.tma_strided(k, v)) == "mma"
    want = tdecode.flash_decode_torch(q, k, v, kvp, qp, window=4096)
    args = [x.to(card) for x in (q, k, v, kvp, qp)]
    before = build.launch_counts()
    for split in (None, 1, 2, 4, 8):
        got = tdecode.flash_decode_kernel(*args, window=4096,
                                          kv_split=split)
        _close(got, want, 1e-2)
        assert torch.equal(got, tdecode.flash_decode_kernel(
            *args, window=4096, kv_split=split))
    after = build.launch_counts()
    assert {name for name in after if after[name] != before[name]} == {
        "flash_decode_mma"}


@pytest.mark.parametrize("q_pos", [[1023, 1087, 1500, 40],
                                   [0, 1024, 2047, 1100]])
def test_flat_decode_mma_masked_tail_at_musicgen_shape(card, q_pos):
    """B6's mma engine over musicgen_medium's flat decode cache: 4
    sequences x 24 query heads on 24 kv heads (G = 1: one live row of the
    m16 A fragment) x D 64 over 2048 slots in the (B, L, Hkv, D) storage,
    slot j holding position j up to each row's q_pos and -1 past it, the
    slots past it filled with large values.  At the planned cluster size
    and every other (at 2-8 slices whole slices of some rows are masked):
    within 1e-2 x (1 + |ref|) of ``flash_decode_torch``, finite, bit-equal
    from call to call, on the mma counter only."""
    gen = torch.Generator().manual_seed(64)
    b, length, h, d = 4, 2048, 24, 64
    q = torch.randn(b, h, d, generator=gen).to(torch.bfloat16)
    qp = torch.tensor(q_pos, dtype=torch.int32)
    idx = torch.arange(length)
    live = (idx[None] <= qp[:, None])[:, :, None, None]
    k, v = (torch.where(live, torch.randn(b, length, h, d, generator=gen),
                        torch.full((), 1e4)).to(torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    kvp = torch.where(idx[None] <= qp[:, None], idx, -1).to(torch.int32)
    assert tgeometry.flat_decode_engine(k.dtype, q.dtype, 1, d,
                                        tdecode.tma_strided(k, v)) == "mma"
    want = tdecode.flash_decode_torch(q, k, v, kvp, qp)
    args = [x.to(card) for x in (q, k, v, kvp, qp)]
    before = build.launch_counts()
    for split in (None, 1, 2, 3, 4, 8):
        got = tdecode.flash_decode_kernel(*args, kv_split=split)
        assert torch.isfinite(got.float()).all()
        _close(got, want, 1e-2)
        assert torch.equal(got, tdecode.flash_decode_kernel(
            *args, kv_split=split))
    after = build.launch_counts()
    assert {name for name in after if after[name] != before[name]} == {
        "flash_decode_mma"}


@pytest.mark.parametrize("kv_split", [None, 1, 2])
def test_flash_attention_wgmma_at_musicgen_shape(card, kv_split):
    """B5's wgmma engine at musicgen_medium's prefill and forward: 24
    heads on 24 kv heads (G = 1) x D 64, causal, Sq = Skv = 1024 and
    1088 (a sequence of 17 64-row tiles), at the planned kv split and
    both others: within 1e-2 of ``flash_attention_torch``, on the wgmma
    counter only."""
    gen = torch.Generator().manual_seed(1088)
    before = build.launch_counts()
    for s in (1024, 1088):
        q, k, v = (torch.randn(1, 24, s, 64, generator=gen).to(
            torch.bfloat16) for _ in range(3))
        want = tattn.flash_attention_torch(q, k, v)
        got = tattn.flash_attention_kernel(q.to(card), k.to(card),
                                           v.to(card), kv_split=kv_split)
        _close(got, want, 1e-2)
    after = build.launch_counts()
    assert {name for name in after if after[name] != before[name]} == {
        "flash_attention_wgmma"}


def test_ring_decode_engines_split_by_type_and_stride(card):
    """f32 caches, D = 32, G > 16 and views TMA cannot read stay on the
    SIMT kernel; the serving ring goes to the mma engine: each launch
    counts on its own engine's counter only."""
    gen = torch.Generator().manual_seed(17)
    for case, counter in [("f32", "flash_decode"), ("d32", "flash_decode"),
                          ("g17", "flash_decode"),
                          ("padded", "flash_decode"),
                          ("ring", "flash_decode_mma")]:
        g, d = (17, 64) if case == "g17" else (4, 32 if case == "d32" else 64)
        q, k, v, kvp, qp = _ring(3, 40, g, 1, d, [45, 17, 39], gen)
        if case == "f32":
            q, k, v = q.float(), k.float(), v.float()
        args = [x.to(card) for x in (q, k, v, kvp, qp)]
        if case == "padded":
            # Rows 68 bf16 apart, made on the card (a copy to the card
            # would be dense).
            args[1], args[2] = (torch.nn.functional.pad(x, (0, 4))[..., :d]
                                for x in args[1:3])
            assert not tdecode.tma_strided(args[1], args[2])
        before = build.launch_counts()
        got = tdecode.flash_decode_kernel(*args, window=32)
        after = build.launch_counts()
        _close(got, tdecode.flash_decode_torch(q, k, v, kvp, qp, window=32),
               1e-5 if q.dtype == torch.float32 else 1e-2)
        assert {name for name in after if after[name] != before[name]} \
            == {counter}


def _bf16_ulp(x):
    """One bf16 unit in the last place at each element of ``x`` (f32)."""
    mag = x.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("n", [16384, 2056, 257, 7])
def test_epilogue_pass_every_option_matches_plain(card, n):
    """B8's pass against its plain version at aligned N (the 16-byte
    vector path) and odd N (the scalar path in the same kernel), with each
    epilogue option alone and all together, each activation: f32 out
    within 1e-5 x (1 + |ref|) (tanhf against PyTorch's tanh), bf16 out
    within one bf16 ulp of the plain version's f32 result beyond that same
    f32 difference; one ``epilogue_pass`` launch per call."""
    gen = torch.Generator().manual_seed(n)
    m = 9
    acc = torch.randn(m, n, generator=gen) * 3
    c = torch.randn(m, n, generator=gen)
    bias = torch.randn(n, generator=gen)
    epis = [tepilogue.Epilogue(activation=act)
            for act in ("none", "relu", "gelu", "silu", "tanh")]
    epis += [tepilogue.Epilogue(alpha=0.7, beta=0.5),
             tepilogue.Epilogue(has_bias=True),
             tepilogue.Epilogue(softcap=4.0),
             tepilogue.Epilogue(alpha=0.7, beta=0.5, has_bias=True,
                                softcap=20.0, activation="gelu")]
    before = build.launch_counts()["epilogue_pass"]
    for epi in epis:
        want = trigid.epilogue_pass_torch(acc, c, bias, epilogue=epi)
        for out in (torch.float32, torch.bfloat16):
            got = trigid.epilogue_pass_kernel(
                acc.to(card), c.to(card), bias.to(card), epilogue=epi,
                out_dtype=out).cpu()
            assert got.dtype == out
            if out == torch.float32:
                _close(got, want, 1e-5)
            else:
                diff = (got.float() - want).abs()
                lim = _bf16_ulp(want) + 1e-5 * (1 + want.abs())
                assert bool((diff <= lim).all()), epi
    assert build.launch_counts()["epilogue_pass"] == before + 2 * len(epis)


# -- the decode step as a CUDA graph (the async engine's step) ----------------

tconfigs = LazyModule("repro_torch.configs")
tengine = LazyModule("repro_torch.serving.engine")
tmodel = LazyModule("repro_torch.models.model")


def _live_engine(card, arch, policy, prompts=(20, 9, 30), max_tokens=12,
                 steps=4):
    """A reduced engine on the card (graph + async, its defaults) that has
    served ``steps`` steps of ``prompts`` (lengths; 2 slots, 2-chunk
    prefill), its pipeline flushed: slots decoding at live positions."""
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              format_policy=policy)
    params = tmodel.init_params(cfg, seed=0, device=card)
    eng = tengine.ServingEngine(params, cfg, slots=2, cache_len=64,
                                prefill_len=32, page_size=8,
                                prefill_chunk=16, device=card)
    assert eng.decode_step.graph and eng.async_steps
    rng = np.random.default_rng(1)
    for rid, n_tok in enumerate(prompts):
        eng.submit(tengine.Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab, n_tok,
                                         dtype=np.int32),
            max_tokens=max_tokens))
    eng._admit()
    for _ in range(steps):
        eng.step()
    eng._flush_pipeline()
    assert eng._decoding()
    return eng


def _state(eng):
    """Every cache leaf and the carried token buffer (the tensors a
    replay writes), in a fixed order."""
    return [leaf for layer in eng.cache["layers"]
            for leaf in layer.values()] + [eng.decode_step.tokens]


def _run_steps(eng, n, fn, temp):
    """``n`` decode steps of the slots now decoding through ``fn`` (the
    eager step or a replay), positions advancing by one a step; → each
    step's (tok, finite, logits, carried tokens), cloned."""
    step = eng.decode_step
    decoding = eng._decoding()
    maxp = eng.sched.max_pages_per_seq
    table = np.full((eng.slots, maxp), -1, np.int32)
    active = np.zeros(eng.slots, bool)
    for slot in decoding:
        eng.sched.ensure_decode(slot, int(eng.slot_pos[slot]) + n)
        table[slot] = eng.sched.table_row(slot)
        active[slot] = True
    temps = np.where(active, temp, 0.0).astype(np.float32)
    out = []
    for i in range(n):
        pos = eng.slot_pos.astype(np.int64) + np.where(active, i, 0)
        step.stage(pos, table, temps, active)
        tok, finite, logits = fn(temp > 0)
        out.append([x.clone() for x in (tok, finite, logits, step.tokens)])
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
def test_decode_graph_replays_equal_the_eager_step(card, arch, policy,
                                                   temp):
    """From one live state, 4 eager decode steps and 4 replays of the
    captured step: tok, finite, logits, the carried tokens and every
    cache leaf equal bit for bit (sampled rows too: the generator is put
    back to the same state before each run)."""
    eng = _live_engine(card, arch, policy)
    step = eng.decode_step
    step.capture(temp > 0)            # before the snapshot: the capture's
    start = [x.clone() for x in _state(eng)]  # warm-up writes page 0
    gen_state = eng._gen.get_state()
    eager = _run_steps(eng, 4, step.eager, temp)
    eager_state = [x.clone() for x in _state(eng)]
    for dst, src in zip(_state(eng), start):
        dst.copy_(src)
    eng._gen.set_state(gen_state)
    graph = _run_steps(eng, 4, step, temp)
    for i, (e, g) in enumerate(zip(eager, graph)):
        for name, a, b in zip(("tok", "finite", "logits", "tokens"), e, g):
            assert torch.equal(a, b), (i, name)
    for i, (a, b) in enumerate(zip(eager_state, _state(eng))):
        assert torch.equal(a, b), i
    rows = torch.as_tensor(eng._decoding(), device=card)
    for tok, _, _, tokens in graph:           # each replay chains its token
        assert torch.equal(tokens[rows, 0], tok[rows])


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
def test_decode_graph_capture_leaves_the_cache_unchanged(card, arch):
    """The capture's all-inactive warm-up (and the capture) change no KV
    page but the null page 0, no ring or RG-LRU row, no carried token
    and no staged input."""
    eng = _live_engine(card, arch, "bf16")
    step = eng.decode_step
    step.graphs.clear()
    step.stage(eng.slot_pos, np.full((2, eng.sched.max_pages_per_seq), 3,
                                     np.int32), np.ones(2, np.float32),
               np.ones(2, bool))
    before = [x.clone() for x in _state(eng)]
    staged = [x.clone() for x in (step.pos, step.page_table, step.temps,
                                  step.active)]
    for sampled in (False, True):
        step.capture(sampled)
    torch.cuda.synchronize()
    names = [name for layer in eng.cache["layers"] for name in layer]
    for name, old, new in zip(names + ["tokens"], before, _state(eng)):
        if name.endswith(("_pages", "_scale")):
            old, new = old[1:], new[1:]
        assert torch.equal(old, new), name
    for old, new in zip(staged, (step.pos, step.page_table, step.temps,
                                 step.active)):
        assert torch.equal(old, new)


def test_decode_graph_replay_counts_the_captured_launches(card):
    """A replay adds what its capture recorded: the eager step's launches
    per kernel, once per replay; the capture itself counts nothing."""
    eng = _live_engine(card, "recurrentgemma_9b", "bf16")
    step = eng.decode_step
    step.graphs.clear()
    build.reset_launch_counts()
    step.eager(False)
    eager = {k: v for k, v in build.launch_counts().items() if v}
    assert eager.get("flash_decode_mma") or eager.get("flash_decode")
    build.reset_launch_counts()
    step.capture(False)
    warm = {k: v for k, v in build.launch_counts().items() if v}
    assert warm == eager                      # the warm-up ran; no more
    assert step.graphs[False][2] == eager
    build.reset_launch_counts()
    for _ in range(3):
        step(False)
    assert {k: v for k, v in build.launch_counts().items() if v} == {
        k: 3 * v for k, v in eager.items()}


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
def test_decode_steps_do_not_grow_device_memory(card, arch):
    """One long request in steady async decode: the graph's outputs live
    in its pool and the inputs are static, so live device memory stays
    flat step after step."""
    eng = _live_engine(card, arch, "bf16", prompts=(20,), max_tokens=40,
                       steps=5)
    seen = []
    for _ in range(5):
        eng.step()
        seen.append(torch.cuda.memory_allocated(card))
    assert max(seen) == min(seen), seen
    assert eng.steps_in_flight == 1


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
def test_steady_async_step_syncs_only_in_the_retire(card, arch):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` a steady-state
    step — staging, replay, token copies, the retire of the step before —
    raises on any synchronising call; the retire's event wait is not one
    of them (it is the step's one host sync)."""
    eng = _live_engine(card, arch, "bf16", prompts=(20, 25), max_tokens=30,
                       steps=5)
    eng.step()                                # a decode is in flight now
    assert eng.steps_in_flight == 1
    outputs = [len(r.output) for r in eng.slot_req if r is not None]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = [len(r.output) for r in eng.slot_req if r is not None]
    assert [b - a for a, b in zip(outputs, after)] == [2] * len(after)


def test_decode_graph_capture_failure_raises(card, monkeypatch):
    """A decode step that syncs inside the capture cannot be captured: the
    engine's step raises and never falls back to the eager step."""
    eng = _live_engine(card, "gemma_2b", "fp32")
    step = eng.decode_step
    step.graphs.clear()
    real = tmodel.decode_and_sample

    def syncing(*args, **kw):
        out = real(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            out[2].sum().item()
        return out

    # The module itself, not its LazyModule stand-in: the engine reads
    # ``decode_and_sample`` from the module at each call.
    monkeypatch.setattr("repro_torch.models.model.decode_and_sample",
                        syncing)
    outputs = {r.rid: len(r.output) for r in eng.slot_req if r is not None}
    with pytest.raises(RuntimeError):
        eng.step()
    assert step.graphs == {}
    assert {r.rid: len(r.output) for r in eng.slot_req
            if r is not None} == outputs


# -- speculative decoding: the verify window and the engine -------------------

def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _card_format(arch):
    """The format of the card's model-level tests: the arch's own bf16acc
    for qwen15_4b, bf16 for the others."""
    return "bf16acc" if arch == "qwen15_4b" else "bf16"


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b",
                                  "gemma2_27b", "qwen15_4b"])
def test_verify_rows_equal_decode_steps_on_the_card(card, arch):
    """bf16 at head_dim 64 (qwen15_4b: its bf16acc format), so attention
    runs the full-width engines (B4's and B6's mma): 4 slots, the second
    masked, a 4-token window (M = 16).  Logits row i equals a decode
    step's at pos + i and the cache after the window the cache after the
    4 steps, bit for bit; the window launches the kernels the 4 steps
    launch and no other, B4 once per position and global layer, B6 once
    per position and local layer."""
    slots, k, page, maxp = 4, 4, 8, 8
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              head_dim=64, format_policy=_card_format(arch),
                              compute_dtype="bfloat16",
                              decode_qkv_grouped=True)
    params = tmodel.init_params(cfg, seed=0, device=card)
    cache = tmodel.init_paged_cache(cfg, slots, page * maxp,
                                    num_pages=slots * maxp + 1,
                                    page_size=page, device=card)
    table = (1 + torch.arange(slots * maxp, dtype=torch.int32,
                              device=card)).reshape(slots, maxp)
    rng = np.random.default_rng(0)
    for s in range(slots):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 24)),
                               device=card)
        tmodel.prefill_chunk(params, {"tokens": toks,
                                      "page_table": table[s:s + 1],
                                      "slot": s}, cache, cfg, pos0=0)
    window = torch.as_tensor(rng.integers(0, cfg.vocab, (slots, k)),
                             device=card)
    pos = torch.tensor([24, 20, 18, 24], device=card)
    valid = torch.tensor([True, False, True, True], device=card)
    start = {"layers": [{n: v.clone() for n, v in layer.items()}
                        for layer in cache["layers"]]}
    build.reset_launch_counts()
    steps = []
    for i in range(k):
        logits, cache = tmodel.decode(
            params, {"tokens": window[:, i:i + 1], "pos": pos + i,
                     "page_table": table, "row_valid": valid}, cache, cfg)
        steps.append(logits)
    torch.cuda.synchronize()
    stepped = {n: c for n, c in build.launch_counts().items() if c}
    build.reset_launch_counts()
    logits, after = tmodel.verify_chunk(
        params, {"tokens": window, "pos": pos, "page_table": table,
                 "row_valid": valid}, start, cfg)
    torch.cuda.synchronize()
    verified = {n: c for n, c in build.launch_counts().items() if c}
    for i in range(k):
        assert torch.equal(logits[:, i], steps[i]), i
    for a, b in zip(after["layers"], cache["layers"]):
        for name in a:
            assert torch.equal(a[name], b[name]), name
    assert set(verified) == set(stepped), (verified, stepped)
    kinds = [mixer for mixer, _ in cfg.layer_kinds]
    for attn, kind in (("flash_decode_paged_mma", "attn"),
                       ("flash_decode_mma", "local")):
        want = k * kinds.count(kind)
        assert verified.get(attn, 0) == stepped.get(attn, 0) == want


@pytest.mark.parametrize("n_out,k_dim,rows_per_launch",
                         [(36864, 4608, 14), (4608, 36864, 7),
                          (4608, 4096, 16)])
def test_window_rows_keep_the_decode_bits_at_gemma2_shapes(
        card, n_out, k_dim, rows_per_launch):
    """gemma2_27b's decode gate/up, down and o on the plan of a 4-slot
    decode step, called on 16 and 20 window rows: the rows run in chunks
    of ``geometry.window_rows`` on B2's cluster engine (the split planned
    at 4 rows does not fit more of x's rows in shared memory) and equal,
    bit for bit, the 4-row GEMMs a decode step launches."""
    gen = torch.Generator(device=card).manual_seed(0)
    w = torch.randn(k_dim, n_out, generator=gen,
                    device=card).to(torch.bfloat16)
    for rows in (16, 20):
        a = (torch.randn(rows, k_dim, generator=gen, device=card)
             / k_dim ** 0.5).to(torch.bfloat16)
        build.reset_launch_counts()
        whole = tops.mte_gemm(a, w, plan_rows=4)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        parts = torch.cat([tops.mte_gemm(a[i:i + 4], w)
                           for i in range(0, rows, 4)])
        assert torch.equal(whole, parts), rows
        assert counts["splitk_gemm_cluster"] == -(-rows // rows_per_launch)
        assert counts["splitk_gemm"] == counts["mte_gemm"] == 0


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b",
                                  "gemma2_27b"])
def test_speculative_engine_on_the_card_equals_the_cpu(card, arch):
    """The reduced fp32 engine with ``spec_k=4`` on the card (its
    defaults: async, the decode step as a CUDA graph) and on the CPU
    (synchronous, eager): equal greedy streams, with rejections, and
    equal to ``spec_k=0`` on the card."""
    cfg = tconfigs.get_config(arch).reduced()
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n_tok, dtype=np.int32)
               for n_tok in (20, 9, 30, 17)]

    def serve(device, spec_k):
        eng = tengine.ServingEngine(
            params if device == "cpu" else _to_device(params, device), cfg,
            device=device, spec_k=spec_k, async_steps=device != "cpu",
            slots=2, cache_len=64, prefill_len=32, page_size=8,
            prefill_chunk=16)
        for rid, prompt in enumerate(prompts):
            eng.submit(tengine.Request(rid=rid, prompt=prompt,
                                       max_tokens=10))
        out = eng.run()
        assert all(r.status == "ok" for r in out.values())
        return {rid: list(r) for rid, r in out.items()}, eng.metrics()

    card_spec, m = serve(card, 4)
    assert m["spec_steps"] > 0 and 0.0 < m["acceptance_rate"] < 1.0
    assert card_spec == serve("cpu", 4)[0]
    assert card_spec == serve(card, 0)[0]


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b",
                                  "gemma2_27b", "qwen15_4b"])
def test_speculative_engine_on_the_full_width_engines(card, arch):
    """bf16 at head_dim 64 (qwen15_4b: its bf16acc format; B2's cluster,
    B3's split-K, B4's and B6's mma engines): greedy streams with
    ``spec_k=4`` equal those without it on the card, with rejections
    (rollback, and on recurrentgemma the ring and RG-LRU restore and
    replay), and no tile-loop or SIMT launch."""
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              head_dim=64, format_policy=_card_format(arch),
                              compute_dtype="bfloat16")
    params = tmodel.init_params(cfg, seed=0, device=card)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n_tok, dtype=np.int32)
               for n_tok in (20, 9, 30, 17)]

    def serve(spec_k):
        eng = tengine.ServingEngine(params, cfg, device=card, spec_k=spec_k,
                                    slots=2, cache_len=64, prefill_len=32,
                                    page_size=8, prefill_chunk=16)
        for rid, prompt in enumerate(prompts):
            eng.submit(tengine.Request(rid=rid, prompt=prompt,
                                       max_tokens=10))
        build.reset_launch_counts()
        out = eng.run()
        counts = build.launch_counts()
        assert all(r.status == "ok" for r in out.values())
        return {rid: list(r) for rid, r in out.items()}, eng.metrics(), counts

    spec, m, counts = serve(4)
    assert m["spec_steps"] > 0 and 0.0 < m["acceptance_rate"] < 1.0
    assert spec == serve(0)[0]
    for kernel in ("splitk_gemm", "grouped_gemm", "flash_decode_paged",
                   "flash_decode"):
        assert counts[kernel] == 0, kernel


# -- the speculative step's graphs --------------------------------------------

# (family, n) of every graph family of ``SpecStep`` at k = 3 and below.
SPEC_SHAPES = [("verify", 3), ("catchup", 2), ("replay", 2), ("draft", 1)]


def _live_spec_engine(card, arch):
    """A reduced bf16 engine with ``spec_k=4`` on the card (its defaults:
    the speculative step's shapes as CUDA graphs) that has served a few
    steps: slots decoding at live positions, the draft caught up to some
    of them."""
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              format_policy="bf16")
    params = tmodel.init_params(cfg, seed=0, device=card)
    eng = tengine.ServingEngine(params, cfg, slots=2, cache_len=64,
                                prefill_len=32, page_size=8,
                                prefill_chunk=16, spec_k=4, device=card)
    assert eng.spec_step.graph
    rng = np.random.default_rng(4)
    for rid, n_tok in enumerate((20, 30)):
        eng.submit(tengine.Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab, n_tok,
                                         dtype=np.int32), max_tokens=40))
    eng._admit()
    for _ in range(5):
        eng.step()
    eng._flush_pipeline()
    assert len(eng._decoding()) == 2 and eng.metrics()["spec_steps"] > 0
    return eng


def _stage_spec(eng, family, n, seed=0):
    """Stage one call of (family, n) over both decoding slots at their
    live positions, with random tokens."""
    spec = eng.spec_step
    rows = eng._decoding()
    tokens = np.random.default_rng(seed).integers(
        0, eng.cfg.vocab, (eng.slots, n)).astype(np.int64)
    if family in ("verify", "replay"):
        pos = eng.slot_pos.astype(np.int64)
        spec.stage("target", pos, *eng._rows(rows, draft=False))
    else:
        pos = eng._draft_pos.astype(np.int64)
        spec.stage("draft", pos, *eng._rows(rows, draft=True))
    spec.stage_tokens(family, tokens)


def _spec_state(eng):
    """Every target and draft cache leaf and the speculative step's
    proposal and token buffers (what a call writes), in a fixed order."""
    spec = eng.spec_step
    return ([leaf for cache in (eng.cache, eng.draft_cache)
             for layer in cache["layers"] for leaf in layer.values()]
            + [spec.last, spec.props, spec.draft_tok])


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
def test_spec_graph_replays_equal_the_eager_calls(card, arch):
    """From one live state, each shape of the speculative step called
    eagerly and replayed: every output (logits, argmax, finite flags,
    accepted drafts) and every cache leaf and proposal buffer equal bit
    for bit."""
    eng = _live_spec_engine(card, arch)
    spec = eng.spec_step
    for family, n in SPEC_SHAPES:
        _stage_spec(eng, family, n)
        if (family, n) not in spec.graphs:
            spec.capture(family, n)
        start = [x.clone() for x in _spec_state(eng)]
        eager = {k: v.clone() for k, v in spec.eager(family, n).items()}
        after = [x.clone() for x in _spec_state(eng)]
        for dst, src in zip(_spec_state(eng), start):
            dst.copy_(src)
        replayed = spec(family, n)
        torch.cuda.synchronize()
        assert sorted(replayed) == sorted(eager), family
        for name in eager:
            assert torch.equal(replayed[name], eager[name]), (family, name)
        for i, (a, b) in enumerate(zip(after, _spec_state(eng))):
            assert torch.equal(a, b), (family, i)


@pytest.mark.parametrize("arch", ["gemma_2b", "recurrentgemma_9b"])
def test_spec_graph_capture_leaves_the_caches_unchanged(card, arch):
    """The all-inactive warm-up and the capture of every shape change no
    target or draft KV page but the null page 0, no ring or RG-LRU row,
    no proposal buffer and no staged input."""
    eng = _live_spec_engine(card, arch)
    spec = eng.spec_step
    spec.graphs.clear()
    for seed, (family, n) in enumerate(SPEC_SHAPES):
        _stage_spec(eng, family, n, seed)
    before = [x.clone() for x in _spec_state(eng)]
    staged = [x.clone() for side in spec.inputs.values()
              for x in side.values()]
    for family, n in SPEC_SHAPES:
        spec.capture(family, n)
    torch.cuda.synchronize()
    names = [name for cache in (eng.cache, eng.draft_cache)
             for layer in cache["layers"] for name in layer]
    names += ["last", "props", "draft_tok"]
    for name, old, new in zip(names, before, _spec_state(eng)):
        if name.endswith(("_pages", "_scale")):
            old, new = old[1:], new[1:]
        assert torch.equal(old, new), name
    for old, new in zip(staged, [x for side in spec.inputs.values()
                                 for x in side.values()]):
        assert torch.equal(old, new)


def test_spec_graph_replay_counts_the_captured_launches(card):
    """A replay adds what its capture recorded: the eager call's launches
    per kernel, once per replay; the capture itself counts only its
    warm-up."""
    eng = _live_spec_engine(card, "recurrentgemma_9b")
    spec = eng.spec_step
    spec.graphs.clear()
    _stage_spec(eng, "verify", 3)
    build.reset_launch_counts()
    spec.eager("verify", 3)
    eager = {k: v for k, v in build.launch_counts().items() if v}
    assert eager.get("flash_decode_mma") or eager.get("flash_decode")
    build.reset_launch_counts()
    spec.capture("verify", 3)
    assert {k: v for k, v in build.launch_counts().items() if v} == eager
    assert spec.graphs[("verify", 3)][2] == eager
    build.reset_launch_counts()
    replays = spec.replays["verify"]
    for _ in range(3):
        spec("verify", 3)
    assert {k: v for k, v in build.launch_counts().items() if v} == {
        k: 3 * v for k, v in eager.items()}
    assert spec.replays["verify"] == replays + 3
    assert spec.captures["verify"] >= 1


def test_spec_graph_capture_failure_raises(card, monkeypatch):
    """A verify window that syncs inside the capture cannot be captured:
    the engine's step raises, never falls back to the eager call, and
    registers no graph for the shape."""
    eng = _live_spec_engine(card, "gemma_2b")
    spec = eng.spec_step
    spec.graphs.clear()
    real = tmodel.verify_chunk

    def syncing(*args, **kw):
        out = real(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            out[0].sum().item()
        return out

    monkeypatch.setattr("repro_torch.models.model.verify_chunk", syncing)
    with pytest.raises(RuntimeError):
        eng.step()
    assert not any(family in ("verify", "catchup", "replay")
                   for family, _ in spec.graphs)


# -- training: autograd through the kernels ----------------------------------

ttrainer = LazyModule("repro_torch.training.trainer")
topt = LazyModule("repro_torch.optim.optimizer")
ttree = LazyModule("repro_torch.tree")


def test_mte_gemm_backward_runs_on_the_kernels(card):
    """A bf16-format projection of f32 parameters with bias + gelu: the
    forward on B1's wgmma mainloop, the backward's recompute, dA and dB
    as three f32 launches of B1's SIMT engine, none on the tile loop (the
    dB, 1024 x 1024 x 2048, on its 128 x 64 tile); the gradients equal
    the CPU's
    (the plain versions): the f32 ones (w, bias) within 1e-4 of the
    largest entry, a's within 1e-2, as it is rounded to a's bf16 (one
    bf16 step where the two f32 sums straddle a rounding boundary)."""
    gen = torch.Generator().manual_seed(0)
    m, k, n = 2048, 1024, 1024       # no plan splits K
    a = (torch.randn(m, k, generator=gen) / 32).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen) / 32
    bias = torch.randn(n, generator=gen)
    ct = torch.randn(m, n, generator=gen)
    epi = tepilogue.Epilogue(has_bias=True, activation="gelu")
    grads = {}
    for dev in ("cpu", card):
        leaves = [x.to(dev).requires_grad_() for x in (a, w, bias)]
        before = build.launch_counts()
        out = tops.mte_gemm(*leaves[:2], bias=leaves[2], epilogue=epi,
                            format_policy="bf16")
        g = torch.autograd.grad((out.float() * ct.to(dev)).sum(), leaves)
        grads[str(dev)] = [x.float().cpu() for x in g]
        after = build.launch_counts()
    assert after["mte_gemm_wgmma"] - before["mte_gemm_wgmma"] == 1
    assert after["mte_gemm_simt"] - before["mte_gemm_simt"] == 3
    assert after["mte_gemm"] == before["mte_gemm"]
    for got, want, tol in zip(grads["cuda"], grads["cpu"],
                              (1e-2, 1e-4, 1e-4)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err < tol


def test_flash_attention_backward_on_the_card(card):
    """B5's forward on the card, its backward through the plain
    attention: the gradients equal the CPU's within bf16 tolerance."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 8, 128, 256, generator=gen).to(torch.bfloat16),
               torch.randn(1, 1, 128, 256, generator=gen).to(torch.bfloat16),
               torch.randn(1, 1, 128, 256, generator=gen).to(torch.bfloat16))
    grads = {}
    for dev in ("cpu", card):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = tops.flash_attention(*leaves, causal=True)
        g = torch.autograd.grad(out.float().square().sum(), leaves)
        grads[str(dev)] = [x.float().cpu() for x in g]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 2e-2


def test_train_steps_on_the_card_equal_the_cpu(card):
    """Two train steps of a small fp32 gemma_2b on the card and on the
    CPU: losses within 1e-5 relative, parameters within 1e-5."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                              n_layers=2, d_model=64, d_ff=128, vocab=128,
                              n_heads=2, n_kv_heads=1, head_dim=32)
    opt = topt.AdamWConfig(lr=1e-3)
    step = ttrainer.make_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab, (2, 4, 32),
                           generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", card):
        params = tmodel.init_params(cfg, seed=0, device="cpu")
        params = ttree.tree_map(lambda p: p.to(dev), params)
        state = topt.init_opt_state(params)
        losses = []
        for i in range(2):
            params, state, m = step(params, state,
                                    {"tokens": tokens[i].to(dev)})
            losses.append(float(m["loss"]))
        out[str(dev)] = (losses, [p.cpu() for p in ttree.leaves(params)])
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= 1e-5


SIMT_TILES = [(128, 128), (128, 64)]
SIMT_SHAPES = [(100, 72, 132), (520, 2056, 1032), (17, 260, 36),
               (257, 64, 1000), (4096, 256, 128)]


@pytest.mark.parametrize("transposed", [False, True], ids=["kn", "nk"])
@pytest.mark.parametrize("tile", SIMT_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_simt_engine_is_bit_equal_to_the_tile_loop(card, tile, transposed):
    """B1's SIMT f32 engine against the tile loop pinned at 64 x 64, both
    B layouts, ragged M (17, 100, 257, 520), K not a multiple of the
    16-deep stage (36, 132, 1000, 1032), with the identity and a full
    epilogue: bit for bit (each output is the same FMA chain over k), and
    within 1e-4 x (1 + |ref|) of the plain version; the counters show
    each engine ran."""
    gen = torch.Generator().manual_seed(11)
    sew = tgeometry.SEW.E32
    geom = tgeometry.BlockGeometry(*tile, 256, 1, 1, transposed, sew, sew,
                                   "mte")
    loop = dataclasses.replace(geom, bm=64, bn=64)
    full = tepilogue.Epilogue(alpha=0.7, beta=0.5, has_bias=True,
                              softcap=20.0, activation="gelu")
    before = build.launch_counts()
    for m, n, k in SIMT_SHAPES:
        assert tgeometry.gemm_engine(torch.float32, *tile, n, k,
                                     m=m) == "simt"
        a = torch.randn(m, k, generator=gen) / k ** 0.5
        b = torch.randn(k, n, generator=gen)
        c = torch.randn(m, n, generator=gen)
        bias = torch.randn(n, generator=gen)
        bk = (b.t().contiguous() if transposed else b).to(card)
        for epi, c_, bias_ in ((tepilogue.Epilogue(), None, None),
                               (full, c, bias)):
            dev = [x.to(card) if x is not None else None
                   for x in (a, c_, bias_)]
            got = tgemm.mte_gemm_kernel(dev[0], bk, dev[1], dev[2],
                                        geom=geom, epilogue=epi)
            ref = tgemm.mte_gemm_kernel(dev[0], bk, dev[1], dev[2],
                                        geom=loop, epilogue=epi)
            assert torch.equal(got, ref), (m, n, k, epi)
            want = tgemm.mte_gemm_torch(a, b, c_, bias_, geom=dataclasses.
                                        replace(geom, transposed_b=False),
                                        epilogue=epi)
            got, want = got.cpu(), want
            assert bool(((got - want).abs()
                         <= 1e-4 * (1 + want.abs())).all()), (m, n, k)
    after = build.launch_counts()
    runs = 2 * len(SIMT_SHAPES)
    assert after["mte_gemm_simt"] - before["mte_gemm_simt"] == runs
    assert after["mte_gemm"] - before["mte_gemm"] == runs


@pytest.mark.parametrize("tile", SIMT_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("m,n,k,n_split", [(2048, 256, 4096, 4),
                                           (300, 200, 1000, 3),
                                           (40, 128, 68, 2),
                                           (33, 64, 36, 8)])
def test_simt_splitk_matches_plain(card, tile, m, n, k, n_split):
    """B2's split on the SIMT engine: within 1e-4 of its plain version
    (the f32 tolerance of ``test_gemm_kernels_match_plain``), and equal
    to the tile loop's split at the same slices (each slice the same FMA
    chain, summed by the same pass); slices past K write zeros."""
    gen = torch.Generator().manual_seed(n_split)
    sew = tgeometry.SEW.E32
    geom = tgeometry.BlockGeometry(*tile, 256, n_split, 1, False, sew, sew,
                                   "mte")
    a = torch.randn(m, k, generator=gen) / k ** 0.5
    b = torch.randn(k, n, generator=gen)
    assert tgeometry.splitk_engine(torch.float32, m, n, k,
                                   tile=tile) == "simt"
    before = build.launch_counts()
    got = tsplitk.mte_gemm_splitk_kernel(a.to(card), b.to(card), geom=geom,
                                         n_split=n_split)
    mid = build.launch_counts()
    ref = tsplitk.mte_gemm_splitk_kernel(
        a.to(card), b.to(card), geom=dataclasses.replace(geom, bm=64, bn=64),
        n_split=n_split)
    _close(got, tsplitk.mte_gemm_splitk_torch(a, b, geom=geom,
                                              n_split=n_split), 1e-4)
    assert torch.equal(got, ref)
    parts = tsplitk.launch_partials(a.to(card), b.to(card), geom=geom,
                                    n_split=n_split,
                                    acc_dtype=torch.float32, engine="simt")
    _close(parts, tsplitk.splitk_partials_torch(a, b, geom=geom,
                                                n_split=n_split), 1e-4)
    live = -(-k // tsplitk.splitk_layout(k, geom, n_split)[1])
    assert not parts[live:].any()
    assert {k_ for k_ in mid if mid[k_] != before[k_]} == {"splitk_gemm_simt"}


def test_f32_train_step_on_the_simt_engine_equals_the_cpu(card):
    """A 4-layer f32 gemma_2b (reduced widths) over 4 x 32 tokens: every
    GEMM of the step has 128 rows or more and widths that are multiples
    of 4, so forward and backward run on the SIMT engine (B1, and B2
    where a plan splits K) and none on the tile loops.  Loss within 1e-5
    relative and every gradient leaf within 1e-4 relative Frobenius error
    of the CPU's (chip_smoke.py's fp32 gate), after one AdamW step the
    parameters within 1e-5."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                              n_layers=4)
    tokens = torch.randint(0, cfg.vocab, (4, 32),
                           generator=torch.Generator().manual_seed(4))
    opt = topt.AdamWConfig(lr=1e-3)
    out = {}
    for dev in ("cpu", card):
        params = tmodel.init_params(cfg, seed=0, device="cpu")
        params = ttree.tree_map(lambda p: p.to(dev), params)
        before = build.launch_counts()
        metrics, grads = ttrainer.loss_and_grads(
            params, {"tokens": tokens.to(dev)}, cfg)
        after = build.launch_counts()
        topt.adamw_update(params, grads, topt.init_opt_state(params), opt)
        out[str(dev)] = (float(metrics["loss"]),
                         [g.cpu() for g in ttree.leaves(grads)],
                         [p.cpu() for p in ttree.leaves(params)])
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert ran.get("mte_gemm_simt", 0) > 0, ran
    assert not {"mte_gemm", "splitk_gemm"} & set(ran), ran
    (lg, gg, pg), (lc, gc, pc) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        rel = float(torch.linalg.vector_norm(a - b)
                    / (torch.linalg.vector_norm(b) + 1e-30))
        assert rel <= 1e-4
    for a, b in zip(pg, pc):
        assert float((a - b).abs().max()) <= 1e-5


RIGID_SIMT_SHAPES = [(4, 300, 1000), (16, 392, 1000), (1, 4, 4),
                     (130, 264, 520), (129, 128, 132), (520, 2056, 1032)]


@pytest.mark.parametrize("m,n,k", RIGID_SIMT_SHAPES)
def test_rigid_simt_is_bit_equal_to_the_rigid_tile_loop(card, m, n, k):
    """B8 stage 1 on the SIMT f32 engine (every M, M <= 16 included, K
    and N multiples of 4) against the rigid tile loop pinned: bit for bit
    (each output is the same FMA chain over k from 0), and within 1e-4 x
    (1 + |ref|) of the plain version; each counter shows its engine."""
    assert tgeometry.gemm_engine(torch.float32, 128, 128, n, k, m=m,
                                 rigid=True) == "simt"
    gen = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=gen) / k ** 0.5
    b = torch.randn(k, n, generator=gen)
    before = build.launch_counts()
    got = trigid.rigid_accumulate_kernel(a.to(card), b.to(card))
    mid = build.launch_counts()
    ref = trigid.rigid_accumulate_kernel(a.to(card), b.to(card),
                                         engine="tile")
    after = build.launch_counts()
    assert torch.equal(got, ref)
    want = trigid.rigid_accumulate_torch(a, b)
    assert bool(((got.cpu() - want).abs() <= 1e-4 * (1 + want.abs())).all())
    assert {k_ for k_ in mid if mid[k_] != before[k_]} == {"rigid_gemm_simt"}
    assert {k_ for k_ in after if after[k_] != mid[k_]} == {"rigid_gemm"}
    with pytest.raises(ValueError, match="engine='wgmma'"):
        trigid.rigid_accumulate_kernel(a.to(card), b.to(card),
                                       engine="wgmma")


GROUPED_PIPED = [(3, 100, 392, 1000, True, (392, 129, 0)),
                 (2, 200, 264, 520, False, None),
                 (4, 64, 392, 1032, False, (392, 40, 300, 0)),
                 (2, 17, 136, 72, True, None)]


# bf16acc takes no 256-wide tile (its two register sets).
@pytest.mark.parametrize("tile,acc", [((64, 64), None), ((128, 128), None),
                                      ((128, 256), None),
                                      ((64, 64), "bfloat16"),
                                      ((128, 128), "bfloat16")],
                         ids=lambda v: (f"{v[0]}x{v[1]}"
                                        if isinstance(v, tuple)
                                        else f"{v or 'f32'}acc"))
@pytest.mark.parametrize("case", GROUPED_PIPED,
                         ids=lambda c: f"G{c[0]}-C{c[1]}")
def test_grouped_wgmma_matches_plain(card, case, tile, acc):
    """B3 past 16 rows on the wgmma engine against its plain version: C
    not a multiple of 64, an N tail, a K not a multiple of 64, a
    broadcast x (group stride 0) and a per-group x, widths that straddle
    a tile and one of 0 (their columns exactly 0), bf16 out with an f32
    accumulator (1e-2 x (1 + |ref|)) and bf16acc (3e-2, B1's); two calls
    are bit-equal."""
    g, c, n, k, shared, widths = case
    acc = getattr(torch, acc) if acc else None
    gen = torch.Generator().manual_seed(c + n)
    x = (torch.randn(g, c, k, generator=gen) / k ** 0.5).to(torch.bfloat16)
    w = torch.randn(g, k, n, generator=gen).to(torch.bfloat16)
    if shared:
        x = x[:1].expand(g, c, k)
    sew = tgeometry.SEW.E32
    geom = tgeometry.BlockGeometry(*tile, 64, 1, 1, False, sew, sew, "mte")
    epi = tepilogue.Epilogue(alpha=0.7, softcap=20.0, activation="gelu")
    out_dt = torch.float32 if acc is not None else torch.bfloat16
    kw = dict(geom=geom, epilogue=epi, out_dtype=out_dt, acc_dtype=acc,
              widths=widths)
    assert tgeometry.grouped_engine(torch.bfloat16, c, n, k,
                                    bf16acc=acc is not None,
                                    tile=tile) == "wgmma"
    before = build.launch_counts()["grouped_gemm_wgmma"]
    got = tgrouped.grouped_gemm_kernel(x.to(card), w.to(card), **kw)
    again = tgrouped.grouped_gemm_kernel(x.to(card), w.to(card), **kw)
    assert build.launch_counts()["grouped_gemm_wgmma"] == before + 2
    assert torch.equal(got, again)
    want = tgrouped.grouped_gemm_torch(x, w, **kw)
    tol = 3e-2 if acc is not None else 1e-2
    got = got.float().cpu()
    assert bool(((got - want.float()).abs()
                 <= tol * (1 + want.float().abs())).all())
    for i, wd in enumerate(widths or ()):
        assert not got[i, :, wd:].any()


@pytest.mark.parametrize("tile", SIMT_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", GROUPED_PIPED,
                         ids=lambda c: f"G{c[0]}-C{c[1]}")
def test_grouped_simt_is_bit_equal_to_the_tile_loop(card, case, tile):
    """B3 past 16 rows on the SIMT f32 engine against B3's tile loop
    pinned at 64 x 64: bit for bit with a full epilogue, broadcast and
    per-group x, widths (their columns exactly 0); within 1e-4 x (1 +
    |ref|) of the plain version."""
    g, c, n, k, shared, widths = case
    gen = torch.Generator().manual_seed(c + k)
    x = torch.randn(g, c, k, generator=gen) / k ** 0.5
    w = torch.randn(g, k, n, generator=gen)
    if shared:
        x = x[:1].expand(g, c, k)
    sew = tgeometry.SEW.E32
    geom = tgeometry.BlockGeometry(*tile, 64, 1, 1, False, sew, sew, "mte")
    kw = dict(epilogue=tepilogue.Epilogue(alpha=0.7, softcap=20.0,
                                          activation="gelu"),
              widths=widths)
    assert tgeometry.grouped_engine(torch.float32, c, n, k,
                                    tile=tile) == "simt"
    before = build.launch_counts()
    got = tgrouped.grouped_gemm_kernel(x.to(card), w.to(card), geom=geom,
                                       **kw)
    ref = tgrouped.grouped_gemm_kernel(
        x.to(card), w.to(card), geom=dataclasses.replace(geom, bm=64, bn=64),
        **kw)
    after = build.launch_counts()
    assert after["grouped_gemm_simt"] == before["grouped_gemm_simt"] + 1
    assert after["grouped_gemm"] == before["grouped_gemm"] + 1
    assert torch.equal(got, ref)
    want = tgrouped.grouped_gemm_torch(x, w, geom=geom, **kw)
    got = got.cpu()
    assert bool(((got - want).abs() <= 1e-4 * (1 + want.abs())).all())
    for i, wd in enumerate(widths or ()):
        assert not got[i, :, wd:].any()


def test_amx_train_steps_on_the_card_equal_the_cpu(card):
    """Three steps of reduced fp32 gemma_2b under the rigid ``amx``
    policy on the card and on the CPU (``loss_and_grads`` + AdamW): every
    GEMM, forward and backward, runs B8 stage 1 on the SIMT f32 engine
    and none runs B1, B2 or a tile loop; each loss within 1e-5 relative,
    every gradient leaf within 1e-4 relative Frobenius error, the
    parameters after the steps within 1e-5."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma_2b").reduced(),
                              gemm_policy="amx")
    tokens = torch.randint(0, cfg.vocab, (3, 4, 32),
                           generator=torch.Generator().manual_seed(6))
    opt = topt.AdamWConfig(lr=1e-3)
    out = {}
    for dev in ("cpu", card):
        params = tmodel.init_params(cfg, seed=0, device="cpu")
        params = ttree.tree_map(lambda p: p.to(dev), params)
        state = topt.init_opt_state(params)
        before = build.launch_counts()
        steps = []
        for i in range(3):
            metrics, grads = ttrainer.loss_and_grads(
                params, {"tokens": tokens[i].to(dev)}, cfg)
            topt.adamw_update(params, grads, state, opt)
            steps.append((float(metrics["loss"]),
                          [g.cpu() for g in ttree.leaves(grads)]))
        after = build.launch_counts()
        out[str(dev)] = (steps, [p.cpu() for p in ttree.leaves(params)])
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert ran.get("rigid_gemm_simt", 0) > 0, ran
    assert not {"rigid_gemm", "mte_gemm", "mte_gemm_simt", "splitk_gemm",
                "splitk_gemm_simt"} & set(ran), ran
    for (lg, gg), (lc, gc) in zip(out["cuda"][0], out["cpu"][0]):
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        for a, b in zip(gg, gc):
            rel = float(torch.linalg.vector_norm(a - b)
                        / (torch.linalg.vector_norm(b) + 1e-30))
            assert rel <= 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= 1e-5


# -- int8 on the s8 wgmma engine (B1 and B3) ----------------------------------

# Ragged int8 shapes the s8 engine takes: M 65 and 520, N 72 and 2056
# (past the last 64-, 128- and 256-column tile), K 144 and 1040 (a K-tail
# stage past the 128-deep ones).
S8_SHAPES = [(65, 72, 144), (520, 2056, 1040), (65, 2056, 144),
             (520, 72, 1040)]


def _s8_geom(tile, transposed=False):
    return tgeometry.BlockGeometry(*tile, 256, 1, 1, transposed,
                                   tgeometry.SEW.E8, tgeometry.SEW.E32,
                                   "mte")


def _ints(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)


@pytest.mark.parametrize("transposed", [False, True], ids=["kn", "nk"])
@pytest.mark.parametrize("tile", WGMMA_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_s8_gemm_bit_equal_to_the_tile_loop_and_plain(card, tile,
                                                      transposed):
    """B1's int8 entry at every compiled tile, B given as (K, N) (the
    wrapper's K-major copy) and as (N, K): int32 bit-equal to the tile
    loop (pinned at its 64 x 64 tile) and to the exact plain product."""
    gen = torch.Generator().manual_seed(tile[0] + tile[1])
    before = build.launch_counts()
    for m, n, k in S8_SHAPES:
        a, b = _ints(gen, m, k), _ints(gen, k, n)
        bb = b.t().contiguous() if transposed else b
        want = tgemm.mte_gemm_torch(a, b, geom=_s8_geom((64, 64)),
                                    out_dtype=torch.int32)
        got = tgemm.mte_gemm_kernel(a.to(card), bb.to(card),
                                    geom=_s8_geom(tile, transposed),
                                    out_dtype=torch.int32)
        loop = tgemm.mte_gemm_kernel(a.to(card), bb.to(card),
                                     geom=_s8_geom((64, 64), transposed),
                                     out_dtype=torch.int32, engine="tile")
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got, loop)
    after = build.launch_counts()
    assert after["mte_gemm_wgmma_s8"] == before["mte_gemm_wgmma_s8"] + 4
    assert after["mte_gemm"] == before["mte_gemm"] + 4
    assert after["mte_gemm_wgmma"] == before["mte_gemm_wgmma"]


@pytest.mark.parametrize("tile", [(64, 64), (128, 256)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_s8_sums_past_two_to_the_24_are_exact(card, tile):
    """±127 operands at K = 4096: sums up to 127² · 4096 > 2^24 that f32
    cannot hold come out exactly (the accumulator is staged as raw int32
    words), on B1 and on B3."""
    m, n, k = 192, 320, 4096
    a = torch.full((m, k), 127, dtype=torch.int8)
    b = torch.full((k, n), -127, dtype=torch.int8)
    b[::2, 1::2] = 127
    b[:3, ::3] = 1
    b[3, ::3] = 2
    want = tgemm.mte_gemm_torch(a, b, geom=_s8_geom(tile),
                                out_dtype=torch.int32)
    assert int(want.abs().max()) > 2 ** 24
    assert not torch.equal(want.float().long(), want.long())
    got = tgemm.mte_gemm_kernel(a.to(card), b.to(card), geom=_s8_geom(tile),
                                out_dtype=torch.int32)
    assert torch.equal(got.cpu(), want)
    x, w = a[None].expand(2, m, k), torch.stack([b, -b])
    got = tgrouped.grouped_gemm_kernel(x.to(card), w.to(card),
                                       geom=_s8_geom(tile),
                                       out_dtype=torch.int32)
    assert torch.equal(got.cpu(), torch.stack([want, -want]))


@pytest.mark.parametrize("tile", [(64, 128), (128, 64), (128, 256)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("shared", [True, False], ids=["broadcast-x",
                                                        "own-x"])
def test_s8_grouped_bit_equal_to_the_tile_loop_and_plain(card, tile, shared):
    """B3's int8 entry: x broadcast (group stride 0, a 2-D map) or each
    member's own (a 3-D map), w through a 3-D map over (G, N, K), ragged
    C, N and K, with and without widths (one 0, one inside a tile, one
    past N): bit-equal to the tile loop (pinned) and to the plain
    version, the columns past each width exactly 0."""
    gen = torch.Generator().manual_seed(31 + tile[1])
    before = build.launch_counts()
    for g, c, n, k in [(3, 65, 2056, 144), (3, 520, 72, 1040)]:
        x, w = _ints(gen, 1 if shared else g, c, k), _ints(gen, g, k, n)
        if shared:
            x = x.expand(g, c, k)
        for widths in (None, [n, 0, 40]):
            kw = dict(geom=_s8_geom(tile), out_dtype=torch.int32,
                      widths=widths)
            want = tgrouped.grouped_gemm_torch(x, w, **kw)
            xc, wc = x.to(card), w.to(card)
            got = tgrouped.grouped_gemm_kernel(xc, wc, **kw)
            loop = tgrouped.grouped_gemm_kernel(
                xc, wc, engine="tile", **dict(kw, geom=_s8_geom((64, 64))))
            assert got.dtype == torch.int32
            assert torch.equal(got.cpu(), want)
            assert torch.equal(got, loop)
            for i, wd in enumerate(widths or ()):
                assert bool((got[i, :, wd:] == 0).all())
    after = build.launch_counts()
    assert after["grouped_gemm_wgmma_s8"] == \
        before["grouped_gemm_wgmma_s8"] + 4
    assert after["grouped_gemm"] == before["grouped_gemm"] + 4
    assert after["grouped_gemm_wgmma"] == before["grouped_gemm_wgmma"]


def test_s8_refuses_what_it_cannot_take(card):
    """K not a multiple of 16 with the s8 engine pinned (a wgmma-only
    tile, or ``engine="wgmma"`` on B3) raises before a launch; the C
    entries themselves refuse such a K and a K past S8_MAX_K (the int32
    sum could overflow) with an error, not a clamp or another engine."""
    gen = torch.Generator().manual_seed(41)
    before = build.launch_counts()
    a, b = _ints(gen, 128, 1032), _ints(gen, 1032, 256)
    with pytest.raises(ValueError, match="no mte GEMM engine"):
        tgemm.mte_gemm_kernel(a.to(card), b.to(card),
                              geom=_s8_geom((128, 256)),
                              out_dtype=torch.int32)
    with pytest.raises(ValueError, match="engine='wgmma'"):
        tgrouped.grouped_gemm_kernel(
            a[None].to(card), b[None].to(card), geom=_s8_geom((128, 256)),
            out_dtype=torch.int32, engine="wgmma")
    assert build.launch_counts() == before
    with pytest.raises(RuntimeError, match="wgmma s8"):
        tgemm._s8_launch(a.to(card), b.to(card), _s8_geom((128, 256)),
                         torch.int32, card)
    k = tgeometry.S8_MAX_K + 16
    a, b = _ints(gen, 64, k), _ints(gen, k, 64)
    with pytest.raises(RuntimeError, match="wgmma s8"):
        tgemm._s8_launch(a.to(card), b.to(card), _s8_geom((64, 64)),
                         torch.int32, card)
    with pytest.raises(TypeError, match="int32"):
        tgemm._s8_launch(a.to(card), b.to(card), _s8_geom((64, 64)),
                         torch.float32, card)


def test_ops_int8_runs_the_s8_engine_past_16_rows(card):
    """``ops.mte_gemm`` and ``ops.grouped_gemm`` under int8 at 128 rows
    plan onto the s8 engine and equal the CPU's plain route bit for bit
    (quantize, int32 sum and dequantize are exact on both devices); at 4
    rows the tile loops run."""
    gen = torch.Generator().manual_seed(43)
    a = torch.randn(128, 512, generator=gen)
    b = torch.randn(512, 256, generator=gen)
    x = torch.randn(4, 96, 256, generator=gen)
    w = torch.randn(4, 256, 128, generator=gen)
    before = build.launch_counts()
    got = tops.mte_gemm(a.to(card), b.to(card), format_policy="int8")
    assert torch.equal(got.cpu(), tops.mte_gemm(a, b, format_policy="int8"))
    got = tops.grouped_gemm(x.to(card), w.to(card), format_policy="int8")
    assert torch.equal(got.cpu(),
                       tops.grouped_gemm(x, w, format_policy="int8"))
    tops.mte_gemm(a[:4].to(card), b.to(card), format_policy="int8")
    after = build.launch_counts()
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert ran.pop("mte_gemm_wgmma_s8") == 1
    assert ran.pop("grouped_gemm_wgmma_s8") == 1
    assert set(ran) <= {"mte_gemm", "splitk_gemm"} and ran, ran
