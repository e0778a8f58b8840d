"""Each CUDA kernel of the port against its plain PyTorch version, on a
Hopper card.  Imports torch and the port only (no JAX), so it runs on a
machine with the card: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_cuda.py``.  Elsewhere every test skips, naming what is
missing."""
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
