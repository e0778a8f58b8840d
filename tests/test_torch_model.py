"""The port's model entry points against the JAX package's, on
gemma_2b.reduced(): the JAX side runs the eager kernel path (pallas
backend in interpret mode, no graph programs) with parameters made by JAX
and carried across by ``repro_torch.convert.params_from_jax``; the port
runs its plain versions on the CPU.  Compared: the logits of two prefill
chunks (the second reads the first's pages back through the page table),
of decode steps, and the greedy token stream."""
import numpy as np
import pytest

from torch_lazy import torch
from torch_parity import MODEL_TOL, n, run_model_pair, torch_cfg, torch_model


@pytest.mark.parametrize("fmt,kv", [("fp32", None), ("fp32", "int8pt"),
                                    ("bf16", None), ("bf16", "int8pt")])
def test_prefill_chunk_and_decode_logits_match_jax(fmt, kv):
    pairs, _, _ = run_model_pair(fmt, kv, n_decode=3)
    tol = MODEL_TOL[fmt]
    for i, (tl, jl) in enumerate(pairs):
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                                   err_msg=f"call {i}")


def test_greedy_tokens_equal_over_16_decode_steps():
    _, jtok, ttok = run_model_pair("fp32", None, n_decode=16)
    assert len(ttok) == 17
    assert ttok == jtok


@pytest.mark.parametrize("reduced", [False, True])
def test_gemma_2b_config_matches_jax(reduced):
    """Every field equal, full width and ``reduced()``, except the
    execution knob whose default the port changes on purpose (the kernel
    backend's name); ``use_graph`` defaults to True in both."""
    import dataclasses
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    j, t = jget("gemma_2b"), tget("gemma_2b")
    if reduced:
        j, t = j.reduced(), t.reduced()
    names = {f.name for f in dataclasses.fields(j)}
    assert names == {f.name for f in dataclasses.fields(t)}
    differ = {k for k in names if getattr(j, k) != getattr(t, k)}
    assert differ == {"gemm_backend"}
    assert (t.gemm_backend, t.use_graph) == ("kernels", True)
    with pytest.raises(ValueError, match="format_policy"):
        dataclasses.replace(t, format_policy="fp8")
    with pytest.raises(ValueError, match="n_kv_heads"):
        dataclasses.replace(t, n_kv_heads=3)


def test_port_refuses_unported_layer_kinds_and_configs():
    """Every assigned config resolves (``ARCH_NAMES``, all ten ported);
    what stays unported raises: a layer kind outside ``_PORTED_KINDS``
    (an SSD mixer with an MLP, which no config has).  The ``"torch"``
    GEMM backend and the int8 model-level decode cache (``cache_quant``)
    run; a GEMM backend the port does not have raises ValueError."""
    import dataclasses
    from repro_torch.configs import ARCH_NAMES, get_config
    assert sorted(get_config(name).name for name in ARCH_NAMES) == sorted(
        ARCH_NAMES)
    assert len(ARCH_NAMES) == 10
    assert ("ssd", "none") in torch_model._PORTED_KINDS
    cfg = dataclasses.replace(torch_cfg(), pattern=(("ssd", "mlp"),))
    with pytest.raises(NotImplementedError, match="not ported"):
        torch_model.init_params(cfg, device="cpu")
    tcfg = dataclasses.replace(torch_cfg(), gemm_backend="torch")
    logits, _ = torch_model.prefill_chunk(
        torch_model.init_params(tcfg, device="cpu"),
        {"tokens": torch.zeros(1, 4, dtype=torch.int64),
         "page_table": torch.ones(1, 2, dtype=torch.int32)},
        torch_model.init_paged_cache(tcfg, 1, 8, num_pages=3, page_size=4,
                                     device="cpu"), tcfg, pos0=0)
    assert logits.shape == (1, tcfg.vocab)
    assert bool(torch.isfinite(logits).all())
    cache = torch_model.init_cache(dataclasses.replace(torch_cfg(),
                                                       cache_quant=True),
                                   1, 8, device="cpu")
    assert all(layer["k"].dtype == torch.int8 and "k_scale" in layer
               for layer in cache["layers"])
    with pytest.raises(ValueError, match="gemm_backend"):
        dataclasses.replace(torch_cfg(), gemm_backend="xla")
