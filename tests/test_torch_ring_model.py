"""The model entry points of the port on recurrentgemma_9b.reduced()
against the JAX package's, on the CPU: ``prefill_chunk`` and ``decode``
logits in fp32 and in the served bf16, and at 8 layers, where the JAX tree
holds scanned groups plus a tail that ``params_from_jax`` unstacks.  JAX
runs its pallas backend in interpret mode (B6 and B7 included); the port
runs its plain versions."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import model as jax_model

from torch_lazy import LazyModule, torch
from torch_parity import jax_params, n, torch_model

# The port, imported at first use (see torch_lazy).
tconfigs = LazyModule("repro_torch.configs")

ARCH = "recurrentgemma_9b"
# fp32 against JAX, and the served type: bf16 operands and activations.
MODEL_TOL = {"fp32": 1e-4, "bf16": 5e-2}
_FMT = {"fp32": {}, "bf16": dict(format_policy="bf16",
                                 compute_dtype="bfloat16")}


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               gemm_backend="pallas", **kw)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), **kw)
    return jcfg, tcfg


PAGE, SLOTS, CACHE_LEN, PROMPT = 8, 2, 64, 24
MAXP = CACHE_LEN // PAGE


@functools.lru_cache(maxsize=None)
def _jitted(fmt, n_layers, chunk_len):
    jcfg, _ = _cfgs(n_layers=n_layers, **_FMT[fmt])
    chunk = {p0: jax.jit(lambda p, b, c, _p0=p0: jax_model.prefill_chunk(
        p, b, c, jcfg, pos0=_p0)) for p0 in range(0, PROMPT, chunk_len)}
    dec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, jcfg))
    return jcfg, chunk, dec


@pytest.mark.parametrize("fmt,n_layers,chunk_len", [("fp32", 6, 12),
                                                    ("bf16", 6, 24),
                                                    ("fp32", 8, 24)])
def test_model_logits_match_jax(fmt, n_layers, chunk_len):
    """A 24-token prompt, longer than the 16-slot ring, into slot 1 in one
    chunk or in two (the second resumes the first's state and wraps the
    ring), then three
    greedy decode steps with slot 0 idle (``row_valid`` False): logits of
    every call within the stated tolerance.  At 8 layers the JAX tree
    holds 2 scanned groups plus a 2-layer tail, as the full 38 = 12·3 + 2
    does."""
    jcfg, jchunk, jdec = _jitted(fmt, n_layers, chunk_len)
    _, tcfg = _cfgs(n_layers=n_layers, **_FMT[fmt])
    jp, tp = jax_params(jcfg)
    assert len(tp["layers"]) == n_layers
    assert ("groups" in jp and jp["tail"]) if n_layers == 8 else True
    kw = dict(num_pages=SLOTS * MAXP + 1, page_size=PAGE)
    jcache = jax_model.init_paged_cache(jcfg, SLOTS, CACHE_LEN, **kw)
    tcache = torch_model.init_paged_cache(tcfg, SLOTS, CACHE_LEN,
                                          device="cpu", **kw)
    table = np.full((SLOTS, MAXP), -1, np.int32)
    table[1] = 1 + np.arange(MAXP, dtype=np.int32)
    prompt = np.random.default_rng(7).integers(
        0, jcfg.vocab, PROMPT).astype(np.int32)
    tol = MODEL_TOL[fmt]
    for p0 in range(0, PROMPT, chunk_len):
        toks = prompt[None, p0:p0 + chunk_len]
        jl, jcache = jchunk[p0](jp, {"tokens": jnp.asarray(toks),
                                     "page_table": jnp.asarray(table[1:]),
                                     "slot": jnp.int32(1)}, jcache)
        tl, tcache = torch_model.prefill_chunk(
            tp, {"tokens": torch.as_tensor(toks),
                 "page_table": torch.as_tensor(table[1:]), "slot": 1},
            tcache, tcfg, pos0=p0)
        np.testing.assert_allclose(n(tl), n(jl), rtol=tol, atol=tol,
                                   err_msg=f"chunk at {p0}")
    tok = int(np.argmax(np.asarray(jl)[0]))
    for i in range(3):
        batch = dict(tokens=np.array([[0], [tok]], np.int32),
                     pos=np.array([0, PROMPT + i], np.int32), page_table=table,
                     row_valid=np.array([False, True]))
        jl, jcache = jdec(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          jcache)
        tl, tcache = torch_model.decode(
            tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tcache,
            tcfg)
        np.testing.assert_allclose(n(tl[1]), n(jl[1]), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        tok = int(np.argmax(np.asarray(jl)[1]))
    # Slot 0 never ran: its ring and RG-LRU rows are still zero.
    for layer in tcache["layers"]:
        for leaf in layer.values():
            assert torch.count_nonzero(leaf[0]) == 0
