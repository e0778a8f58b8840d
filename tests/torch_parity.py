"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU as its own tests run it (Pallas in interpret mode), the
port runs its plain PyTorch versions on the CPU.  The port is imported
at first use (see torch_lazy).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import model as jax_model
from torch_lazy import LazyModule, torch

torch_model = LazyModule("repro_torch.models.model")

# Per-format tolerances (rtol = atol) of the port against the JAX package.
TOL = {"fp32": 1e-5, "bf16": 2e-2}
MODEL_TOL = {"fp32": 1e-4, "bf16": 2e-2, "bf16acc": 5e-2, "int8": 2e-2}


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array → CPU torch tensor (bf16 arrays via f32)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    out = torch.as_tensor(np.array(a))
    return out.to(dtype) if dtype is not None else out


def n(x) -> np.ndarray:
    """torch tensor or JAX array → float64 numpy (for comparisons)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().astype(np.float64)
    return np.asarray(x).astype(np.float32).astype(np.float64)


def jax_cfg(**kw):
    """gemma_2b.reduced() on the JAX side, eager kernel path (pallas
    backend, no graph programs)."""
    from repro.configs import get_config
    cfg = get_config("gemma_2b").reduced()
    return dataclasses.replace(cfg, gemm_backend="pallas", use_graph=False,
                               **kw)


def torch_cfg(**kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("gemma_2b").reduced(), **kw)


def jax_params(cfg, seed: int = 0):
    """JAX ``init_params`` and the port's conversion of it (CPU)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.configs import get_config
    jp = jax_model.init_params(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree.map(np.asarray, jax.device_get(jp))
    tcfg = dataclasses.replace(get_config(cfg.name).reduced(),
                               n_layers=cfg.n_layers)
    return jp, params_from_jax(tree, tcfg, device="cpu")


# -- the model harness of test_torch_model*.py --------------------------------

CHUNK, PAGE, SLOTS, CACHE_LEN = 16, 8, 2, 64
MAXP = CACHE_LEN // PAGE
NUM_PAGES = SLOTS * MAXP + 1


@functools.lru_cache(maxsize=None)
def _jitted(fmt, kv):
    cfg = jax_cfg(format_policy=fmt, kv_cache_format=kv)
    chunk = {p0: jax.jit(lambda p, b, c, _p0=p0: jax_model.prefill_chunk(
        p, b, c, cfg, pos0=_p0)) for p0 in (0, CHUNK)}
    dec = jax.jit(lambda p, b, c: jax_model.decode(p, b, c, cfg))
    return cfg, chunk, dec


def run_model_pair(fmt, kv, n_decode):
    """Two prefill chunks then ``n_decode`` greedy decode steps on slot 0
    (slot 1 idle, its table row unmapped), in both packages.  Returns the
    per-call logits pairs and both token streams."""
    jcfg, jchunk, jdec = _jitted(fmt, kv)
    tcfg = torch_cfg(format_policy=fmt, kv_cache_format=kv)
    jp, tp = jax_params(jcfg)
    jcache = jax_model.init_paged_cache(jcfg, SLOTS, CACHE_LEN,
                                        num_pages=NUM_PAGES, page_size=PAGE)
    tcache = torch_model.init_paged_cache(tcfg, SLOTS, CACHE_LEN,
                                          num_pages=NUM_PAGES,
                                          page_size=PAGE, device="cpu")
    table = np.full((SLOTS, MAXP), -1, np.int32)
    table[0] = 1 + np.arange(MAXP, dtype=np.int32)
    prompt = np.random.default_rng(7).integers(
        0, jcfg.vocab, 2 * CHUNK).astype(np.int32)
    pairs = []
    for c, p0 in enumerate((0, CHUNK)):
        toks = prompt[None, p0:p0 + CHUNK]
        jl, jcache = jchunk[p0](jp, {"tokens": jnp.asarray(toks),
                                     "page_table": jnp.asarray(table[:1])},
                                jcache)
        tl, tcache = torch_model.prefill_chunk(
            tp, {"tokens": torch.as_tensor(toks),
                 "page_table": torch.as_tensor(table[:1])}, tcache, tcfg,
            pos0=p0)
        pairs.append((tl, jl))
    jtok = [int(np.argmax(np.asarray(pairs[-1][1])[0]))]
    ttok = [int(pairs[-1][0][0].argmax())]
    for i in range(n_decode):
        pos = np.array([2 * CHUNK + i, 0], np.int32)
        jl, jcache = jdec(jp, {"tokens": jnp.asarray([[jtok[-1]], [0]],
                                                     jnp.int32),
                               "pos": jnp.asarray(pos),
                               "page_table": jnp.asarray(table)}, jcache)
        tl, tcache = torch_model.decode(
            tp, {"tokens": torch.as_tensor([[ttok[-1]], [0]]),
                 "pos": torch.as_tensor(pos), "page_table":
                     torch.as_tensor(table)}, tcache, tcfg)
        pairs.append((tl[:1], jl[:1]))
        jtok.append(int(np.argmax(np.asarray(jl)[0])))
        ttok.append(int(tl[0].argmax()))
    return pairs, jtok, ttok
