"""Decoder-stack entry points of the port (``repro/models/model.py``).

Parameters are plain dictionaries: ``{"embedding": {"table"[, "head"]},
"layers": [per-layer dict], "final_norm": {"scale"[, "bias"]}}``
(``head``: an untied LM head, (d_model, vocab); ``bias``: on every norm
of a ``norm_type="layernorm"`` model) — JAX's ``lax.scan`` group stack
(``params["groups"]``) becomes a Python list of layers
(:func:`repro_torch.convert.params_from_jax` unstacks it).  The layer
kinds ported are ``("attn", "mlp")`` (global attention over the paged
pool), ``("local", "mlp")`` (sliding-window attention over a per-slot
ring) and ``("rglru", "mlp")`` (the RG-LRU block with its per-slot
state), each followed by an MLP (gated, or the plain GELU MLP with
biases), ``("attn", "moe")`` (global attention followed by the
capacity-dispatch MoE layer, :mod:`repro_torch.models.moe`) and
``("ssd", "none")`` (the Mamba2 SSD block with its per-slot state,
:mod:`repro_torch.models.ssm`, and no FFN: such a layer has no ``norm2``
and no ``ffn``), in any mix of them in one model; other kinds raise.
Features: RMSNorm or LayerNorm (``cfg.norm_type``), attention and final
logit softcaps, a query scale of the config's own (``attn_scale``), MHA
and GQA, QKV biases, QK-norm, untied LM heads, and
``post_norms`` (gemma2: the mixer's and the MLP's outputs normed again
before each residual add), and a stubbed frontend (``frontend_stub``:
precomputed frame embeddings in ``batch["embeddings"]`` in place of
tokens, :func:`_inputs_to_x`).

Entry points: :func:`init_params`; the model level — :func:`forward`
(the training forward; differentiable, with each layer rematerialised
under ``cfg.remat="full"``, or all but its GEMMs' outputs under
``"dots"``), :func:`loss_fn` (next-token cross
entropy), :func:`prefill` (which returns a contiguous
decode cache, :func:`init_cache`'s layout) and :func:`decode` over it;
serving — :func:`init_paged_cache`, :func:`prefill_chunk`,
:func:`decode` through a page table, :func:`sample_token`,
:func:`decode_and_sample`, and for speculative decoding
:func:`verify_chunk` and :func:`draft_from`.  A decode updates its cache
in place: the page slabs, the flat caches, the rings and the RG-LRU
and SSD state rows.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import REMATS
from repro_torch.core.formats import to_torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (check_backend, compute_dtype, embed,
                                       init_embedding, init_mlp, init_norm,
                                       mlp, norm, on_kernels, unembed)
from repro_torch.tree import leaves

__all__ = ["init_params", "forward", "loss_fn", "prefill", "init_cache",
           "init_paged_cache", "prefill_chunk", "decode", "sample_token",
           "decode_and_sample", "verify_chunk", "draft_from",
           "param_count"]

_PORTED_KINDS = (("attn", "mlp"), ("local", "mlp"), ("rglru", "mlp"),
                 ("attn", "moe"), ("ssd", "none"))
# The per-slot state rows of the recurrent mixers.
_STATE_CACHES = {"rglru": rglru_mod.init_rglru_cache,
                 "ssd": ssm_mod.init_ssd_cache}


def _check_kinds(cfg) -> None:
    for kind in cfg.layer_kinds:
        if tuple(kind) not in _PORTED_KINDS:
            raise NotImplementedError(
                f"layer kind {kind} is not ported; ported: "
                f"{_PORTED_KINDS}")


def init_params(cfg, *, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters from ``torch.Generator(seed)`` on ``device`` (the
    card unless ``device="cpu"``): the JAX package's distributions (normal
    × fan-in scale, unit norms, 0.02 embedding), not its bits."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = to_torch_dtype(cfg.param_dtype)
    layers = []
    init_mixer = {"rglru": rglru_mod.init_rglru, "ssd": ssm_mod.init_ssd}
    for mixer, ffn in cfg.layer_kinds:
        lp = {"norm1": init_norm(cfg.d_model, cfg.norm_type, dt, dev),
              "mixer": init_mixer.get(mixer, attn_mod.init_attention)(
                  gen, cfg, dev)}
        if ffn != "none":
            lp["norm2"] = init_norm(cfg.d_model, cfg.norm_type, dt, dev)
            lp["ffn"] = (moe_mod.init_moe(gen, cfg, dev) if ffn == "moe"
                         else init_mlp(gen, cfg, dev))
        if cfg.post_norms:
            lp["post_norm1"] = init_norm(cfg.d_model, cfg.norm_type, dt, dev)
            if ffn != "none":
                lp["post_norm2"] = init_norm(cfg.d_model, cfg.norm_type, dt,
                                             dev)
        layers.append(lp)
    return {"embedding": init_embedding(gen, cfg, dev), "layers": layers,
            "final_norm": init_norm(cfg.d_model, cfg.norm_type, dt, dev)}


def param_count(params) -> int:
    return sum(p.numel() for p in leaves(params))


def init_cache(cfg, batch: int, seq_len: int, *, device=None):
    """The zero decode cache of the model-level path (``model.py:582-606``
    of the JAX package), what :func:`prefill` returns: global attention
    layers a flat (batch, seq_len, Hkv, D) cache, local layers a ring of
    min(window, seq_len) slots, RG-LRU layers their ``{"h", "conv"}``
    rows, SSD layers their ``{"state", "conv"}`` rows.  Under
    ``cfg.cache_quant`` the flat caches and rings are int8 with f32
    per-(slot, head) scales (``attention.init_attn_cache``)."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    cdt = compute_dtype(cfg)

    def layer_cache(mixer):
        if mixer in _STATE_CACHES:
            return _STATE_CACHES[mixer](cfg, batch, cdt, dev)
        return attn_mod.init_attn_cache(
            cfg, batch, seq_len, cfg.window if mixer == "local" else None,
            cdt, dev)

    return {"layers": [layer_cache(mixer) for mixer, _ in cfg.layer_kinds]}


def init_paged_cache(cfg, batch: int, seq_len: int, *, num_pages: int,
                     page_size: int, device=None):
    """The serving cache of every layer, by kind (``model.py:609-647`` of
    the JAX package): global attention layers store KV in pages of a
    shared pool (page 0 reserved as the null page; ``cfg.kv_cache_format``
    selects the stored element type), local layers a (batch, L, Hkv, D)
    ring of L = min(window, seq_len) slots, RG-LRU layers their
    ``{"h", "conv"}`` rows, SSD layers their ``{"state", "conv"}`` rows
    (never paged)."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    cdt = compute_dtype(cfg)

    def layer_cache(mixer):
        if mixer == "attn":
            return attn_mod.init_paged_attn_cache(cfg, num_pages, page_size,
                                                  cdt, dev)
        if mixer == "local":
            return attn_mod.init_attn_cache(cfg, batch, seq_len, cfg.window,
                                            cdt, dev)
        return _STATE_CACHES[mixer](cfg, batch, cdt, dev)

    return {"layers": [layer_cache(mixer) for mixer, _ in cfg.layer_kinds]}


def _slot_view(cache, slot: int):
    """One slot's (1, ...) view of a batch-axis cache: writes through it
    land in the batch's rows."""
    return {name: leaf[slot:slot + 1] for name, leaf in cache.items()}


def _decode_mixer(h, p, cfg, mixer, cache, pos, row_valid):
    """A flat-cache, ring, RG-LRU or SSD mixer over h (B, K, D): one
    decode step (K = 1) or a speculative window scored as K of them."""
    if mixer == "rglru":
        return rglru_mod.rglru_decode(h, p, cfg, cache, row_valid=row_valid)
    if mixer == "ssd":
        return ssm_mod.ssd_decode(h, p, cfg, cache, row_valid=row_valid)
    return attn_mod.decode_attention(
        h, p, cfg, cache, pos, window=cfg.window if mixer == "local" else None,
        row_valid=row_valid)


def _sequence_mixer(h, p, cfg, mixer, positions, mode, cache_len):
    """A mixer over a whole sequence from position 0, in ``mode``
    ``"train"`` (→ (out, None)) or ``"prefill"`` (→ (out, the layer's
    decode cache of ``cache_len`` slots)): attention through B5 with the
    window mask on local layers, the RG-LRU and SSD blocks from a zero
    state."""
    if mixer == "rglru":
        out, state = rglru_mod.rglru_forward(h, p, cfg,
                                             train=mode == "train")
        return out, state if mode == "prefill" else None
    if mixer == "ssd":
        if mode == "train":
            return ssm_mod.ssd_forward(h, p, cfg), None
        return ssm_mod.ssd_forward(h, p, cfg, return_cache=True)
    window = cfg.window if mixer == "local" else None
    if mode == "train":
        return attn_mod.attention(h, p, cfg, positions, window=window), None
    out, (k, v) = attn_mod.attention(h, p, cfg, positions, window=window,
                                     return_kv=True)
    return out, attn_mod.prefill_cache(k, v, cfg, cache_len or h.shape[1],
                                       window, compute_dtype(cfg))


def _apply_layer(x, lp, cfg, kinds, positions, mode, cache, *, pos=None,
                 page_table=None, chunk_pos0=None, slot=0, row_valid=None,
                 cache_len=None):
    """One layer in ``mode`` ``"train"`` or ``"prefill"`` (the whole
    sequence, :func:`_sequence_mixer`), ``"prefill_chunk"``, ``"decode"``
    or ``"verify"`` (a (B, K, D) speculative window from per-row
    positions ``pos``, ``model.py:163-197`` of the JAX package): paged
    global layers score the whole window in one pass
    (:func:`~repro_torch.models.attention.verify_paged_attention`), flat,
    ring and RG-LRU mixers take the window as they take a decode step
    (only the attention, the conv and the recurrence step per position),
    and every projection and the FFN run once over the B·K rows on the
    decode step's plans (``plan_rows`` = B), so each row keeps the decode
    step's bits.  An ffn ``"none"`` layer (SSD) ends after the mixer's
    residual add (``model.py:267-276`` of the JAX package).  With
    ``cfg.post_norms`` the mixer's and the MLP's outputs are normed (``post_norm1``, ``post_norm2``) before their
    residual adds (``model.py:264-275`` of the JAX package).  A moe FFN
    runs :func:`repro_torch.models.moe.dispatch` over the call's B·S
    tokens in every mode (a verify window's B·K too, on the capacity of
    that many tokens, as in JAX).  → (x, cache, the MoE aux loss, or
    None for an MLP layer)."""
    mixer, ffn = kinds
    kind = cfg.norm_type
    h = norm(x, lp["norm1"], kind)
    plan_rows = x.shape[0] if mode == "verify" else None
    paged = cache is not None and "k_pages" in cache
    if mode in ("train", "prefill"):
        out, cache = _sequence_mixer(h, lp["mixer"], cfg, mixer, positions,
                                     mode, cache_len)
    elif mode == "prefill_chunk":
        if mixer == "attn":
            out, cache = attn_mod.paged_prefill_attention(
                h, lp["mixer"], cfg, cache, positions, page_table,
                kv_len=chunk_pos0 + h.shape[1])
        elif mixer == "local":
            out, _ = attn_mod.ring_chunk_attention(
                h, lp["mixer"], cfg, _slot_view(cache, slot), positions,
                pos0=chunk_pos0, window=cfg.window)
        else:
            # Chunk 0 starts fresh (the slot row holds its previous
            # occupant's state); later chunks resume the carried state.
            one = _slot_view(cache, slot) if chunk_pos0 else None
            if mixer == "ssd":
                out, one = ssm_mod.ssd_forward(h, lp["mixer"], cfg,
                                               return_cache=True, cache=one)
            else:
                out, one = rglru_mod.rglru_forward(h, lp["mixer"], cfg,
                                                   cache=one)
            for name, leaf in one.items():
                cache[name][slot] = leaf[0].to(cache[name].dtype)
    elif paged and mode == "verify":
        out, cache = attn_mod.verify_paged_attention(
            h, lp["mixer"], cfg, cache, pos, page_table)
    elif paged:
        # Inactive rows write into the null page through their all-(−1)
        # page-table row, so ``row_valid`` has nothing to guard here.
        out, cache = attn_mod.paged_decode_attention(
            h, lp["mixer"], cfg, cache, pos, page_table)
    else:
        out, cache = _decode_mixer(h, lp["mixer"], cfg, mixer, cache, pos,
                                   row_valid)
    if cfg.post_norms:
        out = norm(out, lp["post_norm1"], kind)
    x = x + out
    aux = None
    if ffn == "none":
        return x, cache, aux
    h = norm(x, lp["norm2"], kind)
    if ffn == "moe":
        out, aux = moe_mod.dispatch(h, lp["ffn"], cfg)
    else:
        out = mlp(h, lp["ffn"], cfg, plan_rows=plan_rows)
    if cfg.post_norms:
        out = norm(out, lp["post_norm2"], kind)
    return x + out, cache, aux


def _remat(cfg) -> Optional[str]:
    """How a differentiated ``"train"`` layer is rematerialised
    (``model.py:299-305`` of the JAX package), or None: ``cfg.remat=
    "full"`` keeps only each layer's input and recomputes the layer in
    the backward (``torch.utils.checkpoint``, non-reentrant); ``"dots"``
    keeps the GEMMs' outputs too and recomputes the rest
    (:func:`_checkpoint`); ``"none"`` keeps every activation."""
    if cfg.remat not in REMATS:
        raise ValueError(f"unknown remat {cfg.remat!r}; the port's are "
                         f"{REMATS}")
    return None if cfg.remat == "none" else cfg.remat


@functools.lru_cache(maxsize=None)
def _products():
    """The library's matrix products, the operators ``remat="dots"``
    keeps on the ``"torch"`` backend (JAX's ``checkpoint_dots`` keeps
    every ``dot_general``): the projections' ``torch.mm``/``torch.bmm``
    (with ``out_dtype`` on the card), ``torch._int_mm``, and the plain
    attention's einsums, which run as ``bmm``."""
    aten = torch.ops.aten
    return {getattr(op, name) for op in (aten.mm, aten.bmm)
            for name in ("default", "dtype") if hasattr(op, name)} | {
        aten.addmm.default, aten._int_mm.default}


def _keep_products(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _products()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint(remat: str, cfg, fn, *args, **kw):
    """``fn(*args, **kw)`` under ``torch.utils.checkpoint`` as
    ``remat`` says.  ``"dots"`` on the ``"torch"`` backend: a
    selective-checkpoint policy that must save every matrix product
    (:func:`_products`).  ``"dots"`` on the kernel backend, whose GEMMs
    launch inside autograd Functions that such a policy does not see: a
    :class:`~repro_torch.kernels.autodiff.GemmStash` of this call keeps
    each GEMM Function's output and hands it back in the recompute
    without a launch; B5 and everything else is recomputed."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    if not on_kernels(cfg):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda:
                          create_selective_checkpoint_contexts(
                              _keep_products), **kw)
    from repro_torch.kernels.autodiff import GemmStash
    stash = GemmStash()

    def run(*a, **k):
        with stash.active():
            return fn(*a, **k)

    return checkpoint(run, *args, use_reentrant=False, **kw)


def _run_stack(x, params, cfg, positions, mode, cache, **kw):
    """Every layer in turn → (x, cache, the layers' MoE aux losses
    summed, a 0-d f32 tensor); a given cache's layer entries are
    replaced in place, and with ``cache`` None (``"train"``,
    ``"prefill"``) a new one collects what the layers return.  A
    ``"train"`` stack under autograd rematerialises each layer as
    ``cfg.remat`` says (:func:`_remat`): the recompute runs the same
    plans and draws no random numbers, so it gives the forward's bits,
    and ``"dots"`` gives ``"full"``'s."""
    check_backend(cfg)
    _check_kinds(cfg)
    out = cache if cache is not None else {
        "layers": [None] * len(params["layers"])}
    remat = (_remat(cfg) if mode == "train" and torch.is_grad_enabled()
             else None)
    aux_total = torch.zeros((), device=x.device)
    for i, (lp, kinds) in enumerate(zip(params["layers"], cfg.layer_kinds)):
        layer_cache = None if cache is None else cache["layers"][i]
        if remat:
            x, out["layers"][i], aux = _checkpoint(
                remat, cfg, _apply_layer, x, lp, cfg, kinds, positions, mode,
                layer_cache, **kw)
        else:
            x, out["layers"][i], aux = _apply_layer(
                x, lp, cfg, kinds, positions, mode, layer_cache, **kw)
        if aux is not None:
            aux_total = aux_total + aux
    return x, out, aux_total


def _inputs_to_x(batch, params, cfg):
    """The stack's input (B, S, d_model) in the compute dtype
    (``model.py:376-387`` of the JAX package): under ``cfg.frontend_stub``
    the precomputed frame embeddings ``batch["embeddings"]``, cast and,
    with ``embed_scale``, multiplied by √d_model rounded to the compute
    dtype; else the embedded ``batch["tokens"]``."""
    if not cfg.frontend_stub:
        return embed(batch["tokens"], params["embedding"], cfg)
    x = batch["embeddings"].to(compute_dtype(cfg))
    if cfg.embed_scale:
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def _sequence_positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device)[None].expand(b, s)


def forward(params, batch, cfg):
    """The training forward (``model.py:390-401`` of the JAX package) over
    ``batch["tokens"]`` (B, S), or ``batch["embeddings"]`` (B, S, d_model)
    under ``cfg.frontend_stub``: → (logits f32 (B, S, V), the MoE layers'
    aux losses summed, 0 for a model without one)."""
    x = _inputs_to_x(batch, params, cfg)
    x, _, aux = _run_stack(x, params, cfg, _sequence_positions(x), "train",
                           None)
    x = norm(x, params["final_norm"], cfg.norm_type)
    return unembed(x, params["embedding"], cfg), aux


class _TokenNll(torch.autograd.Function):
    """Per-position ``logsumexp(logits) − logits[target]`` over f32 logits
    (B, S, V).  JAX picks the target logit by a mask-and-sum over a
    (B, S, V) one-hot (``model.py:667-674`` there); this gathers it, and
    the backward forms softmax − one-hot in one (B, S, V) buffer, so the
    loss holds no tensor of the logits' size beyond the logits and their
    gradient."""

    @staticmethod
    def forward(ctx, logits, targets):
        lse = torch.logsumexp(logits, dim=-1)
        ctx.save_for_backward(logits, lse, targets)
        return lse - logits.gather(-1, targets[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        logits, lse, targets = ctx.saved_tensors
        grad = logits.sub(lse[..., None]).exp_()
        grad.scatter_add_(-1, targets[..., None],
                          torch.full_like(lse[..., None], -1.0))
        return grad.mul_(g[..., None]), None


def loss_fn(params, batch, cfg):
    """Next-token cross entropy (``model.py:650-678`` of the JAX
    package): → (loss, metrics ``{"loss", "ce", "aux", "tokens"}``, each
    a 0-d f32 tensor).  Position i predicts token i + 1, the last
    position of each row is masked out; under ``cfg.frontend_stub`` the
    targets are ``batch["targets"]`` (B, S), every position counted.
    ``loss`` = ``ce`` + ``aux``, the MoE layers' summed aux loss
    (:func:`forward`)."""
    logits, aux = forward(params, batch, cfg)
    if cfg.frontend_stub:
        targets = torch.as_tensor(batch["targets"],
                                  device=logits.device).long()
        valid = torch.ones(targets.shape, device=logits.device)
    else:
        tokens = batch["tokens"].long()
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                            dim=1)
        valid = torch.ones(tokens.shape, device=logits.device)
        valid[:, -1] = 0.0
    nll = _TokenNll.apply(logits.float(), targets)
    denom = torch.clamp(valid.sum(), min=1.0)
    ce = (nll * valid).sum() / denom
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": denom}


def prefill(params, batch, cfg, cache_len: Optional[int] = None):
    """The forward that also builds the decode cache (``model.py:404-416``
    of the JAX package): → (last-position logits f32 (B, V), cache in
    :func:`init_cache`'s layout with ``cache_len`` slots, the prompt's
    length by default — pass the capacity decode steps need)."""
    x = _inputs_to_x(batch, params, cfg)
    x, cache, _ = _run_stack(x, params, cfg, _sequence_positions(x),
                             "prefill", None, cache_len=cache_len)
    x = norm(x[:, -1:], params["final_norm"], cfg.norm_type)
    return unembed(x, params["embedding"], cfg)[:, 0], cache


def prefill_chunk(params, batch, cache, cfg, *, pos0: int):
    """One prompt chunk into the serving cache: ``batch["tokens"]`` (1, C)
    at positions [pos0, pos0+C), ``batch["page_table"]`` (1, max_pages),
    ``batch["slot"]`` (int, default 0) the batch row whose ring, RG-LRU
    or SSD state the chunk advances.  Returns (last-position logits
    (1, V) f32, cache)."""
    tokens = batch["tokens"]
    x = embed(tokens, params["embedding"], cfg)
    positions = pos0 + torch.arange(tokens.shape[1], device=x.device)[None]
    x, cache, _ = _run_stack(x, params, cfg, positions, "prefill_chunk",
                             cache, page_table=batch["page_table"],
                             chunk_pos0=pos0,
                             slot=int(batch.get("slot", 0)))
    x = norm(x, params["final_norm"], cfg.norm_type)
    return unembed(x[:, -1:], params["embedding"], cfg)[:, 0], cache


def decode(params, batch, cache, cfg):
    """One-token decode over the serving cache or the model-level one:
    ``batch["tokens"]`` (B, 1) (or ``batch["embeddings"]`` (B, 1,
    d_model) under ``cfg.frontend_stub``), ``batch["pos"]`` a scalar or
    (B,) per-slot positions, ``batch["page_table"]`` (B, max_pages) for
    a paged cache (none for :func:`init_cache`'s) and optionally
    ``batch["row_valid"]`` (B,) bool: the rows whose flat-cache, ring,
    RG-LRU and SSD state the step may change (JAX's ``_mask_rows``
    contract; the others — slots still prefilling — keep theirs).  Returns (logits
    (B, V) f32, cache)."""
    x = _inputs_to_x(batch, params, cfg)
    b = x.shape[0]
    pos = torch.as_tensor(batch["pos"], device=x.device).reshape(-1)
    positions = pos.to(torch.int64).expand(b).reshape(b, 1)
    row_valid = batch.get("row_valid")
    if row_valid is not None:
        row_valid = torch.as_tensor(row_valid, dtype=torch.bool,
                                    device=x.device).reshape(-1)
    x, cache, _ = _run_stack(x, params, cfg, positions, "decode", cache,
                             pos=positions[:, 0],
                             page_table=batch.get("page_table"),
                             row_valid=row_valid)
    x = norm(x, params["final_norm"], cfg.norm_type)
    return unembed(x, params["embedding"], cfg)[:, 0], cache


def sample_token(logits, generator: Optional[torch.Generator], temperature,
                 *, sampled: bool):
    """One token per row: rows with temperature <= 0 take the f32 argmax
    (lowest index on ties, as XLA and numpy); rows above 0 draw from the
    tempered softmax with ``generator`` (torch's stream, not JAX's — only
    greedy rows are comparable across the two packages).  ``sampled`` is
    the caller's host-side knowledge of whether any row's temperature is
    above 0 (JAX splits its key only then): with False no draw is made
    and the generator is untouched, and the device is never asked.  The
    draw is the exponential race argmax(p / E), E ~ Exp(1) per entry —
    what ``torch.multinomial`` computes for one sample, without its
    host-side checks, which a CUDA graph cannot hold.  → (tokens (B,)
    int32, finite (B,) bool)."""
    lf = logits.float()
    temps = torch.as_tensor(temperature, dtype=torch.float32,
                            device=lf.device).reshape(-1).expand(lf.shape[0])
    tokens = lf.argmax(dim=-1).to(torch.int32)
    if sampled:
        hot = temps > 0
        safe = torch.where(hot, temps, torch.ones_like(temps))
        probs = torch.softmax(lf / safe[:, None], dim=-1)
        race = torch.empty_like(probs).exponential_(generator=generator)
        drawn = (probs / race).argmax(dim=-1).to(torch.int32)
        tokens = torch.where(hot, drawn, tokens)
    return tokens, torch.isfinite(lf).all(dim=-1)


def decode_and_sample(params, batch, cache, cfg, *, generator,
                      temperatures, active_rows, sampled: bool):
    """Decode + sample in one call: → (tokens (B,), finite (B,),
    logits f32 (B, V), next_tokens (B, 1), cache).  ``batch["tokens"]``
    (B, 1) int32 is the carried last-token buffer: the sampled token of
    every row in ``active_rows`` is written into it in place (inactive
    rows keep theirs), so a CUDA graph replay of this call chains the
    token on the device; ``next_tokens`` is that buffer.  ``sampled``:
    see :func:`sample_token`."""
    logits, cache = decode(params, batch, cache, cfg)
    tokens, finite = sample_token(logits, generator, temperatures,
                                  sampled=sampled)
    active = torch.as_tensor(active_rows, dtype=torch.bool,
                             device=logits.device).reshape(-1)
    carried = batch["tokens"]
    carried.copy_(torch.where(active[:, None], tokens[:, None], carried))
    return tokens, finite, logits, carried, cache


def verify_chunk(params, batch, cache, cfg, *, last_only: bool = False):
    """Speculative verification (``model.py:523-556`` of the JAX
    package): → (logits f32 (B, K, V), cache).

    ``batch["tokens"]`` (B, K): per row the last emitted token and K − 1
    draft proposals; ``batch["pos"]`` (B,): each row's window start, the
    position of that emitted token; ``batch["page_table"]`` and
    ``batch["row_valid"]`` as in :func:`decode`.  Logits row i is the
    target's distribution for position pos + i + 1 and judges proposal
    i + 1.

    Row i equals, bit for bit, the logits of a decode step at pos + i
    (see :func:`_apply_layer`), for any B·K: the GEMMs run their rows in
    chunks on the decode step's plans (``ops`` module docstring).  The LM
    head runs one product per window
    position over the B rows a decode step unembeds: the library's f32
    product picks other kernels, and so gives other bits, for B·K rows
    than for B (measured on the H100).  ``last_only`` unembeds the last
    position alone, → (B, 1, V): what the draft's catch-up reads.  The
    cache is updated in place; the engine restores the ring and RG-LRU
    rows of a rejected suffix, and paged KV past the accepted point is
    garbage the next window overwrites."""
    tokens = batch["tokens"]
    b, k = tokens.shape
    x = embed(tokens, params["embedding"], cfg)
    pos = torch.as_tensor(batch["pos"], device=x.device).reshape(-1)
    pos = pos.to(torch.int64).expand(b)
    positions = pos[:, None] + torch.arange(k, device=x.device)[None]
    row_valid = batch.get("row_valid")
    if row_valid is not None:
        row_valid = torch.as_tensor(row_valid, dtype=torch.bool,
                                    device=x.device).reshape(-1)
    x, cache, _ = _run_stack(x, params, cfg, positions, "verify", cache,
                             pos=pos, page_table=batch["page_table"],
                             row_valid=row_valid)
    x = norm(x, params["final_norm"], cfg.norm_type)
    logits = [unembed(x[:, i:i + 1].contiguous(), params["embedding"], cfg)
              for i in range(k - 1 if last_only else 0, k)]
    return torch.cat(logits, dim=1), cache


def draft_from(params, cfg, *, groups: int = 1):
    """Weight-shared draft parameters (``model.py:559-579`` of the JAX
    package): the target's first ``groups * cfg.period`` layers with its
    embedding and final norm.  The port's layers are a flat list, so the
    draft holds the same layer dictionaries and tensors, not copies: it
    costs no weight memory.  Pairs with ``cfg.draft(groups)``."""
    n_groups = cfg.n_layers // cfg.period if cfg.scan_layers else 0
    if not n_groups:
        raise ValueError("draft_from needs a scanned group stack "
                         "(cfg.scan_layers with n_layers >= period)")
    if not 0 < groups <= n_groups:
        raise ValueError(f"groups must be in [1, {n_groups}], got {groups}")
    return {"embedding": params["embedding"],
            "layers": params["layers"][:groups * cfg.period],
            "final_norm": params["final_norm"]}
