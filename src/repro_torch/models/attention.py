"""MQA/GQA attention over the paged KV pool, over sliding-window ring
caches and over flat decode caches (the port of
``repro/models/attention.py``).

Projections run through the kernel GEMMs: with ``cfg.use_graph`` (the
default) the q/k/v projections are ONE compiled :mod:`repro_torch.graph`
program (:func:`_qkv_compiled`), and the decode step's q/k/v, under
``cfg.decode_qkv_grouped``, ONE grouped GEMM (B3) over the prestacked
(3, D, Nmax) weight (:func:`_project_qkv_grouped`).  Prefill-chunk
attention runs through B5 (``flash_attention``), decode attention
through B4 (``flash_decode_paged``), and a speculative verify window
through B4 once per window position (:func:`verify_paged_attention`).
Sliding-window (``local``) layers keep a per-slot ring of L =
min(window, cache_len) slots: a decode step reads it through B6
(``flash_decode``), a prefill chunk attends to it with
:func:`_xla_attention`, the plain mirror of JAX's non-Pallas path
(JAX's ring chunk does not reach a Pallas kernel either).  The
model-level path (``model.forward``/``prefill``/``decode``) runs the
whole sequence through B5 (:func:`attention`, with the window mask on
local layers), builds its decode cache from the K/V it computed
(:func:`prefill_cache`: a flat (B, cache_len, Hkv, D) cache for global
layers, a ring for local ones) and decodes over it through B6
(:func:`decode_attention`); under ``cfg.cache_quant`` that cache is
int8 with per-(slot, head) scales, quantized as it is written and
dequantized whole before each read, as in JAX.  The KV scatter
into pages and rings, the prefix-page gather and the dequantize outside
the kernels stay plain PyTorch, as they are plain jnp in JAX.

On the ``"torch"`` backend (JAX's ``"xla"``) no kernel runs: every
attention above is the plain :func:`_xla_attention` over the same
positions (paged reads over the gathered table pages), which scans kv
chunks of ``cfg.attn_chunk`` past 2048 kv positions on both backends, as
JAX's does.

Unlike JAX, the port updates the page slabs and rings **in place**
(``index_put_``) instead of returning fresh arrays: a decode step then
allocates no new cache and writes only the new token's KV.  A ring row
whose ``row_valid`` is False is left untouched (JAX writes every row and
merges the old rows back).  The functions still return the cache, so
call sites read as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.formats import resolve_format, to_torch_dtype
from repro_torch.models.layers import (compute_dtype, dense, init_dense,
                                       init_norm, model_format, on_kernels,
                                       rmsnorm, rope, use_graph)

__all__ = ["init_attention", "attention", "prefill_cache",
           "init_attn_cache", "decode_attention",
           "ring_chunk_attention", "init_paged_attn_cache",
           "paged_decode_attention", "paged_prefill_attention",
           "verify_paged_attention", "grouped_decode"]


def init_attention(gen: torch.Generator, cfg, device=None):
    d, hd = cfg.d_model, cfg.hd
    dt = to_torch_dtype(cfg.param_dtype)
    p = {
        "q": init_dense(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias,
                        dtype=dt, device=device),
        "k": init_dense(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        dtype=dt, device=device),
        "v": init_dense(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        dtype=dt, device=device),
        "o": init_dense(gen, cfg.n_heads * hd, d, dtype=dt,
                        scale=(cfg.n_heads * hd) ** -0.5, device=device),
    }
    if cfg.qk_norm:
        # Per-head RMSNorm scales over head_dim, applied to q and k
        # before rope (``_finish_qkv``).
        p["q_norm"] = init_norm(hd, "rmsnorm", dt, device)
        p["k_norm"] = init_norm(hd, "rmsnorm", dt, device)
    return p


def _finish_qkv(q, k, v, p, cfg, positions):
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta), v


def _project_qkv(x, p, cfg, positions, plan_rows=None):
    b, s, _ = x.shape
    hd = cfg.hd
    if use_graph(cfg):
        q2, k2, v2 = _qkv_compiled(x.reshape(b * s, -1), p, cfg, plan_rows)
        q = q2.reshape(b, s, cfg.n_heads, hd)
        k = k2.reshape(b, s, cfg.n_kv_heads, hd)
        v = v2.reshape(b, s, cfg.n_kv_heads, hd)
    else:
        q = dense(x, p["q"], cfg, plan_rows=plan_rows).reshape(
            b, s, cfg.n_heads, hd)
        k = dense(x, p["k"], cfg, plan_rows=plan_rows).reshape(
            b, s, cfg.n_kv_heads, hd)
        v = dense(x, p["v"], cfg, plan_rows=plan_rows).reshape(
            b, s, cfg.n_kv_heads, hd)
    return _finish_qkv(q, k, v, p, cfg, positions)


def _qkv_compiled(x2, p, cfg, plan_rows=None):
    """The q/k/v projections as ONE compiled :mod:`repro_torch.graph`
    program (``attention.py:69-115`` of the JAX package).

    Three GemmNodes sharing the input: the sibling-grouping rewrite turns
    them into one GroupNode (one B3 launch) when the scheduler's program
    score favours it — it prices the k/v zero-padding and the per-call
    weight restacking, so grouping is a modelled choice.  Each node
    carries the epilogue ``dense`` would fuse (the QKV bias).
    ``plan_rows``: the program of that many rows (``layers.dense``)."""
    from repro_torch.graph import schedule as graph_schedule
    from repro_torch.graph.trace import GraphBuilder

    cdt = compute_dtype(cfg)
    fmt = model_format(cfg)
    m, d = x2.shape
    m = m if plan_rows is None else plan_rows

    def build():
        b = GraphBuilder()
        xv = b.input((m, d), x2.dtype, "x")
        outs = []
        for name in ("q", "k", "v"):
            wv = b.input(p[name]["w"].shape, p[name]["w"].dtype,
                         f"w_{name}")
            bv = (b.input((p[name]["w"].shape[1],), "float32",
                          f"b_{name}") if cfg.qkv_bias else None)
            outs.append(b.gemm(
                xv, wv, bias=bv,
                epilogue=Epilogue(has_bias=cfg.qkv_bias),
                fmt=fmt.name, out_dtype=cdt, policy=cfg.gemm_policy,
                name=name))
        b.output(*outs)
        return b.build()

    key = ("qkv", m, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, fmt.name,
           str(cdt), cfg.gemm_policy, cfg.qkv_bias, str(x2.dtype),
           str(p["q"]["w"].dtype))
    prog = graph_schedule.compile_cached(key, build)
    args = [x2]
    for name in ("q", "k", "v"):
        args.append(p[name]["w"])
        if cfg.qkv_bias:
            args.append(p[name]["b"].float())
    return prog(*args)


def _project_qkv_grouped(x, p, cfg, positions, plan_rows=None):
    """Decode q/k/v as ONE GroupNode program (G=3) through the plan cache
    (``attention.py:118-177`` of the JAX package).

    A decode step's three projection GEMVs share M = B and K = d_model
    and differ only in N; the GroupNode batches them as one B3 launch, so
    the plan cache sees one grouped signature per step instead of three.
    k/v columns are zero-padded up to q's width (the kernel skips the
    tiles wholly in that padding) and sliced back off.  The stacked
    (3, D, Nmax) weight is pure layout (:func:`repro_torch.graph.
    stack_group_weights`): the serving engine precomputes it once per
    layer (``p["qkv"]``); the inline stack here serves direct
    ``model.decode`` calls.  ``plan_rows``: the program of that many rows
    (``layers.dense``)."""
    from repro_torch.graph import schedule as graph_schedule
    from repro_torch.graph import stack_group_weights
    from repro_torch.graph.trace import GraphBuilder
    b, s, dm = x.shape
    hd = cfg.hd
    nq = cfg.n_heads * hd
    nkv = cfg.n_kv_heads * hd

    wstack = p.get("qkv")
    if wstack is None:
        wstack = stack_group_weights([p["q"]["w"], p["k"]["w"],
                                      p["v"]["w"]])       # (3, D, Nmax)
    x2 = x.reshape(b * s, dm)
    m = b * s if plan_rows is None else plan_rows
    cdt = compute_dtype(cfg)
    fmt = model_format(cfg)

    def build():
        bld = GraphBuilder()
        xv = bld.input((m, dm), x2.dtype, "x")
        wv = bld.input(wstack.shape, wstack.dtype, "qkv")
        outs = bld.group(xv, stacked=wv, widths=(nq, nkv, nkv),
                         fmt=fmt.name, out_dtype=cdt,
                         policy=cfg.gemm_policy)
        bld.output(*outs)
        return bld.build()

    key = ("qkv_decode", m, dm, nq, nkv, fmt.name, str(cdt),
           cfg.gemm_policy, str(x2.dtype), str(wstack.dtype))
    prog = graph_schedule.compile_cached(key, build)
    q, k, v = prog(x2, wstack)
    if cfg.qkv_bias:
        q = q + p["q"]["b"].to(q.dtype)
        k = k + p["k"]["b"].to(k.dtype)
        v = v + p["v"]["b"].to(v.dtype)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    return _finish_qkv(q, k, v, p, cfg, positions)


def grouped_decode(cfg) -> bool:
    """True when the decode step projects q/k/v as one grouped GEMM:
    ``cfg.decode_qkv_grouped`` on the graph path (use_graph=False keeps
    eager per-GEMM dispatch, as in JAX) under the MTE policy.  Unlike
    JAX, whose GroupNode launches the grouped kernel whatever
    ``gemm_policy`` says, the rigid ``"amx"`` baseline keeps its three
    rigid GEMMs: a rigid ISA has no grouped launch, and the grouping
    rewrite itself never groups rigid GEMMs (``fuse._groupable``)."""
    return (bool(getattr(cfg, "decode_qkv_grouped", False))
            and use_graph(cfg) and cfg.gemm_policy == "mte")


def _project_qkv_decode(x, p, cfg, positions, plan_rows=None):
    if grouped_decode(cfg):
        return _project_qkv_grouped(x, p, cfg, positions, plan_rows)
    return _project_qkv(x, p, cfg, positions, plan_rows)


def _quantize_kv(x: torch.Tensor, per_channel: bool = True):
    """Symmetric int8 KV quantization.  x: (..., kv, hd).  Per channel:
    one scale per (token, head); per tensor (int8pt): one per token over
    (kv, hd), broadcast to the (..., kv, 1) layout."""
    xf = x.float()
    dims = (-1,) if per_channel else (-2, -1)
    amax = xf.abs().amax(dim=dims, keepdim=True)
    # A true division on every device, as ``formats.quantize``.
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    scale = scale.expand(*x.shape[:-1], 1)
    return q.to(torch.int8), scale.float()


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _kv_storage_format(cfg):
    name = getattr(cfg, "kv_cache_format", None)
    return resolve_format(name) if name is not None else None


def _scale(cfg) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else cfg.hd ** -0.5


_NEG_INF = -1e30
# Above this many kv positions the plain attention scans kv chunks
# (``attention.py:190-191`` of the JAX package).
_CHUNK_THRESHOLD = 2048
_KV_CHUNK = 1024


def _grouped_logits(qg, k, scale, softcap):
    """f32 logits (B, Hkv, G, Sq, Skv) of qg (B, Hkv, G, Sq, D) against k
    (B, Hkv, Skv, D), KV heads never repeated, softcapped."""
    logits = torch.einsum("bngqd,bnkd->bngqk", qg.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def _mask(qp, kp, causal, window):
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    return m


def _xla_attention(q, k, v, *, causal, window, softcap, scale,
                   kv_positions=None, q_positions=None,
                   chunk: int = _KV_CHUNK):
    """Plain attention in the BHSD layout with the flash kernels' mask
    semantics (``kvpos ≥ 0``, causal, window) over (B, Skv) kv and
    (B, Sq) query positions — by default queries right-aligned to the
    keys: the mirror of ``_xla_attention`` (``attention.py:215-253`` of
    the JAX package).  GQA runs as a grouped einsum, KV heads never
    repeated.  Above ``_CHUNK_THRESHOLD`` kv positions it scans kv chunks
    of ``chunk`` with an online softmax (:func:`_chunked_attention`), as
    JAX does; below, the probabilities are cast to v's dtype before the
    value product, as JAX's unchunked path does."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    skv = k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, sq, hd)
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device) + (skv - sq)
    if kv_positions is None:
        kv_positions = torch.arange(skv, device=q.device)
    q_positions = torch.atleast_2d(q_positions).expand(b, sq)
    kv_positions = torch.atleast_2d(kv_positions).expand(b, skv)
    if skv > _CHUNK_THRESHOLD:
        out = _chunked_attention(qg, k, v, q_positions, kv_positions,
                                 causal=causal, window=window,
                                 softcap=softcap, scale=scale, chunk=chunk)
        return out.reshape(b, h, sq, hd)
    logits = _grouped_logits(qg, k, scale, softcap)
    mask = _mask(q_positions[:, :, None], kv_positions[:, None, :], causal,
                 window)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), _NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bngqk,bnkd->bngqd", probs, v)
    return out.reshape(b, h, sq, hd)


def _chunked_attention(qg, k, v, q_positions, kv_positions, *, causal,
                       window, softcap, scale, chunk: int = _KV_CHUNK):
    """The online-softmax scan over kv chunks (``attention.py:256-300``
    of the JAX package): qg (B, Hkv, G, Sq, D), k/v (B, Hkv, Skv, D),
    the kv axis padded to whole chunks with masked (−1) positions.  Each
    chunk's running max, sum and f32 accumulator update is JAX's; under
    autograd each chunk runs under ``torch.utils.checkpoint``, as JAX
    wraps its scan body in ``jax.checkpoint``: the backward recomputes
    the (…, Sq, chunk) logits instead of keeping them."""
    b, hkv, g, sq, hd = qg.shape
    skv = k.shape[2]
    nc = -(-skv // chunk)
    pad = nc * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-1)
    qp = q_positions[:, :, None]
    neg = torch.full((), _NEG_INF, device=qg.device)

    def body(m_prev, l_prev, acc, k_blk, v_blk, kp_blk):
        logits = _grouped_logits(qg, k_blk, scale, softcap)
        emask = _mask(qp, kp_blk[:, None, :], causal, window)[:, None, None]
        logits = torch.where(emask, logits, neg)
        m_new = torch.maximum(m_prev, logits.amax(dim=-1, keepdim=True))
        p = torch.where(emask, torch.exp(logits - m_new),
                        torch.zeros((), device=qg.device))
        alpha = torch.exp(m_prev - m_new)
        l_new = alpha * l_prev + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bngqk,bnkd->bngqd", p,
                                         v_blk.float())
        return m_new, l_new, acc

    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (qg, k, v))
    m = torch.full((b, hkv, g, sq, 1), _NEG_INF, device=qg.device)
    l = torch.zeros((b, hkv, g, sq, 1), device=qg.device)
    acc = torch.zeros((b, hkv, g, sq, hd), device=qg.device)
    for c in range(nc):
        blk = (k[:, :, c * chunk:(c + 1) * chunk],
               v[:, :, c * chunk:(c + 1) * chunk],
               kv_positions[:, c * chunk:(c + 1) * chunk])
        if grad:
            m, l, acc = torch.utils.checkpoint.checkpoint(
                body, m, l, acc, *blk, use_reentrant=False)
        else:
            m, l, acc = body(m, l, acc, *blk)
    l = torch.where(l == 0.0, torch.ones((), device=qg.device), l)
    return (acc / l).to(qg.dtype)


def _chunk(cfg) -> int:
    return getattr(cfg, "attn_chunk", _KV_CHUNK)


def _full_attention(cfg, q, k, v, *, window: Optional[int]):
    """Causal attention of q (B, H, Sq, D) over k/v (B, Hkv, Skv, D),
    queries right-aligned to the keys: B5 (``ops.flash_attention``) on
    the kernel backend, the plain attention (:func:`_xla_attention`, kv
    chunks of ``cfg.attn_chunk``) on ``"torch"``, as JAX's two branches
    (``attention.py:310-323`` there)."""
    if not on_kernels(cfg):
        return _xla_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, scale=_scale(cfg),
                              chunk=_chunk(cfg))
    from repro_torch.kernels import ops
    return ops.flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_softcap, scale=_scale(cfg))


def attention(x, p, cfg, positions, *, window: Optional[int] = None,
              return_kv: bool = False):
    """Full-sequence causal attention, the training forward's and the
    prefill's (``attention.py:304-327`` of the JAX package): x (B, S, D)
    at positions 0..S−1, q/k/v projected over the B·S rows, the
    attention over the whole sequence with the window mask on local
    layers (:func:`_full_attention`: B5, or the plain attention on
    ``"torch"``), then ``o``.  With ``return_kv`` → (out, (k, v)), the
    roped k and v (B, S, Hkv, D) that :func:`prefill_cache` stores."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = _full_attention(cfg, q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), window=window)
    y = dense(out.transpose(1, 2).reshape(b, s, -1), p["o"], cfg)
    return (y, (k, v)) if return_kv else y


def prefill_cache(k, v, cfg, seq_len: int, window: Optional[int], dtype):
    """The decode cache of one layer from its prefill K/V (B, S, Hkv, D)
    (``attention.py:766-786`` of the JAX package), in ``dtype``: for a
    global layer (``window`` None) a flat cache of ``seq_len`` slots,
    position i at slot i and the slots past S zero; for a local layer a
    ring of L = min(window, seq_len) slots, which holds the last L
    positions each at its slot (position mod L) when S ≥ L, as
    :func:`ring_chunk_attention` leaves it, else the S positions at
    slots 0..S−1.  Under ``cfg.cache_quant`` that whole cache, zero
    slots included, is quantized as JAX quantizes it: int8 ``k``/``v``
    with f32 ``k_scale``/``v_scale`` (B, L, Hkv, 1), one per (slot,
    head)."""
    b, s = k.shape[:2]
    length = min(window, seq_len) if window else seq_len
    if window and s >= length:
        start = s - length
        order = (torch.arange(length, device=k.device) - start) % length
        kf, vf = k[:, start:][:, order], v[:, start:][:, order]
    elif s > length:
        raise ValueError(f"prefill_cache: {s} positions do not fit a "
                         f"{length}-slot cache")
    else:
        pad = (0, 0, 0, 0, 0, length - s)
        kf = torch.nn.functional.pad(k, pad)
        vf = torch.nn.functional.pad(v, pad)
    if getattr(cfg, "cache_quant", False):
        kq, ks = _quantize_kv(kf)
        vq, vs = _quantize_kv(vf)
        return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    return {"k": kf.to(dtype), "v": vf.to(dtype)}


def init_attn_cache(cfg, batch: int, seq_len: int, window: Optional[int],
                    dtype, device=None):
    """A decode cache (B, L, Hkv, D) of zeros: a local layer's ring of
    L = min(window, seq_len) slots, or with ``window`` None a global
    layer's flat cache of L = seq_len slots (the serving engine keeps
    global layers' KV in the paged pool instead).  Under
    ``cfg.cache_quant`` (``attention.py:355-369`` of the JAX package)
    int8 ``k``/``v`` and f32 ``k_scale``/``v_scale`` (B, L, Hkv, 1):
    about 0.53x the bytes of a bf16 cache at D = 64."""
    length = min(window, seq_len) if window else seq_len
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    if getattr(cfg, "cache_quant", False):
        sshape = (batch, length, cfg.n_kv_heads, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(sshape, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_slots(cache, rows, slot_b, k, v, row_valid):
    """Write k/v (B, Hkv, D) at (row, slot) of a flat or ring cache, in
    place, quantized (per (token, head), ``_quantize_kv``) where the
    cache holds int8; rows whose ``row_valid`` is False keep what they
    held."""
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        new = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    else:
        new = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    for name, leaf in new.items():
        if row_valid is not None:
            keep = row_valid.reshape(-1, 1, 1)
            leaf = torch.where(keep, leaf, cache[name][rows, slot_b])
        cache[name][rows, slot_b] = leaf


def _cache_kv(cache, cfg):
    """The cache's k and v (B, L, Hkv, D) to attend over: as stored, or
    an int8 cache dequantized whole to the compute dtype
    (``attention.py:383-395`` of the JAX package)."""
    if "k_scale" not in cache:
        return cache["k"], cache["v"]
    cdt = compute_dtype(cfg)
    return (_dequantize_kv(cache["k"], cache["k_scale"], cdt),
            _dequantize_kv(cache["v"], cache["v_scale"], cdt))


def decode_attention(x, p, cfg, cache, pos, *,
                     window: Optional[int] = None, row_valid=None):
    """Decode over a local layer's ring or, with ``window`` None, a global
    layer's flat cache (``attention.py:372-429`` of the JAX package): one
    token, or a K-token speculative window scored as K decode steps.
    x: (B, K, D); pos: (B,) the first positions.  The q/k/v and o
    projections run once over the B·K rows on the plans of the decode
    step's B rows (``plan_rows``), so every row gets a decode step's
    bits.  Then per position i, in order: its K/V are written at slot
    (pos + i) mod L of every row whose ``row_valid`` is True (all rows
    without it), in place, and B6 reads the cache in its stored layout:
    in a ring, slot j holds absolute position p − ((p − j) mod L) for
    p = pos + i; in a flat cache, slot j holds position j if j ≤ p and is
    masked (−1) past it.  (Writing the whole window first would overwrite
    keys an earlier position still sees.)  Under ``cfg.cache_quant`` the
    position's K/V are quantized as they are written and the whole cache
    is dequantized to the compute dtype before it is read, JAX's order.
    The attention is B6 (``ops.flash_decode``) on the kernel backend, the
    plain attention over the same positions on ``"torch"``.  Returns
    (out, cache)."""
    b, klen, _ = x.shape
    pos_b = torch.as_tensor(pos, dtype=torch.int64,
                            device=x.device).reshape(-1).expand(b)
    positions = (pos_b[:, None] if klen == 1 else
                 pos_b[:, None] + torch.arange(klen, device=x.device)[None])
    q, k, v = _project_qkv_decode(x, p, cfg, positions, plan_rows=b)
    length = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    idx = torch.arange(length, device=x.device)[None, :]
    outs = []
    for i in range(klen):
        pos_i = positions[:, i]
        slot_b = pos_i % length
        _write_slots(cache, rows, slot_b, k[:, i], v[:, i], row_valid)
        if window is None:
            kv_positions = torch.where(idx <= pos_i[:, None], idx, -1)
        else:
            kv_positions = pos_i[:, None] - (pos_i[:, None] - idx) % length
        kc, vc = _cache_kv(cache, cfg)
        outs.append(_one_query(cfg, q[:, i], kc.transpose(1, 2),
                               vc.transpose(1, 2), kv_positions, pos_i,
                               window))
    out = torch.stack(outs, dim=1) if klen > 1 else outs[0][:, None]
    return dense(out.reshape(b, klen, -1), p["o"], cfg, plan_rows=b), cache


def _one_query(cfg, q, k, v, kv_positions, q_pos, window):
    """One query per row, q (B, H, D), over k/v (B, Hkv, L, D) at
    ``kv_positions`` (B, L), the row's query at ``q_pos`` (B,): B6
    (``ops.flash_decode``) on the kernel backend, the plain attention on
    ``"torch"`` (``attention.py:409-426`` of the JAX package) → (B, H,
    D)."""
    if on_kernels(cfg):
        from repro_torch.kernels import ops
        return ops.flash_decode(q, k, v, kv_positions, q_pos, window=window,
                                softcap=cfg.attn_softcap, scale=_scale(cfg))
    return _xla_attention(q[:, :, None], k, v, causal=True, window=window,
                          softcap=cfg.attn_softcap, scale=_scale(cfg),
                          kv_positions=kv_positions,
                          q_positions=q_pos[:, None],
                          chunk=_chunk(cfg))[:, :, 0]


def ring_chunk_attention(x, p, cfg, cache, positions, *, pos0: int,
                         window: int):
    """One prefill chunk of a sliding-window layer over its ring
    (``attention.py:720-763`` of the JAX package).  x: (1, C, D); cache:
    the slot's (1, L, Hkv, D) ring (a view into the batch's ring);
    ``pos0`` the chunk's first absolute position.  The chunk attends to
    the ring's pre-chunk contents plus itself under the window mask, then
    its last min(C, L) tokens overwrite their ring slots (slot = pos mod
    L), in place — the layout decode reads.  Returns (out, cache)."""
    b, c_len, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    ring_k, ring_v = cache["k"], cache["v"]
    length = ring_k.shape[1]
    idx = torch.arange(length, device=x.device)
    # Ring slot i holds the most recent absolute position ≡ i (mod L)
    # strictly before the chunk; never-written slots are masked (−1).
    rp = pos0 - (pos0 - idx) % length
    rp = torch.where((rp >= pos0) | (rp < 0), torch.full_like(rp, -1), rp)
    kv_positions = torch.cat([rp[None].expand(b, length),
                              positions.to(rp.dtype)], dim=1)
    kc = torch.cat([ring_k, k.to(ring_k.dtype)], dim=1)
    vc = torch.cat([ring_v, v.to(ring_v.dtype)], dim=1)
    out = _xla_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        causal=True, window=window, softcap=cfg.attn_softcap,
        scale=_scale(cfg), kv_positions=kv_positions,
        q_positions=positions, chunk=_chunk(cfg))
    out = out.transpose(1, 2)
    keep = min(c_len, length)
    slots = (pos0 + c_len - keep
             + torch.arange(keep, device=x.device)) % length
    ring_k[:, slots] = k[:, c_len - keep:].to(ring_k.dtype)
    ring_v[:, slots] = v[:, c_len - keep:].to(ring_v.dtype)
    return dense(out.reshape(b, c_len, -1), p["o"], cfg), cache


def init_paged_attn_cache(cfg, num_pages: int, page_size: int, dtype,
                          device=None):
    """Paged KV storage for ONE global-attention layer; page 0 is the
    reserved null page."""
    fmt = _kv_storage_format(cfg)
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    if fmt is None:
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    if fmt.quantized:
        sshape = (num_pages, page_size, cfg.n_kv_heads, 1)
        return {"k_pages": torch.zeros(shape, dtype=torch.int8,
                                       device=device),
                "k_scale": torch.zeros(sshape, device=device),
                "v_pages": torch.zeros(shape, dtype=torch.int8,
                                       device=device),
                "v_scale": torch.zeros(sshape, device=device)}
    return {"k_pages": torch.zeros(shape, dtype=fmt.operand_torch,
                                   device=device),
            "v_pages": torch.zeros(shape, dtype=fmt.operand_torch,
                                   device=device)}


def _write_kv(cache, cfg, phys, slot, k, v):
    """Scatter K/V rows into (physical page, slot), quantizing under the
    KV storage format.  In place."""
    if "k_scale" in cache:
        fmt = _kv_storage_format(cfg)
        kq, ks = _quantize_kv(k, per_channel=fmt.per_channel)
        vq, vs = _quantize_kv(v, per_channel=fmt.per_channel)
        cache["k_pages"][phys, slot] = kq
        cache["k_scale"][phys, slot] = ks
        cache["v_pages"][phys, slot] = vq
        cache["v_scale"][phys, slot] = vs
    else:
        dt = cache["k_pages"].dtype
        cache["k_pages"][phys, slot] = k.to(dt)
        cache["v_pages"][phys, slot] = v.to(dt)


def _paged_plain(cfg, q, cache, page_table, pos, window):
    """The ``"torch"`` backend's attention of one query per row, q (B, H,
    D) at positions ``pos`` (B,), over the paged pool: JAX's xla branch
    (``attention.py:506-538`` there).  Every table page is gathered in
    logical order (slot j of the view is position j; unmapped rows clamp
    to the null page 0), int8 pages are dequantized to the compute
    dtype, and positions past ``pos`` or on an unmapped page are masked.
    Static shapes and device-side masks only: a decode step holding it
    is captured as a CUDA graph.  → (B, H, D)."""
    b, maxp = page_table.shape
    page = cache["k_pages"].shape[1]
    idx = page_table.long().clamp(min=0)

    def gather(leaf):
        return leaf[idx].reshape(b, maxp * page, *leaf.shape[2:])

    kg, vg = gather(cache["k_pages"]), gather(cache["v_pages"])
    if "k_scale" in cache:
        cdt = compute_dtype(cfg)
        kg = _dequantize_kv(kg, gather(cache["k_scale"]), cdt)
        vg = _dequantize_kv(vg, gather(cache["v_scale"]), cdt)
    slots = torch.arange(maxp * page, device=q.device)[None, :]
    mapped = (page_table >= 0)[:, :, None].expand(b, maxp, page).reshape(
        b, maxp * page)
    kv_positions = torch.where((slots <= pos[:, None]) & mapped, slots, -1)
    return _xla_attention(q[:, :, None], kg.transpose(1, 2),
                          vg.transpose(1, 2), causal=True, window=window,
                          softcap=cfg.attn_softcap, scale=_scale(cfg),
                          kv_positions=kv_positions,
                          q_positions=pos[:, None],
                          chunk=_chunk(cfg))[:, :, 0]


def _paged_query(cfg, q, cache, page_table, pos, window):
    """One query per row at positions ``pos`` over the paged pool: B4
    (``ops.flash_decode_paged``, ``seq_lens = pos + 1``) on the kernel
    backend, :func:`_paged_plain` on ``"torch"`` → (B, H, D)."""
    if not on_kernels(cfg):
        return _paged_plain(cfg, q, cache, page_table, pos, window)
    from repro_torch.kernels import ops
    return ops.flash_decode_paged(
        q, cache["k_pages"], cache["v_pages"], page_table, pos + 1,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        window=window, softcap=cfg.attn_softcap, scale=_scale(cfg))


def paged_decode_attention(x, p, cfg, cache, pos, page_table, *,
                           window: Optional[int] = None):
    """One-token decode over the paged pool.  x: (B, 1, D); pos: (B,)
    positions; page_table: (B, max_pages) int32 (−1 unmapped; inactive
    rows write their garbage token into the null page 0).  The new
    token's K/V are scattered first, then B4 (the plain attention over
    the gathered pages on ``"torch"``, :func:`_paged_query`) reads the
    table-selected pages.  Returns (out, cache)."""
    b = x.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int64,
                            device=x.device).reshape(-1).expand(b)
    q, k, v = _project_qkv_decode(x, p, cfg, pos_b[:, None])
    page = cache["k_pages"].shape[1]
    rows = torch.arange(b, device=x.device)
    phys = page_table[rows, pos_b // page].long().clamp(min=0)
    _write_kv(cache, cfg, phys, pos_b % page, k[:, 0], v[:, 0])
    out = _paged_query(cfg, q[:, 0], cache, page_table, pos_b, window)
    return dense(out.reshape(b, 1, -1), p["o"], cfg), cache


def verify_paged_attention(x, p, cfg, cache, pos, page_table):
    """Score a K-token speculative window over the paged pool
    (``attention.py:542-640`` of the JAX package).  x: (B, K, D), per row
    the last emitted token and K − 1 draft proposals; pos: (B,) the
    window's first positions; page_table: (B, max_pages).

    The decode step run K times, with the projections run once: q/k/v
    and o over the B·K rows on the plans of the decode step's B rows
    (``plan_rows``), so every row gets the bits a decode step at its
    position gets.  The window's K/V are scattered into their (page,
    slot) targets first; then the attention runs once per window
    position i at position pos + i, as JAX's kernel branch does: B4 with
    ``seq_lens = pos + i + 1``, the launch a decode step at that position
    makes, over the same visible keys, or on ``"torch"`` the decode
    step's plain attention (JAX's xla branch scores the K queries in one
    batched pass, whose products have other shapes than a decode
    step's).  A rejected suffix is never unwritten: the slots past the
    accepted point hold garbage the next window overwrites.  Returns
    (out, cache)."""
    b, klen, _ = x.shape
    pos_b = torch.as_tensor(pos, dtype=torch.int64,
                            device=x.device).reshape(-1).expand(b)
    positions = pos_b[:, None] + torch.arange(klen, device=x.device)[None]
    q, k, v = _project_qkv_decode(x, p, cfg, positions, plan_rows=b)
    page = cache["k_pages"].shape[1]
    rows = torch.arange(b, device=x.device)[:, None]
    phys = page_table[rows, positions // page].long().clamp(min=0)
    _write_kv(cache, cfg, phys, positions % page, k, v)
    out = torch.stack([_paged_query(cfg, q[:, i], cache, page_table,
                                    pos_b + i, None)
                       for i in range(klen)], dim=1)
    return dense(out.reshape(b, klen, -1), p["o"], cfg, plan_rows=b), cache


def paged_prefill_attention(x, p, cfg, cache, positions, page_table, *,
                            kv_len: int):
    """One prefill chunk over the paged pool.  x: (1, C, D); positions:
    (1, C) = [kv_len − C, kv_len); page_table: (1, max_pages).  The
    chunk's K/V are stored (quantized under the KV format); attention
    reads the prior prefix's pages (aliased prefix-cache pages included,
    dequantized to the compute dtype) followed by the chunk's own
    full-precision K/V, through B5 (the plain attention on ``"torch"``,
    JAX's ``attention.py:702-717``).  Returns (out, cache)."""
    b, c_len, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    page = cache["k_pages"].shape[1]
    pos_v = positions[0].long()
    phys = page_table[0, pos_v // page].long().clamp(min=0)
    _write_kv(cache, cfg, phys, pos_v % page, k[0], v[0])

    pos0 = kv_len - c_len
    n_prefix = -(-pos0 // page)
    cdt = compute_dtype(cfg)

    def gather(leaf):
        idx = page_table[:, :n_prefix].long().clamp(min=0)
        g = leaf[idx]
        return g.reshape(b, n_prefix * page, *leaf.shape[2:])[:, :pos0]

    if pos0:
        kg, vg = gather(cache["k_pages"]), gather(cache["v_pages"])
        if "k_scale" in cache:
            kg = _dequantize_kv(kg, gather(cache["k_scale"]), cdt)
            vg = _dequantize_kv(vg, gather(cache["v_scale"]), cdt)
        kg = torch.cat([kg.to(cdt), k.to(cdt)], dim=1)
        vg = torch.cat([vg.to(cdt), v.to(cdt)], dim=1)
    else:
        kg, vg = k.to(cdt), v.to(cdt)
    out = _full_attention(cfg, q.transpose(1, 2), kg.transpose(1, 2),
                          vg.transpose(1, 2), window=None).transpose(1, 2)
    return dense(out.reshape(b, c_len, -1), p["o"], cfg), cache
