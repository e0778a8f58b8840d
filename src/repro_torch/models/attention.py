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
(:func:`decode_attention`).  The KV scatter
into pages and rings, the prefix-page gather and the dequantize outside
the kernels stay plain PyTorch, as they are plain jnp in JAX.

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

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.formats import resolve_format, to_torch_dtype
from repro_torch.models.layers import (compute_dtype, dense, init_dense,
                                       init_norm, model_format, rmsnorm,
                                       rope, use_graph)

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
    scale = xf.abs().amax(dim=dims, keepdim=True) / 127.0
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


def _xla_attention(q, k, v, *, causal, window, softcap, scale,
                   kv_positions, q_positions):
    """Plain attention in the BHSD layout with the flash kernels' mask
    semantics (``kvpos ≥ 0``, causal, window) over explicit (B, Skv) kv
    and (B, Sq) query positions: the mirror of ``_xla_attention``
    (``attention.py:215-253`` of the JAX package).
    GQA runs as a grouped einsum, KV heads never repeated.  Always the
    unchunked formulation: above 2048 kv positions JAX switches to an
    online-softmax scan over kv chunks, which differs from this only in
    rounding (f32 logits either way; the bf16 cast of the probabilities
    here, as JAX's unchunked path does)."""
    b, h, sq, hd = q.shape
    hkv = k.shape[1]
    g = h // hkv
    qp = q_positions[:, :, None]
    kp = kv_positions[:, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    qg = q.reshape(b, hkv, g, sq, hd)
    logits = torch.einsum("bngqd,bnkd->bngqk", qg.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), _NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bngqk,bnkd->bngqd", probs, v)
    return out.reshape(b, h, sq, hd)


def attention(x, p, cfg, positions, *, window: Optional[int] = None,
              return_kv: bool = False):
    """Full-sequence causal attention, the training forward's and the
    prefill's (``attention.py:304-327`` of the JAX package): x (B, S, D)
    at positions 0..S−1, q/k/v projected over the B·S rows, B5
    (``flash_attention``) over the whole sequence with the window mask
    on local layers, then ``o``.  With ``return_kv`` → (out, (k, v)), the
    roped k and v (B, S, Hkv, D) that :func:`prefill_cache` stores."""
    from repro_torch.kernels import ops
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, softcap=cfg.attn_softcap,
        scale=_scale(cfg))
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
    slots 0..S−1."""
    if getattr(cfg, "cache_quant", False):
        raise NotImplementedError("int8 decode caches (cache_quant) are "
                                  "ROADMAP A10")
    b, s = k.shape[:2]
    length = min(window, seq_len) if window else seq_len
    if window and s >= length:
        start = s - length
        order = (torch.arange(length, device=k.device) - start) % length
        return {"k": k[:, start:][:, order].to(dtype),
                "v": v[:, start:][:, order].to(dtype)}
    if s > length:
        raise ValueError(f"prefill_cache: {s} positions do not fit a "
                         f"{length}-slot cache")
    cache = init_attn_cache(cfg, b, length, None, dtype, k.device)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return cache


def init_attn_cache(cfg, batch: int, seq_len: int, window: Optional[int],
                    dtype, device=None):
    """A decode cache (B, L, Hkv, D) of zeros: a local layer's ring of
    L = min(window, seq_len) slots, or with ``window`` None a global
    layer's flat cache of L = seq_len slots (the serving engine keeps
    global layers' KV in the paged pool instead)."""
    if getattr(cfg, "cache_quant", False):
        raise NotImplementedError("int8 decode caches (cache_quant) are "
                                  "ROADMAP A10")
    length = min(window, seq_len) if window else seq_len
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
    keys an earlier position still sees.)  Returns (out, cache)."""
    from repro_torch.kernels import ops
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
        for name, new in (("k", k[:, i]), ("v", v[:, i])):
            new = new.to(cache[name].dtype)
            if row_valid is not None:
                keep = row_valid.reshape(b, 1, 1)
                new = torch.where(keep, new, cache[name][rows, slot_b])
            cache[name][rows, slot_b] = new
        if window is None:
            kv_positions = torch.where(idx <= pos_i[:, None], idx, -1)
        else:
            kv_positions = pos_i[:, None] - (pos_i[:, None] - idx) % length
        outs.append(ops.flash_decode(
            q[:, i], cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
            kv_positions, pos_i, window=window, softcap=cfg.attn_softcap,
            scale=_scale(cfg)))
    out = torch.stack(outs, dim=1) if klen > 1 else outs[0][:, None]
    return dense(out.reshape(b, klen, -1), p["o"], cfg, plan_rows=b), cache


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
        q_positions=positions)
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


def paged_decode_attention(x, p, cfg, cache, pos, page_table, *,
                           window: Optional[int] = None):
    """One-token decode over the paged pool.  x: (B, 1, D); pos: (B,)
    positions; page_table: (B, max_pages) int32 (−1 unmapped; inactive
    rows write their garbage token into the null page 0).  The new
    token's K/V are scattered first, then B4 reads the table-selected
    pages.  Returns (out, cache)."""
    from repro_torch.kernels import ops
    b = x.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int64,
                            device=x.device).reshape(-1).expand(b)
    q, k, v = _project_qkv_decode(x, p, cfg, pos_b[:, None])
    page = cache["k_pages"].shape[1]
    rows = torch.arange(b, device=x.device)
    phys = page_table[rows, pos_b // page].long().clamp(min=0)
    _write_kv(cache, cfg, phys, pos_b % page, k[:, 0], v[:, 0])
    out = ops.flash_decode_paged(
        q[:, 0], cache["k_pages"], cache["v_pages"], page_table, pos_b + 1,
        k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        window=window, softcap=cfg.attn_softcap, scale=_scale(cfg))
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
    slot) targets first; then B4 runs once per window position i with
    ``seq_lens = pos + i + 1``, as JAX's kernel branch does: the launch a
    decode step at that position makes, over the same visible keys.  A
    rejected suffix is never unwritten: the slots past the accepted point
    hold garbage the next window overwrites.  Returns (out, cache)."""
    from repro_torch.kernels import ops
    b, klen, _ = x.shape
    pos_b = torch.as_tensor(pos, dtype=torch.int64,
                            device=x.device).reshape(-1).expand(b)
    positions = pos_b[:, None] + torch.arange(klen, device=x.device)[None]
    q, k, v = _project_qkv_decode(x, p, cfg, positions, plan_rows=b)
    page = cache["k_pages"].shape[1]
    rows = torch.arange(b, device=x.device)[:, None]
    phys = page_table[rows, positions // page].long().clamp(min=0)
    _write_kv(cache, cfg, phys, positions % page, k, v)
    out = torch.stack([ops.flash_decode_paged(
        q[:, i], cache["k_pages"], cache["v_pages"], page_table,
        pos_b + i + 1, k_scale=cache.get("k_scale"),
        v_scale=cache.get("v_scale"), window=None,
        softcap=cfg.attn_softcap, scale=_scale(cfg))
        for i in range(klen)], dim=1)
    return dense(out.reshape(b, klen, -1), p["o"], cfg, plan_rows=b), cache


def paged_prefill_attention(x, p, cfg, cache, positions, page_table, *,
                            kv_len: int):
    """One prefill chunk over the paged pool.  x: (1, C, D); positions:
    (1, C) = [kv_len − C, kv_len); page_table: (1, max_pages).  The
    chunk's K/V are stored (quantized under the KV format); attention
    reads the prior prefix's pages (aliased prefix-cache pages included,
    dequantized to the compute dtype) followed by the chunk's own
    full-precision K/V, through B5.  Returns (out, cache)."""
    from repro_torch.kernels import ops
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
    out = ops.flash_attention(
        q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
        causal=True, window=None, softcap=cfg.attn_softcap,
        scale=_scale(cfg))
    out = out.transpose(1, 2)
    return dense(out.reshape(b, c_len, -1), p["o"], cfg), cache
