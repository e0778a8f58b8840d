"""Serving engine: continuous batching over the paged KV pool (the port of
``repro/serving/engine.py``, synchronous path).

The scheduler (:mod:`repro_torch.serving.scheduler`) owns every policy
decision — FIFO admission by token budget, page growth, prefix aliasing,
eviction; this class owns the parameters, the paged cache and the model
calls: chunked prefill (``models.prefill_chunk``, fixed ``prefill_chunk``
chunks written straight into the request's pool pages, interleaved with
decode — ``scheduler.prefill_chunk_quota`` chunks per step), prefix
caching (page-aligned content hashes with the JAX engine's salt, so a
hit implies the same tokens at the same positions under the same
formats), copy-on-write of shared pages before a decode writes them, and
ONE batched decode + sample over the fixed slots per step
(``models.decode_and_sample``).

Steps run at pipeline depth 1: every launched decode and every prefill
seed token is delivered within its own step, in launch order — the JAX
engine's ``async_steps=False`` structure, step for step.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: ``async_steps=True`` / ``pipeline_depth > 1`` and ``spec_k ≥ 2``
(ROADMAP A8), ``fault``, deadlines, load shedding, ``watchdog_s``,
``prefix_index_path``, ``plan_cache_path`` (A6/A4), ``slo_monitor`` (A9),
and the grouped decode q/k/v (``grouped_qkv``, B3).

Weights: the engine keeps the projection weights, and the embedding table
when the compute dtype equals the operand dtype, already cast to the
format's operand dtype (every GEMM casts them to it anyway, so the values
are identical), and a widened copy of the operand-rounded table for the
LM head — the bf16 weights a decode step reads are then the only weight
bytes it moves.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.geometry import cdiv
from repro_torch.models import model as model_lib
from repro_torch.models.layers import (compute_dtype, model_format,
                                       unembed_operand_dtype)
from repro_torch.serving.kv_cache import page_prefix_hashes
from repro_torch.serving.resilience import (CapacityExceeded,
                                            PoisonedOutput, RequestError,
                                            Response)
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

__all__ = ["Request", "ServingEngine", "serving_params"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    format_policy: Optional[str] = None  # per-request prefill precision
    deadline: Optional[float] = None     # read by DeadlineScheduler
    deadline_ms: Optional[float] = None  # queued (A6): refused at submit
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def serving_params(params, cfg: ArchConfig):
    """The parameter tree the engine serves from: dense weights cast to
    the model format's operand dtype (float formats only: int8 quantizes
    the full-precision weights), the embedding table likewise when the
    compute dtype is that operand dtype, and ``embedding["unembed"]`` =
    the table rounded to the LM head's operand dtype and widened to f32.
    Shallow copies; the caller's tensors are untouched."""
    fmt = model_format(cfg)
    op = fmt.operand_torch
    cast_w = not fmt.quantized

    def layer(lp):
        out = dict(lp)
        for group in ("mixer", "ffn"):
            out[group] = {name: ({**d, "w": d["w"].to(op)} if cast_w else d)
                          for name, d in lp[group].items()}
        return out

    emb = dict(params["embedding"])
    table = emb["table"]
    odt = unembed_operand_dtype(cfg)
    emb["unembed"] = table.to(odt).float()
    if cast_w and compute_dtype(cfg) == op:
        emb["table"] = table.to(op)
    return {"embedding": emb,
            "layers": [layer(lp) for lp in params["layers"]],
            "final_norm": params["final_norm"]}


class ServingEngine:
    def __init__(self, params, cfg: ArchConfig, *, slots: int = 4,
                 cache_len: int = 512, prefill_len: int = 128,
                 seed: int = 0, plan_cache_path: Optional[str] = None,
                 format_policy: Optional[str] = None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_format: Optional[str] = None,
                 token_budget: Optional[int] = None,
                 grouped_qkv: Optional[bool] = None,
                 scheduler_cls=None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 deadline_ms: Optional[float] = None,
                 shed_queue_depth: Optional[int] = None,
                 shed_token_watermark: Optional[int] = None,
                 fault=None,
                 debug_audit: bool = False,
                 watchdog_s: Optional[float] = None,
                 quarantine: bool = True,
                 spec_k: int = 0,
                 prefix_index_path: Optional[str] = None,
                 slo_monitor=None,
                 async_steps: bool = False,
                 pipeline_depth: int = 1,
                 device=None):
        queued = {
            "async_steps=True (ROADMAP A8)": async_steps,
            "pipeline_depth > 1 (ROADMAP A8)": pipeline_depth > 1,
            "spec_k >= 2 (ROADMAP A8)": spec_k >= 2,
            "fault injection (ROADMAP A6)": fault is not None,
            "deadline_ms (ROADMAP A6)": deadline_ms is not None,
            "load shedding (ROADMAP A6)": (shed_queue_depth is not None
                                           or shed_token_watermark
                                           is not None),
            "watchdog_s (ROADMAP A6)": watchdog_s is not None,
            "prefix_index_path (ROADMAP A6)": prefix_index_path is not None,
            "plan_cache_path (ROADMAP A4)": plan_cache_path is not None,
            "slo_monitor (ROADMAP A9)": slo_monitor is not None,
            "grouped_qkv=True (ROADMAP B3)": bool(grouped_qkv),
        }
        asked = [name for name, on in queued.items() if on]
        if asked:
            raise NotImplementedError(
                "ServingEngine: not ported yet: " + ", ".join(asked))
        self.device = resolve_device(device)
        if format_policy is not None:
            cfg = dataclasses.replace(cfg, format_policy=format_policy)
        if kv_format is None and cfg.cache_quant:
            kv_format = "int8pt"
        if kv_format is not None:
            from repro_torch.core.formats import resolve_format
            resolve_format(kv_format)
        cache_len = cdiv(cache_len, page_size) * page_size
        cfg = dataclasses.replace(cfg, cache_quant=False,
                                  kv_cache_format=kv_format,
                                  decode_qkv_grouped=False)
        self.cfg = cfg
        self.params = serving_params(params, cfg)
        self.slots = slots
        self.cache_len = cache_len
        self.prefill_len = prefill_len
        self.page_size = page_size
        if prefill_chunk is None:
            prefill_chunk = prefill_len
        if prefill_len % prefill_chunk != 0:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must divide "
                f"prefill_len ({prefill_len}): chunks are the static "
                f"prefill shape")
        self.prefill_chunk = int(prefill_chunk)
        self.n_chunks = prefill_len // self.prefill_chunk
        self.prefix_cache = bool(prefix_cache)
        self._prefix_active = (
            self.prefix_cache
            and self.prefill_chunk % page_size == 0
            and prefill_len >= 2 * self.prefill_chunk
            and all(kind[0] == "attn" for kind in cfg.layer_kinds))
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        scheduler_cls = scheduler_cls or ContinuousBatchingScheduler
        self.sched = scheduler_cls(
            slots=slots, max_seq_len=cache_len, page_size=page_size,
            num_pages=num_pages, token_budget=token_budget,
            prefill_chunk=self.prefill_chunk)
        self.cache = model_lib.init_paged_cache(
            cfg, slots, cache_len, num_pages=self.sched.pool.num_pages,
            page_size=page_size, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self.completed: List[Request] = []
        self._prefilling: Dict[int, dict] = {}
        self._inflight: Deque[dict] = collections.deque()
        self._last_tok = torch.zeros((slots, 1), dtype=torch.int32,
                                     device=self.device)
        self.debug_audit = bool(debug_audit)
        self.quarantine = bool(quarantine)
        self.step_idx = 0
        self._responses: Dict[int, Response] = {}

    @property
    def queue(self) -> List[Request]:
        """Waiting requests in arrival order (FIFO line)."""
        return [e.req for e in
                sorted(self.sched.waiting, key=lambda e: e.arrival)]

    def _chunk_cfg(self, format_policy: Optional[str]) -> ArchConfig:
        if format_policy is None or format_policy == self.cfg.format_policy:
            return self.cfg
        return dataclasses.replace(self.cfg, format_policy=format_policy)

    def _table(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int32),
                               device=self.device)

    # -- client API -----------------------------------------------------------
    def submit(self, req: Request):
        if req.format_policy is not None:
            from repro_torch.core.formats import resolve_format
            resolve_format(req.format_policy)
        if req.deadline_ms is not None:
            raise NotImplementedError("per-request deadlines are ROADMAP A6")
        self.sched.submit(req)

    def run(self, max_steps: int = 1000) -> Dict[int, Response]:
        """Run until every submitted request finishes (or the step
        budget).  Returns ``rid -> Response``; requests still live at the
        budget come back ``"incomplete"``."""
        for _ in range(max_steps):
            self._admit()
            if not any(r is not None for r in self.slot_req):
                if not self.sched.waiting:
                    break
                if self.sched.admission_stuck(self.prefill_len):
                    head = self.sched._pick_admit()
                    self._cancel_waiting(head, CapacityExceeded(
                        f"request rid={head.rid} can never be admitted: "
                        f"pool={self.sched.pool.describe_str()}, "
                        f"token_budget={self.sched.token_budget}",
                        rid=head.rid))
                continue
            self.step()
        self._flush_pipeline()
        out = dict(self._responses)
        for r in self.queue + [r for r in self.slot_req if r is not None]:
            out[r.rid] = Response(r.output, rid=r.rid, status="incomplete")
        return out

    def metrics(self) -> Dict[str, float]:
        """Scheduler counters plus pool sharing state and plan-cache
        hit counts."""
        from repro_torch.core import autotune
        m = dict(self.sched.metrics())
        pool = self.sched.pool
        m.update(slots=self.slots, page_size=self.page_size,
                 num_pages=pool.num_pages, free_pages=pool.free_pages,
                 kv_format=self.cfg.kv_cache_format or "none",
                 prefix_cache=int(self._prefix_active),
                 prefill_chunk=self.prefill_chunk,
                 prefix_queries=pool.prefix_queries,
                 prefix_hit_pages=pool.prefix_hit_pages,
                 shared_pages=pool.shared_pages,
                 cached_pages=pool.cached_pages,
                 cow_copies=pool.cow_copies)
        cs = autotune.cache_stats()
        m.update(plan_cache_hits=cs.hits, plan_cache_misses=cs.misses,
                 plan_solver_calls=cs.solver_calls)
        return m

    # -- scheduler ------------------------------------------------------------
    def _window_tokens(self, req: Request) -> np.ndarray:
        """The request's static prefill window: the last ``prefill_len``
        tokens of prompt + generated output, left-padded."""
        context = np.asarray(req.prompt, np.int32).ravel()
        if req.output:
            context = np.concatenate(
                [context, np.asarray(req.output, np.int32)])
        prompt = context[-self.prefill_len:]
        return np.pad(prompt, (self.prefill_len - len(prompt), 0))

    def _hasher(self, entry) -> List[str]:
        """Content hashes of an entry's prefill window, salted with the
        arch, the prefill format and the KV storage format — the JAX
        engine's salt string, so both packages hash alike."""
        req = entry.req
        fmt = req.format_policy or self.cfg.format_policy
        salt = f"{self.cfg.name}|{fmt}|{self.cfg.kv_cache_format}"
        entry.window = self._window_tokens(req)
        return page_prefix_hashes(entry.window, self.page_size, salt)

    def _admit(self):
        """Admit the longest-waiting requests while capacity allows; the
        uncached suffix of each window is queued for chunked prefill."""
        hasher = self._hasher if self._prefix_active else None
        while True:
            got = self.sched.pop_admit(self.prefill_len, hasher)
            if got is None:
                return
            slot, entry, cached_tok = got
            req = entry.req
            self.slot_req[slot] = req
            self.slot_pos[slot] = 0
            window = (entry.window if entry.window is not None
                      else self._window_tokens(req))
            self._prefilling[slot] = {
                "tokens": window,
                "chunk": cached_tok // self.prefill_chunk,
                "hashes": entry.hashes,
            }

    def step(self):
        """One engine step: up to ``prefill_chunk_quota`` prefill chunks,
        delivery of their seed tokens, re-admission into freed slots,
        page growth (evicting the youngest request when the pool runs
        dry), copy-on-write, then one batched decode + sample and its
        delivery."""
        self.step_idx += 1
        self._run_prefill_chunks()
        self._flush_pipeline()
        if self.sched.waiting and any(r is None for r in self.slot_req):
            self._admit()
            self._run_prefill_chunks()
        decoding = self._decoding()
        # Seeds queued by the re-admission above land before a horizon
        # check or an eviction can act on stale host state (the JAX
        # engine's flush boundaries).
        if self._inflight and (
                any(int(self.slot_pos[s]) >= self.cache_len
                    for s in decoding)
                or (decoding and self._needs_eviction(decoding))):
            self._flush_pipeline()
            decoding = self._decoding()
        for slot in decoding:
            if self.slot_req[slot] is None or slot in self._prefilling:
                continue
            evicted = self.sched.ensure_decode(slot,
                                               int(self.slot_pos[slot]) + 1)
            for vslot, _ventry in evicted:
                self._clear_slot(vslot)
        decoding = [s for s in decoding if self.slot_req[s] is not None
                    and s not in self._prefilling]
        if decoding:
            for slot in decoding:
                self._cow_guard(slot)
            self._launch_decode(decoding)
        self._flush_pipeline()
        if self.debug_audit:
            self.sched.pool.audit()

    def _decoding(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req)
                if r is not None and s not in self._prefilling]

    def _needs_eviction(self, decoding) -> bool:
        """True when growing every decoding slot by one token would need
        more pages than the pool can hand out without evicting."""
        pool = self.sched.pool
        need = 0
        for slot in decoding:
            entry = self.sched.active.get(slot)
            if entry is None:
                continue
            owned = len(pool.pages_of(entry.arrival))
            want = -(-(int(self.slot_pos[slot]) + 1) // self.page_size)
            need += max(0, want - owned)
        return need > pool.free_pages

    # -- decode launch / delivery ------------------------------------------------
    def _launch_decode(self, decoding):
        table = np.full((self.slots, self.sched.max_pages_per_seq), -1,
                        np.int32)
        temps = np.zeros(self.slots, np.float32)
        active = np.zeros(self.slots, bool)
        for slot in decoding:
            table[slot] = self.sched.table_row(slot)
            temps[slot] = max(0.0, float(self.slot_req[slot].temperature))
            active[slot] = True
        batch = {"tokens": self._last_tok,
                 "pos": torch.as_tensor(self.slot_pos.astype(np.int64),
                                        device=self.device),
                 "page_table": self._table(table)}
        tok, finite, logits, self._last_tok, self.cache = \
            model_lib.decode_and_sample(
                self.params, batch, self.cache, self.cfg,
                generator=self._gen,
                temperatures=torch.as_tensor(temps, device=self.device),
                active_rows=torch.as_tensor(active, device=self.device))
        self._inflight.append({
            "kind": "decode", "step": self.step_idx,
            "slots": list(decoding),
            "reqs": {s: self.slot_req[s] for s in decoding},
            "pos_after": {s: int(self.slot_pos[s]) + 1 for s in decoding},
            "tok": tok, "finite": finite,
        })
        for slot in decoding:
            self.slot_pos[slot] += 1

    def _flush_pipeline(self):
        """Deliver every launched step, in launch order."""
        while self._inflight:
            entry = self._inflight.popleft()
            if entry["kind"] == "seed":
                self._deliver_seed(entry)
            else:
                self._deliver_decode(entry)

    def _deliver_decode(self, entry):
        tok = entry["tok"].cpu().numpy()
        finite = entry["finite"].cpu().numpy()
        n_live = 0
        for slot in entry["slots"]:
            req = entry["reqs"][slot]
            if req.done or self.slot_req[slot] is not req:
                continue
            n_live += 1
            if self.quarantine and not finite[slot]:
                self._cancel_active(slot, PoisonedOutput(
                    f"non-finite logits for rid={req.rid} at step "
                    f"{entry['step']}", rid=req.rid))
                continue
            req.output.append(int(tok[slot]))
            done = self._finished(slot)
            if not done and entry["pos_after"][slot] >= self.cache_len:
                self._record_done(req)
                self.slot_req[slot] = None
                self.slot_pos[slot] = 0
                self.sched.release(slot, finished=True)
        if n_live:
            self.sched.note_step(n_live, lag=self.step_idx - entry["step"])

    def _deliver_seed(self, entry):
        slot = entry["slots"][0]
        req = entry["reqs"][slot]
        tok = int(entry["tok"].reshape(-1)[0])
        finite = bool(entry["finite"].reshape(-1)[0])
        if req.done or self.slot_req[slot] is not req:
            return
        if self.quarantine and not finite:
            self._cancel_active(slot, PoisonedOutput(
                f"non-finite prefill logits for rid={req.rid} at step "
                f"{entry['step']}", rid=req.rid))
            return
        req.output.append(tok)
        self._finished(slot)

    # -- chunked prefill ----------------------------------------------------------
    def _run_prefill_chunks(self):
        if not self._prefilling:
            return
        n_decoding = sum(1 for s, r in enumerate(self.slot_req)
                         if r is not None and s not in self._prefilling)
        quota = max(1, int(self.sched.prefill_chunk_quota(n_decoding)))
        for _ in range(quota):
            if not self._prefilling:
                return
            slot = min(self._prefilling,
                       key=lambda s: self.sched.active[s].arrival)
            self._advance_prefill(slot)

    def _advance_prefill(self, slot: int):
        """Run ONE prompt chunk for ``slot`` into its pool pages; the final
        chunk's logits seed the first token (sampled on the device)."""
        st = self._prefilling[slot]
        req = self.slot_req[slot]
        c = st["chunk"]
        size = self.prefill_chunk
        toks = st["tokens"][c * size:(c + 1) * size]
        batch = {"tokens": torch.as_tensor(toks[None].astype(np.int64),
                                           device=self.device),
                 "page_table": self._table(self.sched.table_row(slot)[None])}
        logits, self.cache = model_lib.prefill_chunk(
            self.params, batch, self.cache,
            self._chunk_cfg(req.format_policy), pos0=c * size)
        if st["hashes"] is not None and size % self.page_size == 0:
            per_chunk = size // self.page_size
            for j in range(c * per_chunk, (c + 1) * per_chunk):
                self.sched.register_prefix(slot, j, st["hashes"][j])
        st["chunk"] = c + 1
        if st["chunk"] < self.n_chunks:
            return
        del self._prefilling[slot]
        self.slot_pos[slot] = self.prefill_len
        temp = max(0.0, float(req.temperature))
        tok, finite = model_lib.sample_token(
            logits, self._gen,
            torch.full((1,), temp, dtype=torch.float32, device=self.device))
        self._last_tok[slot, 0] = tok[0]
        self._inflight.append({
            "kind": "seed", "step": self.step_idx, "slots": [slot],
            "reqs": {slot: req}, "tok": tok, "finite": finite,
        })

    # -- request-level containment ------------------------------------------------
    def _record_done(self, req: Request, status: str = "ok",
                     error: Optional[RequestError] = None):
        req.done = True
        self.completed.append(req)
        self._responses[req.rid] = Response(
            req.output, rid=req.rid, status=status, error=error,
            metrics={"tokens": len(req.output)})

    def _cancel_active(self, slot: int, err: RequestError):
        req = self.slot_req[slot]
        if req is None:
            return
        self.sched.cancel(slot)
        self._clear_slot(slot)
        req.done = True
        self._responses[req.rid] = Response(
            req.output, rid=req.rid, status=err.code, error=err,
            metrics={"tokens": len(req.output)})

    def _cancel_waiting(self, entry, err: RequestError):
        self.sched.cancel_waiting(entry)
        req = entry.req
        req.done = True
        self._responses[req.rid] = Response(
            req.output, rid=req.rid, status=err.code, error=err,
            metrics={"tokens": len(req.output)})

    # -- helpers -------------------------------------------------------------------
    def _clear_slot(self, slot: int):
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        self._prefilling.pop(slot, None)

    def _cow_guard(self, slot: int, n_tokens: int = 1):
        """Copy-on-write: any shared physical page among the logical pages
        the next ``n_tokens`` decode writes touch is re-owned onto a fresh
        page, its device content copied first."""
        entry = self.sched.active.get(slot)
        if entry is None:
            return
        pos = int(self.slot_pos[slot])
        for idx in range(pos // self.page_size,
                         (pos + n_tokens - 1) // self.page_size + 1):
            pages = self.sched.pool.pages_of(entry.arrival)
            if idx >= len(pages) or self.sched.pool.ref_of(pages[idx]) <= 1:
                continue
            old, new = self.sched.pool.make_private(entry.arrival, idx)
            self._copy_page(old, new)

    def _copy_page(self, old: int, new: int):
        """Duplicate one physical page across every layer's slabs."""
        for layer in self.cache["layers"]:
            for leaf in layer.values():
                leaf[new] = leaf[old]

    def _finished(self, slot: int) -> bool:
        req = self.slot_req[slot]
        if req is None:
            return True
        hit_eos = req.eos_id is not None and req.output[-1] == req.eos_id
        if len(req.output) >= req.max_tokens or hit_eos:
            self._record_done(req)
            self.slot_req[slot] = None
            self.slot_pos[slot] = 0
            self.sched.release(slot, finished=True)
            return True
        return False
