"""Serving engine: continuous batching over the paged KV pool (the port of
``repro/serving/engine.py``).

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

Steps are pipelined as in the JAX engine (``async_steps=True``,
``pipeline_depth=2``, its defaults): a step launches its decode and
returns; the next step's prefill chunks run while it is on the device,
and its tokens are delivered (retired) after them, before the next
decode is planned.  Prefill seed tokens are delivered within their own
step.  The pipeline flushes at the horizon and before an eviction.
``async_steps=False`` delivers every launch within its step (depth 1).
Greedy streams are the same in both modes.

The decode step (:class:`DecodeStep`) reads static device buffers and,
on a CUDA device, is replayed as one CUDA graph per sampling variant
(all-greedy, sampled), captured at its first use — the counterpart of
the JAX engine's ``jax.jit`` of ``decode_and_sample``.  ``cuda_graph``
picks the graph (the default on a CUDA device) or the eager step (the
default, and the only choice, on the CPU).  A failed capture or replay
raises.  Every per-step copy to the device goes through pinned staging
buffers without blocking, and the tokens come back through pinned
buffers and an event: a step's one host sync is the retire's wait on
that event.

Speculative decoding (``spec_k ≥ 2``, ``engine.py:1127-1555`` of the JAX
package): a draft (by default weight-shared: the target's first
``draft_groups`` layer periods; or ``draft_config`` with its own
``draft_params``) proposes k − 1 tokens per decoding slot, the target
scores the window [last emitted token, proposals] in ONE
:func:`~repro_torch.models.model.verify_chunk` whose GEMMs carry M =
slots·k rows on the decode step's plans, and greedy requests keep the
proposals while the target's argmax agrees (sampled ones run rejection
sampling), so greedy streams are those of ``spec_k=0`` bit for bit, for
any slots and k: the window's GEMMs run in chunks of rows on the decode
step's plans (``kernels.ops``, ``geometry.window_rows``), and k is
clamped as the JAX engine clamps it.  The speculative step's model
calls (:class:`SpecStep`: the target's verify and replay windows, the
draft's catch-up windows and decode step) read
static device buffers and, on a CUDA device, are replayed as one CUDA
graph per shape, captured at first use — the counterpart of the JAX
engine's jitted ``_verify``, ``_draft_verify`` and ``_draft_decode``.
All-greedy steps chain the draft's proposals on the device and fetch
once (the target's argmax, finite flags and accepted drafts); sampled
steps fetch the logits of each call.  The step is synchronous: the
pipeline is flushed before it.  The ring and RG-LRU rows of a rejected
suffix are restored from clones into the same storage and the accepted
prefix replayed; paged KV past the accepted point is garbage the next
window overwrites.  Proposals and acceptance draw from a host
``torch.Generator`` seeded from ``seed`` (JAX draws from its key stream,
so sampled rows differ in bits, not in distribution).

Telemetry (:mod:`repro_torch.telemetry`, the JAX engine's hooks at
their counterparts): spans ``admit``, ``evict``, ``prefill_chunk``,
``decode`` (open from the launch to the delivery, so an async trace
shows it across the next step's host work), ``sample``, ``draft`` and
``verify``; the scheduler's request-lifecycle instants and
``request.first_token``; the histograms ``serving.queue_wait_s`` (at
admission) and ``serving.ttft_s``, ``inter_token_s`` and ``e2e_s`` (at
delivery, never at the launch), each request's latency summary in its
``Response.metrics``; per-step gauges (``kv.*``, queue depth, active
slots, completions, ``serving.steps_in_flight`` and
``results_stale_steps``) and an optional ``slo_monitor`` observed after
every step.  All of it reads the host clock only — no sync, no device
state, so greedy streams are the same with it on and off.
``plan_cache_path`` warm-starts the plan cache at construction
(:func:`repro_torch.core.autotune.load_plans`; a file of another
substrate is skipped with a message) and :meth:`save_plan_cache` saves
it.

Failure model (:mod:`repro_torch.serving.resilience`, the JAX engine's):
requests fail one at a time while the batch keeps decoding.  Deadlines
(``deadline_ms``, the engine's default or a ``Request``'s own) cancel a
late request with its partial output (status ``"deadline"``); load
shedding (``shed_queue_depth``, ``shed_token_watermark``) rejects at
``submit`` with :class:`~repro_torch.serving.resilience.Shed`; NaN/inf
logits quarantine their slot alone (``"poisoned"``); a head request that
can never fit ends ``"capacity"``.  ``fault=`` threads a deterministic
:class:`~repro_torch.serving.resilience.FaultInjector` through the step,
chunk and logit hooks and pins the pipeline to depth 1 while it is armed;
a poisoned row is a constant, so the host derives its finite flag and
token (JAX's ``_sample``) and writes the token into the carried buffer
with a staged copy, outside the captured graph, which is never captured
again or branched.  Only a :class:`~repro_torch.serving.resilience.
RequestError` raised in a prefill chunk is contained to its request; any
other exception (a kernel that fails to build or launch, a CUDA error)
propagates and fails the run.  ``watchdog_s`` arms a
:class:`~repro_torch.distributed.fault.StepWatchdog` around every step;
``snapshot()``/``restore()`` carry the host state across a supervised
restart (:func:`~repro_torch.serving.resilience.serve_with_recovery`),
and ``restore(cache=)`` adopts the dying engine's cache before any graph
is captured, so re-admitted requests alias its published pages;
``prefix_index_path`` loads the pool's page index at start and saves it
at the end of :meth:`run`.  ``clock`` replaces ``time.monotonic`` for
every host timestamp.  Not ported yet, and refused with
``NotImplementedError`` rather than ignored: speculation on a config with
a MoE layer (A13).

The grouped decode q/k/v (``grouped_qkv``) defaults as in JAX: on with the
kernel backend.  Then every attention layer gains a prestacked
(3, D, Nmax) ``qkv`` weight (:func:`_stack_decode_qkv`) and the decode
step projects q/k/v as ONE grouped GEMM (B3) over it, whenever
:func:`repro_torch.models.attention.grouped_decode` says the path takes
it (the graph path under the MTE policy).

Weights: the engine keeps the projection weights, and the embedding table
when the compute dtype equals the operand dtype, already cast to the
format's operand dtype (every GEMM casts them to it anyway, so the values
are identical), and a widened copy of the operand-rounded LM head (the
tied table, or an untied model's own head) — the bf16 weights a decode
step reads are then the only weight bytes it moves.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
import weakref
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.geometry import cdiv
from repro_torch.kernels import build
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_lib
from repro_torch.models.layers import (compute_dtype, model_format,
                                       unembed_operand_dtype)
from repro_torch.distributed.fault import StepWatchdog
from repro_torch.serving.kv_cache import page_prefix_hashes
from repro_torch.serving.resilience import (CapacityExceeded,
                                            DeadlineExceeded, FaultInjector,
                                            PoisonedOutput, RequestError,
                                            Response, Shed)
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.telemetry import gemm_account, tracing
from repro_torch.telemetry.registry import publish
from repro_torch.telemetry.registry import registry as metrics_registry

__all__ = ["Request", "ServingEngine", "DecodeStep", "SpecStep",
           "HostStaging", "greedy_accepted", "serving_params"]


def _draft_widths(cfg: ArchConfig):
    """What a weight-shared draft must have of its target's config."""
    return (cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.window, cfg.rglru, cfg.ssm, cfg.period)


def _stack_decode_qkv(params):
    """Precompute the grouped decode-projection layout
    (``engine.py:136-163`` of the JAX package): every attention mixer
    gains a stacked (3, D, Nmax) ``qkv`` weight
    (:func:`repro_torch.graph.stack_group_weights`, the same stacking the
    GroupNode path executes), so the decode step reads the grouped operand
    directly instead of re-padding q/k/v on every step; prefill ignores
    the extra leaf.  Shallow copies; the caller's tree is untouched."""
    from repro_torch.graph import stack_group_weights

    def aug_layer(lp):
        m = lp.get("mixer")
        if not (isinstance(m, dict) and {"q", "k", "v"} <= m.keys()):
            return lp
        m = dict(m)
        m["qkv"] = stack_group_weights([m["q"]["w"], m["k"]["w"],
                                        m["v"]["w"]])
        return {**lp, "mixer": m}

    return {**params, "layers": [aug_layer(lp) for lp in params["layers"]]}


# A MoE layer's bare expert tensors (``models/moe.py``): (E, D, F) and
# (E, F, D).
_EXPERT_LEAVES = ("gate", "up", "down")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    format_policy: Optional[str] = None  # per-request prefill precision
    deadline: Optional[float] = None     # read by DeadlineScheduler
    deadline_ms: Optional[float] = None  # completion deadline from submit
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def serving_params(params, cfg: ArchConfig):
    """The parameter tree the engine serves from: dense weights (every
    ``{"w", ...}`` leaf) and a MoE layer's expert tensors (``gate``,
    ``up``, ``down``) cast to the model format's operand dtype (float
    formats only: int8 quantizes the full-precision weights at every
    call, as JAX serves them), the embedding table likewise when the
    compute dtype is that operand dtype, and ``embedding["unembed"]`` =
    the LM head -- the tied table, or the untied ``head`` in its
    (d_model, vocab) layout, which the copy then drops -- rounded to the
    head's operand dtype and widened to f32.  A MoE ``router`` stays at
    its own width: JAX routes through its f32 value, and a rounded
    router would route other experts.  Shallow copies; the caller's
    tensors are untouched."""
    fmt = model_format(cfg)
    op = fmt.operand_torch
    cast_w = not fmt.quantized

    def cast(group, name, leaf):
        # Dense projections and the experts only: the RG-LRU and SSD
        # mixers' bare tensors (conv_w, conv_b, lam, A_log, ...) pass
        # through and are widened to f32 at use, as in JAX, and so does
        # the router.
        if not cast_w:
            return leaf
        if isinstance(leaf, dict) and "w" in leaf:
            return {**leaf, "w": leaf["w"].to(op)}
        if group == "ffn" and name in _EXPERT_LEAVES:
            return leaf.to(op)
        return leaf

    def layer(lp):
        out = dict(lp)
        for group in ("mixer", "ffn"):
            if group in lp:      # an SSD layer has no ffn
                out[group] = {name: cast(group, name, leaf)
                              for name, leaf in lp[group].items()}
        return out

    emb = dict(params["embedding"])
    table = emb["table"]
    head = table if cfg.tied_embeddings else emb.pop("head")
    emb["unembed"] = head.to(unembed_operand_dtype(cfg)).float()
    if cast_w and compute_dtype(cfg) == op:
        emb["table"] = table.to(op)
    return {"embedding": emb,
            "layers": [layer(lp) for lp in params["layers"]],
            "final_norm": params["final_norm"]}


class HostStaging:
    """The engine's host ↔ device copies, none of which blocks the host.

    On a CUDA device a host array goes to the device through a pinned
    buffer and ``copy_(non_blocking=True)``: the host has written the
    buffer before the copy is enqueued, and the copy may run much later
    (step N+1's prefill chunks are enqueued before step N retires).  So
    each pinned buffer carries the event recorded after its copy, and the
    host rewrites only a buffer whose event has completed — it takes the
    first free one of a ring per (shape, dtype) and adds a buffer when
    none is free, so it never waits.  Device results come back the same
    way (:meth:`fetch`): a non-blocking copy into pinned buffers and an
    event, which :meth:`wait` waits on — the one host sync of a step.
    On the CPU there is nothing to pin: plain tensors, copied at once."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self._rings: Dict[tuple, List[tuple]] = {}
        self._spare: Dict[tuple, List[torch.Tensor]] = {}

    def to_device(self, array: np.ndarray,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``array`` on the device: into ``out`` when given, else into a
        new tensor."""
        host = torch.from_numpy(np.array(array))
        if not self.pinned:
            return host if out is None else out.copy_(host)
        ring = self._rings.setdefault((host.shape, host.dtype), [])
        for buf, done in ring:
            if done.query():
                break
        else:
            buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            done = torch.cuda.Event()
            ring.append((buf, done))
        buf.copy_(host)
        if out is None:
            out = torch.empty_like(host, device=self.device)
        out.copy_(buf, non_blocking=True)
        done.record()
        return out

    def fetch(self, *tensors: torch.Tensor):
        """Start copying ``tensors`` to the host; → a handle for
        :meth:`wait`."""
        if not self.pinned:
            return [t.numpy().copy() for t in tensors], None
        bufs = []
        for t in tensors:
            spare = self._spare.setdefault((t.shape, t.dtype), [])
            buf = (spare.pop() if spare else
                   torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
            buf.copy_(t, non_blocking=True)
            bufs.append(buf)
        done = torch.cuda.Event()
        done.record()
        return bufs, done

    def wait(self, handle) -> List[np.ndarray]:
        """The fetched tensors as numpy arrays, once their copy is done."""
        bufs, done = handle
        if done is None:
            return bufs
        done.synchronize()
        out = [b.numpy().copy() for b in bufs]
        for b in bufs:
            self._spare[(b.shape, b.dtype)].append(b)
        return out


class DecodeStep:
    """The engine's batched decode + sample over its fixed slots (the
    JAX engine's ``jax.jit`` of ``decode_and_sample``,
    ``src/repro/serving/engine.py:318``).

    It reads static device buffers, written by :meth:`stage` before each
    call: the carried (slots, 1) token buffer (which the step itself
    updates), ``pos``, ``page_table``, ``temps`` and ``active`` (also the
    stateful archs' ``row_valid``); parameters and cache are updated in
    place.  With ``graph=True`` each sampling variant (all-greedy,
    sampled) is captured once as a CUDA graph at its first call and
    replayed after; its outputs ``tok``, ``finite`` and ``logits`` live
    in the graph's memory pool.  Before the capture it runs once eagerly
    on the capture stream (plans, compiled programs, kernel attributes,
    cuBLAS's workspace) with every row inactive: page-table rows all −1
    (the writes land in the null page 0) and ``active`` all False, so no
    live KV, ring or RG-LRU row changes; the generator's state is put
    back after it, so a sampled replay draws what the eager step would.
    A replay adds the launches its capture recorded to the counters
    (:func:`repro_torch.kernels.build.capturing`); a per-GEMM accountant
    records the capture's dispatches once (:func:`_capture`)."""

    def __init__(self, engine: "ServingEngine", *, graph: bool):
        dev = engine.device
        if graph and dev.type != "cuda":
            raise ValueError(f"DecodeStep: a CUDA graph needs a CUDA "
                             f"device, not {dev}")
        slots, maxp = engine.slots, engine.sched.max_pages_per_seq
        # A proxy, not a reference: the engine holds this step, and a
        # cycle would keep a dropped engine's device memory until the
        # cycle collector ran.
        self.engine = weakref.proxy(engine)
        self.graph = graph
        self.tokens = engine._last_tok
        self.pos = torch.zeros(slots, dtype=torch.int64, device=dev)
        self.page_table = torch.full((slots, maxp), -1, dtype=torch.int32,
                                     device=dev)
        self.temps = torch.zeros(slots, dtype=torch.float32, device=dev)
        self.active = torch.zeros(slots, dtype=torch.bool, device=dev)
        self.graphs: Dict[bool, tuple] = {}

    def stage(self, pos, page_table, temps, active) -> None:
        """Write one step's host inputs into the static buffers."""
        stage = self.engine._stage
        stage.to_device(np.asarray(pos, np.int64), out=self.pos)
        stage.to_device(np.asarray(page_table, np.int32),
                        out=self.page_table)
        stage.to_device(np.asarray(temps, np.float32), out=self.temps)
        stage.to_device(np.asarray(active, bool), out=self.active)

    def eager(self, sampled: bool):
        """One eager call: → (tok, finite, logits)."""
        eng = self.engine
        batch = {"tokens": self.tokens, "pos": self.pos,
                 "page_table": self.page_table}
        if eng._stateful_rows:
            batch["row_valid"] = self.active
        tok, finite, logits, _, eng.cache = model_lib.decode_and_sample(
            eng.params, batch, eng.cache, eng.cfg, generator=eng._gen,
            temperatures=self.temps, active_rows=self.active,
            sampled=sampled)
        return tok, finite, logits

    def __call__(self, sampled: bool):
        """One step over the staged inputs: a replay of the variant's
        graph (captured first if needed), or an eager call."""
        if not self.graph:
            return self.eager(sampled)
        if sampled not in self.graphs:
            self.capture(sampled)
        graph, outputs, delta = self.graphs[sampled]
        graph.replay()
        build.add_launches(delta)
        return outputs

    def warm_up(self, sampled: bool):
        """One eager call with every row inactive (see the class)."""
        self.page_table.fill_(-1)
        self.pos.zero_()
        self.temps.zero_()
        self.active.fill_(False)
        return self.eager(sampled)

    def capture(self, sampled: bool) -> None:
        """Warm up, then capture the variant (:func:`_capture`).  Raises
        if the capture fails."""
        self.graphs[sampled] = _capture(
            self.engine.device,
            (self.pos, self.page_table, self.temps, self.active),
            lambda: self.warm_up(sampled), lambda: self.eager(sampled),
            self.engine._gen if sampled else None)


# One side stream per device for every capture: PyTorch keeps a cuBLAS
# workspace for each stream a product has run on, for the life of the
# process, so a fresh stream per capture would hold one more each time.
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture(device, staged, warm_up, run, generator=None):
    """Capture ``run()`` as a CUDA graph on the device's capture stream,
    after an eager ``warm_up()`` on the same stream (plans, compiled
    programs, kernel attributes, cuBLAS's workspace).  The ``staged``
    input buffers, which the warm-up overwrites, are put back after
    both, and so is the state of ``generator``, which the graph
    registers: a sampled replay draws what the eager call would.  The
    warm-up runs under :func:`repro_torch.telemetry.gemm_account.suppress`,
    so an installed accountant records the capture's dispatches once.
    → (graph, the outputs of ``run``, the launches the capture
    recorded).  Raises if the capture fails."""
    saved = [buf.clone() for buf in staged]
    state = None if generator is None else generator.get_state()
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    side = _CAPTURE_STREAMS[device]
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), gemm_account.suppress():
        warm_up()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        generator.set_state(state)
        graph.register_generator_state(generator)
    with build.capturing() as delta:
        with torch.cuda.graph(graph, stream=side):
            outputs = run()
    for buf, value in zip(staged, saved):
        buf.copy_(value)
    return graph, outputs, delta


def greedy_accepted(argmax: torch.Tensor,
                    proposals: torch.Tensor) -> torch.Tensor:
    """Per row, how many leading proposals (B, k − 1) the target's argmax
    tokens (B, k) agree with: the j of :meth:`ServingEngine._accept`'s
    greedy branch, which then emits ``argmax[:j + 1]``."""
    agree = (argmax[:, :-1] == proposals).to(torch.int64)
    return agree.cumprod(dim=1).sum(dim=1)


# Which model a family of the speculative step runs: the target's verify
# and replay windows, the draft's catch-up windows and decode step.
_SPEC_SIDE = {"verify": "target", "replay": "target", "catchup": "draft",
              "draft": "draft"}


class SpecStep:
    """The speculative step's model calls (the JAX engine's jitted
    ``_draft_decode``, ``_draft_verify`` and ``_verify``,
    ``src/repro/serving/engine.py:391-398``), in four families of static
    shapes:

    - ``("verify", k)``: the target's window [e, d_1..d_{k−1}] for k = 2
      up to the engine's largest window; → its logits (slots, k, V), the
      tokens it verified, their f32 argmax (slots, k) int32, finite flags
      (slots, k) and the accepted drafts j of greedy rows
      (:func:`greedy_accepted`);
    - ``("replay", n)``: the target's accepted prefix of n = 1..k − 1
      tokens (stateful archs), last position only;
    - ``("catchup", n)``: the draft fed n = 1..k known tokens, last
      position only; → its last logits (slots, V) and their argmax, which
      it also writes, for the window's rows, into proposal column 0 and
      the draft's token — d_1;
    - ``("draft", 1)``: one draft decode step from the draft's token;
      → logits and argmax, written back into that token for the active
      rows, so greedy steps chain on the device.

    Each family reads static buffers that :meth:`stage` and
    :meth:`stage_tokens` write: per model ``pos``, ``page_table`` and
    ``active`` (also the stateful archs' ``row_valid``; masked rows have
    all-(−1) page-table rows), the last emitted token ``last`` (slots,),
    the proposals ``props`` (slots, spec_k − 1), the draft's token
    ``draft_tok`` (slots, 1), and a token buffer per (catch-up or replay,
    n).  With ``graph=True`` each shape is captured once as a CUDA graph
    at its first call and replayed after, as :class:`DecodeStep` is: an
    eager warm-up with every row inactive on a side stream, the capture
    on the same stream, the staged inputs put back, and each replay
    adding its capture's launches to the counters.  No graph draws random
    numbers (proposals and coins come from the host generator), so
    greedy and sampled steps replay the same graphs: greedy steps chain
    the proposals on the device and fetch once, sampled ones fetch the
    logits each call."""

    def __init__(self, engine: "ServingEngine", *, graph: bool):
        dev = engine.device
        if graph and dev.type != "cuda":
            raise ValueError(f"SpecStep: a CUDA graph needs a CUDA device, "
                             f"not {dev}")
        slots, maxp = engine.slots, engine.sched.max_pages_per_seq
        self.engine = weakref.proxy(engine)
        self.graph = graph

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.inputs = {side: {"pos": zeros(slots),
                              "page_table": torch.full(
                                  (slots, maxp), -1, dtype=torch.int32,
                                  device=dev),
                              "active": zeros(slots, dtype=torch.bool)}
                       for side in ("target", "draft")}
        self.last = zeros(slots)
        self.props = zeros(slots, engine.spec_k - 1)
        self.draft_tok = zeros(slots, 1)
        self.tokens: Dict[tuple, torch.Tensor] = {}
        self.graphs: Dict[tuple, tuple] = {}
        self.captures: Dict[str, int] = collections.Counter()
        self.replays: Dict[str, int] = collections.Counter()

    def stage(self, side: str, pos, page_table, active) -> None:
        """Write one call's rows into the ``"target"`` or ``"draft"``
        buffers."""
        inputs, to_device = self.inputs[side], self.engine._stage.to_device
        to_device(np.asarray(pos, np.int64), out=inputs["pos"])
        to_device(np.asarray(page_table, np.int32), out=inputs["page_table"])
        to_device(np.asarray(active, bool), out=inputs["active"])

    def stage_tokens(self, family: str, tokens) -> None:
        """Write a call's (slots, n) tokens: a catch-up or replay window's
        own buffer, the draft's token (n = 1), or for a verify window
        ``last`` (column 0) and, when given, the proposals."""
        to_device = self.engine._stage.to_device
        tokens = np.asarray(tokens, np.int64)
        if family == "draft":
            to_device(tokens, out=self.draft_tok)
        elif family == "verify":
            to_device(tokens[:, 0], out=self.last)
            if tokens.shape[1] > 1:
                props = np.zeros(tuple(self.props.shape), np.int64)
                props[:, :tokens.shape[1] - 1] = tokens[:, 1:]
                to_device(props, out=self.props)
        else:
            key = (family, tokens.shape[1])
            if key not in self.tokens:
                self.tokens[key] = torch.zeros(
                    tokens.shape, dtype=torch.int64, device=self.last.device)
            to_device(tokens, out=self.tokens[key])

    def eager(self, family: str, n: int) -> Dict[str, torch.Tensor]:
        """One eager call of shape (family, n) over the staged buffers."""
        eng = self.engine
        side = _SPEC_SIDE[family]
        inputs = self.inputs[side]
        if side == "target":
            params, cache, cfg = eng.params, eng.cache, eng.cfg
            stateful = eng._stateful_rows
        else:
            params, cache, cfg = eng.draft_params, eng.draft_cache, \
                eng.draft_cfg
            stateful = eng._draft_stateful
        if family == "verify":
            tokens = torch.cat([self.last[:, None], self.props[:, :n - 1]],
                               dim=1)
        elif family == "draft":
            tokens = self.draft_tok
        else:
            tokens = self.tokens[(family, n)]
        batch = {"tokens": tokens, "pos": inputs["pos"],
                 "page_table": inputs["page_table"]}
        if stateful:
            batch["row_valid"] = inputs["active"]
        if family == "draft":
            logits, _ = model_lib.decode(params, batch, cache, cfg)
        else:
            logits, _ = model_lib.verify_chunk(params, batch, cache, cfg,
                                               last_only=family != "verify")
        if family == "replay":
            return {"logits": logits}
        argmax = logits.argmax(dim=-1)
        if family == "verify":
            return {"logits": logits, "tokens": tokens,
                    "argmax": argmax.to(torch.int32),
                    "finite": torch.isfinite(logits).all(dim=-1),
                    "accepted": greedy_accepted(argmax, tokens[:, 1:])}
        active = inputs["active"]
        if family == "catchup":
            logits, argmax = logits[:, 0], argmax[:, 0]
            for buf in (self.props[:, 0], self.draft_tok[:, 0]):
                buf.copy_(torch.where(active, argmax, buf))
        else:
            self.draft_tok.copy_(torch.where(active[:, None],
                                             argmax[:, None],
                                             self.draft_tok))
        return {"logits": logits, "argmax": argmax}

    def __call__(self, family: str, n: int) -> Dict[str, torch.Tensor]:
        """One call over the staged buffers: a replay of the shape's graph
        (captured first if needed), or an eager call."""
        if not self.graph:
            return self.eager(family, n)
        if (family, n) not in self.graphs:
            self.capture(family, n)
        graph, outputs, delta = self.graphs[(family, n)]
        graph.replay()
        build.add_launches(delta)
        self.replays[family] += 1
        return outputs

    def capture(self, family: str, n: int) -> None:
        """Warm up with every row inactive, then capture the shape
        (:func:`_capture`).  Raises if the capture fails."""
        inputs = self.inputs[_SPEC_SIDE[family]]

        def warm_up():
            inputs["page_table"].fill_(-1)
            inputs["pos"].zero_()
            inputs["active"].fill_(False)
            self.eager(family, n)

        self.graphs[(family, n)] = _capture(
            self.engine.device, list(inputs.values()), warm_up,
            lambda: self.eager(family, n))
        self.captures[family] += 1


class ServingEngine:
    # The speculative step's calls (a subclass may wrap them).
    spec_step_cls = SpecStep

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
                 fault: Optional[FaultInjector] = None,
                 debug_audit: bool = False,
                 watchdog_s: Optional[float] = None,
                 quarantine: bool = True,
                 clock=None,
                 spec_k: int = 0,
                 draft_params=None,
                 draft_config: Optional[ArchConfig] = None,
                 draft_groups: int = 1,
                 draft_format_policy: Optional[str] = None,
                 prefix_index_path: Optional[str] = None,
                 slo_monitor=None,
                 async_steps: bool = True,
                 pipeline_depth: int = 2,
                 cuda_graph: Optional[bool] = None,
                 device=None):
        if cfg.frontend_stub:
            raise NotImplementedError(
                f"ServingEngine: {cfg.name!r} takes frame embeddings "
                f"(frontend_stub), and the engine serves token batches "
                f"only, as the JAX package's does; run it through "
                f"models.model.forward / prefill / decode")
        self.device = resolve_device(device)
        # Warm-start the plan cache before anything plans.  A stale or
        # foreign file (another substrate, the JAX package's) must not
        # stop the engine: it starts cold.
        self.plan_cache_path = plan_cache_path
        if plan_cache_path and os.path.exists(plan_cache_path):
            from repro_torch.core import autotune
            try:
                autotune.load_plans(plan_cache_path, self.device)
            except (ValueError, KeyError, TypeError, OSError,
                    json.JSONDecodeError) as e:
                print(f"plan-cache warm start skipped "
                      f"({plan_cache_path}: {e})")
        if format_policy is not None:
            cfg = dataclasses.replace(cfg, format_policy=format_policy)
        if kv_format is None and cfg.cache_quant:
            kv_format = "int8pt"
        if kv_format is not None:
            from repro_torch.core.formats import resolve_format
            resolve_format(kv_format)
        if grouped_qkv is None:
            grouped_qkv = (cfg.gemm_backend == "kernels"
                           or cfg.decode_qkv_grouped)
        cache_len = cdiv(cache_len, page_size) * page_size
        cfg = dataclasses.replace(cfg, cache_quant=False,
                                  kv_cache_format=kv_format,
                                  decode_qkv_grouped=bool(grouped_qkv))
        self.cfg = cfg
        self.params = serving_params(params, cfg)
        if attn_mod.grouped_decode(cfg):
            self.params = _stack_decode_qkv(self.params)
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
        # Speculation's proposals and acceptance coins are drawn on the
        # host (the JAX engine's key stream, ``engine.py:1258-1345``).
        if self.device.type == "cpu":
            self._host_gen = self._gen
        else:
            self._host_gen = torch.Generator()
            self._host_gen.manual_seed(seed)

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
        # The pool's published page index from an earlier engine (one that
        # kept or handed over the device pages).  A stale, corrupt or
        # mismatched file must not stop the engine: it starts cold.
        self.prefix_index_path = prefix_index_path
        if prefix_index_path and os.path.exists(prefix_index_path):
            try:
                self.sched.pool.load_index(prefix_index_path)
            except (ValueError, KeyError, TypeError, OSError,
                    json.JSONDecodeError) as e:
                print(f"prefix-index warm start skipped "
                      f"({prefix_index_path}: {e})")
        # Ring/recurrent layers keep per-slot rows that a batched decode
        # step must not touch for a slot that is still prefilling: such
        # archs pass the decoding rows as ``row_valid``.
        self._stateful_rows = any(kind[0] != "attn"
                                  for kind in cfg.layer_kinds)
        self._prefilling: Dict[int, dict] = {}
        # The async pipeline (``src/repro/serving/engine.py:304-315``): the
        # in-flight deque is the lagging delivery queue; at depth 2 a
        # step's decode stays launched across the next step's prefill.
        self.async_steps = bool(async_steps)
        self.pipeline_depth = (max(1, int(pipeline_depth))
                               if self.async_steps else 1)
        self._inflight: Deque[dict] = collections.deque()
        self._flushing = False
        self.steps_in_flight_max = 0   # deepest pipeline ever
        self._inflight_peak = 0        # deepest pipeline this step
        self._stage = HostStaging(self.device)
        self._last_tok = torch.zeros((slots, 1), dtype=torch.int32,
                                     device=self.device)
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        self.decode_step = DecodeStep(self, graph=bool(cuda_graph))
        self._init_speculation(spec_k, draft_params, draft_config,
                               draft_groups, draft_format_policy, kv_format,
                               grouped_qkv, bool(cuda_graph))
        # Resilience (repro_torch.serving.resilience).
        self.deadline_ms = deadline_ms
        self.shed_queue_depth = shed_queue_depth
        self.shed_token_watermark = shed_token_watermark
        self.fault = fault
        self.debug_audit = bool(debug_audit)
        self.quarantine = bool(quarantine)
        # An optional repro_torch.telemetry.slo.SloMonitor, observed after
        # every step (host-side registry reads only).
        self.slo_monitor = slo_monitor
        self._clock = clock or time.monotonic
        self.step_idx = 0
        self._deadline_at: Dict[int, float] = {}   # rid -> absolute deadline
        self._responses: Dict[int, Response] = {}
        # Per-request latency bookkeeping: host-clock reads when a token
        # is delivered (already on the host), feeding the serving.*_s
        # histograms and each Response's metrics.
        self._ts_submit: Dict[int, float] = {}
        self._ts_first: Dict[int, float] = {}
        self._ts_last: Dict[int, float] = {}
        self._queue_wait: Dict[int, float] = {}
        self._itl: Dict[int, List[float]] = {}
        self.watchdog_s = watchdog_s
        self._watchdog = None
        if watchdog_s:
            self._watchdog = StepWatchdog(watchdog_s)
            # Its polling thread holds the watchdog, not the engine: stop
            # it when the engine is dropped.
            weakref.finalize(self, self._watchdog.stop)

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
        return self._stage.to_device(np.asarray(rows, np.int32))

    @property
    def steps_in_flight(self) -> int:
        """Distinct engine steps launched but not yet delivered (0: the
        host state is exact)."""
        return len({e["step"] for e in self._inflight})

    # -- client API -----------------------------------------------------------
    def submit(self, req: Request):
        """Queue ``req``; raises :class:`Shed` (and records its
        ``"shed"`` response) when load shedding rejects it."""
        if req.format_policy is not None:
            from repro_torch.core.formats import resolve_format
            resolve_format(req.format_policy)
        err = self._shed_reason(req)
        if err is not None:
            self.sched.shed_requests += 1
            self._responses[req.rid] = Response(
                (), rid=req.rid, status=err.code, error=err)
            tr = tracing.active()
            if tr is not None:
                tr.instant("request.shed", args={"rid": req.rid})
            # The caller gets a twin: a raised error's traceback holds this
            # engine's frames, and the stored Response must not keep the
            # engine (its weights, its graph pools) alive.
            raise type(err)(str(err), rid=req.rid)
        self._ts_submit[req.rid] = self._clock()
        self.sched.submit(req)
        dl = (req.deadline_ms if req.deadline_ms is not None
              else self.deadline_ms)
        if dl is not None:
            self._deadline_at[req.rid] = self._clock() + dl / 1000.0

    def _shed_reason(self, req: Request) -> Optional[Shed]:
        """Load shedding at the door: the queue is already
        ``shed_queue_depth`` deep, or the committed-token demand (active +
        waiting + this request, each booked at ``prefill_len +
        max_tokens``) is over ``shed_token_watermark``."""
        if (self.shed_queue_depth is not None
                and len(self.sched.waiting) >= self.shed_queue_depth):
            return Shed(f"queue depth {len(self.sched.waiting)} >= "
                        f"{self.shed_queue_depth} (rid={req.rid})",
                        rid=req.rid)
        if self.shed_token_watermark is not None:
            demand = (self.sched._committed_tokens(self.prefill_len)
                      + sum(self.prefill_len
                            + int(getattr(e.req, "max_tokens", 0))
                            for e in self.sched.waiting)
                      + self.prefill_len + int(req.max_tokens))
            if demand > self.shed_token_watermark:
                return Shed(f"committed-token demand {demand} > watermark "
                            f"{self.shed_token_watermark} (rid={req.rid})",
                            rid=req.rid)
        return None

    def save_plan_cache(self, path: Optional[str] = None):
        """Save the plan cache for the next process's warm start (to
        ``path``, else ``plan_cache_path``), for this engine's device."""
        from repro_torch.core import autotune
        target = path or self.plan_cache_path
        if target:
            autotune.save_plans(target, self.device)

    def run(self, max_steps: int = 1000) -> Dict[int, Response]:
        """Run until every submitted request finishes (or the step
        budget).  Returns ``rid -> Response``: ``"ok"``, a
        :class:`RequestError` code for a contained failure, or
        ``"incomplete"`` for requests still live at the budget.  With
        ``watchdog_s`` a step past its deadline raises ``StragglerError``
        after it; with ``prefix_index_path`` the pool's index is saved at
        the end."""
        for _ in range(max_steps):
            self._enforce_deadlines()
            with tracing.current().span("admit"):
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
            if self._watchdog is not None:
                self._watchdog.arm()
            self.step()
            if self._watchdog is not None:
                self._watchdog.disarm()
                self._watchdog.check()
        self._flush_pipeline()
        out = dict(self._responses)
        for r in self.queue + [r for r in self.slot_req if r is not None]:
            out[r.rid] = Response(r.output, rid=r.rid, status="incomplete")
        if self.prefix_index_path:
            try:
                self.sched.pool.save_index(self.prefix_index_path)
            except OSError as e:     # best effort, like the plan file
                print(f"prefix-index save skipped "
                      f"({self.prefix_index_path}: {e})")
        return out

    def metrics(self) -> Dict[str, float]:
        """Scheduler counters plus pool sharing state, plan-cache hit
        counts and compiled-program counts."""
        from repro_torch.core import autotune
        from repro_torch.graph import schedule as graph_schedule
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
                 cow_copies=pool.cow_copies,
                 spec_on=int(self._spec_on), spec_k=self.spec_k)
        if self.spec_k_hist:
            steps = sum(self.spec_k_hist.values())
            m["spec_k_mean"] = (sum(k * n for k, n
                                    in self.spec_k_hist.items()) / steps)
        cs = autotune.cache_stats()
        m.update(plan_cache_hits=cs.hits, plan_cache_misses=cs.misses,
                 plan_solver_calls=cs.solver_calls)
        ps = graph_schedule.program_stats()
        m.update(graph_programs_compiled=ps["compiles"],
                 graph_program_hits=ps["hits"])
        publish("serving", m)
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
            sub = self._ts_submit.get(req.rid)
            if sub is not None and req.rid not in self._queue_wait:
                # First admission only: a preempted request re-admits,
                # but its queue wait is the submit -> admit gap.
                wait = self._clock() - sub
                self._queue_wait[req.rid] = wait
                metrics_registry().histogram(
                    "serving.queue_wait_s").observe(wait)
            self.slot_req[slot] = req
            self.slot_pos[slot] = 0
            window = (entry.window if entry.window is not None
                      else self._window_tokens(req))
            self._prefilling[slot] = {
                "tokens": window,
                "chunk": cached_tok // self.prefill_chunk,
                "hashes": entry.hashes,
            }
            if self._spec_on:
                # The draft re-derives the slot's context from this window
                # and the tokens emitted from now on.
                self._slot_window[slot] = window
                self._slot_out0[slot] = len(req.output)
                self._draft_pos[slot] = 0

    def step(self):
        """One engine step (:meth:`_step_impl`), then the per-step
        observability hook (:meth:`_observe_step`)."""
        self._step_impl()
        self._observe_step()

    def _observe_step(self):
        """Publish the pool's and the scheduler's state as gauges and
        evaluate the SLO monitor: registry writes only, never the device
        or a generator, so outputs cannot move."""
        publish("kv", self.sched.pool.describe())
        reg = metrics_registry()
        reg.gauge("serving.queue_depth").set(len(self.sched.waiting))
        reg.gauge("serving.active_slots").set(
            sum(1 for r in self.slot_req if r is not None))
        reg.gauge("serving.completed_requests").set(
            self.sched.completed_requests)
        reg.gauge("serving.cancelled_requests").set(
            self.sched.cancelled_requests)
        reg.gauge("serving.finished_requests").set(
            self.sched.completed_requests + self.sched.cancelled_requests)
        # With async steps the counters above describe the last delivered
        # step; up to pipeline_depth - 1 steps are still in flight.
        reg.gauge("serving.steps_in_flight").set(self._inflight_peak)
        reg.gauge("serving.results_stale_steps").set(self.steps_in_flight)
        if self.slo_monitor is not None:
            self.slo_monitor.observe(step=self.step_idx)

    def _step_impl(self):
        """One engine step, in the JAX engine's order
        (``src/repro/serving/engine.py:721-827``): the fault injector's
        step hook and the deadlines, up to ``prefill_chunk_quota`` prefill
        chunks, the retire of the previous
        step's decode (after the chunks, which its device time overlaps),
        a second admission pass into slots the retire freed, the flush
        boundaries (horizon, speculation, predicted eviction), page growth
        (evicting the youngest request when the pool runs dry),
        copy-on-write, then one batched decode + sample launch, which
        stays in flight at depth 2, or one speculative step of window k
        (:meth:`_spec_depth`), which runs synchronously."""
        self.step_idx += 1
        self._inflight_peak = self.steps_in_flight
        if self.fault is not None:
            # May raise EngineCrash (the supervised restart), sleep through
            # a straggle or arm a page-allocation failure.
            self.fault.step_begin(self.step_idx, pool=self.sched.pool)
        self._enforce_deadlines()
        self._run_prefill_chunks()
        self._drain_to_depth()
        if self.sched.waiting and any(r is None for r in self.slot_req):
            with tracing.current().span("admit"):
                self._admit()
            self._run_prefill_chunks()
        decoding = self._decoding()
        # Horizon boundary: a slot whose launched position reached
        # cache_len finishes at delivery.
        if self._inflight and any(int(self.slot_pos[s]) >= self.cache_len
                                  for s in decoding):
            self._flush_pipeline()
            decoding = self._decoding()
        k_step = self._spec_depth(decoding)
        # Speculation boundary: the draft's windows and the acceptance
        # read every request's output on the host.
        if k_step >= 2 and self._inflight:
            self._flush_pipeline()
            decoding = self._decoding()
            k_step = self._spec_depth(decoding)
        # Eviction boundary: preemption requeues the victim with its
        # host-visible output, so in-flight tokens land first.
        if self._inflight and decoding and self._needs_eviction(decoding,
                                                                k_step):
            self._flush_pipeline()
            decoding = self._decoding()
            k_step = self._spec_depth(decoding)
        with tracing.current().span("evict"):
            for slot in decoding:
                if self.slot_req[slot] is None or slot in self._prefilling:
                    continue
                evicted = self.sched.ensure_decode(
                    slot, int(self.slot_pos[slot]) + k_step)
                for vslot, _ventry in evicted:
                    self._clear_slot(vslot)
        decoding = self._decoding()
        if decoding:
            for slot in decoding:
                self._cow_guard(slot, k_step)
            if k_step >= 2:
                self._spec_step(decoding, k_step)
            else:
                self._launch_decode(decoding)
        self._drain_to_depth()
        if self.debug_audit:
            self.sched.pool.audit()

    def _decoding(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req)
                if r is not None and s not in self._prefilling]

    def _needs_eviction(self, decoding, k_step: int) -> bool:
        """True when growing every decoding slot by ``k_step`` tokens
        would need more pages than the pool can hand out without
        evicting."""
        pool = self.sched.pool
        need = 0
        for slot in decoding:
            entry = self.sched.active.get(slot)
            if entry is None:
                continue
            owned = len(pool.pages_of(entry.arrival))
            want = -(-(int(self.slot_pos[slot]) + k_step) // self.page_size)
            need += max(0, want - owned)
        return need > pool.free_pages

    # -- decode launch / delivery ---------------------------------------------
    def _launch_decode(self, decoding):
        """Stage the step's inputs, launch the decode + sample and queue
        its delivery; nothing here waits for the device.  The token input
        is the carried device buffer, which the previous launch updated."""
        table = np.full((self.slots, self.sched.max_pages_per_seq), -1,
                        np.int32)
        temps = np.zeros(self.slots, np.float32)
        active = np.zeros(self.slots, bool)
        for slot in decoding:
            table[slot] = self.sched.table_row(slot)
            temps[slot] = max(0.0, float(self.slot_req[slot].temperature))
            active[slot] = True
        step = self.decode_step
        # The decode span stays open until the delivery: in an async
        # trace it covers the next step's admit / prefill / sample spans.
        span = tracing.current().span(
            "decode", args={"step": self.step_idx, "rows": len(decoding)})
        span.__enter__()
        step.stage(self.slot_pos, table, temps, active)
        tok, finite, _ = step(bool(temps.any()))
        self._inflight.append({
            "kind": "decode", "step": self.step_idx, "span": span,
            "slots": list(decoding),
            "reqs": {s: self.slot_req[s] for s in decoding},
            "pos_after": {s: int(self.slot_pos[s]) + 1 for s in decoding},
            "fetch": self._stage.fetch(tok, finite),
        })
        for slot in decoding:
            self.slot_pos[slot] += 1
        self._inflight_peak = max(self._inflight_peak, self.steps_in_flight)
        self.steps_in_flight_max = max(self.steps_in_flight_max,
                                       self.steps_in_flight)

    def _drain_to_depth(self):
        """Deliver in-flight results down to the pipeline's depth
        (``src/repro/serving/engine.py:894-923``): at depth 1 everything;
        at depth 2 every entry of an older step, then this step's seeds
        at the head — a first token never lags — so the decode launched
        in this step stays on the device across the next step's prefill
        chunks, and the next launch still sees every delivered finish.
        An armed fault injector pins the depth to 1: its poison fires on
        the host in the step its decode ran."""
        if self.fault is not None or self.pipeline_depth <= 1:
            self._flush_pipeline()
            return
        while self._inflight and self._inflight[0]["step"] < self.step_idx:
            self._retire_one()
        while self._inflight and self._inflight[0]["kind"] == "seed":
            self._retire_one()

    def _flush_pipeline(self):
        """Deliver every launched step, in launch order: the barrier at
        the horizon, before an eviction and at the end of :meth:`run`."""
        if self._flushing:
            return
        self._flushing = True
        try:
            while self._inflight:
                self._retire_one()
        finally:
            self._flushing = False

    def _retire_one(self):
        """Deliver the oldest in-flight entry; its wait on the copy of
        the sampled tokens is the step's one host sync."""
        entry = self._inflight.popleft()
        try:
            if entry["kind"] == "seed":
                self._deliver_seed(entry)
            else:
                self._deliver_decode(entry)
        finally:
            span = entry.get("span")
            if span is not None:
                span.__exit__(None, None, None)

    def _deliver_decode(self, entry):
        tok, finite = self._stage.wait(entry["fetch"])
        if self.fault is not None:
            # Poison overrides a row on the host (JAX's engine.py:964-985):
            # its finite flag and token are derived again, and the token
            # replaces the one the step carried on the device.
            carry = {}
            for slot in entry["slots"]:
                req = entry["reqs"][slot]
                val = self.fault.poison_value(entry["step"], req.rid)
                if val is None:
                    continue
                finite[slot] = bool(np.isfinite(val))
                tok[slot] = self._poisoned_token(val, req)
                if self.slot_req[slot] is req:
                    carry[slot] = int(tok[slot])
            if carry:
                self._carry(carry)
        n_live = 0
        with tracing.current().span("sample"):
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
                self._note_emitted(req, 1)
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
        tok, finite = (int(a.reshape(-1)[0]) for a in
                       self._stage.wait(entry["fetch"]))
        if req.done or self.slot_req[slot] is not req:
            return
        val = (None if self.fault is None
               else self.fault.poison_value(entry["step"], req.rid))
        if val is not None:
            finite = bool(np.isfinite(val))
            tok = self._poisoned_token(val, req)
        if self.quarantine and not finite:
            self._cancel_active(slot, PoisonedOutput(
                f"non-finite prefill logits for rid={req.rid} at step "
                f"{entry['step']}", rid=req.rid))
            return
        req.output.append(tok)
        self._note_emitted(req, 1)
        self._finished(slot)
        if val is not None and self.slot_req[slot] is req:
            self._carry({slot: tok})

    # -- chunked prefill ------------------------------------------------------
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
            try:
                with tracing.current().span("prefill_chunk"):
                    self._advance_prefill(slot)
            except RequestError as e:
                # Contained to this request: its slot and pages free, the
                # others untouched.  Any other exception (a kernel that
                # fails to build or launch, a CUDA error, which is sticky)
                # propagates: JAX's engine wraps it as a RequestError.
                self._cancel_active(slot, e)

    def _advance_prefill(self, slot: int):
        """Run ONE prompt chunk for ``slot`` into its pool pages; the final
        chunk's logits seed the first token (sampled on the device).  With
        a fault injector armed the seed is delivered at once, as JAX's
        engine delivers it inside the chunk, so a poisoned seed's token is
        carried before this step's decode launch."""
        st = self._prefilling[slot]
        req = self.slot_req[slot]
        c = st["chunk"]
        if self.fault is not None:
            self.fault.chunk_fault(self.step_idx, req.rid, c)
        size = self.prefill_chunk
        toks = st["tokens"][c * size:(c + 1) * size]
        batch = {"tokens": self._stage.to_device(toks[None].astype(np.int64)),
                 "page_table": self._table(self.sched.table_row(slot)[None]),
                 "slot": slot}
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
            torch.full((1,), temp, dtype=torch.float32, device=self.device),
            sampled=temp > 0.0)
        self._last_tok[slot, 0] = tok[0]
        self._inflight.append({
            "kind": "seed", "step": self.step_idx, "slots": [slot],
            "reqs": {slot: req}, "fetch": self._stage.fetch(tok, finite),
        })
        self._inflight_peak = max(self._inflight_peak, self.steps_in_flight)
        self.steps_in_flight_max = max(self.steps_in_flight_max,
                                       self.steps_in_flight)
        if self.fault is not None:
            self._flush_pipeline()

    # -- speculative decoding -------------------------------------------------
    #
    # A step of window k (``engine.py:1127-1151`` of the JAX package):
    #   1. draft catch-up: the draft is fed every known token it has not
    #      seen (the admission window through its prefill chunks, then
    #      windows of at most k tokens through its verify_chunk); the
    #      last logits propose d_1;
    #   2. rollback point of the draft's ring and RG-LRU rows, then k − 2
    #      draft decode steps propose d_2..d_{k-1};
    #   3. ONE target verify_chunk scores [e, d_1..d_{k-1}] (e the last
    #      emitted token, at slot_pos) with M = slots·k rows;
    #   4. acceptance: greedy keeps drafts while the target's argmax
    #      agrees and emits the argmax at the first mismatch; sampled
    #      rows run rejection sampling;
    #   5. rollback: rejected positions are rewound, never freed; ring and
    #      RG-LRU rows are restored and the accepted prefix replayed.
    def _init_speculation(self, spec_k, draft_params, draft_config,
                          draft_groups, draft_format_policy, kv_format,
                          grouped_qkv, graph):
        """The draft config, its parameters, its slot-private page
        stripes and cache (``engine.py:343-401`` of the JAX package).
        Without ``draft_params`` the draft is the target's own first
        layers, so a ``draft_config`` must then be a truncation of the
        target (its widths, and its pattern over its depth)."""
        slots = self.slots
        self.spec_k = int(spec_k or 0)
        if self.spec_k > 0 and any(ffn == "moe"
                                   for _, ffn in self.cfg.layer_kinds):
            raise NotImplementedError(
                f"ServingEngine: speculative decoding on {self.cfg.name!r}, "
                f"a config with MoE layers, is queued (ROADMAP A13: a "
                f"verify window routes its slots x k tokens at their own "
                f"capacity, which no test holds to JAX's yet)")
        self._spec_on = self.spec_k >= 2
        self.draft_cfg: Optional[ArchConfig] = None
        self.draft_params = None
        self.spec_k_hist: Dict[int, int] = {}   # window k -> steps
        self._slot_window: Dict[int, np.ndarray] = {}
        self._slot_out0: Dict[int, int] = {}
        self._draft_pos = np.zeros(slots, np.int32)
        if not self._spec_on:
            return
        cfg = self.cfg
        if draft_config is not None:
            dcfg = draft_config
        else:
            dfmt = (draft_format_policy if draft_format_policy is not None
                    else cfg.format_policy)
            dcfg = cfg.draft(draft_groups, format_policy=dfmt)
        dcfg = dataclasses.replace(dcfg, cache_quant=False,
                                   kv_cache_format=kv_format,
                                   decode_qkv_grouped=bool(grouped_qkv))
        if draft_params is None:
            if _draft_widths(dcfg) != _draft_widths(cfg) or (
                    dcfg.layer_kinds
                    != cfg.layer_kinds[:len(dcfg.layer_kinds)]):
                raise ValueError(
                    f"draft_config {dcfg.name!r} without draft_params: "
                    f"the draft shares the target's layers, so its widths "
                    f"and layer pattern must be the target's "
                    f"({cfg.name!r})")
            # The target's own layers, already cast and qkv-stacked.
            draft_params = model_lib.draft_from(
                self.params, cfg, groups=dcfg.n_layers // dcfg.period)
        else:
            draft_params = serving_params(draft_params, dcfg)
            if attn_mod.grouped_decode(dcfg):
                draft_params = _stack_decode_qkv(draft_params)
        self.draft_cfg = dcfg
        self.draft_params = draft_params
        self._draft_stateful = any(kind[0] != "attn"
                                   for kind in dcfg.layer_kinds)
        # Slot-private page stripes, no pool and no sharing: slot i owns
        # pages [1 + i*maxp, 1 + (i+1)*maxp).
        maxp = self.sched.max_pages_per_seq
        self._draft_table = (1 + np.arange(slots * maxp, dtype=np.int32)
                             ).reshape(slots, maxp)
        self.draft_cache = model_lib.init_paged_cache(
            dcfg, slots, self.cache_len, num_pages=slots * maxp + 1,
            page_size=self.page_size, device=self.device)
        self.spec_step = self.spec_step_cls(self, graph=graph)

    def _spec_depth(self, decoding) -> int:
        """This step's window k, clamped as the JAX engine's
        (``engine.py:1152-1172``): ``spec_k``, the scheduler's ``spec_k``
        policy, each slot's room to the horizon, and the largest window
        whose extra pages every decoding slot can take from the free
        list: speculation never evicts, a full pool degrades the step to
        k = 1."""
        if not self._spec_on or not decoding:
            return 1
        k = self.spec_k
        cap = self.sched.spec_k(len(decoding))
        if cap is not None:
            k = min(k, int(cap))
        for slot in decoding:
            k = min(k, self.cache_len - int(self.slot_pos[slot]))
        while k >= 2 and self._needs_eviction(decoding, k):
            k -= 1
        return max(1, k)

    def _known_tokens(self, slot: int) -> np.ndarray:
        """Every token whose position is settled for ``slot``: the
        admission window (positions [0, prefill_len)) and the tokens
        emitted since the admission; the last sits at ``slot_pos``.  (The
        JAX engine appends the whole output, which double-counts the
        output a resumed request's window already holds.)"""
        out = self.slot_req[slot].output[self._slot_out0[slot]:]
        return np.concatenate([self._slot_window[slot],
                               np.asarray(out, np.int32)])

    def _rows(self, rows, *, draft: bool) -> tuple:
        """The (slots, max_pages) page table of ``rows``, in the draft's
        page stripes or the target's pool (the other rows −1), and their
        (slots,) mask."""
        table = np.full((self.slots, self.sched.max_pages_per_seq), -1,
                        np.int32)
        active = np.zeros(self.slots, bool)
        for s in rows:
            table[s] = (self._draft_table[s] if draft
                        else self.sched.table_row(s))
            active[s] = True
        return table, active

    def _fetch(self, *tensors) -> List[np.ndarray]:
        """``tensors`` on the host: one copy through pinned buffers, one
        sync."""
        return self._stage.wait(self._stage.fetch(*tensors))

    def _spec_sampled(self, decoding) -> bool:
        """The step's variant: sampled when any decoding request samples
        (the host draws its proposals and coins), else all-greedy."""
        return any(self.slot_req[s].temperature > 0.0 for s in decoding)

    def _draft_catchup(self, decoding, k,
                       sampled: bool) -> Dict[int, np.ndarray]:
        """Advance the draft to every known token; the last logits propose
        d_1.  A fresh slot prefills its window through the draft's chunks;
        the rest is fed in batched windows of at most k known tokens
        (grouped by the shortest remainder, the other rows masked) through
        the ``("catchup", n)`` shapes, which leave each row's d_1 on the
        device.  → per-slot last logits when ``sampled``, else {}."""
        for slot in decoding:
            if int(self._draft_pos[slot]) == 0:
                window = self._slot_window[slot]
                table = self._table(self._draft_table[slot][None])
                size = self.prefill_chunk
                for c in range(self.n_chunks):
                    toks = window[c * size:(c + 1) * size]
                    model_lib.prefill_chunk(
                        self.draft_params,
                        {"tokens": self._stage.to_device(
                            toks[None].astype(np.int64)),
                         "page_table": table, "slot": slot},
                        self.draft_cache, self.draft_cfg, pos0=c * size)
                self._draft_pos[slot] = self.prefill_len
        spec = self.spec_step
        last: Dict[int, np.ndarray] = {}
        known = {s: self._known_tokens(s) for s in decoding}
        while True:
            rem = {s: len(known[s]) - int(self._draft_pos[s])
                   for s in decoding if len(known[s]) > self._draft_pos[s]}
            if not rem:
                return last
            length = min(min(rem.values()), k)
            rows = sorted(rem)
            tokens = np.zeros((self.slots, length), np.int64)
            pos = np.zeros(self.slots, np.int64)
            for s in rows:
                dp = int(self._draft_pos[s])
                tokens[s] = known[s][dp:dp + length]
                pos[s] = dp
            spec.stage("draft", pos, *self._rows(rows, draft=True))
            spec.stage_tokens("catchup", tokens)
            out = spec("catchup", length)
            logits = self._fetch(out["logits"])[0] if sampled else None
            for s in rows:
                self._draft_pos[s] += length
                if sampled and int(self._draft_pos[s]) == len(known[s]):
                    last[s] = logits[s]

    def _categorical(self, probs: np.ndarray) -> int:
        if not np.isfinite(probs).all():
            # A poisoned row (NaN/inf logits): the device sampler's token.
            return int(np.argmax(probs))
        return int(torch.multinomial(torch.as_tensor(probs), 1,
                                     generator=self._host_gen))

    def _propose(self, logits: np.ndarray, req: Request) -> int:
        """One draft proposal: the argmax for a greedy request, else a
        draw from the draft's tempered distribution (rejection sampling
        divides by the distribution it was drawn from)."""
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        return self._categorical(self._softmax(logits / req.temperature))

    def _draft_propose(self, decoding, k, sampled: bool):
        """k − 1 proposals per decoding slot.  → (proposals, the draft
        logits each was drawn from, the draft's rollback point: clones of
        its ring and RG-LRU rows after the catch-up, or None).  All-greedy
        steps leave the proposals on the device (``spec_step.props``: each
        draft step's argmax chained into the next) and return None for
        the first two; ``_draft_pos`` stays at the catch-up position until
        the acceptance is known."""
        spec = self.spec_step
        last = self._draft_catchup(decoding, k, sampled)
        snapshot = (self._snapshot_rows(self.draft_cache, decoding)
                    if self._draft_stateful else None)
        table, active = self._rows(decoding, draft=True)
        base = np.where(active, self._draft_pos, 0).astype(np.int64)
        if not sampled:
            for i in range(k - 2):
                spec.stage("draft", base + active * i, table, active)
                spec("draft", 1)
                spec.props[:, i + 1].copy_(spec.draft_tok[:, 0])
            return None, None, snapshot
        proposals = {s: [] for s in decoding}
        dlogits = {s: [] for s in decoding}
        cur = last
        for i in range(k - 1):
            for s in decoding:
                proposals[s].append(self._propose(cur[s], self.slot_req[s]))
                dlogits[s].append(cur[s])
            if i == k - 2:
                break
            tokens = np.zeros((self.slots, 1), np.int64)
            for s in decoding:
                tokens[s, 0] = proposals[s][-1]
            spec.stage("draft", base + active * i, table, active)
            spec.stage_tokens("draft", tokens)
            logits = self._fetch(spec("draft", 1)["logits"])[0]
            cur = {s: logits[s] for s in decoding}
        return proposals, dlogits, snapshot

    @staticmethod
    def _softmax(x: np.ndarray) -> np.ndarray:
        x = x - x.max()
        e = np.exp(x)
        return e / e.sum()

    def _accept(self, logits: np.ndarray, proposals, dlogits, req: Request):
        """The tokens one slot emits from its (k, V) target logits:
        → (emit, j), j accepted drafts and one target token (j + 1 ≥ 1).
        Greedy: accept while the target's argmax agrees; the first
        disagreement emits the argmax, the token vanilla decode gives
        (verify row i equals the decode step's bits).  Sampled: accept d
        with probability min(1, p_t(d)/p_d(d)), else draw from the
        normalised residual max(0, p_t − p_d): the emitted token's
        marginal is p_t whatever the draft.  (All-greedy steps take the
        greedy branch on the device: :func:`greedy_accepted`.)"""
        k = len(proposals) + 1
        emit: List[int] = []
        if req.temperature <= 0.0:
            for i in range(k - 1):
                t = int(np.argmax(logits[i]))
                emit.append(t)
                if t != proposals[i]:
                    return emit, i
            emit.append(int(np.argmax(logits[k - 1])))
            return emit, k - 1
        temp = req.temperature
        for i in range(k - 1):
            pt = self._softmax(logits[i] / temp)
            pd = self._softmax(dlogits[i] / temp)
            d = proposals[i]
            coin = float(torch.rand((), generator=self._host_gen))
            if coin < min(1.0, float(pt[d]) / max(float(pd[d]), 1e-30)):
                emit.append(d)
                continue
            res = np.maximum(pt - pd, 0.0)
            if res.sum() <= 0.0:
                res = pt
            emit.append(self._categorical(res / res.sum()))
            return emit, i
        emit.append(self._categorical(self._softmax(logits[k - 1] / temp)))
        return emit, k - 1

    def _spec_step(self, decoding, k):
        """One draft-and-verify step of window k over the decoding slots
        (``engine.py:1348-1455`` of the JAX package).  All-greedy steps
        fetch once: the target's argmax tokens, its finite flags and each
        row's accepted drafts."""
        sampled = self._spec_sampled(decoding)
        with tracing.current().span("draft"):
            proposals, dlogits, draft_snap = self._draft_propose(
                decoding, k, sampled)
        target_snap = (self._snapshot_rows(self.cache, decoding)
                       if self._stateful_rows else None)
        tokens = np.zeros((self.slots, k if sampled else 1), np.int64)
        pos = np.zeros(self.slots, np.int64)
        for s in decoding:
            tokens[s, 0] = self.slot_req[s].output[-1]  # at slot_pos
            if sampled:
                tokens[s, 1:] = proposals[s]
            pos[s] = self.slot_pos[s]
        spec = self.spec_step
        with tracing.current().span("verify"):
            spec.stage("target", pos, *self._rows(decoding, draft=False))
            spec.stage_tokens("verify", tokens)
            out = spec("verify", k)
            if sampled:
                logits, finite = self._fetch(out["logits"], out["finite"])
            else:
                argmax, finite, accepted = self._fetch(
                    out["argmax"], out["finite"], out["accepted"])
        self.spec_k_hist[k] = self.spec_k_hist.get(k, 0) + 1
        if self.fault is not None:
            # Poison overrides a slot's k rows (JAX's engine.py:1372-1377),
            # on the host: greedy rows take the constant row's argmax and
            # accept the proposals that agree with it.
            poison = {}
            for s in decoding:
                val = self.fault.poison_value(self.step_idx,
                                              self.slot_req[s].rid)
                if val is not None:
                    poison[s] = val
            if poison and not sampled:
                verified = self._fetch(out["tokens"])[0]
            for s, val in poison.items():
                finite[s] = bool(np.isfinite(val))
                if sampled:
                    logits[s] = val
                    continue
                t = self._poisoned_token(val, self.slot_req[s])
                argmax[s] = t
                accepted[s] = int(np.cumprod(verified[s, 1:] == t).sum())
        if self.quarantine:
            healthy = []
            for s in decoding:
                if finite[s].all():
                    healthy.append(s)
                else:
                    req = self.slot_req[s]
                    self._cancel_active(s, PoisonedOutput(
                        f"non-finite logits for rid={req.rid} at step "
                        f"{self.step_idx}", rid=req.rid))
            decoding = healthy
        drafted = accepted_total = emitted = 0
        partial: Dict[int, int] = {}       # slot -> accepted prefix + 1
        carried: Dict[int, int] = {}       # slot -> last emitted token
        sample_span = tracing.current().span("sample")
        sample_span.__enter__()
        for s in decoding:
            req = self.slot_req[s]
            if sampled:
                emit, j = self._accept(logits[s], proposals[s], dlogits[s],
                                       req)
            else:
                j = int(accepted[s])
                emit = argmax[s, :j + 1].tolist()
            drafted += k - 1
            accepted_total += j
            n_emit = 0
            for t in emit:
                req.output.append(int(t))
                self.slot_pos[s] += 1
                emitted += 1
                n_emit += 1
                if (len(req.output) >= req.max_tokens
                        or (req.eos_id is not None
                            and int(t) == req.eos_id)):
                    break
            # Before _finished, which pops the request's timing state.
            self._note_emitted(req, n_emit)
            done = self._finished(s)
            if not done and int(self.slot_pos[s]) >= self.cache_len:
                self._record_done(req)
                self.slot_req[s] = None
                self.slot_pos[s] = 0
                self.sched.release(s, finished=True)
                done = True
            if done:
                self._draft_pos[s] = 0
                self._slot_window.pop(s, None)
                continue
            carried[s] = req.output[-1]
            if j == k - 1:
                # Everything verified was real: the draft saw d_1..d_{k-2}.
                self._draft_pos[s] += k - 2
            else:
                partial[s] = j + 1
        sample_span.__exit__(None, None, None)
        if carried:
            # A later k = 1 step (a graph replay) chains from the carried
            # token buffer: it must hold what speculation emitted.
            self._carry(carried)
        if partial and draft_snap is not None:
            self._restore_rows(draft_snap, list(partial))
        if partial and target_snap is not None:
            self._restore_rows(target_snap, list(partial))
            self._replay(partial)
        self.sched.note_spec_step(len(decoding), drafted, accepted_total,
                                  emitted)

    def _snapshot_rows(self, cache, rows):
        """The rollback point of ``rows`` (JAX keeps the old cache,
        ``engine.py:1270``, ``:1352``): a clone of those rows of every
        ring and RG-LRU leaf; paged slabs need none (their rollback is
        positional)."""
        index = {r: i for i, r in enumerate(rows)}
        idx = self._stage.to_device(np.asarray(rows, np.int64))
        return index, [(leaf, leaf.index_select(0, idx))
                       for layer in cache["layers"] if "k_pages" not in layer
                       for leaf in layer.values()]

    def _restore_rows(self, snapshot, rows) -> None:
        """Put ``rows`` back from a snapshot, in place: the decode step's
        and the speculative step's CUDA graphs hold these tensors'
        addresses (``engine.py:1457-1482`` of the JAX package rebinds the
        cache instead)."""
        index, saved = snapshot
        dst = self._stage.to_device(np.asarray(rows, np.int64))
        src = self._stage.to_device(np.asarray([index[r] for r in rows],
                                               np.int64))
        for leaf, clone in saved:
            leaf[dst] = clone[src]

    def _replay(self, partial: Dict[int, int]):
        """Re-run the accepted prefix [e, d_1..d_j] of partially accepted
        rows through the ``("replay", n)`` shapes (grouped by length, the
        other rows masked), so their ring and RG-LRU rows land where
        sequential decode leaves them; the paged rewrites are
        idempotent."""
        spec = self.spec_step
        for length in sorted(set(partial.values())):
            rows = [s for s, n_real in partial.items() if n_real == length]
            tokens = np.zeros((self.slots, length), np.int64)
            pos = np.zeros(self.slots, np.int64)
            for s in rows:
                tokens[s] = self.slot_req[s].output[-(length + 1):-1]
                pos[s] = int(self.slot_pos[s]) - length
            spec.stage("target", pos, *self._rows(rows, draft=False))
            spec.stage_tokens("replay", tokens)
            spec("replay", length)

    # -- telemetry: per-request latency ----------------------------------------
    def _note_emitted(self, req: Request, n_new: int):
        """``n_new`` tokens of ``req`` just reached the host: the first
        closes its time to first token (and marks ``request.first_token``
        on the trace), later ones feed the inter-token histogram (a
        speculative step's n tokens as n samples of the per-token share of
        its gap)."""
        if n_new <= 0:
            return
        rid = req.rid
        now = self._clock()
        reg = metrics_registry()
        if rid not in self._ts_first:
            self._ts_first[rid] = now
            sub = self._ts_submit.get(rid)
            if sub is not None:
                reg.histogram("serving.ttft_s").observe(now - sub)
            tr = tracing.active()
            if tr is not None:
                tr.instant("request.first_token", args={"rid": rid})
            n_new -= 1
        last = self._ts_last.get(rid)
        if last is not None and n_new > 0:
            gap = (now - last) / n_new
            hist = reg.histogram("serving.inter_token_s")
            samples = self._itl.setdefault(rid, [])
            for _ in range(n_new):
                hist.observe(gap)
                samples.append(gap)
        self._ts_last[rid] = now

    def _request_metrics(self, rid: int, n_tokens: int) -> Dict[str, float]:
        """The latency summary of a request that ended (finished or
        cancelled), for its ``Response.metrics``; pops its timing state
        and observes ``serving.e2e_s``."""
        m: Dict[str, float] = {"tokens": n_tokens}
        now = self._clock()
        sub = self._ts_submit.pop(rid, None)
        first = self._ts_first.pop(rid, None)
        self._ts_last.pop(rid, None)
        wait = self._queue_wait.pop(rid, None)
        itl = self._itl.pop(rid, None)
        if sub is not None:
            m["e2e_s"] = now - sub
            metrics_registry().histogram("serving.e2e_s").observe(
                m["e2e_s"])
        if wait is not None:
            m["queue_wait_s"] = wait
        if sub is not None and first is not None:
            m["ttft_s"] = first - sub
        if itl:
            itl = sorted(itl)
            m["itl_mean_s"] = sum(itl) / len(itl)
            m["itl_p50_s"] = itl[len(itl) // 2]
            m["itl_p99_s"] = itl[min(len(itl) - 1,
                                     int(round(0.99 * (len(itl) - 1))))]
        return m

    # -- request-level containment --------------------------------------------
    def _record_done(self, req: Request, status: str = "ok",
                     error: Optional[RequestError] = None):
        req.done = True
        self._deadline_at.pop(req.rid, None)
        self.completed.append(req)
        self._responses[req.rid] = Response(
            req.output, rid=req.rid, status=status, error=error,
            metrics=self._request_metrics(req.rid, len(req.output)))

    def _cancel_active(self, slot: int, err: RequestError):
        req = self.slot_req[slot]
        if req is None:
            return
        self.sched.cancel(slot)
        self._clear_slot(slot)
        req.done = True
        self._deadline_at.pop(req.rid, None)
        # A caught error's traceback holds this engine's frames: the
        # Response keeps the error without it.
        self._responses[req.rid] = Response(
            req.output, rid=req.rid, status=err.code,
            error=err.with_traceback(None),
            metrics=self._request_metrics(req.rid, len(req.output)))

    def _cancel_waiting(self, entry, err: RequestError):
        self.sched.cancel_waiting(entry)
        req = entry.req
        req.done = True
        self._deadline_at.pop(req.rid, None)
        self._responses[req.rid] = Response(
            req.output, rid=req.rid, status=err.code, error=err,
            metrics=self._request_metrics(req.rid, len(req.output)))

    def _enforce_deadlines(self):
        """Cancel every request, active or waiting, whose deadline has
        passed: its partial output comes back with status ``"deadline"``
        and its slot and pages go to the live batch.  The pipeline is
        flushed first, so the partial output holds every token the
        device already produced."""
        if not self._deadline_at:
            return
        now = self._clock()
        if self._inflight and any(dl <= now
                                  for dl in self._deadline_at.values()):
            self._flush_pipeline()
        for slot, req in enumerate(self.slot_req):
            if (req is not None
                    and self._deadline_at.get(req.rid, now + 1) <= now):
                self._cancel_active(slot, DeadlineExceeded(
                    f"rid={req.rid} missed its deadline after "
                    f"{len(req.output)} tokens", rid=req.rid))
        for entry in list(self.sched.waiting):
            if self._deadline_at.get(entry.rid, now + 1) <= now:
                self._cancel_waiting(entry, DeadlineExceeded(
                    f"rid={entry.rid} missed its deadline in queue",
                    rid=entry.rid))

    # -- crash recovery -------------------------------------------------------
    def _geometry(self) -> Dict[str, object]:
        return {"arch": self.cfg.name, "slots": self.slots,
                "cache_len": self.cache_len,
                "prefill_len": self.prefill_len,
                "page_size": self.page_size,
                "num_pages": self.sched.pool.num_pages,
                "kv_format": self.cfg.kv_cache_format}

    def snapshot(self) -> Dict[str, object]:
        """The host state a restart needs: every live request in arrival
        order with its partial output, the pool's published page
        registrations, the finished responses and the engine's geometry
        (no device tensor: pair it with ``self.cache`` to re-attach the
        surviving KV).  The pipeline is flushed first, so the snapshot
        holds every token the device produced."""
        with tracing.current().span("snapshot"):
            self._flush_pipeline()
            now = self._clock()
            entries = sorted(
                list(self.sched.active.values()) + list(self.sched.waiting),
                key=lambda e: e.arrival)
            reqs = []
            for entry in entries:
                req = entry.req
                dl = self._deadline_at.get(req.rid)
                reqs.append({
                    "rid": req.rid,
                    "prompt": np.asarray(req.prompt, np.int32).tolist(),
                    "output": list(req.output),
                    "max_tokens": req.max_tokens,
                    "temperature": req.temperature,
                    "eos_id": req.eos_id,
                    "format_policy": req.format_policy,
                    "deadline": req.deadline,
                    "deadline_remaining_ms": (
                        None if dl is None
                        else max(0.0, (dl - now) * 1000.0)),
                })
            return {
                "version": 1,
                "geometry": self._geometry(),
                "requests": reqs,
                "published": self.sched.pool.registrations(),
                "responses": {int(rid): {"tokens": list(r),
                                         "status": r.status}
                              for rid, r in self._responses.items()},
            }

    def restore(self, snap: Dict[str, object], *, cache=None):
        """Rebuild a freshly constructed engine from a :meth:`snapshot`:
        finished responses carry over, live requests re-enter the queue
        in arrival order (never shed: they were admitted once) and
        re-prefill their prompt + generated window.  With ``cache`` (the
        dying engine's) this engine adopts it and the snapshot's page
        registrations, so re-admission aliases the published KV through
        the prefix cache.  The adoption must come before any CUDA graph
        is captured: a graph holds the addresses of the cache it was
        captured over.  → self."""
        with tracing.current().span("restore"):
            geo = snap.get("geometry")
            if geo != self._geometry():
                raise ValueError(f"snapshot geometry {geo} does not match "
                                 f"this engine {self._geometry()}")
            if cache is not None:
                spec = self.spec_step if self._spec_on else None
                if self.decode_step.graphs or (spec is not None
                                               and spec.graphs):
                    raise RuntimeError(
                        "restore(cache=): this engine has captured a CUDA "
                        "graph over its own cache; restore into a fresh "
                        "engine")
                leaf = next(iter(cache["layers"][0].values()))
                if leaf.device.type != self.device.type:
                    raise ValueError(f"restore(cache=): the cache is on "
                                     f"{leaf.device}, this engine on "
                                     f"{self.device}")
                self.cache = cache
                self.sched.pool.restore_registrations(
                    snap.get("published", ()))
            for rid, rd in snap.get("responses", {}).items():
                self._responses[int(rid)] = Response(
                    rd["tokens"], rid=int(rid), status=rd["status"])
            for rd in snap.get("requests", ()):
                req = Request(
                    rid=rd["rid"],
                    prompt=np.asarray(rd["prompt"], np.int32),
                    max_tokens=rd["max_tokens"],
                    temperature=rd["temperature"],
                    eos_id=rd["eos_id"],
                    format_policy=rd["format_policy"],
                    deadline=rd["deadline"],
                    output=list(rd["output"]))
                self.sched.submit(req)   # direct: re-admission is never shed
                rem = rd.get("deadline_remaining_ms")
                if rem is not None:
                    self._deadline_at[req.rid] = (self._clock()
                                                  + rem / 1000.0)
        return self

    # -- helpers --------------------------------------------------------------
    def _poisoned_token(self, val: float, req: Request) -> int:
        """The token sampled on the host (JAX's ``_sample``) from a logits
        row poisoned to the constant ``val``: its argmax, 0, for a greedy
        request or a non-finite row (the token the device's sampler gives
        such a row), else a draw from the host generator."""
        row = np.full(self.cfg.vocab, val, np.float32)
        if req.temperature <= 0.0 or not np.isfinite(val):
            return int(np.argmax(row))
        return self._categorical(self._softmax(row / req.temperature))

    def _carry(self, tokens: Dict[int, int]) -> None:
        """Write host-side tokens into the carried buffer ``_last_tok``
        (slot -> token), which the next decode step reads: staged copies
        on the stream, outside every captured graph."""
        rows = self._stage.to_device(np.asarray(list(tokens), np.int64))
        self._last_tok[rows, 0] = self._stage.to_device(
            np.asarray(list(tokens.values()), np.int32))

    def _clear_slot(self, slot: int):
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        self._prefilling.pop(slot, None)
        self._draft_pos[slot] = 0
        self._slot_window.pop(slot, None)

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
        """Duplicate one physical page across every paged layer's slabs
        (ring and RG-LRU layers hold per-slot rows, not pages)."""
        for layer in self.cache["layers"]:
            if "k_pages" not in layer:
                continue
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
