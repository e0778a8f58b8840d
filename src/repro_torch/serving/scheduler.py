"""Continuous-batching scheduler: admit → prefill → decode → evict.

The port's own copy of ``repro/serving/scheduler.py``.  Pure policy +
bookkeeping — no device tensors and no model knowledge.  The
:class:`~repro_torch.serving.engine.ServingEngine` owns params/caches and runs
the compiled steps; it consults this class for every scheduling decision:

- **admission** (:meth:`pop_admit`): strict FIFO over *arrival* order.
  Only the longest-waiting request is ever considered; if the head cannot
  be admitted (no free decode slot, token budget exhausted, or the page
  pool cannot hold its prefill), nothing younger is admitted either.
  Strict FIFO is what makes starvation-freedom a theorem instead of a
  tuning outcome: every completion frees capacity, and the head request
  is first in line for it.  A preempted request keeps its original
  arrival stamp, so it returns to the *front* of the line, not the back.
- **token-budget admission**: ``token_budget`` caps the sum of committed
  token slots (``prefill_len + max_tokens`` per in-flight request) — the
  knob that keeps worst-case KV growth inside the pool.
- **prefix-cached admission**: when the engine supplies a ``hasher``
  (page-aligned content hashes of the request's prefill window, see
  :func:`repro_torch.serving.kv_cache.page_prefix_hashes`), admission aliases
  the longest cached prefix out of the pool instead of recomputing it.
  The usable prefix is capped at a *chunk* boundary no later than
  ``prefill_len − chunk`` — the final chunk is always recomputed because
  its last-position logits seed sampling — and matched pages inside that
  recompute window are re-owned privately (booked as CoW copies by the
  pool) so the rewrite never touches another sharer's pages.
- **growth / preemption** (:meth:`ensure_decode`): before a decode step
  the engine asks for page coverage of every active sequence's next
  token.  When the pool runs dry the *youngest-arrival* active request is
  evicted (pages whose refcount drops to zero are reclaimed, shared ones
  only decremented; request requeued with its stamp) — the victim
  closest to the back of the FIFO line, so eviction never inverts
  fairness.
- **metrics**: per-step occupancy, prefill/decode token counts (computed
  vs prefix-cached), preemptions — the numbers ``benchmarks/run.py``
  reports as the serving-throughput and serving-prefix sections (the
  port's benchmark is ROADMAP A12).

Adding a scheduling policy: subclass and override :meth:`_pick_admit`
(which waiting request next), :meth:`_pick_victim` (who to evict),
and/or :meth:`prefill_chunk_quota` (how many prefill chunks ride along
with each batched decode step — chunks are budgeted like decode tokens);
everything else — budget accounting, pool interaction, metrics — is
policy-agnostic.  :class:`DeadlineScheduler` (earliest-deadline-first
with an aging guard) is the worked example.  See ROADMAP.md "Serving
subsystem".
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.geometry import cdiv
from repro_torch.serving.kv_cache import KVPagePool

__all__ = ["ScheduledRequest", "ContinuousBatchingScheduler",
           "DeadlineScheduler"]


@dataclasses.dataclass
class ScheduledRequest:
    """A request plus its scheduling state (arrival stamp survives
    preemption — it IS the FIFO fairness key)."""

    req: object               # repro_torch.serving.engine.Request
    arrival: int
    preemptions: int = 0
    skipped: int = 0          # admission decisions that bypassed this
    #                           entry while it was the oldest waiting
    #                           (DeadlineScheduler's starvation bound)
    hashes: Optional[List[str]] = None  # page-prefix content hashes of the
    #                                     current prefill window, memoized
    #                                     while the entry waits (the window
    #                                     only changes on preemption, which
    #                                     clears them — see requeue)
    window: Optional[object] = None     # the hashed (prefill_len,) token
    #                                     window itself (engine-owned; saves
    #                                     rebuilding it on admission)

    @property
    def rid(self) -> int:
        return self.req.rid


class ContinuousBatchingScheduler:
    def __init__(self, *, slots: int, max_seq_len: int, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefill_chunk: Optional[int] = None):
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.max_seq_len = cdiv(max_seq_len, page_size) * page_size
        self.max_pages_per_seq = self.max_seq_len // page_size
        if num_pages is None:
            # Roomy default: every slot can grow to max_seq_len (+ null
            # page) — preemption then only triggers under explicit
            # overcommit (smaller num_pages).
            num_pages = self.slots * self.max_pages_per_seq + 1
        self.pool = KVPagePool(num_pages, page_size)
        self.token_budget = token_budget
        # Prefill-chunk size in tokens (None ⇒ the whole prefill window,
        # i.e. monolithic-shaped).  Caps how much cached prefix an
        # admission may alias: the final chunk is always recomputed.
        self.prefill_chunk = prefill_chunk
        self.waiting: List[ScheduledRequest] = []
        self.active: Dict[int, ScheduledRequest] = {}   # slot -> entry
        self._arrival = itertools.count()
        # events: ("submit"|"admit"|"preempt"|"finish", rid) in order —
        # what the fairness tests assert on.
        self.events: List[Tuple[str, int]] = []
        # metrics
        self.decode_steps = 0
        self.active_step_sum = 0
        self.prefill_tokens = 0          # prefill tokens actually computed
        self.cached_prefill_tokens = 0   # prefill tokens served by aliasing
        self.decode_tokens = 0
        self.delivery_lag_sum = 0   # Σ (delivery step − launch step)
        self.preemptions = 0
        self.completed_requests = 0
        self.cancelled_requests = 0   # structured per-request failures
        self.shed_requests = 0        # rejected at submit (engine-counted)
        # speculative decoding (engine reports via note_spec_step)
        self.spec_steps = 0
        self.spec_drafted = 0         # draft tokens offered for verification
        self.spec_accepted = 0        # draft tokens the target accepted
        self.spec_emitted = 0         # tokens emitted by spec steps
        #                               (accepted + resample/bonus)

    def _note_event(self, kind: str, rid: int) -> None:
        """Append to the in-order lifecycle log — the single choke point
        every request lifecycle transition passes through (the trace
        instants JAX emits here come with the telemetry port, ROADMAP
        A9)."""
        self.events.append((kind, rid))

    # -- queue -----------------------------------------------------------------
    def submit(self, req) -> ScheduledRequest:
        entry = ScheduledRequest(req=req, arrival=next(self._arrival))
        self.waiting.append(entry)
        self._note_event("submit", entry.rid)
        return entry

    def requeue(self, entry: ScheduledRequest) -> None:
        """Return a preempted entry to the queue, stamp intact.  The
        preemption is the one event that changes the entry's prefill
        window (resume re-prefills prompt + generated prefix), so its
        memoized window/hashes are invalidated here."""
        entry.preemptions += 1
        entry.hashes = None
        entry.window = None
        self.preemptions += 1
        self.waiting.append(entry)
        self._note_event("preempt", entry.rid)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.slots) if s not in self.active]

    def _committed_tokens(self, prefill_len: int) -> int:
        return sum(prefill_len + int(getattr(e.req, "max_tokens", 0))
                   for e in self.active.values())

    # -- policy hooks (override to add a scheduling policy) --------------------
    def _pick_admit(self) -> ScheduledRequest:
        """Which waiting request is next in line: oldest arrival (FIFO)."""
        return min(self.waiting, key=lambda e: e.arrival)

    def _pick_victim(self, protect: Optional[int]) -> Optional[int]:
        """Which active slot to evict: youngest arrival, never
        ``protect`` unless it is the only one left."""
        slots = [s for s in self.active if s != protect]
        if not slots:
            slots = list(self.active)
        if not slots:
            return None
        return max(slots, key=lambda s: self.active[s].arrival)

    def prefill_chunk_quota(self, n_decoding: int) -> int:
        """Policy hook: how many prefill chunks to run alongside this
        engine step's batched decode.  Chunks are budgeted like decode
        tokens — the default interleaves ONE chunk per step so a long
        prompt never stalls in-flight decodes, and lets prefill drain at
        full speed when no slot is decoding.  Override together with
        :meth:`_pick_admit` to trade first-token latency against decode
        throughput."""
        return 1 if n_decoding else self.slots

    def spec_k(self, n_decoding: int) -> Optional[int]:
        """Policy hook: cap on this step's speculation depth (window
        tokens per slot, draft proposals + 1).  A speculative step
        commits up to ``k − 1`` extra page slots per sequence *before*
        knowing how many tokens the target accepts, so depth is load
        traffic the policy should shed first: the default halves the
        configured k (engine-side) whenever free pages cannot cover a
        full-depth window for every decoding slot, by returning the
        depth that fits.  The engine additionally clamps per-slot (page
        availability without eviction, sequence-horizon room) and floors
        at 1 — k=1 is exactly vanilla decode, so a full pool degrades to
        non-speculative steps instead of evicting.  Return ``None`` for
        "no policy cap"."""
        if not n_decoding:
            return None
        per_slot = (self.pool.free_pages // n_decoding
                    if self.pool.free_pages else 0)
        # Each extra window token may need at most one fresh page.
        return max(1, per_slot * self.page_size + 1)

    def note_spec_step(self, n_active: int, drafted: int, accepted: int,
                       emitted: int) -> None:
        """Account one speculative decode step: ``drafted`` proposals
        verified, ``accepted`` of them kept, ``emitted`` tokens appended
        across ``n_active`` slots (emitted ≥ n_active — every slot gets
        at least its resampled/bonus token, so a spec step is never worse
        than a vanilla step in tokens)."""
        self.decode_steps += 1
        self.active_step_sum += n_active
        self.decode_tokens += emitted
        self.spec_steps += 1
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_emitted += emitted

    # -- admission -------------------------------------------------------------
    def _usable_prefix(self, matched_pages: int, prefill_len: int
                       ) -> Tuple[int, int]:
        """(aliasable pages, matched-but-rewritten pages) for a content
        match of ``matched_pages``.  The usable prefix is rounded down to
        a chunk boundary and capped at ``prefill_len − chunk``: the final
        chunk always recomputes (its logits seed sampling), and a chunk
        never starts mid-page.  Matches past the cap fall in the
        recompute window — the pool books them as CoW copies."""
        chunk = self.prefill_chunk or prefill_len
        if chunk % self.page_size != 0:
            return 0, 0  # chunk writes straddle pages: nothing aliasable
        keep_tok = min(matched_pages * self.page_size,
                       max(prefill_len - chunk, 0))
        keep_tok -= keep_tok % chunk
        keep_pages = keep_tok // self.page_size
        total = self.pool.pages_needed(prefill_len)
        rewrite = max(0, min(matched_pages, total) - keep_pages)
        return keep_pages, rewrite

    def pop_admit(self, prefill_len: int,
                  hasher: Optional[Callable[[ScheduledRequest],
                                            List[str]]] = None
                  ) -> Optional[Tuple[int, ScheduledRequest, int]]:
        """Admit the longest-waiting request if a slot, the token budget
        and the page pool allow it.  Strict FIFO: a blocked head blocks
        the whole queue (starvation-freedom over throughput).

        ``hasher`` (engine-supplied) maps an entry to the content hashes
        of its prefill window; when given, the admission aliases the
        longest usable cached prefix instead of allocating/recomputing
        it.  Returns ``(slot, entry, cached_tokens)`` — ``cached_tokens``
        tells the engine where chunked prefill starts.
        """
        if not self.waiting:
            return None
        free = self.free_slots()
        if not free:
            return None
        head = self._pick_admit()
        cost = prefill_len + int(getattr(head.req, "max_tokens", 0))
        if (self.token_budget is not None
                and self._committed_tokens(prefill_len) + cost
                > self.token_budget):
            return None
        keep_pages = rewrite = 0
        if hasher is not None:
            if head.hashes is None:  # memoized until preemption clears it
                head.hashes = list(hasher(head))
            matched = self.pool.lookup_prefix(head.hashes)
            keep_pages, rewrite = self._usable_prefix(matched, prefill_len)
        if not self.pool.admit_prefix(head.arrival, head.hashes or [],
                                      keep_pages, prefill_len,
                                      rewrite_pages=rewrite):
            return None
        slot = free[0]
        self.waiting.remove(head)
        self.active[slot] = head
        cached_tok = keep_pages * self.page_size
        self.prefill_tokens += prefill_len - cached_tok
        self.cached_prefill_tokens += cached_tok
        self._note_event("admit", head.rid)
        return slot, head, cached_tok

    def register_prefix(self, slot: int, index: int, page_hash: str) -> bool:
        """Publish the content hash of an active slot's fully-written
        logical page (engine calls this after the chunk that wrote it)."""
        entry = self.active.get(slot)
        if entry is None:
            return False
        return self.pool.register(entry.arrival, index, page_hash)

    def admission_stuck(self, prefill_len: int) -> bool:
        """True when nothing is running and the head request can *never*
        be admitted (pool/budget too small for it alone) — the caller
        should raise instead of spinning."""
        if self.active or not self.waiting:
            return False
        head = self._pick_admit()
        cost = prefill_len + int(getattr(head.req, "max_tokens", 0))
        if self.token_budget is not None and cost > self.token_budget:
            return True
        return not self.pool.can_allocate(self.pool.pages_needed(prefill_len))

    # -- decode-time growth / preemption ---------------------------------------
    def ensure_decode(self, slot: int, tokens: int
                      ) -> List[Tuple[int, ScheduledRequest]]:
        """Guarantee page coverage for ``slot``'s next decode token.

        Returns the (slot, entry) pairs evicted to make room — possibly
        including ``slot`` itself when it is the youngest and the pool
        still cannot cover it.  Evicted entries are already requeued.
        """
        entry = self.active[slot]
        evicted: List[Tuple[int, ScheduledRequest]] = []
        while not self.pool.ensure(entry.arrival, tokens):
            victim = self._pick_victim(protect=slot)
            if victim is None:
                break
            ventry = self.active.pop(victim)
            self.pool.release(ventry.arrival)
            self.requeue(ventry)
            evicted.append((victim, ventry))
            if victim == slot:
                break
        return evicted

    def release(self, slot: int, *, finished: bool = True) -> None:
        entry = self.active.pop(slot)
        self.pool.release(entry.arrival)
        if finished:
            self.completed_requests += 1
            self._note_event("finish", entry.rid)

    # -- request-level containment ---------------------------------------------
    def cancel(self, slot: int) -> ScheduledRequest:
        """Cancel an *active* request: free its slot and pages (shared
        pages decremented, never freed — identical to eviction) without
        requeueing it.  The engine records the structured failure."""
        entry = self.active.pop(slot)
        self.pool.release(entry.arrival)
        self.cancelled_requests += 1
        self._note_event("cancel", entry.rid)
        return entry

    def cancel_waiting(self, entry: ScheduledRequest) -> None:
        """Cancel a *waiting* request (deadline passed in queue, or the
        head can never fit): it leaves the line without being admitted."""
        self.waiting.remove(entry)
        self.cancelled_requests += 1
        self._note_event("cancel", entry.rid)

    # -- device-side view / metrics --------------------------------------------
    def table_row(self, slot: int):
        entry = self.active.get(slot)
        return self.pool.table_row(
            entry.arrival if entry is not None else None,
            self.max_pages_per_seq)

    def note_step(self, n_active: int, *, lag: int = 0) -> None:
        """Account one delivered decode step.  With async stepping the
        engine calls this at token *delivery* — ``lag`` is how many
        engine steps behind the launch that delivery ran (0 == fully
        synchronous), so the occupancy/token counters describe the same
        work either way, just noted one pipeline depth late."""
        self.decode_steps += 1
        self.active_step_sum += n_active
        self.decode_tokens += n_active
        self.delivery_lag_sum += max(0, int(lag))

    def metrics(self) -> Dict[str, float]:
        occ = (self.active_step_sum / (self.decode_steps * self.slots)
               if self.decode_steps else 0.0)
        asked = self.prefill_tokens + self.cached_prefill_tokens
        return {
            "decode_steps": self.decode_steps,
            "batch_occupancy": occ,
            "prefill_tokens": self.prefill_tokens,
            "cached_prefill_tokens": self.cached_prefill_tokens,
            "prefix_hit_rate": (self.cached_prefill_tokens / asked
                                if asked else 0.0),
            "decode_tokens": self.decode_tokens,
            "delivery_lag_mean": (self.delivery_lag_sum / self.decode_steps
                                  if self.decode_steps else 0.0),
            "preemptions": self.preemptions,
            "completed_requests": self.completed_requests,
            "cancelled_requests": self.cancelled_requests,
            "shed_requests": self.shed_requests,
            "spec_steps": self.spec_steps,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_emitted": self.spec_emitted,
            "accepted_per_step": (self.spec_accepted / self.spec_steps
                                  if self.spec_steps else 0.0),
            "acceptance_rate": (self.spec_accepted / self.spec_drafted
                                if self.spec_drafted else 0.0),
        }


class DeadlineScheduler(ContinuousBatchingScheduler):
    """Earliest-deadline-first admission on the ``_pick_admit`` /
    ``_pick_victim`` hooks — the ROADMAP "priority / deadline" candidate,
    and the worked example that the policy surface works.

    Requests may carry a ``deadline`` (any unit; the scheduler only
    compares values).  The waiting request with the smallest *effective*
    deadline is admitted next; a request without a deadline gets
    ``arrival + default_slack`` so aged best-effort traffic outranks
    far-future deadlines.  Starvation-freedom is enforced structurally,
    not by that heuristic: every *successful admission* that bypasses the
    oldest-arrival waiting entry increments its ``skipped`` counter
    (failed attempts — budget/pool full — age nothing), and once it has
    been bypassed ``default_slack`` times it is admitted regardless of
    deadlines (bounded-bypass EDF).  Even an endless
    stream of urgent small-deadline requests can therefore delay the
    oldest request only a bounded number of admissions (the fairness
    tests assert both behaviours).  Eviction inverts the deadline key —
    the *latest*-effective-deadline active request is preempted first,
    so pool pressure spares the most urgent work.  Budget accounting,
    pool interaction and metrics are inherited untouched — this class
    overrides only the two policy hooks.
    """

    def __init__(self, *args, default_slack: int = 64, **kwargs):
        super().__init__(*args, **kwargs)
        self.default_slack = default_slack

    def _effective_deadline(self, entry: ScheduledRequest) -> float:
        d = getattr(entry.req, "deadline", None)
        return float(d) if d is not None \
            else float(entry.arrival + self.default_slack)

    def _pick_admit(self) -> ScheduledRequest:
        """Earliest effective deadline (ties to oldest arrival), with a
        bounded bypass of the oldest waiting entry."""
        oldest = min(self.waiting, key=lambda e: e.arrival)
        if oldest.skipped >= self.default_slack:
            return oldest
        return min(self.waiting,
                   key=lambda e: (self._effective_deadline(e), e.arrival))

    def pop_admit(self, prefill_len: int, hasher=None):
        """Count a bypass only when an admission actually happened:
        failed attempts (budget/pool full, no slot) admit nobody, so
        they must not age the oldest entry toward force-admission."""
        oldest = (min(self.waiting, key=lambda e: e.arrival)
                  if self.waiting else None)
        got = super().pop_admit(prefill_len, hasher)
        if got is not None and oldest is not None and got[1] is not oldest:
            oldest.skipped += 1
        return got

    def _pick_victim(self, protect: Optional[int]) -> Optional[int]:
        """Latest effective deadline (then youngest arrival), never
        ``protect`` unless it is the only slot left."""
        slots = [s for s in self.active if s != protect]
        if not slots:
            slots = list(self.active)
        if not slots:
            return None
        return max(slots, key=lambda s: (
            self._effective_deadline(self.active[s]),
            self.active[s].arrival))
