"""Paged KV-cache pool: refcounted, content-addressed pages from a shared
free list.

The port's own copy of ``repro/serving/kv_cache.py`` (host code, numpy
only): the same allocator, the same hashes string for string.

The decode-GEMV regime the paper targets is dominated by KV-cache traffic,
and a fixed-slot cache (one ``cache_len`` stripe per slot) wastes most of
it: short requests hold long stripes, and admission is all-or-nothing.
This module implements the vLLM-style answer at the framework level:

- **pages**: the pool is ``num_pages`` fixed-size pages of ``page_size``
  token slots each.  A sequence owns an ordered list of physical pages;
  its *logical* page ``i`` (token positions ``[i·page, (i+1)·page)``) maps
  to a physical page through the page table.
- **growth without recompaction**: appending tokens allocates pages from
  the free list; already-granted physical page ids never move, so decode
  steps never copy KV (the page table is the only thing that changes).
- **refcounted prefix sharing**: a physical page may be referenced by
  several sequences at once.  Every grant bumps the page's refcount;
  :meth:`release` decrements and only a count of zero makes the page
  reclaimable — evicting one sharer can never free pages another sharer
  still reads.  :meth:`make_private` is the copy-on-write primitive: it
  re-owns one logical page of a sequence onto a fresh physical page so
  the caller can write without disturbing the other sharers.
- **content-hash index**: :meth:`register` records a *chained* content
  hash for a fully-written page (see :func:`page_prefix_hashes` — the
  hash of logical page ``i`` covers every token in ``[0, (i+1)·page)``
  plus the storage/compute format salt, so a hash match implies the same
  tokens at the same absolute positions under the same precision, which
  is exactly what makes cached RoPE'd KV reusable).  :meth:`lookup_prefix`
  finds the longest cached page-aligned prefix; :meth:`admit_prefix`
  aliases it into a new sequence.  Pages whose refcount drops to zero
  *keep* their content on an LRU "cached-free" list: they stay findable
  until the allocator reclaims them for fresh writes, so a prefix
  survives its last sharer (and an evicted request finds its own pages
  again on resume).
- **quantized storage**: the stored element format is a
  :class:`repro_torch.core.formats.FormatPolicy` (``int8pt`` per-tensor-scale
  int8 is the quantized default — one f32 scale per stored token; ``int8``
  keeps per-(token, head) scales; ``bf16``/``fp32`` store unscaled).  The
  quantize-on-write / dequantize-on-read halves live with the attention
  layer (:mod:`repro_torch.models.attention`); this pool owns the *allocation*
  state, which is pure host-side bookkeeping (no device tensors).

Physical page **0 is reserved as the null page**: unallocated page-table
entries (−1) clamp to it on the device side, and inactive decode slots
write their garbage token into it, so it must never be granted to a
request.

The scheduler (:mod:`repro_torch.serving.scheduler`) decides *when* to
allocate/evict/alias; this class only answers "can I?" and "do it".
"""
from __future__ import annotations

import hashlib
from collections import Counter, OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.geometry import cdiv

__all__ = ["KVPagePool", "page_prefix_hashes", "AuditError"]


class AuditError(AssertionError):
    """A :meth:`KVPagePool.audit` invariant was violated — allocation
    state is corrupt (lost page, refcount drift, dangling index entry)."""


def page_prefix_hashes(tokens, page_size: int, salt: str = "") -> List[str]:
    """Chained content hashes for the page-aligned prefixes of ``tokens``.

    Entry ``i`` digests ``salt`` plus every token in ``[0, (i+1)·page)``
    (by chaining, not by re-reading — O(n) total), so two sequences share
    hash ``i`` iff they agree on the *whole* prefix through page ``i``
    under the same format salt.  Only full pages get a hash: the partial
    tail of a window is never shareable.
    """
    h = hashlib.blake2b(str(salt).encode(), digest_size=16)
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32).ravel())
    out: List[str] = []
    for i in range(len(arr) // page_size):
        h.update(arr[i * page_size:(i + 1) * page_size].tobytes())
        out.append(h.hexdigest())
    return out


class KVPagePool:
    """Host-side allocator for a shared pool of fixed-size KV pages."""

    def __init__(self, num_pages: int, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 is the reserved "
                             f"null page), got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # Page 0 is the null page — never granted.
        self._free: Deque[int] = deque(range(1, self.num_pages))
        self._owned: Dict[int, List[int]] = {}
        # -- sharing state ----------------------------------------------------
        self._ref: Dict[int, int] = {}          # page -> #sequences holding it
        self._hash_of: Dict[int, str] = {}      # page -> registered hash
        self._page_of: Dict[str, int] = {}      # hash -> page
        # ref-0 pages that still hold registered content, LRU order —
        # allocatable, but only after the plain free list runs dry.
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        # -- metrics ----------------------------------------------------------
        self.prefix_queries = 0     # admissions that consulted the index
        self.prefix_hit_pages = 0   # pages aliased instead of recomputed
        self.cow_copies = 0         # matched pages re-owned for rewriting
        # -- fault injection --------------------------------------------------
        # Consume-once counter (set by a FaultInjector): while positive,
        # each grant request fails as if the pool were dry, exercising
        # the caller's deferral/eviction paths.
        self.inject_alloc_failures = 0
        self.injected_alloc_failures = 0  # how many actually fired

    # -- queries ---------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Allocatable pages (plain free + reclaimable cached-free)."""
        return len(self._free) + len(self._cached_free)

    @property
    def used_pages(self) -> int:
        """Distinct physical pages currently referenced by a sequence."""
        return sum(1 for r in self._ref.values() if r > 0)

    @property
    def shared_pages(self) -> int:
        """Pages currently referenced by more than one sequence."""
        return sum(1 for r in self._ref.values() if r > 1)

    @property
    def cached_pages(self) -> int:
        """Pages with a registered content hash (live or cached-free)."""
        return len(self._page_of)

    def pages_needed(self, tokens: int) -> int:
        return cdiv(max(int(tokens), 0), self.page_size)

    def can_allocate(self, n_pages: int) -> bool:
        return self.free_pages >= n_pages

    def pages_of(self, key: int) -> List[int]:
        return list(self._owned.get(key, ()))

    def ref_of(self, page: int) -> int:
        return self._ref.get(page, 0)

    def _fail_injected(self) -> bool:
        """Consume one injected allocation failure, if armed."""
        if self.inject_alloc_failures > 0:
            self.inject_alloc_failures -= 1
            self.injected_alloc_failures += 1
            return True
        return False

    # -- allocation ------------------------------------------------------------
    def _alloc_page(self) -> Optional[int]:
        """One fresh page: plain free list first, then LRU-reclaim a
        cached-free page (dropping its hash registration)."""
        if self._free:
            return self._free.popleft()
        if self._cached_free:
            page, _ = self._cached_free.popitem(last=False)
            h = self._hash_of.pop(page, None)
            if h is not None:
                self._page_of.pop(h, None)
            return page
        return None

    def _retire_page(self, page: int) -> None:
        """A page whose refcount reached zero: keep it findable if it has
        registered content, else return it to the plain free list."""
        if page in self._hash_of:
            self._cached_free[page] = None
            self._cached_free.move_to_end(page)
        else:
            self._free.append(page)

    def ensure(self, key: int, tokens: int) -> bool:
        """Grow ``key``'s page list to cover ``tokens`` token slots.

        Returns False (and changes nothing) when the pool cannot supply
        the missing pages — the caller decides who to evict.  Existing
        page ids are never moved (no recompaction): growth only appends
        to the sequence's page list.  New pages start with refcount 1.
        """
        need = self.pages_needed(tokens)
        owned = self._owned.setdefault(key, [])
        grow = need - len(owned)
        if grow <= 0:
            return True
        if self.free_pages < grow or self._fail_injected():
            return False
        for _ in range(grow):
            page = self._alloc_page()
            self._ref[page] = 1
            owned.append(page)
        return True

    def release(self, key: int) -> int:
        """Drop ``key``'s references.  Returns the number of pages whose
        refcount reached zero (became reclaimable); shared pages are
        decremented, never freed."""
        pages = self._owned.pop(key, [])
        freed = 0
        for page in pages:
            r = self._ref.get(page, 1) - 1
            if r <= 0:
                self._ref.pop(page, None)
                self._retire_page(page)
                freed += 1
            else:
                self._ref[page] = r
        return freed

    def reset(self) -> None:
        self._free = deque(range(1, self.num_pages))
        self._owned.clear()
        self._ref.clear()
        self._hash_of.clear()
        self._page_of.clear()
        self._cached_free.clear()

    # -- prefix caching --------------------------------------------------------
    def lookup_prefix(self, hashes: Sequence[str]) -> int:
        """Longest run of leading ``hashes`` present in the content index
        (in pages).  Touches the LRU order of matched cached-free pages."""
        n = 0
        for h in hashes:
            page = self._page_of.get(h)
            if page is None:
                break
            if page in self._cached_free:
                self._cached_free.move_to_end(page)
            n += 1
        return n

    def admit_prefix(self, key: int, hashes: Sequence[str],
                     keep_pages: int, total_tokens: int, *,
                     rewrite_pages: int = 0) -> bool:
        """Grant ``key`` pages for ``total_tokens``: alias the first
        ``keep_pages`` from the content index (refcount bump, no write),
        allocate the rest fresh.  All-or-nothing: returns False (nothing
        changed) when the pool cannot supply the fresh pages.

        ``rewrite_pages`` counts index matches the caller chose to re-own
        privately because it will rewrite them (the chunk-aligned
        recompute window) — the pool books them as CoW copies: the alias
        is dropped before the write instead of after, and because the
        rewrite covers every slot of the page the device-side copy is
        elided.
        """
        need = self.pages_needed(total_tokens)
        keep_pages = min(int(keep_pages), need)
        keep = [self._page_of[h] for h in hashes[:keep_pages]]
        # Fresh capacity: cached-free pages we are about to alias are not
        # reclaimable for the same admission.
        reclaimable = (len(self._free) + len(self._cached_free)
                       - sum(1 for p in keep if p in self._cached_free))
        if need - keep_pages > reclaimable:
            return False
        if need - keep_pages > 0 and self._fail_injected():
            return False
        owned = []
        for page in keep:
            self._cached_free.pop(page, None)
            self._ref[page] = self._ref.get(page, 0) + 1
            owned.append(page)
        for _ in range(need - keep_pages):
            page = self._alloc_page()
            self._ref[page] = 1
            owned.append(page)
        self._owned[key] = owned
        self.prefix_queries += 1 if hashes else 0
        self.prefix_hit_pages += keep_pages
        self.cow_copies += max(0, int(rewrite_pages))
        return True

    def register(self, key: int, index: int, page_hash: str) -> bool:
        """Record the content hash of ``key``'s fully-written logical page
        ``index`` so later admissions can alias it.  First writer wins: a
        hash already registered (or a page already hashed) is left alone —
        the duplicate page simply stays private."""
        pages = self._owned.get(key, ())
        if index >= len(pages):
            return False
        page = pages[index]
        if page_hash in self._page_of or page in self._hash_of:
            return False
        self._page_of[page_hash] = page
        self._hash_of[page] = page_hash
        return True

    def make_private(self, key: int, index: int) -> Optional[tuple]:
        """Copy-on-write: re-own ``key``'s logical page ``index`` onto a
        fresh physical page when it is shared.  Returns ``(old, new)``
        physical ids so the caller can copy the device-side content, or
        None when the page was already private (no copy needed).  Raises
        when the pool cannot supply the private copy — the caller should
        have evicted first.
        """
        pages = self._owned.get(key)
        if pages is None or index >= len(pages):
            return None
        old = pages[index]
        if self._ref.get(old, 1) <= 1:
            return None
        new = self._alloc_page()
        if new is None:
            raise RuntimeError("KVPagePool: no page available for the "
                               "copy-on-write split — evict before writing")
        self._ref[old] -= 1
        self._ref[new] = 1
        pages[index] = new
        self.cow_copies += 1
        return old, new

    # -- invariants ------------------------------------------------------------
    def audit(self) -> None:
        """Check every allocation invariant; raise :class:`AuditError` on
        the first violation.  O(num_pages); cheap enough to run after
        every operation in chaos tests and behind the engine's
        ``debug_audit`` flag in production-shaped runs.

        Invariants:
          1. partition: plain-free ∪ cached-free ∪ owned == pages 1..N−1,
             with no page in two states and no duplicates within one;
          2. refcount conservation: ``_ref[p]`` equals the number of
             sequence page-lists containing ``p``, exactly;
          3. content index is a bijection: ``_page_of`` and ``_hash_of``
             are inverse maps, and every indexed page is live (ref > 0)
             or cached-free — never plain-free or unknown;
          4. every cached-free page still has a registration (else it
             belongs on the plain free list);
          5. shared pages (ref > 1) are registered — sharing only arises
             from aliasing published content, and writers must
             :meth:`make_private` first (read-only sharing);
          6. the null page 0 appears nowhere.
        """
        def fail(msg: str):
            raise AuditError(
                f"KVPagePool.audit: {msg} [{self.describe_str()}]")

        free = list(self._free)
        cached = list(self._cached_free)
        held = Counter()
        for key, pages in self._owned.items():
            if len(set(pages)) != len(pages):
                fail(f"sequence {key} owns a duplicate page: {pages}")
            held.update(pages)
        for name, group in (("free", free), ("cached-free", cached)):
            if len(set(group)) != len(group):
                fail(f"duplicate page in {name} list: {group}")
            for p in group:
                if held[p]:
                    fail(f"page {p} is both {name} and owned")
        if set(free) & set(cached):
            fail(f"pages both free and cached-free: {set(free) & set(cached)}")
        every = set(free) | set(cached) | set(held)
        want = set(range(1, self.num_pages))
        if every != want:
            lost, extra = want - every, every - want
            fail(f"page partition broken (lost={sorted(lost)}, "
                 f"unknown={sorted(extra)})")
        if dict(held) != self._ref:
            drift = {p: (self._ref.get(p, 0), held[p])
                     for p in set(held) | set(self._ref)
                     if self._ref.get(p, 0) != held[p]}
            fail(f"refcount drift (page: recorded vs actual) {drift}")
        for h, p in self._page_of.items():
            if self._hash_of.get(p) != h:
                fail(f"index not a bijection: hash {h!r} -> page {p} -> "
                     f"{self._hash_of.get(p)!r}")
            if not held[p] and p not in self._cached_free:
                fail(f"index entry {h!r} points at dead page {p}")
        for p, h in self._hash_of.items():
            if self._page_of.get(h) != p:
                fail(f"index not a bijection: page {p} -> hash {h!r} -> "
                     f"{self._page_of.get(h)}")
        for p in cached:
            if p not in self._hash_of:
                fail(f"cached-free page {p} has no registration")
        for p, r in self._ref.items():
            if r > 1 and p not in self._hash_of:
                fail(f"shared page {p} (ref={r}) is unregistered — "
                     f"sharing must come from published content")
        if held[0] or 0 in every:
            fail("null page 0 was granted")

    # -- crash recovery --------------------------------------------------------
    def registrations(self) -> List[Tuple[int, str]]:
        """Snapshot of the content index as ``(page, hash)`` pairs —
        the pool half of :meth:`ServingEngine.snapshot`."""
        return sorted(self._hash_of.items())

    def restore_registrations(self,
                              pairs: Sequence[Tuple[int, str]]) -> int:
        """Re-seed the content index after a restart that kept the device
        cache: each ``(page, hash)`` from a pre-crash snapshot moves that
        page from the plain free list to the cached-free list under its
        hash, making the surviving KV findable by ``lookup_prefix`` again.
        Entries whose page is not plain-free, or whose page/hash is
        already indexed, are skipped (the restarted pool may have been
        used already).  Returns the number restored.
        """
        free = set(self._free)
        restored = 0
        for page, page_hash in pairs:
            page = int(page)
            if (page not in free or page in self._hash_of
                    or page_hash in self._page_of):
                continue
            self._free.remove(page)
            free.discard(page)
            self._hash_of[page] = page_hash
            self._page_of[page_hash] = page
            self._cached_free[page] = None
            restored += 1
        return restored

    def save_index(self, path) -> int:
        """Persist the content index as JSON — the host half of a
        cross-engine prefix-cache handoff (a restarted or disaggregated
        decode engine that kept/received the device pages reloads it with
        :meth:`load_index`).  Geometry is stored so a mismatched pool
        refuses the file instead of aliasing wrong pages.  Returns the
        number of entries written.
        """
        import json
        entries = self.registrations()
        payload = {"version": 1, "num_pages": self.num_pages,
                   "page_size": self.page_size, "registrations": entries}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        import os
        os.replace(tmp, path)
        return len(entries)

    def load_index(self, path) -> int:
        """Re-seed the content index from a :meth:`save_index` file via
        the :meth:`restore_registrations` rules (plain-free pages only).
        Returns the number restored; 0 for a missing file.  Raises
        ``ValueError`` on pool-geometry mismatch.
        """
        import json
        import os
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            payload = json.load(f)
        if (payload.get("num_pages") != self.num_pages
                or payload.get("page_size") != self.page_size):
            raise ValueError(
                f"prefix index {path} was saved for a "
                f"{payload.get('num_pages')}x{payload.get('page_size')} "
                f"pool, this pool is {self.num_pages}x{self.page_size}")
        pairs = [(int(p), str(h)) for p, h in payload["registrations"]]
        return self.restore_registrations(pairs)

    # -- device-side view ------------------------------------------------------
    def table_row(self, key: Optional[int], max_pages: int) -> np.ndarray:
        """The (max_pages,) int32 page-table row for one sequence.

        Unallocated logical pages are −1 (the device side clamps them to
        the null page and masks their slots).  ``key=None`` yields the
        all-unmapped row of an inactive decode slot.
        """
        row = np.full((max_pages,), -1, np.int32)
        if key is not None:
            pages = self._owned.get(key, ())
            row[: len(pages)] = pages[:max_pages]
        return row

    def describe(self) -> Dict[str, int]:
        """Structured pool state — one dict that audits, telemetry and
        ``ServingEngine.metrics()`` all consume (``describe_str()`` is
        the human-readable rendering of the same fields)."""
        return {"num_pages": self.num_pages,
                "page_size": self.page_size,
                "free_pages": self.free_pages,
                "used_pages": self.used_pages,
                "sequences": len(self._owned),
                "shared_pages": self.shared_pages,
                "cached_pages": self.cached_pages,
                "prefix_hit_pages": self.prefix_hit_pages,
                "prefix_queries": self.prefix_queries,
                "cow_copies": self.cow_copies}

    def describe_str(self) -> str:
        d = self.describe()
        return (f"KVPagePool({d['num_pages']} pages x {d['page_size']} "
                f"tokens, {d['free_pages']} free, "
                f"{d['sequences']} sequences, "
                f"{d['shared_pages']} shared, {d['cached_pages']} cached, "
                f"{d['prefix_hit_pages']} prefix hits / "
                f"{d['prefix_queries']} queries, "
                f"{d['cow_copies']} cow copies)")
