"""Host-side page bookkeeping for the paged KV cache.

The device side of the paged cache is a global page pool per layer
(``(n_pages + 1, page_size, ...)`` — the extra row is the SCRATCH page
that absorbs writes from free slots and dropped span positions) plus a
per-slot page table that is mirrored on the host.  This module owns the
host half of the contract:

``PageAllocator``
    The single authority over which physical pages are live.  Free pages
    are recycled FIFO, so an admit/retire/admit cycle with identical
    requests reproduces identical page tables (determinism is load-bearing
    for the parity tests).  Pages are refcounted: a page shared by N
    requests is freed only when the last holder releases it, and a holder
    that wants to WRITE a shared page must go through ``writable`` first
    (copy-on-write — the allocator hands back a fresh page and drops one
    reference from the shared one; the device copy is the caller's job).

``PoolExhausted``
    Typed backpressure.  It subclasses ``AdmissionRejected`` so the
    engine's existing admission-rejection path (push the request back on
    the queue, stop pumping) and the lifecycle preemption machinery apply
    unchanged when the pool — rather than a slot — is the scarce resource.

``PrefixRegistry``
    Maps prompt prefixes to resident pages so requests sharing a system
    prompt share physical pages.  Sharing is only ever whole-page and
    only covers tokens the donor actually prefilled; because prefill is
    bitwise invariant to right-padding (DESIGN.md §5), the donor's page
    contents are bit-identical to what the sharer's own prefill would
    have produced, which keeps paged-vs-contiguous parity exact even
    across sharing.  The registry holds one reference per registered
    page; eviction (oldest-first) releases those references so the pool
    can reclaim pages that no live request pins.

Pure Python bookkeeping (a copy of ``repro.serve.paging``: the port
imports nothing of the JAX package), held decision for decision against
the reference in tests/test_torch_paging.py.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .lifecycle import AdmissionRejected


class PoolExhausted(AdmissionRejected):
    """The page pool cannot satisfy an allocation.

    Subclasses ``AdmissionRejected`` so pool pressure rides the same
    backpressure path as slot pressure: at admission time the engine
    pushes the request back on the queue; at decode time it preempts or
    retires a victim and retries.
    """


class PageAllocator:
    """Refcounted FIFO allocator over a fixed pool of ``n_pages`` pages.

    Page ids are ints in ``[0, n_pages)``.  The device pool has one extra
    row (index ``n_pages``) — the scratch page — which is NOT managed
    here; callers use ``allocator.scratch`` as the sentinel table entry.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: Deque[int] = deque(range(self.n_pages))
        self._refs: Dict[int, int] = {}
        # lifetime churn counters (telemetry/report surface): allocations
        # and releases of page REFERENCES, monotone over the engine's life
        self.pages_allocated_total = 0
        self.pages_freed_total = 0

    # -- introspection -------------------------------------------------
    @property
    def scratch(self) -> int:
        """Sentinel page id: the pool row that absorbs masked writes."""
        return self.n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    # -- alloc / retain / free ----------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list (refcount 1 each).

        All-or-nothing: raises ``PoolExhausted`` without side effects if
        fewer than ``n`` pages are free.
        """
        if n < 0:
            raise ValueError(f"alloc count must be >= 0, got {n}")
        if n > len(self._free):
            raise PoolExhausted(
                f"page pool exhausted: requested {n} pages, "
                f"{len(self._free)} free of {self.n_pages}")
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.pages_allocated_total += n
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        """Add one reference to each page (prefix sharing)."""
        for p in pages:
            p = int(p)
            if self._refs.get(p, 0) < 1:
                raise ValueError(f"retain of unallocated page {p}")
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; refcount-0 pages rejoin the free
        list in the order given (FIFO reuse → deterministic tables)."""
        for p in pages:
            p = int(p)
            rc = self._refs.get(p, 0)
            if rc < 1:
                raise ValueError(f"free of unallocated page {p}")
            if rc == 1:
                del self._refs[p]
                self._free.append(p)
                self.pages_freed_total += 1
            else:
                self._refs[p] = rc - 1

    def writable(self, page: int) -> Tuple[int, bool]:
        """Make ``page`` safe to write for ONE holder (copy-on-write).

        Returns ``(page_id, fresh)``.  If the caller is the sole holder
        the page itself is returned (``fresh=False``).  Otherwise a fresh
        page is allocated, one reference is dropped from the shared page,
        and ``fresh=True`` signals the caller to copy the device rows
        ``pool[page] -> pool[new]`` before writing.
        """
        page = int(page)
        rc = self._refs.get(page, 0)
        if rc < 1:
            raise ValueError(f"writable() on unallocated page {page}")
        if rc == 1:
            return page, False
        new = self.alloc(1)[0]
        self._refs[page] = rc - 1
        return new, True


class PrefixRegistry:
    """Prompt-prefix → resident-pages map for system-prompt sharing.

    Entries are keyed by the full prompt tuple of the donor request and
    record the donor's page list plus its prompt length.  ``lookup``
    returns the longest usable shared prefix for a new prompt:

    * an exact prompt match may share ALL the donor's pages (including a
      trailing partially-filled page — the sharer's first write lands
      past the donor's fill, and copy-on-write intervenes first anyway);
    * otherwise the best common prefix rounded DOWN to whole pages, and
      never beyond the donor's own prompt (shared tokens must have been
      actually prefilled by the donor for bitwise parity to hold).

    The registry holds one reference per page per entry.  ``evict_one``
    (oldest entry first) releases those references — pages still pinned
    by live requests survive, unpinned ones return to the free list.
    """

    def __init__(self, allocator: PageAllocator, min_tokens: Optional[int] = None):
        self.allocator = allocator
        # Below one full page there is nothing shareable.
        self.min_tokens = (allocator.page_size if min_tokens is None
                           else int(min_tokens))
        self._entries: "OrderedDict[Tuple[int, ...], Tuple[List[int], int]]" = (
            OrderedDict())

    def __len__(self) -> int:
        return len(self._entries)

    def register(self, prompt: Sequence[int], pages: Sequence[int]) -> bool:
        """Record ``prompt`` as resident in ``pages`` (one ref per page).

        Skipped (returns False) when the prompt is too short to ever
        share a whole page or is already registered.
        """
        key = tuple(int(t) for t in prompt)
        if len(key) < self.min_tokens or key in self._entries:
            return False
        pages = [int(p) for p in pages]
        self.allocator.retain(pages)
        self._entries[key] = (pages, len(key))
        return True

    def lookup(self, prompt: Sequence[int],
               exact_ok: bool = True) -> Tuple[int, List[int]]:
        """Best shareable prefix for ``prompt``.

        Returns ``(shared_tokens, pages)`` — the caller must
        ``allocator.retain(pages)`` to actually pin them.  ``(0, [])``
        when nothing is shareable.  ``exact_ok=False`` restricts the
        result to whole pages even on an exact match (used by resume
        replay, which rewrites the tail page itself).
        """
        key = tuple(int(t) for t in prompt)
        ps = self.allocator.page_size
        best_tokens, best_pages = 0, []  # type: int, List[int]
        for donor, (pages, n) in self._entries.items():
            if exact_ok and donor == key:
                return n, list(pages)
            lcp = 0
            for a, b in zip(donor, key):
                if a != b:
                    break
                lcp += 1
            # Whole pages only, and only pages the donor fully prefilled.
            shared = min(lcp, n) // ps * ps
            if shared > best_tokens:
                best_tokens = shared
                best_pages = list(pages[: shared // ps])
        return best_tokens, best_pages

    def evict_one(self) -> bool:
        """Release the oldest entry's page references. False if empty."""
        if not self._entries:
            return False
        _, (pages, _) = self._entries.popitem(last=False)
        self.allocator.free(pages)
        return True

    def clear(self) -> None:
        while self.evict_one():
            pass
