"""Dynamic page allocation + radix-tree prefix caching (host side).

The port's own copy of ``repro.serving.allocator`` (pure Python, no torch):
the same classes, names, sharing policy and invariants.  The device side of
the dynamic engine keeps fixed-size pools and page-table indirection;
everything that *varies* between requests — which physical page backs which
(slot, logical column), which prompt spans are already resident, when a
request may be admitted at all — is host-side data, resolved here and sent
to the card as page tables.

Three layers:

- :class:`PageAllocator` — a free-list allocator with per-page refcounts
  over one physical pool.  ``alloc`` pops a page (refcount 1), ``share``
  takes another reference, ``release`` drops one and returns the page to
  the free list only when the count hits zero.
- :class:`PrefixCache` — a radix tree (token trie at *page* granularity:
  each edge is a full ``page_size``-token block) mapping prompt prefixes to
  the physical pages that already hold their KV.  The cache itself holds
  one reference on every cached page, so pages survive their original
  request's retirement and are reclaimed lazily: when allocation runs dry,
  least-recently-used *leaf* entries (and only entries no slot references)
  are evicted back to the free list.
- :class:`BlockManager` — the per-engine paging brain: builds full page
  tables for admissions (shared prefix pages first, freshly popped private
  pages for the rest of the budget), queues requests that cannot get pages
  yet (``try_admit`` -> None), inserts completed prompts into the radix
  tree, and releases everything at retirement.  The property-based suite
  (tests/test_torch_allocator.py) drives this class directly and asserts the
  refcount/free-list invariants after every step.

Sharing policy
--------------
Only *global*-attention pages are ever shared.  KV entries are a pure
function of the token prefix and the absolute position, so two requests
whose prompts agree on a full page of tokens have bitwise-equal page
contents — but sliding-window pools are rings whose pages are overwritten
as decode advances, so a shared ring page would be corrupted by whichever
slot decodes first.  Engines on windowed configs therefore run with
sharing disabled (the allocator and chunked prefill still apply); the
prefix cache reports zero savings there rather than approximate reuse.

A shared span is also always capped at ``plen - 1`` tokens: the admission
forward must produce the last-prompt-position logits to sample the first
generated token, so at least the final prompt token is always recomputed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


class PoolExhausted(RuntimeError):
    """A single request needs more pages than the whole pool owns —
    queueing can never satisfy it, so admission fails loudly."""


# ---------------------------------------------------------------------------
# free-list allocator
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free-list page allocator with per-page refcounts."""

    def __init__(self, n_pages: int):
        if n_pages < 0:
            raise ValueError(f"n_pages must be >= 0, got {n_pages}")
        self.n_pages = n_pages
        # LIFO, seeded so the first pops hand out 0, 1, 2, ... — keeps
        # fresh-pool allocation order deterministic and test-friendly
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self.refcount: List[int] = [0] * n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted("page pool empty")
        page = self._free.pop()
        assert self.refcount[page] == 0
        self.refcount[page] = 1
        return page

    def share(self, page: int) -> None:
        if self.refcount[page] <= 0:
            raise ValueError(f"share() on unallocated page {page}")
        self.refcount[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; returns True iff the page was freed."""
        rc = self.refcount[page]
        if rc <= 0:
            raise ValueError(f"release() on unallocated page {page}")
        self.refcount[page] = rc - 1
        if rc == 1:
            self._free.append(page)
            return True
        return False

    def free_set(self) -> set:
        return set(self._free)


# ---------------------------------------------------------------------------
# radix-tree prefix cache
# ---------------------------------------------------------------------------

class _RadixNode:
    __slots__ = ("children", "parent", "block", "page", "stamp")

    def __init__(self, parent: Optional["_RadixNode"], block, page: int):
        self.children: Dict[Tuple[int, ...], _RadixNode] = {}
        self.parent = parent
        self.block = block          # the page_size-token edge key from parent
        self.page = page            # physical page holding this block's KV
        self.stamp = 0              # LRU clock at last touch


class PrefixCache:
    """Token trie at page granularity over the *global* page pool.

    Each node below the root owns one physical page and holds one allocator
    reference on it.  ``match`` returns the longest chain of full-page
    blocks already cached; ``insert`` registers a completed prompt's pages;
    ``evict`` reclaims LRU leaves that no slot references.
    """

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self.root = _RadixNode(None, None, -1)
        self._clock = 0
        self._nodes: Dict[int, _RadixNode] = {}   # page -> node
        # lifetime totals (the serving metrics read them)
        self.n_hit_pages = 0
        self.n_inserted = 0
        self.n_evicted = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def pages(self) -> set:
        return set(self._nodes)

    def _blocks(self, tokens: Sequence[int]):
        P = self.page_size
        for i in range(len(tokens) // P):
            yield tuple(int(t) for t in tokens[i * P:(i + 1) * P])

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached full-page prefix of ``tokens``; returns the page
        ids in prefix order (no references taken — the caller shares them
        before anything else can evict)."""
        self._clock += 1
        node, pages = self.root, []
        for block in self._blocks(tokens):
            child = node.children.get(block)
            if child is None:
                break
            child.stamp = self._clock
            pages.append(child.page)
            node = child
        self.n_hit_pages += len(pages)
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register a completed prompt: page ``pages[i]`` holds the KV of
        full-page block i.  New nodes take one allocator reference; blocks
        already cached (possibly under a *different* physical page — a
        concurrent admission recomputed them) are left untouched.  Returns
        the number of pages newly cached."""
        self._clock += 1
        node, taken = self.root, 0
        for i, block in enumerate(self._blocks(tokens)):
            if i >= len(pages):
                break
            child = node.children.get(block)
            if child is None:
                child = _RadixNode(node, block, int(pages[i]))
                node.children[block] = child
                self._nodes[child.page] = child
                self.allocator.share(child.page)
                taken += 1
            child.stamp = self._clock
            node = child
        self.n_inserted += taken
        return taken

    def _evictable(self) -> List[_RadixNode]:
        # leaves only: evicting an interior node would orphan its longer
        # prefixes (lookups walk from the root).  refcount 1 means the
        # cache holds the only reference — no slot is using the page.
        return [
            n for n in self._nodes.values()
            if not n.children and self.allocator.refcount[n.page] == 1
        ]

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages, LRU leaves first (evicting a leaf
        can expose its parent as the next candidate).  Returns the number
        actually freed."""
        freed = 0
        while freed < n_pages:
            cands = self._evictable()
            if not cands:
                break
            victim = min(cands, key=lambda n: n.stamp)
            del victim.parent.children[victim.block]
            del self._nodes[victim.page]
            self.allocator.release(victim.page)
            freed += 1
        self.n_evicted += freed
        return freed

    def drop_all(self) -> int:
        """Evict everything evictable (slot-referenced pages stay cached)."""
        return self.evict(len(self._nodes))


# ---------------------------------------------------------------------------
# per-engine block manager
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Admission:
    """Everything the device step needs to admit one request."""

    table_row: List[int]               # (gp_cols,) global page ids
    wtab_row: Optional[List[int]]      # (wp_cols,) window page ids or None
    cached_len: int                    # prompt tokens served from shared pages
    fresh_pages: List[int]             # newly popped global pages (invalidate)
    fresh_wpages: List[int]            # newly popped window pages (invalidate)


@dataclasses.dataclass
class _SlotPages:
    gpages: List[int]
    wpages: List[int]
    n_shared: int                      # leading table_row entries from cache


class BlockManager:
    """Host-side paging for one engine: allocator + prefix cache + tables.

    Admission reserves a request's *whole* page budget up front (``gp_cols``
    global + ``wp_cols`` window pages, minus whatever the prefix cache
    provides), so over-subscription can only surface at admission time:
    ``try_admit`` returns None when the pool cannot satisfy the request yet
    (the caller queues it until retirements free pages) and raises
    :class:`PoolExhausted` only when the request alone exceeds the pool —
    the behavior pinned by tests/test_torch_allocator.py.
    """

    def __init__(
        self,
        *,
        n_pages: int,
        page_size: int,
        gp_cols: int,
        wp_cols: int = 0,
        n_window_pages: int = 0,
        prefix_cache: bool = True,
    ):
        self.page_size = page_size
        self.gp_cols = gp_cols
        self.wp_cols = wp_cols
        self.galloc = PageAllocator(n_pages)
        self.walloc = PageAllocator(n_window_pages) if wp_cols else None
        # window pools are rings — never shareable (see module docstring)
        self.cache = (
            PrefixCache(self.galloc, page_size)
            if prefix_cache and wp_cols == 0 else None
        )
        self.slots: Dict[int, _SlotPages] = {}

    # ------------------------------------------------------------------
    def try_admit(
        self, slot: int, prompt: Sequence[int], *, align_pages: int = 1
    ) -> Optional[Admission]:
        """Build the page tables for ``prompt`` in ``slot``.

        Shared-prefix pages are capped at ``plen - 1`` tokens (the last
        prompt token is always recomputed for first-token logits) and
        floored to a multiple of ``align_pages`` (the engine passes its
        prefill-chunk size in pages, so cached spans always start chunks on
        the same absolute boundaries as an uncached admission — chunk
        forwards are then bitwise-identical with caching on or off).

        Returns None when the pools cannot cover the request *right now*;
        raises PoolExhausted when they never could.
        """
        if slot in self.slots:
            raise ValueError(f"slot {slot} already admitted")
        if self.gp_cols > self.galloc.n_pages:
            raise PoolExhausted(
                f"request needs {self.gp_cols} global pages; pool has "
                f"{self.galloc.n_pages}"
            )
        if self.walloc is not None and self.wp_cols > self.walloc.n_pages:
            raise PoolExhausted(
                f"request needs {self.wp_cols} window pages; pool has "
                f"{self.walloc.n_pages}"
            )
        plen = len(prompt)
        shared: List[int] = []
        if self.cache is not None:
            shared = self.cache.match(prompt)
            max_shared = (plen - 1) // self.page_size      # cap at plen - 1
            n_shared = min(len(shared), max_shared)
            n_shared -= n_shared % max(align_pages, 1)
            shared = shared[:n_shared]
        # take the shared references FIRST: refcount >= 2 shields these
        # pages from the eviction pass below
        for p in shared:
            self.galloc.share(p)

        def rollback():
            for p in shared:
                self.galloc.release(p)

        need_g = self.gp_cols - len(shared)
        need_w = self.wp_cols
        short = need_g - self.galloc.n_free
        if short > 0 and self.cache is not None:
            self.cache.evict(short)
        if (self.galloc.n_free < need_g) or (
            self.walloc is not None and self.walloc.n_free < need_w
        ):
            rollback()
            return None
        fresh = [self.galloc.alloc() for _ in range(need_g)]
        fresh_w = (
            [self.walloc.alloc() for _ in range(need_w)]
            if self.walloc is not None else []
        )
        self.slots[slot] = _SlotPages(
            gpages=shared + fresh, wpages=list(fresh_w),
            n_shared=len(shared),
        )
        return Admission(
            table_row=shared + fresh,
            wtab_row=list(fresh_w) if self.walloc is not None else None,
            cached_len=len(shared) * self.page_size,
            fresh_pages=fresh,
            fresh_wpages=list(fresh_w),
        )

    # ------------------------------------------------------------------
    def complete(self, slot: int, prompt: Sequence[int]) -> int:
        """The prompt is fully resident: publish its full pages to the
        radix tree (idempotent for the shared span — those nodes exist).
        Returns the number of pages newly cached."""
        sp = self.slots[slot]
        if self.cache is None:
            return 0
        n_full = len(prompt) // self.page_size
        return self.cache.insert(prompt, sp.gpages[:n_full])

    # ------------------------------------------------------------------
    def retire(self, slot: int) -> None:
        """Release every page the slot maps; pages the cache still holds
        stay resident, everything else returns to the free lists."""
        sp = self.slots.pop(slot)
        for p in sp.gpages:
            self.galloc.release(p)
        if self.walloc is not None:
            for p in sp.wpages:
                self.walloc.release(p)

    # ------------------------------------------------------------------
    # invariant checks (driven by the property-based suite)
    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        for alloc, live in (
            (self.galloc, [sp.gpages for sp in self.slots.values()]),
            (self.walloc, [sp.wpages for sp in self.slots.values()]),
        ):
            if alloc is None:
                continue
            cache_pages = (
                self.cache.pages()
                if (self.cache is not None and alloc is self.galloc)
                else set()
            )
            free = alloc.free_set()
            # allocated + free == pool
            assert len(free) + alloc.n_allocated == alloc.n_pages
            counts = {p: 0 for p in range(alloc.n_pages)}
            for pages in live:
                assert len(pages) == len(set(pages)), "slot maps a page twice"
                for p in pages:
                    counts[p] += 1
            for p in cache_pages:
                counts[p] += 1
            for p in range(alloc.n_pages):
                # refcount == #mapping slots (+1 if the cache holds it)
                assert alloc.refcount[p] == counts[p], (
                    f"page {p}: refcount {alloc.refcount[p]} != "
                    f"{counts[p]} references"
                )
                # freed pages are never referenced by a live table/cache
                if p in free:
                    assert counts[p] == 0, f"freed page {p} still referenced"
                else:
                    assert counts[p] > 0, f"page {p} leaked (allocated, unreferenced)"
