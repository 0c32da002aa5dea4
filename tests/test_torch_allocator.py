"""The port's page allocator and radix-tree prefix cache
(``repro_torch/serving/allocator.py``, its own copy of the reference's
pure-Python module) against the reference.

- The reference's unit cases (tests/test_allocator.py), run against the
  port's classes: free-list refcounts, radix match/insert/evict,
  BlockManager admission, exhaustion, sharing and alignment.
- Lockstep: the same seeded random sequence of ``try_admit`` /
  ``complete`` / ``retire`` / ``evict`` on the reference's BlockManager and
  the port's gives the same tables, ``cached_len``, fresh pages, evictions,
  refcounts and free lists, with ``check_invariants`` after every step.

Pure host-side Python: no torch, no JAX.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.serving import allocator as ref_alloc
from repro_torch.serving.allocator import (
    Admission,
    BlockManager,
    PageAllocator,
    PoolExhausted,
    PrefixCache,
)

P = 4  # page size used throughout


# ---------------------------------------------------------------------------
# PageAllocator
# ---------------------------------------------------------------------------

class TestPageAllocator:
    def test_alloc_release_roundtrip(self):
        a = PageAllocator(4)
        pages = [a.alloc() for _ in range(4)]
        assert sorted(pages) == [0, 1, 2, 3]
        assert a.n_free == 0 and a.n_allocated == 4
        for p in pages:
            assert a.release(p) is True
        assert a.n_free == 4 and a.n_allocated == 0

    def test_alloc_order_deterministic(self):
        # fresh pool hands out 0, 1, 2, ... — chunked-vs-oneshot tests rely
        # on identical page ids across identically-driven engines
        a, b = PageAllocator(6), PageAllocator(6)
        assert [a.alloc() for _ in range(6)] == [b.alloc() for _ in range(6)]

    def test_share_defers_free(self):
        a = PageAllocator(2)
        p = a.alloc()
        a.share(p)
        a.share(p)
        assert a.refcount[p] == 3
        assert a.release(p) is False
        assert a.release(p) is False
        assert a.release(p) is True          # last reference frees
        assert a.n_free == 2

    def test_exhaustion_raises(self):
        a = PageAllocator(1)
        a.alloc()
        with pytest.raises(PoolExhausted):
            a.alloc()

    def test_bad_refcount_ops_raise(self):
        a = PageAllocator(2)
        with pytest.raises(ValueError):
            a.release(0)
        with pytest.raises(ValueError):
            a.share(1)


# ---------------------------------------------------------------------------
# PrefixCache (radix tree)
# ---------------------------------------------------------------------------

def _toks(*blocks):
    out = []
    for b in blocks:
        out.extend([b] * P)
    return out


class TestPrefixCache:
    def test_match_longest_full_page_prefix(self):
        a = PageAllocator(8)
        c = PrefixCache(a, P)
        pages = [a.alloc() for _ in range(3)]
        c.insert(_toks(1, 2, 3), pages)
        assert c.match(_toks(1, 2, 3)) == pages
        assert c.match(_toks(1, 2, 9)) == pages[:2]
        assert c.match(_toks(9, 2, 3)) == []
        # partial trailing page never matches
        assert c.match(_toks(1) + [2, 2]) == pages[:1]

    def test_insert_takes_cache_reference(self):
        a = PageAllocator(4)
        c = PrefixCache(a, P)
        p = a.alloc()
        assert c.insert(_toks(7), [p]) == 1
        assert a.refcount[p] == 2            # slot + cache
        assert a.release(p) is False         # slot retires, cache holds it
        assert a.refcount[p] == 1

    def test_insert_idempotent(self):
        a = PageAllocator(4)
        c = PrefixCache(a, P)
        p, q = a.alloc(), a.alloc()
        assert c.insert(_toks(7), [p]) == 1
        # same block under a different physical page: first entry wins
        assert c.insert(_toks(7), [q]) == 0
        assert c.match(_toks(7)) == [p]
        assert a.refcount[q] == 1            # no extra reference taken

    def test_evict_lru_leaves_only(self):
        a = PageAllocator(8)
        c = PrefixCache(a, P)
        pages = [a.alloc() for _ in range(2)]
        c.insert(_toks(1, 2), pages)
        for p in pages:
            a.release(p)                     # cache is now the only holder
        c.match(_toks(1))                    # touch the interior node
        assert c.evict(1) == 1
        # the leaf (deeper block) went first despite the older stamp order
        assert c.match(_toks(1, 2)) == pages[:1]
        assert c.evict(1) == 1               # now the exposed parent
        assert c.match(_toks(1)) == []
        assert a.n_free == 8

    def test_evict_skips_shared_pages(self):
        a = PageAllocator(4)
        c = PrefixCache(a, P)
        p = a.alloc()
        c.insert(_toks(5), [p])              # refcount 2: slot + cache
        assert c.evict(1) == 0               # a live slot still maps it
        a.release(p)
        assert c.evict(1) == 1


# ---------------------------------------------------------------------------
# BlockManager: admission semantics
# ---------------------------------------------------------------------------

def _mgr(n_pages=8, gp_cols=2, prefix_cache=True, **kw):
    return BlockManager(
        n_pages=n_pages, page_size=P, gp_cols=gp_cols,
        prefix_cache=prefix_cache, **kw,
    )


class TestBlockManager:
    def test_admit_retire_roundtrip(self):
        m = _mgr(prefix_cache=False)
        adm = m.try_admit(0, [1] * 5)
        assert isinstance(adm, Admission)
        assert len(adm.table_row) == 2 and adm.cached_len == 0
        m.check_invariants()
        m.retire(0)
        m.check_invariants()
        assert m.galloc.n_free == 8

    def test_single_request_exceeding_pool_raises(self):
        m = _mgr(n_pages=1, gp_cols=2)
        with pytest.raises(PoolExhausted):
            m.try_admit(0, [1] * 5)

    def test_oversubscription_queues_not_raises(self):
        # pool fits exactly one request; the second must wait, not die
        m = _mgr(n_pages=2, gp_cols=2, prefix_cache=False)
        assert m.try_admit(0, [1] * 8) is not None
        assert m.try_admit(1, [2] * 8) is None
        m.check_invariants()
        m.retire(0)
        assert m.try_admit(1, [2] * 8) is not None
        m.check_invariants()

    def test_prefix_sharing_and_refcounts(self):
        m = _mgr(n_pages=8, gp_cols=3)
        prompt = _toks(1, 2) + [3, 3]        # 2 full pages + partial
        a0 = m.try_admit(0, prompt)
        m.complete(0, prompt)
        a1 = m.try_admit(1, prompt)
        # slot 1 maps slot 0's full prompt pages copy-free
        assert a1.table_row[:2] == a0.table_row[:2]
        assert a1.cached_len == 2 * P
        assert a1.fresh_pages == a1.table_row[2:]
        for p in a0.table_row[:2]:
            assert m.galloc.refcount[p] == 3  # two slots + cache
        m.check_invariants()
        m.retire(0)
        m.retire(1)
        m.check_invariants()
        # pages survive retirement inside the cache
        assert m.cache is not None and len(m.cache) == 2

    def test_shared_span_capped_below_plen(self):
        # a fully-cached prompt still recomputes its last token (first-token
        # logits must come from somewhere)
        m = _mgr(n_pages=8, gp_cols=2)
        prompt = _toks(1, 2)                 # exactly 2 full pages
        m.try_admit(0, prompt)
        m.complete(0, prompt)
        m.retire(0)
        adm = m.try_admit(1, prompt)
        assert adm.cached_len == P           # not 2 * P
        m.check_invariants()

    def test_shared_span_alignment(self):
        m = _mgr(n_pages=12, gp_cols=3)
        prompt = _toks(1, 2, 3)[:-1]         # 2 full pages + 3 tokens
        m.try_admit(0, prompt)
        m.complete(0, prompt)
        m.retire(0)
        adm = m.try_admit(1, prompt, align_pages=2)
        assert adm.cached_len == 2 * P       # floor(2 pages, align 2) = 2
        m.retire(1)
        adm = m.try_admit(2, _toks(1) + [9] * 4, align_pages=2)
        assert adm.cached_len == 0           # 1 matching page floors to 0
        m.check_invariants()

    def test_eviction_under_pressure(self):
        # more unique prefixes than the pool holds: old cache entries are
        # evicted to admit new requests, and invariants survive the churn
        m = _mgr(n_pages=4, gp_cols=2)
        for i in range(6):
            prompt = _toks(10 + i) + [1, 2]
            adm = m.try_admit(0, prompt)
            assert adm is not None, f"iteration {i} starved"
            m.complete(0, prompt)
            m.retire(0)
            m.check_invariants()

    def test_all_slots_share_then_diverge(self):
        # the pathological case: every slot shares one prefix, then each
        # needs private pages for its divergent suffix
        m = _mgr(n_pages=10, gp_cols=3)
        base = _toks(1, 2)
        first = base + [50, 50, 50, 50]
        m.try_admit(0, first)
        m.complete(0, first)
        for s in (1, 2):
            prompt = base + [60 + s] * 4
            adm = m.try_admit(s, prompt)
            assert adm.cached_len == 2 * P
            assert adm.table_row[:2] == m.slots[0].gpages[:2]
            m.complete(s, prompt)
        for p in m.slots[0].gpages[:2]:
            assert m.galloc.refcount[p] == 4  # 3 slots + cache
        m.check_invariants()
        for s in (0, 1, 2):
            m.retire(s)
        m.check_invariants()

    def test_failed_admission_rolls_back_shares(self):
        # an admission that matches the cache but cannot get private pages
        # must drop the shared references it took
        m = _mgr(n_pages=4, gp_cols=4)
        prompt = _toks(1, 2) + [3] * 8
        m.try_admit(0, prompt)
        m.complete(0, prompt)
        rc_before = list(m.galloc.refcount)
        assert m.try_admit(1, _toks(1, 2) + [4] * 8) is None
        assert m.galloc.refcount == rc_before
        m.check_invariants()

    def test_windowed_configs_disable_sharing(self):
        m = BlockManager(
            n_pages=8, page_size=P, gp_cols=2, wp_cols=2, n_window_pages=8,
            prefix_cache=True,
        )
        assert m.cache is None
        adm = m.try_admit(0, [1] * 8)
        assert adm.cached_len == 0 and len(adm.wtab_row) == 2
        m.complete(0, [1] * 8)               # no-op without a cache
        m.check_invariants()
        m.retire(0)
        m.check_invariants()


# ---------------------------------------------------------------------------
# lockstep against the reference
# ---------------------------------------------------------------------------

def _snapshot(m):
    cache = m.cache
    return dict(
        free=list(m.galloc._free), refcount=list(m.galloc.refcount),
        slots={s: (sp.gpages, sp.n_shared) for s, sp in m.slots.items()},
        cache=None if cache is None else (
            sorted(cache.pages()), cache.n_hit_pages, cache.n_inserted,
            cache.n_evicted),
    )


def _adm(a):
    return None if a is None else (a.table_row, a.cached_len, a.fresh_pages)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_lockstep_with_reference_block_manager(seed, prefix_cache):
    """Prompts from a tiny alphabet (so prefixes collide: sharing, refcounts
    above 2, eviction), several alignments, a pool that runs dry."""
    rng = np.random.default_rng(seed)
    n_slots, gp_cols = 4, 3
    kw = dict(n_pages=10, page_size=P, gp_cols=gp_cols,
              prefix_cache=prefix_cache)
    ours, theirs = BlockManager(**kw), ref_alloc.BlockManager(**kw)
    admitted = {}
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0:
            slot = int(rng.integers(0, n_slots))
            if slot in admitted:
                continue
            body = rng.integers(0, 3, size=rng.integers(1, 4))
            prompt = [int(b) for b in body for _ in range(P)]
            prompt = (prompt + [7] * int(rng.integers(1, 2 * P)))[:gp_cols * P]
            align = int(rng.integers(1, 3))
            got = ours.try_admit(slot, prompt, align_pages=align)
            want = theirs.try_admit(slot, prompt, align_pages=align)
            assert _adm(got) == _adm(want)
            if got is not None:
                admitted[slot] = prompt
        elif op == 1 and admitted:
            slot = sorted(admitted)[int(rng.integers(0, len(admitted)))]
            assert ours.complete(slot, admitted[slot]) == \
                theirs.complete(slot, admitted[slot])
        elif op == 2 and admitted:
            slot = sorted(admitted)[int(rng.integers(0, len(admitted)))]
            ours.retire(slot)
            theirs.retire(slot)
            del admitted[slot]
        elif op == 3 and prefix_cache:
            n = int(rng.integers(1, 5))
            assert ours.cache.evict(n) == theirs.cache.evict(n)
        ours.check_invariants()
        theirs.check_invariants()
        assert _snapshot(ours) == _snapshot(theirs)
