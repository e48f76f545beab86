"""The port's page allocator against the JAX package's
(generativeaiexamples_tpu/engine/kv_pages.py) on the prefix cache's side of
it: refcounted pages (``alloc`` at refcount 1, ``retain``, ``release`` by
refcount, ``refcount``, the shared count of ``stats()``), the pool sizing
with one extra strip per prefix-cache slot (``pool_pages``), and the
explicit paged layout's checks with JAX's messages. Seeded operation
sequences go through both allocators and every answer is compared."""
import dataclasses

import numpy as np
import pytest

from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine import kv_pages as jkv
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import kv_pages

_SAME_STATS = ("page_size", "pages_capacity", "pages_in_use", "pages_free", "pages_shared",
               "utilization")


def _call(fn, *args):
    """(result, None) or (None, the ValueError's message)."""
    try:
        return fn(*args), None
    except ValueError as exc:
        return None, str(exc)


@pytest.mark.parametrize("seed", range(8))
def test_retain_release_sequences_match_jax(seed):
    """Random alloc / retain / release sequences (including pages never
    allocated, and over-long allocations the pool refuses): the same pages
    handed out, the same freed counts, refcounts, errors and stats."""
    rng = np.random.default_rng(seed)
    pool = int(rng.integers(3, 24))
    mine, ref = kv_pages.PageAllocator(pool, 8), jkv.PageAllocator(pool, 8)
    held = []  # pages with at least one reference, one entry per reference
    for _ in range(200):
        op = rng.choice(["alloc", "retain", "release", "bogus"])
        if op == "alloc":
            n = int(rng.integers(0, pool + 2))
            got, want = mine.alloc(n, count_failure=bool(rng.integers(2))), ref.alloc(n)
            assert got == want
            held.extend(got or ())
        elif op in ("retain", "release") and held:
            idx = rng.choice(len(held), size=int(rng.integers(1, min(4, len(held)) + 1)),
                             replace=False)
            pages = [held[i] for i in idx]
            if op == "retain":
                assert _call(mine.retain, pages) == _call(ref.retain, pages)
                held.extend(pages)
            else:
                assert _call(mine.release, pages) == _call(ref.release, pages)
                for p in pages:
                    held.remove(p)
        elif op == "bogus":
            # a page no one holds (or the scratch page): both refuse
            page = next(p for p in range(pool) if p not in held)
            assert _call(mine.retain, [page]) == _call(ref.retain, [page])
            assert _call(mine.release, [page]) == _call(ref.release, [page])
        assert mine.free_pages() == ref.free_pages()
        for p in range(pool):
            assert mine.refcount(p) == ref.refcount(p) == held.count(p)
        s_mine, s_ref = mine.stats(), ref.stats()
        assert {k: s_mine[k] for k in _SAME_STATS} == {k: s_ref[k] for k in _SAME_STATS}


def test_a_shared_page_returns_at_refcount_zero():
    alloc = kv_pages.PageAllocator(4, 8)
    pages = alloc.alloc(2)
    alloc.retain(pages[:1])
    assert alloc.stats()["pages_shared"] == 1
    assert alloc.release(pages) == 1  # the retained page keeps one reference
    assert alloc.refcount(pages[0]) == 1 and alloc.refcount(pages[1]) == 0
    assert alloc.release(pages[:1]) == 1
    assert alloc.free_pages() == 3 and alloc.stats()["page_frees"] == 2


def test_failure_and_prefix_mapped_counts():
    """``count_failure=False`` (an evict-and-retry attempt) is no failure;
    ``record_alloc_failure`` counts the final give-up, and
    ``record_prefix_mapped`` the pages a hit maps."""
    alloc = kv_pages.PageAllocator(3, 8)
    assert alloc.alloc(5, count_failure=False) is None
    assert alloc.stats()["page_alloc_failures"] == 0
    alloc.record_alloc_failure()
    assert alloc.alloc(5) is None
    alloc.record_prefix_mapped(3)
    alloc.record_prefix_mapped(0)
    stats = alloc.stats()
    assert (stats["page_alloc_failures"], stats["prefix_pages_mapped"]) == (2, 3)


_GRID = [
    dict(max_batch_size=b, max_seq_len=s, page_size=p, kv_pool_pages=pool)
    for b in (1, 8) for s in (1000, 8192) for p in (8, 128) for pool in (0, 77)
]


@pytest.mark.parametrize("slots", [0, 1, 4, -2])
@pytest.mark.parametrize("fields", _GRID, ids=lambda f: "-".join(map(str, f.values())))
def test_pool_pages_matches_jax(fields, slots):
    """One full strip per decode slot and per prefix slot, plus the
    scratch page, or ``kv_pool_pages`` when set (a negative slot count
    reserves nothing)."""
    mine = EngineConfig(**fields)
    ref = JaxEngineConfig(**fields)
    assert kv_pages.pool_pages(mine, fields["max_seq_len"], slots) == jkv.pool_pages(
        ref, fields["max_seq_len"], slots)


@pytest.mark.parametrize("fields", [
    dict(page_size=12), dict(page_size=0), dict(page_size=256), dict(prefill_chunk=20),
    dict(prefill_chunk=520, page_size=16), dict(page_size=8), dict(),
], ids=lambda f: "-".join(f"{k}{v}" for k, v in f.items()) or "defaults")
def test_explicit_paged_checks_give_jax_messages(fields):
    """An explicit ``kv_layout='paged'`` refuses a page geometry that does
    not tile with JAX's message (the prefill chunk's one names the prefix
    cache's whole pages), from ``kv_pages.validate_config`` and from
    ``EngineConfig.validate``."""
    fields = dict(fields, kv_layout="paged")
    ref = dataclasses.replace(JaxEngineConfig(), **fields)
    want = _call(jkv.validate_config, ref)[1]
    assert _call(kv_pages.validate_config, EngineConfig(**fields))[1] == want
    assert _call(EngineConfig(**fields).validate)[1] == want
    # auto serves such a geometry on the fixed layout instead
    EngineConfig(**dict(fields, kv_layout="auto")).validate()
