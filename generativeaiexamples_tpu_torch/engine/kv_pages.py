"""Host-side page allocator for the paged KV pool.

A copy of the parts of generativeaiexamples_tpu/engine/kv_pages.py that the
serving slice uses: a free list over the device page pool, with
physical page 0 reserved as the scratch page (dead rows and padding writes
land there), and the sizing rules. The engine reserves every page a request
can touch at admission (prompt + generation budget + dispatch slack), so a
decode step never allocates and the pool never over-commits. Counters are
plain integers (``stats()``). Refcounted sharing comes with the prefix
cache.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set

SCRATCH_PAGE = 0


def pages_for_tokens(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` rows (ceil)."""
    return (max(0, tokens) + page_size - 1) // page_size


def pages_needed(
    prompt_len: int, max_tokens: int, page_size: int, max_seq_len: int, slack: int
) -> int:
    """Worst-case pages one request can touch: prompt + generation budget
    + ``slack`` tokens a decode block can write past the budget, capped at
    the per-slot capacity."""
    return pages_for_tokens(min(prompt_len + max_tokens + slack, max_seq_len), page_size)


def pool_pages(cfg, max_seq_len: int) -> int:
    """Pool size in pages: ``kv_pool_pages`` when set, else one
    full-capacity strip per decode slot, plus the scratch page."""
    if cfg.kv_pool_pages > 0:
        return cfg.kv_pool_pages
    return 1 + cfg.max_batch_size * pages_for_tokens(max_seq_len, cfg.page_size)


def validate_runtime(page_size: int, max_seq_len: int, pool: int) -> None:
    """Checks that need the effective sequence capacity and pool size."""
    if max_seq_len % page_size:
        raise ValueError(
            f"effective max_seq_len ({max_seq_len}) must be a multiple of page_size ({page_size})"
        )
    per_slot = pages_for_tokens(max_seq_len, page_size)
    if pool < 1 + per_slot:
        raise ValueError(
            f"kv_pool_pages ({pool}) cannot hold even one full-length request "
            f"({per_slot} pages + 1 scratch)"
        )


class PageAllocator:
    """Free-list allocator over the device page pool. Page 0
    (``SCRATCH_PAGE``) is never handed out."""

    def __init__(self, pool: int, page_size: int) -> None:
        if pool < 2:
            raise ValueError(f"page pool needs >= 2 pages, got {pool}")
        if page_size <= 0:
            raise ValueError(f"page_size must be > 0, got {page_size}")
        self.pool = pool
        self.page_size = page_size
        self.capacity = pool - 1  # scratch page excluded
        self._lock = threading.Lock()
        # pop() hands out page 1 first
        self._free: List[int] = list(range(pool - 1, 0, -1))  # guarded by self._lock
        self._used: Set[int] = set()  # guarded by self._lock
        self._allocs = 0  # guarded by self._lock
        self._frees = 0  # guarded by self._lock
        self._failures = 0  # guarded by self._lock

    def alloc(self, n: int) -> Optional[List[int]]:
        """Reserve ``n`` fresh pages; None when the free list is short
        (the caller requeues the request)."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                self._failures += 1
                return None
            pages = [self._free.pop() for _ in range(n)]
            self._used.update(pages)
            self._allocs += n
            return pages

    def release(self, pages: Sequence[int]) -> int:
        """Return pages to the free list; returns how many."""
        with self._lock:
            for p in pages:
                if p not in self._used:
                    raise ValueError(f"release of unallocated page {p}")
                self._used.remove(p)
                self._free.append(p)
            self._frees += len(pages)
        return len(pages)

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            used = len(self._used)
            return {
                "page_size": self.page_size,
                "pages_capacity": self.capacity,
                "pages_in_use": used,
                "pages_free": len(self._free),
                "utilization": used / self.capacity,
                "page_allocs": self._allocs,
                "page_frees": self._frees,
                "page_alloc_failures": self._failures,
            }
