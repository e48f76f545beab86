"""Host-side page allocator for the paged KV pool.

A copy of the parts of generativeaiexamples_tpu/engine/kv_pages.py that the
serving slice uses: a refcounted free list over the device page pool,
with physical page 0 reserved as the scratch page (dead rows and padding
writes land there), the sizing rules, the explicit paged layout's checks,
and the rules under which ``kv_layout='auto'`` serves the fixed layout
instead. The engine reserves every page a request can touch at admission
(prompt + generation budget + dispatch slack), so a decode step never
allocates and the pool never over-commits. A page is shared by refcount
between a prefix-cache entry and every request whose prompt starts with
that prefix (engine/prefix_cache.py): a hit maps the entry's pages into
the request's table (``retain``) and the insert after prefill donates the
request's own prompt pages the same way. The allocator counts in JAX's
``genai_engine_kv_page_*`` families and in plain integers (``stats()``);
a funding give-up notifies the black box.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

_REG = metrics_mod.get_registry()
_M_ALLOCS = _REG.counter(
    "genai_engine_kv_page_allocs_total",
    "KV-cache pages handed to requests by the page allocator.",
)
_M_FREES = _REG.counter(
    "genai_engine_kv_page_frees_total",
    "KV-cache pages whose refcount dropped to zero and returned to the "
    "free list.",
)
_M_ALLOC_FAILURES = _REG.counter(
    "genai_engine_kv_page_alloc_failures_total",
    "Admission page reservations refused because the free list was "
    "short (the request is requeued — OOM backpressure, not an error).",
)
_M_PREFIX_MAPPED = _REG.counter(
    "genai_engine_kv_prefix_pages_mapped_total",
    "Prefix-cache pages mapped zero-copy into a request's page table "
    "(refcount bump instead of a store->slot copy dispatch).",
)
_M_POOL_IN_USE = _REG.gauge(
    "genai_engine_kv_page_pool_in_use",
    "Pages currently held by live requests or prefix-cache entries.",
)
_M_POOL_CAPACITY = _REG.gauge(
    "genai_engine_kv_page_pool_capacity",
    "Allocatable pages in the device page pool (scratch page excluded).",
)
_M_POOL_UTIL = _REG.gauge(
    "genai_engine_kv_page_utilization_ratio",
    "Fraction of the page pool currently allocated.",
)
_M_FRAGMENTATION = _REG.gauge(
    "genai_engine_kv_page_fragmentation_ratio",
    "Internal fragmentation: fraction of live requests' allocated page "
    "tokens not (yet) holding sequence state — bounded below one page "
    "plus the reserved generation budget per request.",
)
_M_REQUEST_PAGES = _REG.histogram(
    "genai_engine_kv_request_pages",
    "Pages a request held over its lifetime, observed at release.",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
)


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


def pool_pages(cfg, max_seq_len: int, prefix_slots: int = 0) -> int:
    """Pool size in pages: ``kv_pool_pages`` when set, else one
    full-capacity strip per decode slot and one per prefix-cache slot
    (entries hold refcounted pool pages; the paged layout has no separate
    store), plus the scratch page."""
    if cfg.kv_pool_pages > 0:
        return cfg.kv_pool_pages
    per_slot = pages_for_tokens(max_seq_len, cfg.page_size)
    return 1 + (cfg.max_batch_size + max(0, prefix_slots)) * per_slot


def validate_config(cfg) -> None:
    """The checks of an explicit ``kv_layout='paged'``, with the JAX
    package's messages (``auto`` serves a geometry that does not tile on
    the fixed layout instead, :func:`auto_layout_blockers`)."""
    if cfg.kv_layout != "paged":
        return
    p = cfg.page_size
    if p <= 0 or (p & (p - 1)) != 0:
        raise ValueError(f"page_size must be a positive power of two, got {p}")
    if p > 128:
        raise ValueError(
            f"page_size must divide the 128-token attention-window rung (<= 128), got {p}"
        )
    if cfg.prefill_chunk % p:
        raise ValueError(
            f"prefill_chunk ({cfg.prefill_chunk}) must be a multiple of "
            f"page_size ({p}) so chunk-aligned prefix-cache entries are "
            f"page-aligned (zero-copy sharing needs whole pages)"
        )


def auto_layout_blockers(cfg, max_seq_len: int) -> List[str]:
    """Why ``kv_layout='auto'`` cannot resolve to paged for this config
    (empty list = paged): the page-geometry rules of the JAX package's
    list, the ones an explicit 'paged' would refuse. The port is always
    layered and always chunks, so those two rules never fire here. The
    engine logs the reasons where it falls back to the fixed layout."""
    reasons: List[str] = []
    p = cfg.page_size
    if p <= 0 or (p & (p - 1)) != 0 or p > 128:
        reasons.append(f"page_size {p} is not a power of two <= 128")
    elif cfg.prefill_chunk % p:
        reasons.append(
            f"prefill_chunk {cfg.prefill_chunk} is not a multiple of page_size {p}"
        )
    elif max_seq_len % p:
        reasons.append(
            f"effective max_seq_len {max_seq_len} is not a multiple of page_size {p}"
        )
    return reasons


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
    """Refcounted free-list allocator over the device page pool. Page 0
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
        self._refs: Dict[int, int] = {}  # guarded by self._lock
        self._allocs = 0  # guarded by self._lock
        self._frees = 0  # guarded by self._lock
        self._failures = 0  # guarded by self._lock
        self._prefix_mapped = 0  # guarded by self._lock
        _M_POOL_CAPACITY.set(self.capacity)
        _M_POOL_IN_USE.set(0)
        _M_POOL_UTIL.set(0.0)
        _M_FRAGMENTATION.set(0.0)

    def _update_gauges(self) -> None:
        """Caller holds self._lock."""
        used = len(self._refs)
        _M_POOL_IN_USE.set(used)
        _M_POOL_UTIL.set(used / self.capacity)

    def alloc(self, n: int, count_failure: bool = True) -> Optional[List[int]]:
        """Reserve ``n`` fresh pages (refcount 1 each); None when the free
        list is short (the caller requeues the request).
        ``count_failure=False`` keeps the attempts of an evict-and-retry
        loop out of the failure count (``record_alloc_failure`` counts its
        final give-up)."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                if count_failure:
                    self._failures += 1
                    _M_ALLOC_FAILURES.inc()
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            self._allocs += n
            _M_ALLOCS.inc(n)
            self._update_gauges()
            return pages

    def retain(self, pages: Sequence[int]) -> None:
        """Refcount bump for sharing (a prefix hit's map, an insert's
        donation). Every page must already be allocated."""
        if not pages:
            return
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError(f"retain of unallocated page {p}")
                self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> int:
        """Refcount drop; pages reaching zero return to the free list.
        Returns how many were freed."""
        if not pages:
            return 0
        freed = 0
        with self._lock:
            for p in pages:
                refs = self._refs.get(p)
                if refs is None:
                    raise ValueError(f"release of unallocated page {p}")
                if refs > 1:
                    self._refs[p] = refs - 1
                else:
                    del self._refs[p]
                    self._free.append(p)
                    freed += 1
            self._frees += freed
            if freed:
                _M_FREES.inc(freed)
            self._update_gauges()
        return freed

    def record_alloc_failure(self) -> None:
        """Count one admission the pool could not fund even after evicting
        unpinned prefix entries (it is requeued)."""
        with self._lock:
            self._failures += 1
        _M_ALLOC_FAILURES.inc()
        # N give-ups inside the storm window capture a debug bundle
        from generativeaiexamples_tpu_torch.utils import blackbox

        blackbox.notify_page_backpressure()

    def record_prefix_mapped(self, pages: int) -> None:
        """Count pages a prefix-cache hit mapped into a request's table."""
        with self._lock:
            self._prefix_mapped += pages
        _M_PREFIX_MAPPED.inc(pages)

    @staticmethod
    def observe_request_pages(n: int) -> None:
        """The pages a request held over its lifetime, at its release."""
        _M_REQUEST_PAGES.observe(n)

    @staticmethod
    def set_fragmentation(ratio: float) -> None:
        _M_FRAGMENTATION.set(max(0.0, min(1.0, ratio)))

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            used = len(self._refs)
            return {
                "page_size": self.page_size,
                "pages_capacity": self.capacity,
                "pages_in_use": used,
                "pages_free": len(self._free),
                "pages_shared": sum(1 for r in self._refs.values() if r > 1),
                "utilization": used / self.capacity,
                "page_allocs": self._allocs,
                "page_frees": self._frees,
                "page_alloc_failures": self._failures,
                "prefix_pages_mapped": self._prefix_mapped,
            }
