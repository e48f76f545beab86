"""The prefill -> decode handoff of the ``disagg`` policy.

Counterpart of generativeaiexamples_tpu/engine/scheduler/handoff.py. The
prefill tier finishes a wave's prefill (every KV page written into the
shared pool) and hands each request to the decode tier as a
:class:`KVHandoff` through a bounded :class:`TransferQueue`. Both tiers
share the pool, so the handoff moves page ownership: the refcounts funded
at admission travel with the record, with no copy and no recompute.

A full queue stalls the prefill tier before it claims its next wave.
The counters are plain integers (``counters``): handoffs, pages, bytes,
stall and wait seconds, and recomputes (a record whose pages were dead at
import; it must stay 0).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

_COUNTERS_LOCK = threading.Lock()
counters: "collections.Counter[str]" = collections.Counter(dict.fromkeys((
    "handoffs", "handoff_pages", "handoff_bytes", "handoff_stall_seconds",
    "handoff_wait_seconds", "handoff_recompute",
), 0))


def metrics_snapshot() -> dict:
    with _COUNTERS_LOCK:
        return dict(counters)


def _add(**values) -> None:
    with _COUNTERS_LOCK:
        counters.update(values)


def record_handoff(pages: int, nbytes: int) -> None:
    """Count one handoff (at enqueue)."""
    _add(handoffs=1, handoff_pages=pages, handoff_bytes=nbytes)


def record_stall(seconds: float) -> None:
    """Prefill-tier time stalled on a full queue."""
    _add(handoff_stall_seconds=seconds)


def record_wait(seconds: float) -> None:
    """Enqueue-to-import time of one record."""
    _add(handoff_wait_seconds=seconds)


def record_recompute() -> None:
    """A record whose pages were dead at import (requeued)."""
    _add(handoff_recompute=1)


@dataclasses.dataclass
class KVHandoff:
    """One prefilled request crossing the tier boundary.

    ``req`` is the engine's request handle; its KV already sits in the
    pool pages ``pages``. ``position`` and ``budget`` seed the decode
    tier's slot shadows; ``spec_tokens`` carries the spec proposer's
    context (prompt + first token) when the request drafts. ``state`` holds the request's device slot state
    from the prefill (slot, first token, position, temperature, top_p,
    seed: one-element tensors) that the import writes into the decode
    batch's tensors. ``nbytes`` is what a cross-replica transport would
    ship."""

    req: Any
    slot: int
    position: int
    budget: int
    pages: Tuple[int, ...] = ()
    nbytes: int = 0
    state: Optional[tuple] = None
    spec_tokens: Optional[List[int]] = None
    t_enqueue: float = dataclasses.field(default_factory=time.time)


class TransferQueue:
    """Bounded tier-to-tier queue. Every method runs under an external
    condition (``cond``: the engine lock, or the retrieval tier's), so
    queue transitions wake the waiters of that condition. A record only
    needs ``.req.rid``."""

    def __init__(self, capacity: int, cond) -> None:
        if capacity < 1:
            raise ValueError(f"transfer queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._cond = cond
        self._q: "collections.deque" = collections.deque()  # guarded by self._cond

    def __len__(self) -> int:
        """Caller holds self._cond."""
        return len(self._q)

    def has_room(self) -> bool:
        """Caller holds self._cond."""
        return len(self._q) < self.capacity

    def wait_room(self, stop: Callable[[], bool], slice_s: float = 0.2) -> float:
        """Block until there is room or ``stop()`` is true; returns the
        seconds waited. Caller holds self._cond (released while waiting)."""
        t0 = time.monotonic()
        while len(self._q) >= self.capacity and not stop():
            self._cond.wait(timeout=slice_s)
        return time.monotonic() - t0

    def put(self, rec) -> None:
        """Enqueue and wake the consumer. A wave may overshoot the capacity
        by its own rows (room is reserved a wave at a time). Caller holds
        self._cond."""
        self._q.append(rec)
        self._cond.notify_all()

    def pop_all(self) -> List[Any]:
        """Every queued record, and a wake for a stalled producer. Caller
        holds self._cond."""
        out = list(self._q)
        self._q.clear()
        if out:
            self._cond.notify_all()
        return out
