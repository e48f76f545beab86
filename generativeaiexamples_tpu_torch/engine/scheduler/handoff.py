"""The prefill -> decode handoff of the ``disagg`` policy.

Counterpart of generativeaiexamples_tpu/engine/scheduler/handoff.py. The
prefill tier finishes a wave's prefill (every KV page written into the
shared pool) and hands each request to the decode tier as a
:class:`KVHandoff` through a bounded :class:`TransferQueue`. Both tiers
share the pool, so the handoff moves page ownership: the refcounts funded
at admission travel with the record, with no copy and no recompute.

A full queue stalls the prefill tier before it claims its next wave.
The counters (handoffs, pages, bytes, stall and wait seconds, and
recomputes: a record whose pages were dead at import; it must stay 0)
are JAX's ``genai_engine_handoff_*`` families (``metrics_snapshot`` reads
them under JAX's flat keys); the queue's depth is a gauge.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

_REG = metrics_mod.get_registry()
_M_HANDOFFS = _REG.counter(
    "genai_engine_handoffs_total",
    "Requests handed from the prefill tier to the decode tier "
    "(disagg scheduler policy; docs/scheduler.md).",
)
_M_HANDOFF_PAGES = _REG.counter(
    "genai_engine_handoff_pages_total",
    "KV pages whose ownership moved prefill→decode tier with a "
    "handoff. Same-host tiers share the pool, so these pages move by "
    "refcount, not by copy.",
)
_M_HANDOFF_BYTES = _REG.counter(
    "genai_engine_handoff_bytes_total",
    "KV bytes represented by handed-off pages (what a cross-replica "
    "transport would put on the wire; zero device traffic on the "
    "same-host shared-pool path).",
)
_M_HANDOFF_STALL = _REG.counter(
    "genai_engine_handoff_stall_seconds_total",
    "Seconds the prefill tier stalled on a full transfer queue before "
    "claiming its next admission wave (handoff backpressure).",
)
_M_HANDOFF_WAIT = _REG.counter(
    "genai_engine_handoff_wait_seconds_total",
    "Seconds handed-off requests waited in the transfer queue before "
    "the decode tier imported them (decode-tier stall time: grows when "
    "decode cannot keep up with prefill).",
)
_M_HANDOFF_RECOMPUTE = _REG.counter(
    "genai_engine_handoff_recompute_total",
    "Handed-off requests whose pages were no longer live at import and "
    "had to requeue for a full re-prefill. Structurally zero on the "
    "same-host path (refcounts travel with the record) — the bench and "
    "the disagg loadgen gate assert this stays flat, the paged "
    "layout's prefix-copy-dispatch discipline applied to handoffs.",
)
_M_QUEUE_DEPTH = _REG.gauge(
    "genai_engine_handoff_queue_depth",
    "Requests currently sitting in the prefill→decode transfer queue.",
)


def metrics_snapshot() -> dict:
    """The JAX engine's flat keys for the handoff families."""
    return {
        "handoffs": _M_HANDOFFS.value,
        "handoff_pages": _M_HANDOFF_PAGES.value,
        "handoff_bytes": _M_HANDOFF_BYTES.value,
        "handoff_stall_seconds": _M_HANDOFF_STALL.value,
        "handoff_wait_seconds": _M_HANDOFF_WAIT.value,
        "handoff_recompute": _M_HANDOFF_RECOMPUTE.value,
    }


def record_handoff(pages: int, nbytes: int) -> None:
    """Count one handoff (at enqueue)."""
    _M_HANDOFFS.inc()
    _M_HANDOFF_PAGES.inc(pages)
    _M_HANDOFF_BYTES.inc(nbytes)


def record_stall(seconds: float) -> None:
    """Prefill-tier time stalled on a full queue."""
    _M_HANDOFF_STALL.inc(seconds)


def record_wait(seconds: float) -> None:
    """Enqueue-to-import time of one record."""
    _M_HANDOFF_WAIT.inc(seconds)


def record_recompute() -> None:
    """A record whose pages were dead at import (requeued)."""
    _M_HANDOFF_RECOMPUTE.inc()


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
    needs ``.req.rid``. ``depth_gauge`` tracks its occupancy (the KV
    handoff's family by default; the retrieval tier passes its own)."""

    def __init__(self, capacity: int, cond, depth_gauge=None) -> None:
        if capacity < 1:
            raise ValueError(f"transfer queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._cond = cond
        self._depth_gauge = depth_gauge if depth_gauge is not None else _M_QUEUE_DEPTH
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
        self._depth_gauge.set(len(self._q))
        self._cond.notify_all()

    def pop_all(self) -> List[Any]:
        """Every queued record, and a wake for a stalled producer. Caller
        holds self._cond."""
        out = list(self._q)
        self._q.clear()
        self._depth_gauge.set(0)
        if out:
            self._cond.notify_all()
        return out
