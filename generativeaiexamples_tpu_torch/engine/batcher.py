"""Cross-request dynamic micro-batching for the retrieval side-models.

Counterpart of generativeaiexamples_tpu/engine/batcher.py. ``MicroBatcher``
is the scheduler the embedder and the reranker share:

- callers enqueue ``(payload, future)`` items from their request
  threads; one named daemon dispatch thread forms batches up to
  ``max_batch`` rows or ``max_wait_ms`` (whichever comes first), issues
  ONE device dispatch, and scatters the results back to the futures;
- the row count handed to the model is padded up a power-of-two ladder
  (``row_bucket``), as in JAX, so both packages dispatch the same shapes;
- two priority lanes: ``LANE_QUERY`` (interactive query embeds, rerank
  pairs) always dispatches before ``LANE_INGEST`` (bulk document
  embedding);
- the ingest lane yields to the engine: before each bulk dispatch it
  waits an optional gate (the embedder passes the LLM engine scheduler's
  ``ingest_window``: open when no decode slot is held) in short slices up
  to ``gate_budget_ms``; a query arriving between slices re-queues the
  bulk batch and is served first. The query lane never yields;
- batch waits respect the request ``Deadline`` (``utils/resilience.py``):
  each item captures its submitting thread's deadline, the batch flushes
  no later than the earliest queued deadline, and an item whose budget is
  gone fails with ``DeadlineExceeded`` instead of wasting a dispatch.

Each dispatch counts in JAX's ``genai_batcher_*`` families (queue wait,
rows, dispatches by model and lane) and stamps a ``batcher_coalesced``
flight event on each item's request; ``MicroBatcher.counters`` also
counts dispatches and rows by lane and the ingest batches the gate held,
with the seconds they waited.
"""
from __future__ import annotations

import collections
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.utils import flight_recorder
from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod
from generativeaiexamples_tpu_torch.utils import resilience

_REG = metrics_mod.get_registry()
_M_BATCH_ROWS = _REG.histogram(
    "genai_batcher_batch_rows",
    "Live rows coalesced into one device dispatch, by model and lane "
    "(before row-ladder padding).",
    ("model", "lane"),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
_M_QUEUE_WAIT = _REG.histogram(
    "genai_batcher_queue_wait_ms",
    "Milliseconds an item waited in the batcher queue before its batch "
    "dispatched, by model and lane.",
    ("model", "lane"),
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0),
)
_M_DISPATCHES = _REG.counter(
    "genai_batcher_coalesced_dispatches_total",
    "Device dispatches issued by the micro-batcher, by model and lane.",
    ("model", "lane"),
)


LANE_QUERY = "query"
LANE_INGEST = "ingest"
#: Priority order: interactive queries never queue behind bulk ingestion.
LANES: Tuple[str, ...] = (LANE_QUERY, LANE_INGEST)

#: Fallback cap on a future wait when the item carries no deadline.
DEFAULT_RESULT_TIMEOUT_S = 600.0

#: When a queued item's deadline caps the batch window, flush this far
#: before the deadline instant.
DEADLINE_FLUSH_GUARD_S = 0.010

#: The ingest gate is waited in slices this long, so a query arriving
#: mid-gate preempts the bulk batch within one slice.
GATE_SLICE_S = 0.005


def row_ladder(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two row rungs up to ``max_batch`` (inclusive as the last
    rung even when it is not a power of two): 1, 2, 4, ... max_batch."""
    rungs: List[int] = []
    rung = 1
    while rung < max_batch:
        rungs.append(rung)
        rung *= 2
    rungs.append(max_batch)
    return tuple(rungs)


def row_bucket(n: int, max_batch: int) -> int:
    """Smallest ladder rung holding ``n`` rows."""
    for rung in row_ladder(max_batch):
        if n <= rung:
            return rung
    return max_batch


class BatchItem:
    """One enqueued payload and its future. The submitting thread's
    deadline is captured at construction (the dispatch thread has no
    binding of its own)."""

    __slots__ = ("payload", "enqueued", "deadline_at", "flight_rec", "_event", "_result",
                 "_error")

    def __init__(self, payload):
        self.payload = payload
        self.enqueued = time.monotonic()
        deadline = resilience.get_current_deadline()
        self.deadline_at: Optional[float] = (
            self.enqueued + deadline.remaining() if deadline is not None else None
        )
        # the submitting request's flight record (the dispatch thread has
        # no binding of its own)
        self.flight_rec = flight_recorder.current()
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def set_result(self, result) -> None:
        self._result = result
        self._event.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def get(self, timeout: Optional[float] = None):
        """Block for the batched result. The default timeout is the item's
        own deadline budget plus a 5 s dispatch grace, else
        ``DEFAULT_RESULT_TIMEOUT_S``."""
        if timeout is None:
            if self.deadline_at is not None:
                timeout = max(0.0, self.deadline_at - time.monotonic()) + 5.0
            else:
                timeout = DEFAULT_RESULT_TIMEOUT_S
        if not self._event.wait(timeout):
            raise TimeoutError("micro-batch result did not arrive in time")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Deadline-aware cross-request dynamic batcher (one per side-model).

    ``dispatch(payloads, pad_rows)`` runs on the batcher thread
    (``batcher-<model>``) with the coalesced live payloads and the ladder
    rung to pad the row dimension to; it returns one result per payload.
    One batcher = one dispatch thread = at most one device call in flight
    per model. The thread starts at the first ``submit``.

    ``ingest_gate(timeout_s) -> bool`` (True = proceed now) is waited in
    ``GATE_SLICE_S`` slices for up to ``gate_budget_ms`` before each
    ingest-lane dispatch.
    """

    def __init__(
        self,
        model: str,
        dispatch: Callable[[List[object], int], Sequence[object]],
        max_batch: int = 32,
        max_wait_ms: float = 4.0,
        ingest_gate: Optional[Callable[[float], bool]] = None,
        gate_budget_ms: float = 50.0,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self.model = model
        self.max_batch = int(max_batch)
        self._dispatch = dispatch
        self._wait_s = float(max_wait_ms) / 1000.0
        self._ingest_gate = ingest_gate
        self._gate_budget_s = max(0.0, float(gate_budget_ms) / 1000.0)
        self._cond = threading.Condition()
        self._queues: Dict[str, Deque[BatchItem]] = {lane: deque() for lane in LANES}  # guarded by self._cond
        self._held = 0  # guarded by self._cond
        self._running = False  # guarded by self._cond
        self._closed = False  # guarded by self._cond
        self._thread: Optional[threading.Thread] = None  # guarded by self._cond
        # written by the dispatch thread only: "<lane>_dispatches",
        # "<lane>_rows", "ingest_gated_batches", "ingest_gate_wait_s"
        self.counters: "collections.Counter[str]" = collections.Counter()

    # ------------------------------------------------------------------ #
    # submission side

    def submit(self, payload, lane: str = LANE_QUERY) -> BatchItem:
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r} (want one of {LANES})")
        item = BatchItem(payload)
        with self._cond:
            if self._closed:
                raise RuntimeError(f"batcher {self.model!r} is closed")
            if self._thread is None or not self._thread.is_alive():
                self._running = True
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name=f"batcher-{self.model}"
                )
                self._thread.start()
            self._queues[lane].append(item)
            self._cond.notify_all()
        return item

    def submit_many(self, payloads: Sequence[object], lane: str = LANE_QUERY) -> List[BatchItem]:
        """Enqueue a whole work list atomically (under ``hold``), so the
        dispatch thread sees full batches instead of a ragged prefix."""
        with self.hold():
            return [self.submit(p, lane=lane) for p in payloads]

    def hold(self):
        """Context manager pausing batch formation while items enqueue."""
        batcher = self

        class _Hold:
            def __enter__(self):
                with batcher._cond:
                    batcher._held += 1

            def __exit__(self, *exc):
                with batcher._cond:
                    batcher._held -= 1
                    batcher._cond.notify_all()
                return False

        return _Hold()

    def queue_depth(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._queues.values())

    def close(self) -> None:
        """Stop the dispatch thread and fail anything still queued;
        subsequent ``submit`` calls raise."""
        with self._cond:
            self._closed = True
            self._running = False
            pending = [item for q in self._queues.values() for item in q]
            for q in self._queues.values():
                q.clear()
            self._cond.notify_all()
            thread = self._thread
            self._thread = None
        for item in pending:
            item.set_error(RuntimeError(f"batcher {self.model!r} closed"))
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)

    # ------------------------------------------------------------------ #
    # dispatch side

    def _pick_lane(self) -> Optional[str]:
        """First lane with queued work, in priority order. Caller holds
        self._cond."""
        for lane in LANES:
            if self._queues[lane]:
                return lane
        return None

    def _flush_at(self, queue: Deque[BatchItem]) -> float:
        """Absolute monotonic time this batch must dispatch by: the oldest
        item's wait window, capped by every queued deadline. Caller holds
        self._cond."""
        at = queue[0].enqueued + self._wait_s
        for item in queue:
            if item.deadline_at is not None:
                at = min(at, item.deadline_at - DEADLINE_FLUSH_GUARD_S)
        return at

    def _take_batch(self) -> Tuple[str, List[BatchItem]]:
        """Block until a batch is due (full, window expired, or deadline
        capped), honoring lane priority."""
        with self._cond:
            while True:
                if not self._running:
                    return "", []
                lane = None if self._held else self._pick_lane()
                if lane is None:
                    self._cond.wait()
                    continue
                queue = self._queues[lane]
                if len(queue) >= self.max_batch:
                    break
                now = time.monotonic()
                flush_at = self._flush_at(queue)
                if now >= flush_at:
                    break
                # re-pick after every wake: a query arriving while an
                # ingest window fills preempts it
                self._cond.wait(min(flush_at - now, 0.05))
            batch = [queue.popleft() for _ in range(min(len(queue), self.max_batch))]
            return lane, batch

    def _fail_expired(self, batch: List[BatchItem], now: float) -> List[BatchItem]:
        """Fail items whose deadline has passed; return the live rest."""
        live: List[BatchItem] = []
        for item in batch:
            if item.deadline_at is not None and now >= item.deadline_at:
                item.set_error(
                    resilience.DeadlineExceeded(
                        "request deadline exhausted waiting for a "
                        f"{self.model!r} micro-batch"
                    )
                )
            else:
                live.append(item)
        return live

    def _gate_ingest(self, live: List[BatchItem]) -> bool:
        """Yield the bulk batch to live decode: wait the ingest gate in
        short slices, bounded by the gate budget. Returns False when a
        query arrived mid-gate and the batch went back to the front of its
        lane."""
        t0 = time.monotonic()
        end = t0 + self._gate_budget_s
        waited = False
        try:
            while True:
                try:
                    slice_s = min(GATE_SLICE_S, max(0.0, end - time.monotonic()))
                    if self._ingest_gate(slice_s):
                        return True  # decode idle (or no engine): proceed
                except Exception:  # noqa: BLE001 - the gate is best-effort
                    return True
                waited = True
                with self._cond:
                    if self._queues[LANE_QUERY] and self._running:
                        self._queues[LANE_INGEST].extendleft(reversed(live))
                        return False
                if time.monotonic() >= end:
                    return True  # budget spent: ingest proceeds regardless
        finally:
            if waited:
                self.counters["ingest_gated_batches"] += 1
                self.counters["ingest_gate_wait_s"] += time.monotonic() - t0

    def _loop(self) -> None:
        while True:
            lane, batch = self._take_batch()
            if not batch:
                with self._cond:
                    if not self._running:
                        return
                continue
            live = self._fail_expired(batch, time.monotonic())
            if not live:
                continue
            if lane == LANE_INGEST and self._ingest_gate is not None:
                if not self._gate_ingest(live):
                    continue
                # the gate may have blocked: re-check budgets
                live = self._fail_expired(live, time.monotonic())
                if not live:
                    continue
            pad_rows = row_bucket(len(live), self.max_batch)
            now = time.monotonic()
            for item in live:
                _M_QUEUE_WAIT.labels(model=self.model, lane=lane).observe(
                    (now - item.enqueued) * 1000.0
                )
                if item.flight_rec is not None:
                    item.flight_rec.event(
                        "batcher_coalesced", model=self.model, lane=lane, rows=len(live),
                        wait_ms=round((now - item.enqueued) * 1000.0, 3),
                    )
            _M_BATCH_ROWS.labels(model=self.model, lane=lane).observe(len(live))
            _M_DISPATCHES.labels(model=self.model, lane=lane).inc()
            self.counters[f"{lane}_dispatches"] += 1
            self.counters[f"{lane}_rows"] += len(live)
            try:
                results = self._dispatch([item.payload for item in live], pad_rows)
                if len(results) != len(live):
                    raise RuntimeError(
                        f"dispatch returned {len(results)} results for "
                        f"{len(live)} payloads"
                    )
            except Exception as exc:  # noqa: BLE001 - scattered to the callers
                for item in live:
                    item.set_error(exc)
                continue
            for item, result in zip(live, results):
                item.set_result(result)


# --------------------------------------------------------------------------- #
# Config plumbing


def validate_config(cfg) -> None:
    """Validate the batching config section (``cfg.batching`` or the
    section itself); raises ValueError with the JAX package's messages."""
    b = cfg.batching if hasattr(cfg, "batching") else cfg
    if b.enable not in ("on", "off"):
        raise ValueError(f"batching.enable must be on|off, got {b.enable!r}")
    if b.max_wait_ms < 0:
        raise ValueError(
            f"batching.max_wait_ms must be >= 0, got {b.max_wait_ms}"
        )
    if b.max_batch_embed < 1:
        raise ValueError(
            f"batching.max_batch_embed must be >= 1, got {b.max_batch_embed}"
        )
    if b.max_batch_rerank < 1:
        raise ValueError(
            f"batching.max_batch_rerank must be >= 1, got {b.max_batch_rerank}"
        )
    if b.ingest_decode_yield_ms < 0:
        raise ValueError(
            f"batching.ingest_decode_yield_ms must be >= 0 (0 disables the "
            f"decode gate), got {b.ingest_decode_yield_ms}"
        )
