"""The retrieval tier: batched embed, search and rerank waves, co-scheduled
with generation on the scheduler seam.

The port's copy of the JAX package's generativeaiexamples_tpu/engine/retrieval_tier.py.
With ``retriever.backend=tier`` the chain runtime's ``retrieve`` submits a
:class:`RetrievalRecord` into a bounded
:class:`~generativeaiexamples_tpu_torch.engine.scheduler.handoff.TransferQueue`
(the KV handoff's queue, with its backpressure, for a record with no KV)
instead of running the synchronous pipeline. A named daemon worker
(``torch-retrieval-tier``) drains the queue a wave at a time, yields to
the process engine's ``scheduler.retrieval_window`` for at most
``retriever.tier_window_ms``, and serves each (collection, top_k,
threshold) group of the wave with one ``TorchVectorStore.search_batch``:
one ANN dispatch a group instead of one a query. Each query is embedded
by the same ``embed_query`` and finished by the same fuse and rerank tail
(``runtime.finish_hits``) as on the synchronous path.

The counters are plain integers (``counters``): dispatches, queries,
waves, and the backpressure and window-wait seconds.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import threading
import time
from typing import Any, List, Optional

import numpy as np

from generativeaiexamples_tpu_torch.engine.scheduler.handoff import TransferQueue

logger = logging.getLogger(__name__)

_COUNTERS_LOCK = threading.Lock()
counters: "collections.Counter[str]" = collections.Counter()


def _add(**values) -> None:
    with _COUNTERS_LOCK:
        counters.update(values)


@dataclasses.dataclass
class RetrievalRecord:
    """One query crossing into the retrieval tier. The transfer queue only
    needs ``.req.rid``: the record is its own ``req``."""

    rid: int
    query: str
    top_k: int
    threshold: float
    collection: str = "default"
    result: Optional[List[Any]] = None  # the worker writes it, then sets done
    error: Optional[BaseException] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def req(self) -> "RetrievalRecord":
        return self


class RetrievalTier:
    """A bounded-queue retrieval worker serving batched waves. A submitter
    blocks while the queue is full; the worker drains the whole queue a
    pass, yields to the scheduler, and answers every record."""

    def __init__(self, config) -> None:
        self._config = config
        ret = config.retriever
        depth = int(getattr(ret, "tier_queue_depth", 0)) or 16
        self._window_s = max(0.0, float(getattr(ret, "tier_window_ms", 0)) / 1000.0)
        self._cond = threading.Condition()
        self._queue = TransferQueue(depth, self._cond)
        self._rids = itertools.count(1)
        self._stopped = False  # guarded by self._cond
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="torch-retrieval-tier")
        self._thread.start()

    # -- submit side ---------------------------------------------------- #
    def retrieve(self, query: str, top_k: int, threshold: float, collection: str = "default",
                 timeout_s: float = 30.0) -> List[Any]:
        """Submit one query and wait for its wave's answer."""
        rec = RetrievalRecord(rid=next(self._rids), query=query, top_k=int(top_k),
                              threshold=float(threshold), collection=collection)
        with self._cond:
            if self._stopped:
                raise RuntimeError("retrieval tier is closed")
            stall = self._queue.wait_room(
                stop=lambda: self._stopped  # genai-lint: disable=lock-discipline -- wait_room calls stop() with self._cond held
            )
            if self._stopped:
                raise RuntimeError("retrieval tier closed while waiting for room")
            if stall > 1e-3:
                _add(backpressure_stall_seconds=stall)
            self._queue.put(rec)
        if not rec.done.wait(timeout=timeout_s):
            raise TimeoutError(f"retrieval tier did not answer within {timeout_s:.1f}s")
        if rec.error is not None:
            raise rec.error
        return rec.result or []

    # -- worker side ---------------------------------------------------- #
    def _await_window(self) -> float:
        """Ask the process engine's scheduler for a retrieval window,
        bounded by ``tier_window_ms``; no engine, or any error, means an
        open window."""
        if self._window_s <= 0:
            return 0.0
        t0 = time.monotonic()
        try:
            from generativeaiexamples_tpu_torch.engine import llm_engine

            eng = llm_engine._ENGINE
            if eng is not None:
                eng.scheduler.retrieval_window(self._window_s)
        except Exception:  # noqa: BLE001 - the window is best-effort
            pass
        waited = time.monotonic() - t0
        _add(window_wait_seconds=waited)
        return waited

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and len(self._queue) == 0:
                    self._cond.wait(timeout=1.0)
                if self._stopped:
                    for rec in self._queue.pop_all():
                        rec.error = RuntimeError("retrieval tier closed")
                        rec.done.set()
                    return
            self._await_window()
            with self._cond:
                wave = self._queue.pop_all()
            if wave:
                self._serve_wave(wave)

    def _serve_wave(self, wave: List[RetrievalRecord]) -> None:
        from generativeaiexamples_tpu_torch.chains import runtime as runtime_mod

        groups: dict = {}
        for rec in wave:
            groups.setdefault((rec.collection, rec.top_k, rec.threshold), []).append(rec)
        dispatches = 0
        for (collection, top_k, threshold), recs in groups.items():
            try:
                dispatches += self._serve_group(runtime_mod, collection, top_k, threshold, recs)
            except Exception as exc:  # noqa: BLE001 - one group's fault stays its own
                logger.exception("retrieval tier wave group failed: %s", exc)
                for rec in recs:
                    if not rec.done.is_set():
                        rec.error = exc
                        rec.done.set()
        _add(dispatches=dispatches, queries=len(wave), waves=1)

    def _serve_group(self, runtime_mod, collection: str, top_k: int, threshold: float,
                     recs: List[RetrievalRecord]) -> int:
        """One (collection, top_k, threshold) group: each query embedded as
        on the synchronous path, one batched store dispatch, then the
        shared fuse and rerank tail per record. Returns the search
        dispatches."""
        config = self._config
        _, lexical, reranker, fetch_k = runtime_mod.resolve_pipeline(config, top_k)
        embedder = runtime_mod.get_embedder(config)
        q_embs = [embedder.embed_query(rec.query) for rec in recs]
        store = runtime_mod.get_vector_store(collection, config)
        if hasattr(store, "search_batch"):
            hit_lists = store.search_batch(np.stack(q_embs), fetch_k, threshold)
            dispatches = 1
        else:
            hit_lists = [store.search(q, fetch_k, threshold) for q in q_embs]
            dispatches = len(recs)
        for rec, hits in zip(recs, hit_lists):
            rec.result = runtime_mod.finish_hits(rec.query, hits, fetch_k, top_k, lexical,
                                                 reranker, collection, config)
            rec.done.set()
        return dispatches

    # -- lifecycle ------------------------------------------------------ #
    def close(self, timeout_s: float = 5.0) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            logger.error("retrieval tier worker did not join within %.1fs", timeout_s)

    def describe(self) -> dict:
        with self._cond:
            return {"queue_capacity": self._queue.capacity, "queued": len(self._queue),
                    "window_ms": round(self._window_s * 1000.0, 3), "stopped": self._stopped}


_TIER: Optional[RetrievalTier] = None
_TIER_LOCK = threading.Lock()


def get_tier(config) -> RetrievalTier:
    """The process's tier (``retriever.backend=tier``), built on first use
    with a warning: the serving path changed."""
    global _TIER
    with _TIER_LOCK:
        if _TIER is None:
            logger.warning(
                "retrieval backend flip: TIER enabled (retriever.backend=tier) — batched "
                "co-scheduled search waves; set APP_RETRIEVER_BACKEND=off to restore the "
                "synchronous path"
            )
            _TIER = RetrievalTier(config)
        return _TIER


def close_tier() -> None:
    """Stop and drop the process's tier (``reset_runtime``)."""
    global _TIER
    with _TIER_LOCK:
        tier, _TIER = _TIER, None
    if tier is not None:
        tier.close()
        logger.warning("retrieval backend flip: TIER disabled — synchronous per-request "
                       "search restored")
