"""The port's retrieval tier (generativeaiexamples_tpu_torch/engine/retrieval_tier.py)
on the CPU (hash embeddings, the in-process store, the ``debug``
cross-encoder in float32 for ``ranked_hybrid``), with the runtimes of
tests/test_torch_chain_runtime.py:

- with ``retriever.backend=tier``, concurrent queries coalesced into one
  wave give exactly what the same query alone through the batched store
  path gives (``search_batch`` pads every dispatch to ``ann_max_batch``
  rows, so a query's answer does not depend on its wave), followed by the
  synchronous tail; and the synchronous path's hits, whose one-row
  dispatch may round the scores' last bits otherwise: the dense legs
  within ``SCORE_TOL`` with tie runs as sets, and the answers equal when
  the dense leg has no tie; on the dense, hybrid and ranked_hybrid
  pipelines;
- the port's tier answers equal the JAX runtime's tier answers on the
  same store (the runtime parity rules of test_torch_chain_runtime.py:
  scores within its ``SCORE_TOL``, tie runs as sets);
- one wave of 8 queries is one search dispatch; a queue of depth 1
  stalls its submitters (counted) and recovers; the worker is a named
  daemon thread and ``reset_runtime`` stops it.
"""
import dataclasses
import threading
import time
import types

import pytest

from generativeaiexamples_tpu.chains import runtime as jrt
from generativeaiexamples_tpu_torch.chains import runtime as trt
from generativeaiexamples_tpu_torch.engine import llm_engine, retrieval_tier
from tests.test_torch_chain_runtime import (SCORE_TOL, _assert_same_dense,
                                            _assert_same_retrieval, _check_pipeline,
                                            runtimes)  # noqa: F401 - a fixture


def _tier(cfg, **fields):
    return dataclasses.replace(cfg, retriever=dataclasses.replace(cfg.retriever, backend="tier",
                                                                  **fields))


def _queries(docs):
    return [docs[i].split(".")[j] for i, j in ((0, 0), (5, 2), (3, 1), (1, 0), (2, 1),
                                                (4, 0), (6, 1), (7, 0))]


class _HoldingScheduler:
    """A process engine whose retrieval window opens once ``n`` queries
    wait in the tier's queue: the next wave holds all of them."""

    def __init__(self, n):
        self.n = n

    def retrieval_window(self, timeout):
        deadline = time.time() + 10
        tier = retrieval_tier._TIER
        while time.time() < deadline:
            with tier._cond:
                if len(tier._queue) >= self.n:
                    return True
            time.sleep(0.005)
        return False


def _alone_batched(query, cfg):
    """The tier's answer to ``query`` rebuilt outside the tier: the query
    alone through the batched store path, then the synchronous tail."""
    top_k, threshold = cfg.retriever.top_k, cfg.retriever.score_threshold
    _, lexical, reranker, fetch_k = trt.resolve_pipeline(cfg, top_k)
    emb = trt.get_embedder(cfg).embed_query(query)
    hits = trt.get_vector_store("default", cfg).search_batch(emb[None], fetch_k, threshold)[0]
    return trt.finish_hits(query, hits, fetch_k, top_k, lexical, reranker, "default", cfg)


def _assert_close_to_synchronous(query, got, cfg):
    """The tier's answer against the synchronous path's: the dense legs
    (one row padded to ``ann_max_batch`` against one row alone) within
    SCORE_TOL with tie runs as sets, the answers equal when no two dense
    scores are within SCORE_TOL."""
    _, _, _, fetch_k = trt.resolve_pipeline(cfg, cfg.retriever.top_k)
    threshold = cfg.retriever.score_threshold
    emb = trt.get_embedder(cfg).embed_query(query)
    store = trt.get_vector_store("default", cfg)
    batched = store.search_batch(emb[None], fetch_k + 1, threshold)[0]
    alone = store.search(emb, fetch_k + 1, threshold)
    _assert_same_dense(batched[:fetch_k], alone[:fetch_k], cut=len(alone) > fetch_k)
    scores = [h.score for h in alone]
    if all(a - b > SCORE_TOL for a, b in zip(scores, scores[1:])):
        _assert_same_retrieval(got, trt.retrieve(query, config=cfg))


def _concurrently(fn, args):
    out, threads = [None] * len(args), []
    for i, a in enumerate(args):
        t = threading.Thread(target=lambda i=i, a=a: out.__setitem__(i, fn(a)),
                             name=f"test-tier-{i}", daemon=True)
        threads.append(t)
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    return out


@pytest.mark.parametrize("runtimes", ["dense", "hybrid", "ranked_hybrid"], indirect=True)
def test_a_wave_of_eight_gives_the_synchronous_hits(runtimes, monkeypatch):
    jcfg, tcfg, docs = runtimes
    queries = _queries(docs)
    alone = [_alone_batched(q, tcfg) for q in queries]
    monkeypatch.setattr(llm_engine, "_ENGINE",
                        types.SimpleNamespace(scheduler=_HoldingScheduler(len(queries))))
    tier_cfg = _tier(tcfg)
    before = dict(retrieval_tier.counters)
    got = _concurrently(lambda q: trt.retrieve(q, config=tier_cfg), queries)
    after = retrieval_tier.counters
    assert after["queries"] - before.get("queries", 0) == 8
    assert after["waves"] - before.get("waves", 0) == 1
    assert after["dispatches"] - before.get("dispatches", 0) == 1
    for q, g, a in zip(queries, got, alone):
        assert [(h.chunk.source, h.chunk.text, h.score) for h in g] == \
            [(h.chunk.source, h.chunk.text, h.score) for h in a]
        _assert_close_to_synchronous(q, g, tcfg)
    assert retrieval_tier._TIER._thread.name == "torch-retrieval-tier"
    assert retrieval_tier._TIER._thread.daemon


@pytest.mark.parametrize("runtimes", ["dense", "ranked_hybrid"], indirect=True)
def test_tier_answers_equal_the_jax_runtime_s(runtimes):
    jcfg, tcfg, docs = runtimes
    jtier, ttier = _tier(jcfg), _tier(tcfg)
    for query in _queries(docs)[:4] + ["zzz unknown words"]:
        for top_k in (None, 1, 6):
            _check_pipeline(jtier, ttier, query, top_k, batched=True)


@pytest.mark.parametrize("runtimes", ["dense"], indirect=True)
def test_a_full_queue_stalls_submitters_and_recovers(runtimes, monkeypatch):
    jcfg, tcfg, docs = runtimes
    queries = _queries(docs)[:3]
    alone = [_alone_batched(q, tcfg) for q in queries]
    gate = threading.Event()

    class Gated:
        def retrieval_window(self, timeout):
            gate.wait(10)
            return True

    monkeypatch.setattr(llm_engine, "_ENGINE", types.SimpleNamespace(scheduler=Gated()))
    cfg = _tier(tcfg, tier_queue_depth=1)
    before = retrieval_tier.counters.get("backpressure_stall_seconds", 0.0)
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, trt.retrieve(queries[i], config=cfg)), name=f"test-stall-{i}", daemon=True)
        for i in range(3)]
    for t in threads:
        t.start()
        time.sleep(0.1)
    time.sleep(0.2)
    assert retrieval_tier._TIER.describe()["queued"] == 1
    gate.set()
    for t in threads:
        t.join(30)
    assert [results[i] for i in range(3)] == alone
    assert retrieval_tier.counters["backpressure_stall_seconds"] - before > 0.1
    rec = retrieval_tier.RetrievalRecord(rid=1, query="q", top_k=1, threshold=0.0)
    assert rec.req is rec
    trt.reset_runtime()
    assert retrieval_tier._TIER is None


def test_the_tier_is_off_by_default_and_reset_stops_it():
    trt.reset_runtime()
    assert retrieval_tier._TIER is None
    cfg = types.SimpleNamespace(retriever=types.SimpleNamespace(tier_queue_depth=0,
                                                                tier_window_ms=0))
    tier = retrieval_tier.get_tier(cfg)
    assert retrieval_tier.get_tier(cfg) is tier
    assert tier.describe() == {"queue_capacity": 16, "queued": 0, "window_ms": 0.0,
                               "stopped": False}
    retrieval_tier.close_tier()
    assert not tier._thread.is_alive() and retrieval_tier._TIER is None
    with pytest.raises(RuntimeError, match="retrieval tier is closed"):
        tier.retrieve("q", 1, 0.0)
    jrt.reset_runtime()
