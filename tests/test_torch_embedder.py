"""The port's embedder and reranker (generativeaiexamples_tpu_torch/engine/
embedder.py, reranker.py) against the JAX package's, on the CPU.

- ``TorchEmbedder``/``TorchReranker`` against ``TPUEmbedder``/``TPUReranker``
  at the debug preset on the same weights (the JAX models' own parameter
  trees, carried across by ``convert``): embeddings within max |Δ| <= 5e-3
  and cosine >= 0.9999 per row, logits within 5e-3 (the JAX models run
  under ``jax.jit``, whose fused bf16 arithmetic skips roundings the port
  makes op by op: one bf16 step of a unit-norm embedding's ~0.25 entries
  is ~1e-3; observed 2.0e-3 and 1.2e-3);
- the batched path against the synchronous path: bitwise on the CPU;
- the query LRU, the row ladder of the synchronous path, no batcher thread
  with batching off;
- ``HashEmbedder`` bitwise and ``OverlapReranker`` exactly equal to JAX's;
- ``create_embedder``/``create_reranker``: dispatch and JAX's messages;
- the ingest gate against a CPU engine: ``ingest_window`` is False on
  timeout while a slot is held, True when idle, and wakes when the last
  slot frees; a bulk ingest waits on it while a query is never gated.
"""
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import embedder as jembedder
from generativeaiexamples_tpu.engine import reranker as jreranker
from generativeaiexamples_tpu_torch.config import AppConfig, EngineConfig
from generativeaiexamples_tpu_torch.engine import embedder as tembedder
from generativeaiexamples_tpu_torch.engine import llm_engine
from generativeaiexamples_tpu_torch.engine import reranker as treranker
from generativeaiexamples_tpu_torch.engine.embedder import (
    ARCTIC_QUERY_PREFIX, HashEmbedder, TorchEmbedder,
)
from generativeaiexamples_tpu_torch.engine.reranker import OverlapReranker, TorchReranker
from generativeaiexamples_tpu_torch.models.convert import (
    bert_params_from_numpy, rank_head_from_numpy,
)

EMB_TOL, COS_TOL, LOGIT_TOL = 5e-3, 0.9999, 5e-3

TEXTS = [f"document {i} about mesh sharding and kv caches" * (1 + i % 3) for i in range(13)]
PASSAGES = [f"passage {i} on admission waves and wave padding" * (1 + i % 4) for i in range(11)]


def _batching(enable="on", **kw):
    return types.SimpleNamespace(**{
        "enable": enable, "max_wait_ms": 5.0, "max_batch_embed": 8, "max_batch_rerank": 8,
        "ingest_decode_yield_ms": 50.0, **kw})


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def pair():
    """A JAX embedder and the port's on the JAX embedder's weights."""
    jemb = jembedder.TPUEmbedder(model_name="debug", batching=_batching(), query_cache_size=8)
    temb = TorchEmbedder(model_name="debug", batching=_batching(), query_cache_size=8,
                         device="cpu", params=bert_params_from_numpy(_tree(jemb._params)))
    yield jemb, temb
    jemb.close()
    temb.close()


@pytest.fixture(scope="module")
def rerank_pair():
    jr = jreranker.TPUReranker(model_name="debug", batching=_batching())
    tr = TorchReranker(model_name="debug", batching=_batching(), device="cpu",
                       params=bert_params_from_numpy(_tree(jr._params)),
                       head=rank_head_from_numpy(_tree(jr._head)))
    yield jr, tr
    jr.close()
    tr.close()


def _assert_close_rows(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= EMB_TOL
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    assert cos.min() >= COS_TOL


@pytest.mark.parametrize("batching", [True, False], ids=["batched", "sync"])
def test_embed_documents_matches_jax(pair, batching):
    jemb, temb = pair
    jemb.set_batching(batching)
    temb.set_batching(batching)
    _assert_close_rows(temb.embed_documents(TEXTS), jemb.embed_documents(TEXTS))


def test_embed_query_uses_the_arctic_prefix_and_matches_jax(pair):
    jemb, temb = pair
    assert temb.query_prefix == jemb.query_prefix == ARCTIC_QUERY_PREFIX
    temb.set_batching(False)
    temb.clear_query_cache()
    q = temb.embed_query("how are kv caches shared")
    assert np.array_equal(q, temb.embed_documents([ARCTIC_QUERY_PREFIX + "how are kv caches shared"])[0])
    _assert_close_rows(q[None], jemb.embed_query("how are kv caches shared")[None])
    assert temb.dimensions == jemb.dimensions == 64


def test_embedder_batched_matches_sync_bit_exact(pair):
    _, emb = pair
    emb.clear_query_cache()
    emb.set_batching(False)
    sync_docs = emb.embed_documents(TEXTS)
    sync_q = emb.embed_query("how are kv caches shared")
    emb.clear_query_cache()
    emb.set_batching(True)
    outs = {}
    lock = threading.Lock()

    def worker(kind, i):
        out = emb.embed_documents(TEXTS) if kind == "docs" else emb.embed_query(
            "how are kv caches shared")
        with lock:
            outs[(kind, i)] = out

    threads = [threading.Thread(target=worker, args=("docs", 0), daemon=True)] + [
        threading.Thread(target=worker, args=("q", i), daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert np.array_equal(outs[("docs", 0)], sync_docs)
    for i in range(4):
        assert np.array_equal(outs[("q", i)], sync_q)


@pytest.mark.parametrize("batching", [True, False], ids=["batched", "sync"])
def test_reranker_matches_jax(rerank_pair, batching):
    jr, tr = rerank_pair
    jr.set_batching(batching)
    tr.set_batching(batching)
    want = jr.score("how do admission waves pad", PASSAGES)
    got = tr.score("how do admission waves pad", PASSAGES)
    assert got.shape == (11,) and np.abs(got - want).max() <= LOGIT_TOL


def test_reranker_batched_matches_sync_bit_exact(rerank_pair):
    _, tr = rerank_pair
    tr.set_batching(False)
    sync_scores = tr.score("how do admission waves pad", PASSAGES)
    tr.set_batching(True)
    outs = [None] * 3

    def worker(i):
        outs[i] = tr.score("how do admission waves pad", PASSAGES)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    for out in outs:
        assert np.array_equal(out, sync_scores)


def test_reranker_pairs_are_tokenized_as_in_jax(rerank_pair):
    jr, tr = rerank_pair
    assert tr._tokenize_pairs("query", ["one passage", "two"]) == jr._tokenize_pairs(
        "query", ["one passage", "two"])


def test_sync_path_pads_rows_up_the_ladder(pair):
    _, emb = pair
    emb.set_batching(False)
    seen = []
    real = emb._encode

    def spy(params, ids, mask):
        seen.append(tuple(ids.shape))
        return real(params, ids, mask)

    emb._encode = spy
    try:
        emb.embed_documents([f"text number {i}" for i in range(5)])
    finally:
        emb._encode = real
    assert seen == [(8, 32)]  # 5 rows pad to the 8 rung, 14 ids to the 32 bucket


def test_embed_query_lru_skips_device_dispatch(pair):
    _, emb = pair
    emb.set_batching(False)
    emb.clear_query_cache()
    first = emb.embed_query("repeated question")
    n0, hits0 = emb.counters["device_dispatches"], emb.counters["query_cache_hits"]
    again = emb.embed_query("repeated question")
    assert emb.counters["device_dispatches"] == n0
    assert emb.counters["query_cache_hits"] == hits0 + 1
    assert np.array_equal(first, again)
    for i in range(9):  # the cache of 8 drops the oldest entry
        emb.embed_query(f"filler question {i}")
    n1 = emb.counters["device_dispatches"]
    emb.embed_query("repeated question")
    assert emb.counters["device_dispatches"] == n1 + 1


def test_embedder_off_never_starts_a_batcher_thread():
    emb = TorchEmbedder(model_name="debug", batching=_batching("off"), device="cpu")
    try:
        emb.embed_documents(["alpha", "beta"])
        emb.embed_query("gamma")
        assert emb._batcher._thread is None
    finally:
        emb.close()


def test_the_encoders_refuse_to_start_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="TorchEmbedder runs on a CUDA device.*device='cpu'"):
        TorchEmbedder(model_name="debug")
    with pytest.raises(RuntimeError, match="TorchReranker runs on a CUDA device"):
        TorchReranker(model_name="debug")


def test_params_on_another_device_are_refused(pair):
    jemb, _ = pair
    params = bert_params_from_numpy(_tree(jemb._params), device="meta")
    with pytest.raises(ValueError, match="parameters on .*meta"):
        TorchEmbedder(model_name="debug", device="cpu", params=params)


@pytest.mark.parametrize("texts", [
    [], ["one"], ["The quick brown fox!", "jumps over the lazy dog", "", "ÜNICODE naïve café 42"],
])
@pytest.mark.parametrize("dims", [16, 1024])
def test_hash_embedder_is_bitwise_jax(texts, dims):
    mine, ref = HashEmbedder(dims), jembedder.HashEmbedder(dims)
    got, want = mine.embed_documents(texts), ref.embed_documents(texts)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert mine.embed_query("a query").tobytes() == ref.embed_query("a query").tobytes()


def test_overlap_reranker_equals_jax():
    passages = ["kv cache pages", "nothing shared", "", "KV Cache PAGES and more"]
    for query in ("kv cache", "", "unrelated words"):
        assert np.array_equal(OverlapReranker().score(query, passages),
                              jreranker.OverlapReranker().score(query, passages))


# --------------------------------------------------------------------------- #
# factories


def _config(**sections):
    cfg = AppConfig()
    for name, fields in sections.items():
        for field, value in fields.items():
            setattr(getattr(cfg, name), field, value)
    return cfg


def _jax_config(**sections):
    from generativeaiexamples_tpu.config import AppConfig as JaxAppConfig

    return JaxAppConfig.from_dict({k: {_camel(f): v for f, v in d.items()} for k, d in sections.items()})


def _camel(name):
    head, *rest = name.split("_")
    return head + "".join(p.title() for p in rest)


@pytest.fixture
def fresh_caches(monkeypatch):
    monkeypatch.setattr(tembedder, "_EMBEDDER_CACHE", {})
    monkeypatch.setattr(treranker, "_RERANKER_CACHE", {})
    monkeypatch.setattr(jembedder, "_EMBEDDER_CACHE", {})
    monkeypatch.setattr(jreranker, "_RERANKER_CACHE", {})


def test_create_embedder_dispatches_on_the_jax_engine_names(fresh_caches):
    hashed = tembedder.create_embedder(_config(embeddings={"model_engine": "hash", "dimensions": 32}))
    assert isinstance(hashed, HashEmbedder) and hashed.dimensions == 32
    assert tembedder.create_embedder(_config(embeddings={"model_engine": "hash", "dimensions": 32})) is hashed
    remote = tembedder.create_embedder(_config(embeddings={
        "model_engine": "openai", "server_url": "http://127.0.0.1:9/"}))
    assert isinstance(remote, tembedder.RemoteEmbedder) and remote._url == "http://127.0.0.1:9/v1"
    local = tembedder.create_embedder(
        _config(embeddings={"model_engine": "tpu", "model_name": "snowflake/debug"}), device="cpu")
    try:
        assert isinstance(local, TorchEmbedder) and local.dimensions == 64
        assert local._batching_on and local._max_batch == 32  # the batching section's defaults
    finally:
        local.close()


@pytest.mark.parametrize("engine", ["openai", "remote", "nvidia-ai-endpoints"])
def test_create_embedder_refuses_remote_without_url_with_jax_message(fresh_caches, engine):
    with pytest.raises(ValueError) as want:
        jembedder.create_embedder(_jax_config(embeddings={"model_engine": engine}))
    with pytest.raises(ValueError) as got:
        tembedder.create_embedder(_config(embeddings={"model_engine": engine}))
    assert str(got.value) == str(want.value)


def test_create_reranker_dispatch(fresh_caches):
    assert treranker.create_reranker(_config()) is None  # disabled by default, as in JAX
    for off in ("none", "disabled"):
        assert treranker.create_reranker(_config(ranking={"model_engine": off})) is None
    assert isinstance(treranker.create_reranker(_config(ranking={"model_engine": "overlap"})),
                      OverlapReranker)
    rr = treranker.create_reranker(_config(ranking={"model_engine": "tpu", "model_name": "debug"}),
                                   device="cpu")
    try:
        assert isinstance(rr, TorchReranker) and rr._max_batch == 16
    finally:
        rr.close()
    with pytest.raises(ValueError, match="queue 1 item 7"):
        treranker.create_reranker(_config(ranking={"model_engine": "remote", "server_url": "x"}))


# --------------------------------------------------------------------------- #
# the ingest gate against a CPU engine


@pytest.fixture
def held_engine(monkeypatch):
    """A CPU engine whose one request holds its slot until ``release()``:
    the reader blocks at the first emission, so the dispatch thread stops
    once ``decode_runahead`` blocks wait. Installed as the process engine
    (the embedder's gate asks ``llm_engine._ENGINE``)."""
    eng = llm_engine.LLMEngine(EngineConfig(
        model_config_name="debug", max_batch_size=2, max_seq_len=128, prefill_chunk=16,
        page_size=8, decode_block=2, decode_runahead=1,
    ), device="cpu")
    gate = threading.Event()
    emit = eng._emit

    def gated(req, token):
        assert gate.wait(60)
        emit(req, token)

    eng._emit = gated
    monkeypatch.setattr(llm_engine, "_ENGINE", eng)
    req = eng.submit([256, 1, 2, 3], llm_engine.SamplingParams(temperature=0.0, max_tokens=100))
    deadline = time.monotonic() + 30
    while not eng.is_decoding() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert eng.is_decoding()
    eng.release = lambda: (gate.set(), eng.abort(req))
    yield eng
    gate.set()
    assert eng.shutdown()


def test_ingest_window_is_idle_when_no_slot_is_held():
    eng = llm_engine.LLMEngine(EngineConfig(
        model_config_name="debug", max_batch_size=2, max_seq_len=128, prefill_chunk=16, page_size=8,
    ), device="cpu")
    try:
        assert not eng.is_decoding()
        t0 = time.monotonic()
        assert eng.scheduler.ingest_window(5.0) is True
        assert time.monotonic() - t0 < 1.0
        assert eng.scheduler.kind == "unified"
    finally:
        assert eng.shutdown()


def test_ingest_window_times_out_then_wakes_when_the_slot_frees(held_engine):
    t0 = time.monotonic()
    assert held_engine.scheduler.ingest_window(0.05) is False
    assert time.monotonic() - t0 >= 0.05
    woke = {}

    def wait():
        t = time.monotonic()
        woke["ok"] = held_engine.scheduler.ingest_window(60.0)
        woke["s"] = time.monotonic() - t

    waiter = threading.Thread(target=wait, name="test-ingest-waiter", daemon=True)
    waiter.start()
    time.sleep(0.1)
    assert waiter.is_alive()  # still waiting while the slot is held
    held_engine.release()
    waiter.join(30)
    assert not waiter.is_alive()
    assert woke["ok"] is True and woke["s"] < 30
    assert not held_engine.is_decoding()


def test_bulk_ingest_waits_on_the_window_while_a_query_is_never_gated(held_engine):
    emb = TorchEmbedder(model_name="debug", device="cpu", query_cache_size=0,
                        batching=_batching(ingest_decode_yield_ms=30_000.0))
    refused = threading.Event()
    gate = emb._batcher._ingest_gate

    def watched(timeout_s):
        ok = gate(timeout_s)
        if not ok:
            refused.set()
        return ok

    emb._batcher._ingest_gate = watched
    try:
        done = {}

        def ingest():
            done["docs"] = emb.embed_documents(["bulk one", "bulk two", "bulk three"])

        bulk = threading.Thread(target=ingest, name="test-ingest", daemon=True)
        bulk.start()
        assert refused.wait(10)  # the engine's window is closed while its slot is held
        time.sleep(0.1)
        assert bulk.is_alive() and "docs" not in done  # held by the closed window
        t0 = time.monotonic()
        q = emb.embed_query("a live question")
        assert time.monotonic() - t0 < 10 and q.shape == (64,)
        assert emb._batcher.counters["query_dispatches"] >= 1
        assert bulk.is_alive()  # the query went ahead of the gated bulk batch
        held_engine.release()
        bulk.join(30)
        assert not bulk.is_alive() and done["docs"].shape == (3, 64)
        assert emb._batcher.counters["ingest_gated_batches"] >= 1
    finally:
        emb.close()
