"""The port's chain runtime (generativeaiexamples_tpu_torch/chains/,
retrieval/{splitter,loaders,pdf,bm25}.py, engine/llm_backend.py, the new
config sections) against the JAX package's on the CPU:

- the splitters' chunks, exactly, on the whitespace and tokenizer paths;
  ``load_document`` on .txt, .md, .html and a .pdf the test writes;
- BM25 hits and scores bitwise (pure Python on both sides), ``rrf_fuse``,
  and an index persisted by either package loading in the other;
- ``cap_context`` and ``history_to_messages``;
- ``retrieve()`` for ``nr_pipeline`` dense, ``hybrid`` and
  ``ranked_hybrid`` over the same ingested files, with ``HashEmbedder``
  (bitwise on both sides) and the debug-preset reranker on JAX's weights
  in float32: the same chunks in the same order, scores within 1e-5,
  outright where the dense leg has no tie; HashEmbedder's integer counts
  tie exactly and each package's top-k orders a tie its own way, so there
  the dense legs are equal up to the order inside each tie and the port's
  answer equals JAX's fuse-and-rerank tail run on the port's dense hits;
- the prompt ids each package's LLM backend hands its engine for what
  ``llm_chain`` and ``rag_chain`` build (a recording engine stub that both
  backends take as ``engine=``), equal to ``render_chat``;
- a deleted source gone from the store and BM25 in both, and an over-long
  RAG prompt cut by the port's engine to what the JAX engine keeps.
"""
import json
import os
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.chains import developer_rag as jdr
from generativeaiexamples_tpu.chains import registry as jregistry
from generativeaiexamples_tpu.chains import runtime as jrt
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.config import schema as jschema
from generativeaiexamples_tpu.engine import llm_backend as jllm
from generativeaiexamples_tpu.engine import reranker as jreranker
from generativeaiexamples_tpu.engine import tokenizer as jtok
from generativeaiexamples_tpu.retrieval import bm25 as jbm25
from generativeaiexamples_tpu.retrieval import loaders as jloaders
from generativeaiexamples_tpu.retrieval import splitter as jsplitter
from generativeaiexamples_tpu.retrieval.store import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.store import SearchHit as JHit
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch import config_validate as tvalidate
from generativeaiexamples_tpu_torch.chains import developer_rag as tdr
from generativeaiexamples_tpu_torch.chains import registry as tregistry
from generativeaiexamples_tpu_torch.chains import runtime as trt
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import llm_backend as tllm
from generativeaiexamples_tpu_torch.engine import reranker as treranker
from generativeaiexamples_tpu_torch.engine import tokenizer as ttok
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.engine.reranker import TorchReranker
from generativeaiexamples_tpu_torch.models.convert import bert_params_from_numpy, rank_head_from_numpy
from generativeaiexamples_tpu_torch.retrieval import bm25 as tbm25
from generativeaiexamples_tpu_torch.retrieval import loaders as tloaders
from generativeaiexamples_tpu_torch.retrieval import splitter as tsplitter
from generativeaiexamples_tpu_torch.retrieval.pdf import write_text_pdf
from generativeaiexamples_tpu_torch.retrieval.store import Chunk, SearchHit
from generativeaiexamples_tpu_torch.utils import resilience as tres

SCORE_TOL = 1e-5


def _words(rng, n, vocab):
    return " ".join(rng.choice(vocab, n))


def _corpus(seed, n_docs=6, vocab_size=40):
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    vocab = sorted({"".join(rng.choice(letters, rng.integers(3, 8))) for _ in range(vocab_size)})
    docs = []
    for _ in range(n_docs):
        sentences = [_words(rng, int(rng.integers(6, 12)), vocab) + "." for _ in range(rng.integers(4, 9))]
        docs.append(" ".join(sentences))
    return docs


# --------------------------------------------------------------------------- #
# splitters and loaders


@pytest.mark.parametrize("size,overlap", [(510, 200), (48, 16), (7, 3), (5, 0)])
@pytest.mark.parametrize("path", ["whitespace", "tokenizer"])
def test_token_splitter_matches_jax(size, overlap, path):
    for text in _corpus(size) + ["", "   ", "one", "é ü " * 40]:
        j = jsplitter.TokenTextSplitter(size, overlap, jtok.ByteTokenizer() if path == "tokenizer" else None)
        t = tsplitter.TokenTextSplitter(size, overlap, ttok.ByteTokenizer() if path == "tokenizer" else None)
        assert t.split_text(text) == j.split_text(text)
    with pytest.raises(ValueError, match="chunk_overlap must be < chunk_size"):
        tsplitter.get_text_splitter(4, 4)


@pytest.mark.parametrize("size,overlap", [(1000, 100), (50, 0), (40, 10), (7, 2)])
def test_recursive_splitter_matches_jax(size, overlap):
    texts = ["para one is here.\n\npara two is a bit longer than one.\n\nshort.",
             "x" * 130, "a. b. c\nd e f g h i j k l m n o p\n\n" * 5] + _corpus(size, 3)
    for text in texts:
        assert (tsplitter.RecursiveCharacterTextSplitter(size, overlap).split_text(text)
                == jsplitter.RecursiveCharacterTextSplitter(size, overlap).split_text(text))


def _write_docs(tmp_path):
    docs = _corpus(3, n_docs=4)
    paths = {
        "a.txt": docs[0].encode(),
        "b.md": ("# Title **bold**\n\n```code\nx = 1\n```\n" + docs[1] + "\n> [link](u) `c`").encode(),
        "c.pdf": write_text_pdf(docs[2].split(". ") + ["parens (x) and back\\slash"]),
        "d.html": f"<html><script>x()</script><body><h1>T</h1><p>{docs[3]}</p></body></html>".encode(),
    }
    for name, data in paths.items():
        (tmp_path / name).write_bytes(data)
    return docs, paths


@pytest.mark.parametrize("name", ["a.txt", "b.md", "c.pdf", "d.html"])
def test_load_document_matches_jax(tmp_path, name):
    docs, _ = _write_docs(tmp_path)
    path = str(tmp_path / name)
    got = tloaders.load_document(path)
    assert got == jloaders.load_document(path)
    assert got.strip()
    if name == "c.pdf":
        assert "parens (x) and back\\slash" in got
        assert got.split("\n")[0] == docs[2].split(". ")[0]


# --------------------------------------------------------------------------- #
# BM25


def _chunks(seed, n=12):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(30)] + ["kernel", "page", "cache", "x_1"]
    return [(_words(rng, int(rng.integers(3, 20)), vocab), f"src{i % 4}") for i in range(n)]


def _pair_index(seed, tmp_path=None):
    pairs = _chunks(seed)
    j = jbm25.BM25Index(persist_dir=str(tmp_path / "j") if tmp_path else "")
    t = tbm25.BM25Index(persist_dir=str(tmp_path / "t") if tmp_path else "")
    j.add([JChunk(text=x, source=s) for x, s in pairs])
    t.add([Chunk(text=x, source=s) for x, s in pairs])
    return j, t


def _same_hits(got, want):
    assert [(h.chunk.source, h.chunk.text, h.score) for h in got] == \
        [(h.chunk.source, h.chunk.text, h.score) for h in want]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bm25_search_is_bitwise_jax(seed):
    j, t = _pair_index(seed)
    assert t.count() == j.count() == 12
    for query in ["w1 w2 kernel", "W3, w3; page!", "x_1 cache w29", "nothing here", "", "w0"]:
        for k in (1, 4, 16):
            _same_hits(t.search(query, k), j.search(query, k))


def test_bm25_delete_sources_matches_jax():
    j, t = _pair_index(3)
    assert t.delete_sources(["src1", "nope"]) == j.delete_sources(["src1", "nope"])
    assert t.delete_sources(["nope"]) == j.delete_sources(["nope"]) is False
    assert t.count() == j.count() == 9
    _same_hits(t.search("w1 w2 w3 kernel page", 16), j.search("w1 w2 w3 kernel page", 16))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_persisted_bm25_index_loads_in_the_other_package(tmp_path, direction):
    j, t = _pair_index(4, tmp_path)
    a, b = (tmp_path / "j" / "bm25_default.jsonl"), (tmp_path / "t" / "bm25_default.jsonl")
    assert a.read_bytes() == b.read_bytes()  # the same on-disk format
    src = "j" if direction == "jax_to_port" else "t"
    loaded = (tbm25.BM25Index if direction == "jax_to_port" else jbm25.BM25Index)(
        persist_dir=str(tmp_path / src))
    ref = j if direction == "jax_to_port" else t
    assert loaded.count() == ref.count()
    for query in ["w1 w2 kernel", "cache x_1"]:
        _same_hits(loaded.search(query, 8), ref.search(query, 8))


def test_rrf_fuse_is_bitwise_jax():
    j, t = _pair_index(5)
    dense = [(f"w{i} w{i + 1}", f"src{i % 3}", 1.0 - i / 10) for i in range(8)]
    jl = [JHit(chunk=JChunk(text=x, source=s), score=sc) for x, s, sc in dense]
    tl = [SearchHit(chunk=Chunk(text=x, source=s), score=sc) for x, s, sc in dense]
    for query in ["w1 w2", "kernel w3"]:
        _same_hits(tbm25.rrf_fuse([tl, t.search(query, 8)]), jbm25.rrf_fuse([jl, j.search(query, 8)]))
    _same_hits(tbm25.rrf_fuse([tl, tl, []], k=10), jbm25.rrf_fuse([jl, jl, []], k=10))


# --------------------------------------------------------------------------- #
# context cap, history, settings


@pytest.mark.parametrize("cap", [0, 1, 5, 17, 40, 1500])
def test_cap_context_matches_jax(cap):
    texts = _corpus(cap, n_docs=5)
    jcfg, tcfg = jschema.AppConfig(), tconfig.AppConfig()
    assert trt.cap_context(texts, cap, tcfg) == jrt.cap_context(texts, cap, jcfg)
    assert trt.cap_context(texts, config=tcfg) == jrt.cap_context(texts, config=jcfg)


def test_history_and_settings_match_jax():
    class M:
        role, content = "assistant", "an object"

    history = [("user", "a tuple"), {"role": "system", "content": "a dict"}, {"content": "no role"}, M()]
    assert trt.history_to_messages(history) == jrt.history_to_messages(history)
    assert trt.history_to_messages(None) == jrt.history_to_messages(None) == []
    kw = {"temperature": 0.5, "top_p": None, "max_tokens": 7, "stop": [], "other": 1}
    assert trt.llm_settings(kw) == jrt.llm_settings(kw)


# --------------------------------------------------------------------------- #
# retrieve() end to end over ingested files


_ENV = {
    "APP_EMBEDDINGS_MODELENGINE": "hash",
    "APP_EMBEDDINGS_DIMENSIONS": "64",
    "APP_RANKING_MODELENGINE": "tpu",
    "APP_RANKING_MODELNAME": "debug",
    "APP_LLM_MODELENGINE": "echo",
    "APP_BATCHING_ENABLE": "off",
    "APP_RETRIEVER_SCORETHRESHOLD": "0",
    "APP_TEXTSPLITTER_CHUNKSIZE": "24",
    "APP_TEXTSPLITTER_CHUNKOVERLAP": "8",
}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree)


@pytest.fixture
def runtimes(tmp_path, request):
    """Both runtimes configured from the same APP_* environment, the same
    files ingested through ``ingest_file``; ranked_hybrid's reranker is the
    JAX debug preset cast to float32, and the port's on its weights."""
    pipeline = getattr(request, "param", "ranked_hybrid")
    mp = pytest.MonkeyPatch()
    for key in list(os.environ):
        if key.startswith("APP_"):
            mp.delenv(key)
    for key, value in {**_ENV, "APP_RETRIEVER_NRPIPELINE": pipeline}.items():
        mp.setenv(key, value)
    jrt.reset_runtime()
    trt.reset_runtime()
    trt.set_device("cpu")
    try:
        # each package's cached config reads its own store directory
        mp.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "jax"))
        jcfg = jget_config()
        mp.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "port"))
        tcfg = tconfig.get_config()
        if pipeline == "ranked_hybrid":
            jr = jreranker.create_reranker(jcfg)
            jr._params, jr._head = _f32(jr._params), _f32(jr._head)
            tr = TorchReranker(model_name="debug", device="cpu", dtype=torch.float32,
                               params=bert_params_from_numpy(jr._params),
                               head=rank_head_from_numpy(jr._head), batching=tcfg.batching)
            treranker._RERANKER_CACHE[("tpu", "", "debug", "cpu")] = tr
            assert trt.resolve_pipeline(tcfg, 4)[2] is tr
        docs = _corpus(11, n_docs=8)
        for i, doc in enumerate(docs):
            path = tmp_path / f"doc{i}.txt"
            path.write_text(doc)
            assert trt.ingest_file(str(path), path.name) == jrt.ingest_file(str(path), path.name)
        yield jcfg, tcfg, docs
    finally:
        jrt.reset_runtime()
        trt.reset_runtime()
        trt.set_device(None)
        mp.undo()
        jget_config.cache_clear()
        tconfig.get_config.cache_clear()


def _assert_same_retrieval(got, want):
    assert [(h.chunk.source, h.chunk.text) for h in got] == \
        [(h.chunk.source, h.chunk.text) for h in want]
    assert np.abs(np.array([h.score for h in got]) - np.array([h.score for h in want])).max(
        initial=0.0) <= SCORE_TOL


def _assert_same_dense(got, want, cut):
    """Dense hits: scores within SCORE_TOL position by position, the same
    chunk wherever its score is SCORE_TOL clear of its neighbours, and the
    same chunks inside each run of tied scores (HashEmbedder's small integer
    counts tie often; each package's top-k orders a tie as it likes), but
    for a last run the k cut (``cut``) may have split."""
    assert len(got) == len(want)
    gs, ws = np.array([h.score for h in got]), np.array([h.score for h in want])
    assert np.abs(gs - ws).max(initial=0.0) <= SCORE_TOL
    key = lambda h: (h.chunk.source, h.chunk.text)  # noqa: E731
    start = 0
    for end in range(1, len(want) + 1):
        if end == len(want) or ws[end - 1] - ws[end] > SCORE_TOL:
            if not (cut and end == len(want)):
                assert sorted(map(key, got[start:end])) == sorted(map(key, want[start:end]))
            start = end


def _check_pipeline(jcfg, tcfg, query, top_k=None, threshold=None, batched=False):
    """The port's retrieve() against JAX's: the dense legs equal up to
    ties, the fuse and rerank tail of JAX's runtime on the port's dense
    hits equal to the port's answer, and the two answers equal outright
    when the dense leg has no tie. ``batched``: the port's dense hits are
    the batched store path's (the retrieval tier's)."""
    got = trt.retrieve(query, top_k=top_k, score_threshold=threshold, config=tcfg)
    want = jrt.retrieve(query, top_k=top_k, score_threshold=threshold, config=jcfg)
    k = top_k if top_k is not None else tcfg.retriever.top_k
    thr = threshold if threshold is not None else tcfg.retriever.score_threshold
    _, lexical, _, fetch_k = trt.resolve_pipeline(tcfg, k)
    j_rr = jrt.resolve_pipeline(jcfg, k)[2]
    t_emb = trt.get_embedder(tcfg).embed_query(query)
    t_dense = (trt.get_vector_store().search_batch(t_emb[None], fetch_k, thr)[0] if batched
               else trt.get_vector_store().search(t_emb, fetch_k, thr))
    j_dense = jrt.get_vector_store().search(jrt.get_embedder(jcfg).embed_query(query),
                                            fetch_k + 1, thr)
    _assert_same_dense(t_dense, j_dense[:fetch_k], cut=len(j_dense) > fetch_k)
    same_input = [JHit(chunk=JChunk(text=h.chunk.text, source=h.chunk.source), score=h.score)
                  for h in t_dense]
    _assert_same_retrieval(
        got, jrt.finish_hits(query, same_input, fetch_k, k, lexical, j_rr, "default", jcfg))
    scores = [h.score for h in j_dense]
    if all(a - b > SCORE_TOL for a, b in zip(scores, scores[1:])):
        _assert_same_retrieval(got, want)
    return got


@pytest.mark.parametrize("runtimes", ["dense", "hybrid", "ranked_hybrid"], indirect=True)
def test_retrieve_matches_jax(runtimes):
    jcfg, tcfg, docs = runtimes
    assert trt.get_vector_store().sources() == jrt.get_vector_store().sources()
    queries = [docs[0].split(".")[0], docs[5].split(".")[2], "zzz unknown words", docs[3][:40]]
    for query in queries:
        for top_k in (None, 1, 6):
            _check_pipeline(jcfg, tcfg, query, top_k)
        _check_pipeline(jcfg, tcfg, query, threshold=0.3)
    got = tdr.QAChatbot().document_search(queries[0], 3)
    assert [(d["source"], d["content"]) for d in got] == [
        (h.chunk.source, h.chunk.text) for h in _check_pipeline(jcfg, tcfg, queries[0], 3)]


def test_delete_documents_leaves_neither_leg(runtimes, tmp_path):
    jcfg, tcfg, docs = runtimes
    query = docs[2].split(".")[0]
    for chain in (tdr.QAChatbot(), jdr.QAChatbot()):
        assert chain.delete_documents(["doc2.txt"])
        assert "doc2.txt" not in chain.get_documents()
    assert trt.get_bm25_index().count() == jrt.get_bm25_index().count()
    assert all(h.chunk.source != "doc2.txt" for h in trt.get_bm25_index().search(query, 50))
    assert all(h.chunk.source != "doc2.txt" for h in _check_pipeline(jcfg, tcfg, query, 8))
    # a reload from the persisted files holds the deletion too
    trt.reset_runtime()
    trt.set_device("cpu")
    assert "doc2.txt" not in trt.get_vector_store().sources()
    assert trt.get_bm25_index().count() == jrt.get_bm25_index().count()


# --------------------------------------------------------------------------- #
# the prompt ids the backends hand their engines


class _RecordingEngine:
    """An engine stub both packages' backends accept as ``engine=``."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.calls = []

    def stream_text(self, prompt_ids, params=None, timeout=None):
        self.calls.append((list(prompt_ids), params, timeout))
        return iter(["ok"])


def _install_backends(jcfg, tcfg):
    jeng, teng = _RecordingEngine(jtok.ByteTokenizer()), _RecordingEngine(ttok.ByteTokenizer())
    jllm._LLM_CACHE[(jcfg.llm.model_engine, jcfg.llm.server_url, jcfg.llm.model_name)] = \
        jllm.TPULLMBackend(engine=jeng)
    tllm._LLM_CACHE[(tcfg.llm.model_engine, tcfg.llm.server_url, tcfg.llm.model_name)] = \
        tllm.TorchLLMBackend(engine=teng)
    return jeng, teng


@pytest.mark.parametrize("chain", ["llm_chain", "rag_chain"])
def test_backends_submit_the_jax_prompt_ids(runtimes, chain, monkeypatch):
    jcfg, tcfg, docs = runtimes
    jeng, teng = _install_backends(jcfg, tcfg)
    history = [{"role": "user", "content": "earlier"}, {"role": "assistant", "content": "ok then"}]
    query = docs[1].split(".")[1] + " é?"
    # both chains build their context from the port's hits (a dense tie may
    # order JAX's otherwise: test_retrieve_matches_jax covers retrieval)
    hits = trt.retrieve(query, config=tcfg)
    monkeypatch.setattr(jrt, "retrieve", lambda *a, **k: [
        JHit(chunk=JChunk(text=h.chunk.text, source=h.chunk.source), score=h.score) for h in hits])
    settings = {"temperature": 0.5, "top_p": 0.9, "max_tokens": 33, "stop": ["\n\n"]}
    for chat, eng in ((tdr.QAChatbot(), teng), (jdr.QAChatbot(), jeng)):
        assert list(getattr(chat, chain)(query, history, **settings)) == ["ok"]
    (t_ids, t_params, t_timeout), = teng.calls
    (j_ids, j_params, j_timeout), = jeng.calls
    assert t_ids == j_ids
    assert t_timeout is None and j_timeout is None  # no deadline bound to this thread
    assert (t_params.temperature, t_params.top_p, t_params.max_tokens, t_params.stop) == \
        (j_params.temperature, j_params.top_p, j_params.max_tokens, j_params.stop)
    system = tcfg.prompts.chat_template if chain == "llm_chain" else tcfg.prompts.rag_template
    assert t_ids[: len(ttok.ByteTokenizer().render_chat_prefix([("system", system)]))] == \
        ttok.ByteTokenizer().render_chat_prefix([("system", system)])
    if chain == "rag_chain":
        assert hits[0].chunk.text.encode() in bytes(i for i in t_ids if i < 256)


def test_rag_chain_fallbacks_match_jax(runtimes, monkeypatch):
    jcfg, tcfg, docs = runtimes
    _install_backends(jcfg, tcfg)
    # nothing retrieved: the no-context message, verbatim
    monkeypatch.setattr(trt, "retrieve", lambda *a, **k: [])
    monkeypatch.setattr(jrt, "retrieve", lambda *a, **k: [])
    assert list(tdr.QAChatbot().rag_chain("q", [])) == list(jdr.QAChatbot().rag_chain("q", [])) \
        == [tdr.NO_CONTEXT_MSG]
    # retrieval down: a DegradedWarning, then the LLM-only answer
    def boom(*a, **k):
        raise RuntimeError("store down")

    monkeypatch.setattr(trt, "retrieve", boom)
    monkeypatch.setattr(jrt, "retrieve", boom)
    got, want = list(tdr.QAChatbot().rag_chain("q", [])), list(jdr.QAChatbot().rag_chain("q", []))
    assert [str(x) for x in got] == [str(x) for x in want]
    assert isinstance(got[0], trt.DegradedWarning) and got[1:] == ["ok"]
    # resilience off: the canned no-documents message
    monkeypatch.setenv("APP_RESILIENCE_ENABLE", "off")
    tconfig.get_config.cache_clear()
    jget_config.cache_clear()
    assert list(tdr.QAChatbot().rag_chain("q", [])) == list(jdr.QAChatbot().rag_chain("q", [])) \
        == [tdr.NO_DOCS_MSG]


def test_backend_passes_the_deadline_as_its_timeout():
    eng = _RecordingEngine(ttok.ByteTokenizer())
    backend = tllm.TorchLLMBackend(engine=eng)
    tres.set_current_deadline(tres.Deadline(30.0))
    try:
        list(backend.stream_chat([("user", "x")], max_tokens=5))
        assert 29.0 < eng.calls[0][2] <= 30.0
        tres.set_current_deadline(tres.Deadline(0.001))
        time.sleep(0.01)
        with pytest.raises(tres.DeadlineExceeded, match="before backend.stream"):
            backend.stream_chat([("user", "x")])
    finally:
        tres.set_current_deadline(None)
    assert len(eng.calls) == 1


@pytest.mark.parametrize("messages", [
    [("system", "You are terse."), ("user", "hi")],
    [("system", "S"), ("user", "a"), ("assistant", "b"), ("user", "é <x>")],
    [("user", "no system")],
    [],
])
def test_render_chat_cached_equals_jax_and_render_chat(messages):
    t, j = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    ids = ttok.render_chat_cached(t, messages)
    assert ids == jtok.render_chat_cached(j, messages) == t.render_chat(messages)
    assert ttok.render_chat_cached(t, messages) == ids  # served from the cache
    assert ttok.encode_cached(t, "héllo", True) == jtok.encode_cached(j, "héllo", True)
    ttok.clear_tokenization_caches()
    assert ttok.chat_preamble_ids.cache_info().currsize == 0


def test_an_overlong_rag_prompt_is_cut_as_the_jax_engine_cuts_it():
    """The port's engine keeps the prompt's tail, leaving room for
    min(64, max_tokens) tokens, as the JAX engine does (both submits held
    before admission, so no prefill runs)."""
    from generativeaiexamples_tpu.config.schema import EngineConfig as JEngineConfig
    from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JEngine
    from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JParams

    context = trt.cap_context(_corpus(21, n_docs=40), config=tconfig.AppConfig())
    messages = [("system", tconfig.PromptsConfig().rag_template),
                ("user", "Context: " + context + "\n\nQuestion: what?\n")]
    ids = ttok.render_chat_cached(ttok.ByteTokenizer(), messages)
    teng = LLMEngine(EngineConfig(model_config_name="debug", max_batch_size=2, max_seq_len=128,
                                  prefill_chunk=16, page_size=8), device="cpu")
    jeng = JEngine(JEngineConfig(model_config_name="debug", max_batch_size=2, max_seq_len=128,
                                 prefill_chunk=16, tensor_parallelism=1, dtype="float32"))
    try:
        assert len(ids) > 10 * teng.max_seq_len
        for max_tokens in (64, 8, 1024):
            with teng.hold_admissions(), jeng.hold_admissions():
                treq = teng.submit(ids, SamplingParams(max_tokens=max_tokens))
                jreq = jeng.submit(ids, JParams(max_tokens=max_tokens))
                assert treq.prompt_ids == jreq.prompt_ids == ids[-len(jreq.prompt_ids):]
                assert len(treq.prompt_ids) == 128 - 1 - min(64, max_tokens)
                teng.abort(treq)
                jeng.abort(jreq)
    finally:
        assert teng.shutdown()
        jeng.shutdown()


# --------------------------------------------------------------------------- #
# config, factories, registry


_SECTIONS = [
    ("llm", tconfig.LLMConfig, jschema.LLMConfig),
    ("text_splitter", tconfig.TextSplitterConfig, jschema.TextSplitterConfig),
    ("retriever", tconfig.RetrieverConfig, jschema.RetrieverConfig),
    ("prompts", tconfig.PromptsConfig, jschema.PromptsConfig),
    ("resilience", tconfig.ResilienceConfig, jschema.ResilienceConfig),
    ("ranking", tconfig.RankingConfig, jschema.RankingConfig),
]


@pytest.mark.parametrize("name,tcls,jcls", _SECTIONS, ids=[s[0] for s in _SECTIONS])
def test_config_sections_have_the_jax_names_and_defaults(name, tcls, jcls):
    import dataclasses

    port = {f.name: getattr(tcls(), f.name) for f in dataclasses.fields(tcls)}
    port.update({k: v[0] for k, v in getattr(tcls, "UNSERVED", {}).items()})
    assert port == {f.name: getattr(jcls(), f.name) for f in dataclasses.fields(jcls)}


def test_config_reads_the_jax_environment_names():
    env = {"APP_LLM_MODELENGINE": "echo", "APP_LLM_SERVERURL": "http://h:1",
           "APP_TEXTSPLITTER_CHUNKSIZE": "64", "APP_RETRIEVER_SCORETHRESHOLD": "0.5",
           "APP_RETRIEVER_NRPIPELINE": "hybrid", "APP_PROMPTS_CHATTEMPLATE": "Be brief.",
           "APP_RESILIENCE_MAXACTIVESTREAMS": "3", "APP_RANKING_FETCHFACTOR": "2",
           "APP_RESILIENCE_RETRYMAXATTEMPTS": "3"}
    cfg = tconfig.AppConfig.from_env(env)
    assert (cfg.llm.model_engine, cfg.llm.server_url, cfg.text_splitter.chunk_size) == ("echo", "http://h:1", 64)
    assert (cfg.retriever.score_threshold, cfg.retriever.nr_pipeline) == (0.5, "hybrid")
    assert (cfg.prompts.chat_template, cfg.resilience.max_active_streams, cfg.ranking.fetch_factor) == \
        ("Be brief.", 3, 2)


@pytest.mark.parametrize("env,item", [
    ({"APP_RETRIEVER_NRURL": "nr:8000"}, "retriever.nr_url must carry a scheme"),
    ({"APP_TEXTSPLITTER_MODELNAME": " "}, "text_splitter.model_name must not be empty"),
    # a file that APP_CONFIG_FILE names is read and checked as the
    # environment is
    pytest.param({"APP_CONFIG_FILE": {"retriever": {"nrUrl": "retrieval-ms:8000"}}},
                 "retriever.nr_url must carry a scheme", id="env4-APP_CONFIG_FILE"),
])
def test_config_refuses_what_the_port_does_not_serve(env, item, tmp_path):
    """The fields the port reads, checks as JAX does and then ignores
    (``IGNORED``): a value JAX's startup check refuses is refused with
    JAX's message; one it accepts starts (ROADMAP queue 3 fault 4)."""
    from generativeaiexamples_tpu_torch import config_validate

    if isinstance(env.get("APP_CONFIG_FILE"), dict):
        path = tmp_path / "app.json"
        path.write_text(json.dumps(env["APP_CONFIG_FILE"]))
        env = dict(env, APP_CONFIG_FILE=str(path))
    with pytest.raises(ValueError, match=item):
        config_validate.validate_config(tconfig.load_config(env))
    config_validate.validate_config(tconfig.load_config(
        {"APP_RETRIEVER_NRURL": "http://nr:8000", "APP_TEXTSPLITTER_MODELNAME": "bert-base"}))


@pytest.mark.parametrize("env", ["APP_EMBEDDINGS_CHECKPOINTPATH", "APP_RANKING_CHECKPOINTPATH"])
def test_config_serves_a_retrieval_checkpoint_path(env, tmp_path):
    """The encoders' checkpoint paths (refused until ROADMAP queue 1 item
    10) are served as JAX serves them: the config reads the path; the
    encoder built from a directory without safetensors raises
    FileNotFoundError; one built from a written HF checkpoint embeds (or
    scores) exactly as the same weights given in memory."""
    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder
    from generativeaiexamples_tpu_torch.models import bert as tbert
    from generativeaiexamples_tpu_torch.utils import safetensors_io

    section = "embeddings" if "EMBEDDINGS" in env else "ranking"
    missing = str(tmp_path / "missing")
    assert getattr(tconfig.load_config({env: missing}), section).checkpoint_path == missing
    cls = TorchEmbedder if section == "embeddings" else TorchReranker
    kw = dict(model_name="debug", device="cpu", dtype=torch.float32)
    with pytest.raises(FileNotFoundError):
        cls(checkpoint_path=missing, **kw)
    ref = cls(**kw)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    safetensors_io.save_file(tbert.hf_tensors(ref._params), str(ckpt / "model.safetensors"))
    loaded = cls(checkpoint_path=getattr(tconfig.load_config({env: str(ckpt)}), section).checkpoint_path,
                 **kw)
    try:
        texts = ["retrieval on the card", "a second, longer passage about kernels"]
        if section == "embeddings":
            np.testing.assert_array_equal(loaded.embed_documents(texts), ref.embed_documents(texts))
        else:
            np.testing.assert_array_equal(loaded.score("kernels", texts), ref.score("kernels", texts))
    finally:
        loaded.close()
        ref.close()


@pytest.mark.parametrize("env,section,field,value", [
    ({"APP_RETRIEVER_BACKEND": "tier"}, "retriever", "backend", "tier"),
    ({"APP_RETRIEVER_TIERQUEUEDEPTH": "4"}, "retriever", "tier_queue_depth", 4),
    ({"APP_RETRIEVER_TIERWINDOWMS": "0"}, "retriever", "tier_window_ms", 0),
    ({"APP_RESILIENCE_RETRYMAXATTEMPTS": "5"}, "resilience", "retry_max_attempts", 5),
    ({"APP_RESILIENCE_RETRYBASEDELAYMS": "10"}, "resilience", "retry_base_delay_ms", 10),
    ({"APP_RESILIENCE_RETRYMAXDELAYMS": "100"}, "resilience", "retry_max_delay_ms", 100),
    ({"APP_RESILIENCE_RETRYJITTER": "0.0"}, "resilience", "retry_jitter", 0.0),
    ({"APP_RESILIENCE_BREAKERFAILURETHRESHOLD": "2"}, "resilience",
     "breaker_failure_threshold", 2),
    ({"APP_RESILIENCE_BREAKERRECOVERYS": "2.5"}, "resilience", "breaker_recovery_s", 2.5),
    ({"APP_RESILIENCE_FAULTS": "retrieval.search:error@1x0"}, "resilience", "faults",
     "retrieval.search:error@1x0"),
])
def test_config_serves_the_retry_breaker_fault_and_tier_fields(env, section, field, value):
    """What the port refused until it had retries, breakers, faults and the
    retrieval tier is read with the JAX names and passes the JAX checks."""
    cfg = tconfig.AppConfig.from_env(env)
    assert getattr(getattr(cfg, section), field) == value
    tvalidate.validate_config(cfg)
    cfg.resilience.validate()


def test_resilience_validation_has_the_jax_messages():
    for field, value in [("enable", "maybe"), ("request_deadline_ms", -1),
                         ("max_active_streams", -1), ("shed_retry_after_s", 0.0)]:
        j = jschema.ResilienceConfig(**{field: value})
        t = tconfig.ResilienceConfig(**{field: value})
        from generativeaiexamples_tpu.utils.resilience import validate_config

        with pytest.raises(ValueError) as want:
            validate_config(j)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            t.validate()


def test_get_config_is_cached(monkeypatch):
    monkeypatch.setenv("APP_RETRIEVER_TOPK", "7")
    tconfig.get_config.cache_clear()
    try:
        first = tconfig.get_config()
        monkeypatch.setenv("APP_RETRIEVER_TOPK", "9")
        assert tconfig.get_config() is first and first.retriever.top_k == 7
        tconfig.get_config.cache_clear()
        assert tconfig.get_config().retriever.top_k == 9
    finally:
        tconfig.get_config.cache_clear()


def test_create_llm_dispatches_on_the_jax_engine_names(monkeypatch):
    monkeypatch.setattr(tllm, "_LLM_CACHE", {})
    cfg = tconfig.AppConfig()
    echo = tllm.create_llm(cfg, model_engine="echo")
    assert isinstance(echo, tllm.EchoLLMBackend) and tllm.create_llm(cfg, model_engine="echo") is echo
    assert list(echo.stream_chat([("user", "a b c")], max_tokens=2)) == ["a ", "b "]
    for kind in ("openai", "nvidia-ai-endpoints", "remote"):
        remote = tllm.create_llm(cfg, model_engine=kind, server_url="http://127.0.0.1:9")
        assert isinstance(remote, tllm.RemoteLLMBackend) and remote._url == "http://127.0.0.1:9/v1"
    with pytest.raises(ValueError) as want:
        jllm.create_llm(jschema.AppConfig(), model_engine="bogus")
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tllm.create_llm(cfg, model_engine="bogus")


def test_the_remote_backend_streams_an_openai_server():
    """RemoteLLMBackend against the port's own OpenAI-compatible server
    (debug engine on the CPU): its deltas join to the non-streamed answer
    the same request gets."""
    from generativeaiexamples_tpu_torch.engine.server import make_server

    engine = LLMEngine(EngineConfig(model_config_name="debug", max_batch_size=2, max_seq_len=128,
                                    prefill_chunk=16, page_size=8), device="cpu")
    server = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=server.serve_forever, name="test-remote-llm", daemon=True)
    thread.start()
    try:
        backend = tllm.RemoteLLMBackend(f"http://127.0.0.1:{server.server_address[1]}", "m")
        msgs = [("user", "hello there")]
        streamed = "".join(backend.stream_chat(msgs, temperature=0.0, max_tokens=12))
        whole = "".join(engine.chat(msgs, SamplingParams(temperature=0.0, max_tokens=12)))
        assert streamed == whole
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        assert engine.shutdown()


def test_registry_serves_the_ported_chains(monkeypatch):
    monkeypatch.delenv("EXAMPLE_NAME", raising=False)
    assert tregistry.resolve_example() is tdr.QAChatbot
    monkeypatch.setenv("EXAMPLE_NAME", "echo")
    assert tregistry.resolve_example().__name__ == "EchoChain"
    for name in jregistry.available_examples():
        # every JAX name resolves to the port's class of the same name
        assert tregistry.resolve_example(name).__name__ == \
            jregistry.resolve_example(name).__name__
    with pytest.raises(NotImplementedError, match="Unknown example"):
        tregistry.resolve_example("nope")
