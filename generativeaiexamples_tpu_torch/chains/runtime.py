"""The runtime the chains share: the synchronous path of the JAX package's
generativeaiexamples_tpu/chains/runtime.py.

Cached factories for the embedder, the LLM backend, one vector store and
one BM25 index per collection, and the splitter; the single write path
(``index_chunks``: embed, insert, mirror into BM25) and its delete; and
``retrieve``: embed the query, search the store, fuse with BM25 by
reciprocal rank (``hybrid``, ``ranked_hybrid``), rerank
(``ranked_hybrid``), then ``cap_context`` bounds the context the LLM sees.
``retrieve`` calls the ``retrieval.search`` fault point first, and with
``retriever.backend=tier`` hands the query to the retrieval tier
(engine/retrieval_tier.py), whose batched waves give the same hits.
Every model and store lives on the card unless ``set_device`` names
another device (the tests' ``"cpu"``).

JAX's four chain families (retrieve and ingest time, chunks ingested,
degraded answers by chain), its spans (``chain.ingest``,
``retriever.retrieve`` and their children, through utils/tracing.py) and
its ``retrieve`` and ``degraded`` flight events are the port's too; a
degraded answer feeds the SLO tracker's degraded rate.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, Generator, List, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.config import AppConfig, get_config
from generativeaiexamples_tpu_torch.engine.tokenizer import (  # noqa: F401 - the chains' API
    chat_preamble_ids,
    clear_tokenization_caches,
    encode_cached,
    render_chat_cached,
)
from generativeaiexamples_tpu_torch.retrieval.splitter import get_text_splitter
from generativeaiexamples_tpu_torch.retrieval.store import (
    Chunk,
    SearchHit,
    VectorStore,
    create_vector_store,
)
from generativeaiexamples_tpu_torch.utils import faults as faults_mod
from generativeaiexamples_tpu_torch.utils import flight_recorder
from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod
from generativeaiexamples_tpu_torch.utils import resilience
from generativeaiexamples_tpu_torch.utils import slo as slo_mod
from generativeaiexamples_tpu_torch.utils.tracing import get_tracer

logger = logging.getLogger(__name__)

_REG = metrics_mod.get_registry()
_M_RETRIEVE = _REG.histogram(
    "genai_chain_retrieve_seconds",
    "End-to-end retrieval pipeline latency (embed + search + fuse + rerank).",
    ("pipeline",),
)
_M_INGEST = _REG.histogram(
    "genai_chain_ingest_seconds",
    "Document ingestion latency (load + split + embed + index).",
)
_M_INGESTED_CHUNKS = _REG.counter(
    "genai_chain_ingested_chunks_total",
    "Chunks indexed through the single write path (index_chunks).",
)
_M_DEGRADED = _REG.counter(
    "genai_chain_degraded_answers_total",
    "RAG requests answered LLM-only because retrieval failed or its "
    "breaker was open, by chain.",
    ("chain",),
)

_STORES: Dict[str, VectorStore] = {}
_BM25: Dict[str, object] = {}
# the per-collection factories check and insert under this lock: two
# request threads never build two stores (or indexes) for one collection,
# one of which would lose its writes
_FACTORY_LOCK = threading.Lock()
_DEVICE = None  # None: the card


def set_device(device) -> None:
    """The device of the models and stores built from now on (None: the
    card; ``"cpu"`` runs the plain PyTorch paths, as the tests do)."""
    global _DEVICE
    _DEVICE = device


@dataclasses.dataclass
class DegradedWarning:
    """The marker a chain yields before its fallback answer; the server
    sends it as a warnings-only SSE frame instead of answer text."""

    reason: str
    detail: str = ""

    def __str__(self) -> str:
        return f"{self.reason}: {self.detail}" if self.detail else self.reason


def degraded_answer(chain: str, llm_chain_fn, query: str, chat_history,
                    exc: BaseException, **kwargs) -> Generator:
    """The LLM-only fallback of a RAG chain whose retrieval failed: a
    DegradedWarning first, then the plain llm_chain stream."""
    _M_DEGRADED.labels(chain=chain).inc()
    slo_mod.observe_event("degraded")
    flight_recorder.event("degraded", chain=chain, error=type(exc).__name__)
    logger.warning("%s: retrieval unavailable (%s); degrading to LLM-only answer", chain, exc)

    def gen():
        yield DegradedWarning(
            reason="retrieval_degraded",
            detail=f"{type(exc).__name__}: {exc}; answering without retrieved context",
        )
        yield from llm_chain_fn(query=query, chat_history=chat_history, **kwargs)

    return gen()


def get_embedder(config: Optional[AppConfig] = None):
    from generativeaiexamples_tpu_torch.engine.embedder import create_embedder

    return create_embedder(config or get_config(), device=_DEVICE)


def get_llm(config: Optional[AppConfig] = None, **overrides):
    from generativeaiexamples_tpu_torch.engine.llm_backend import create_llm

    return create_llm(config or get_config(), device=_DEVICE, **overrides)


def get_vector_store(collection: str = "default",
                     config: Optional[AppConfig] = None) -> VectorStore:
    """One store per collection name."""
    config = config or get_config()
    with _FACTORY_LOCK:
        if collection not in _STORES:
            ret = config.retriever
            _STORES[collection] = create_vector_store(
                config.vector_store.name,
                dimensions=get_embedder(config).dimensions,
                persist_dir=config.vector_store.persist_dir,
                url=config.vector_store.url,
                collection=collection,
                device=_DEVICE,
                ann_mode=ret.ann_mode or "exact",
                ann_capacity=int(ret.ann_capacity),
                ann_max_batch=int(ret.ann_max_batch),
                nlist=config.vector_store.nlist,
                nprobe=config.vector_store.nprobe,
            )
        return _STORES[collection]


def get_bm25_index(collection: str = "default", config: Optional[AppConfig] = None):
    """The per-collection lexical index of the hybrid pipelines."""
    from generativeaiexamples_tpu_torch.retrieval.bm25 import BM25Index

    config = config or get_config()
    with _FACTORY_LOCK:
        if collection not in _BM25:
            _BM25[collection] = BM25Index(persist_dir=config.vector_store.persist_dir,
                                          collection=collection)
        return _BM25[collection]


def _lexical_enabled(config: AppConfig) -> bool:
    return config.retriever.nr_pipeline in ("hybrid", "ranked_hybrid")


def index_chunks(chunks: Sequence[Chunk], collection: str = "default",
                 config: Optional[AppConfig] = None) -> None:
    """Embed and insert into the vector store, and mirror into the BM25
    index when a hybrid pipeline is configured: the one write path."""
    config = config or get_config()
    tracer = get_tracer()
    with tracer.span("embedder.embed_documents", {"count": len(chunks)}):
        embeddings = get_embedder(config).embed_documents([c.text for c in chunks])
    with tracer.span("vectorstore.add", {"count": len(chunks)}):
        get_vector_store(collection, config).add(chunks, embeddings)
    if _lexical_enabled(config):
        with tracer.span("bm25.add", {"count": len(chunks)}):
            get_bm25_index(collection, config).add(chunks)
    _M_INGESTED_CHUNKS.inc(len(chunks))


def delete_documents(filenames: Sequence[str], collection: str = "default",
                     config: Optional[AppConfig] = None) -> bool:
    """Drop documents from the vector store and the BM25 index (always
    both: an index persisted under a hybrid pipeline must not keep them)."""
    config = config or get_config()
    ok = get_vector_store(collection, config).delete_sources(filenames)
    get_bm25_index(collection, config).delete_sources(filenames)
    return ok


def reset_runtime() -> None:
    """Drop the cached stores, backends, breakers and config (tests); stops
    the retrieval tier's worker and the embedder's and reranker's
    micro-batcher threads first."""
    from generativeaiexamples_tpu_torch.engine import embedder as _emb
    from generativeaiexamples_tpu_torch.engine import llm_backend as _llm
    from generativeaiexamples_tpu_torch.engine import reranker as _rr
    from generativeaiexamples_tpu_torch.engine import retrieval_tier as _tier

    _tier.close_tier()
    _STORES.clear()
    _BM25.clear()
    clear_tokenization_caches()
    resilience.reset_breakers()
    for cache in (_emb._EMBEDDER_CACHE, _rr._RERANKER_CACHE):
        for backend in cache.values():
            for hook in ("close", "clear_query_cache"):
                fn = getattr(backend, hook, None)
                if callable(fn):
                    fn()
        cache.clear()
    _llm._LLM_CACHE.clear()
    get_config.cache_clear()


def get_splitter(config: Optional[AppConfig] = None):
    config = config or get_config()
    return get_text_splitter(config.text_splitter.chunk_size, config.text_splitter.chunk_overlap)


def ingest_file(filepath: str, filename: str, collection: str = "default",
                config: Optional[AppConfig] = None) -> int:
    """Load, split, embed and insert; returns the number of chunks."""
    from generativeaiexamples_tpu_torch.retrieval.loaders import load_document

    config = config or get_config()
    tracer = get_tracer()
    t0 = time.time()
    with tracer.span("chain.ingest", {"filename": filename, "collection": collection}) as span:
        with tracer.span("loader.load"):
            text = load_document(filepath)
        if not text.strip():
            raise ValueError(f"No text extracted from {filename}")
        chunks = [Chunk(text=piece, source=filename)
                  for piece in get_splitter(config).split_text(text)]
        span.set_attribute("chunks", len(chunks))
        index_chunks(chunks, collection, config)
    _M_INGEST.observe(time.time() - t0)
    logger.info("Ingested %s: %d chunks into %s", filename, len(chunks), collection)
    return len(chunks)


def resolve_pipeline(config: AppConfig, top_k: int):
    """``(pipeline name, lexical leg on, reranker or None, fetch_k)``:
    ``hybrid`` fuses dense and BM25 hits by reciprocal rank,
    ``ranked_hybrid`` reranks the fused hits, any other name is dense only."""
    pipeline = config.retriever.nr_pipeline
    lexical = _lexical_enabled(config)
    reranker = None
    fetch_k = top_k
    if pipeline == "ranked_hybrid":
        from generativeaiexamples_tpu_torch.engine.reranker import create_reranker

        reranker = create_reranker(config, device=_DEVICE)
    if reranker is not None or lexical:
        fetch_k = top_k * max(1, config.ranking.fetch_factor)
    return pipeline, lexical, reranker, fetch_k


def finish_hits(query: str, hits: List[SearchHit], fetch_k: int, top_k: int, lexical: bool,
                reranker, collection: str, config: AppConfig) -> List[SearchHit]:
    """BM25 fusion when the lexical leg is on, then the rerank (or a plain
    cut) down to ``top_k``."""
    tracer = get_tracer()
    if lexical:
        from generativeaiexamples_tpu_torch.retrieval.bm25 import rrf_fuse

        index = get_bm25_index(collection, config)
        if index.count():
            with tracer.span("bm25.search"):
                lex_hits = index.search(query, fetch_k)
            if lex_hits:
                hits = rrf_fuse([hits, lex_hits])[:fetch_k]
    if reranker is not None and len(hits) > 1:
        from generativeaiexamples_tpu_torch.engine.reranker import rerank_hits

        with tracer.span("reranker.rerank", {"candidates": len(hits)}):
            return rerank_hits(reranker, query, hits, top_k)
    return hits[:top_k]


def retrieve(query: str, top_k: Optional[int] = None, score_threshold: Optional[float] = None,
             collection: str = "default", config: Optional[AppConfig] = None) -> List[SearchHit]:
    config = config or get_config()
    top_k = top_k if top_k is not None else config.retriever.top_k
    threshold = (score_threshold if score_threshold is not None
                 else config.retriever.score_threshold)
    faults_mod.fault_point("retrieval.search")
    # a request whose budget is gone must not start a pipeline
    resilience.raise_if_deadline_expired("retrieval")
    tracer = get_tracer()
    t0 = time.time()
    pipeline = config.retriever.nr_pipeline
    attrs = {"top_k": top_k, "collection": collection}
    if (config.retriever.backend or "off").lower() == "tier":
        from generativeaiexamples_tpu_torch.engine import retrieval_tier

        with tracer.span("retriever.retrieve_tier", attrs) as span:
            hits = retrieval_tier.get_tier(config).retrieve(query, top_k, threshold, collection)
            span.set_attribute("hits", len(hits))
    else:
        with tracer.span("retriever.retrieve", attrs) as span:
            pipeline, lexical, reranker, fetch_k = resolve_pipeline(config, top_k)
            with tracer.span("embedder.embed_query"):
                q_emb = get_embedder(config).embed_query(query)
            with tracer.span("vectorstore.search"):
                hits = get_vector_store(collection, config).search(q_emb, fetch_k, threshold)
            hits = finish_hits(query, hits, fetch_k, top_k, lexical, reranker, collection, config)
            span.set_attribute("hits", len(hits))
    _M_RETRIEVE.labels(pipeline=pipeline or "dense").observe(time.time() - t0)
    flight_recorder.event("retrieve", pipeline=pipeline or "dense", hits=len(hits),
                          duration_s=round(time.time() - t0, 6))
    return hits


def cap_context(texts: Sequence[str], token_cap: Optional[int] = None,
                config: Optional[AppConfig] = None) -> str:
    """Retrieved texts joined under a budget of whitespace words."""
    config = config or get_config()
    cap = token_cap if token_cap is not None else config.retriever.context_token_cap
    out: List[str] = []
    used = 0
    for text in texts:
        tokens = text.split()
        if used + len(tokens) > cap:
            remaining = cap - used
            if remaining > 0:
                out.append(" ".join(tokens[:remaining]))
            break
        out.append(text)
        used += len(tokens)
    return "\n\n".join(out)


def history_to_messages(chat_history) -> List[Tuple[str, str]]:
    """Server Message objects, dicts or tuples as (role, content)."""
    out: List[Tuple[str, str]] = []
    for m in chat_history or []:
        if isinstance(m, tuple):
            out.append((m[0], m[1]))
        elif isinstance(m, dict):
            out.append((m.get("role", "user"), m.get("content", "")))
        else:
            out.append((getattr(m, "role", "user"), getattr(m, "content", "")))
    return out


def llm_settings(kwargs: dict) -> dict:
    """The generation settings a chain forwards to the backend."""
    return {key: kwargs[key] for key in ("temperature", "top_p", "max_tokens", "stop")
            if kwargs.get(key) is not None}
