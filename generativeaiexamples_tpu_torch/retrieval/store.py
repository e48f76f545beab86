"""Vector store abstraction.

Counterpart of generativeaiexamples_tpu/retrieval/store.py: one small
typed interface with the operations the chains use (ingest chunks,
similarity search with scores, list source documents, delete by source).
``create_vector_store`` serves every name of the JAX package's factory:
``TorchVectorStore`` (in-process, on the card), ``NativeVectorStore`` (the
C++ index on the host), ``MilvusVectorStore`` and ``PgVectorStore``. The
store families (search and ingest time by backend, chunks by backend and
collection) are JAX's, shared by every backend and the BM25 sidecar.
"""
from __future__ import annotations

import dataclasses
import logging
from abc import ABC, abstractmethod
from typing import Dict, List, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

logger = logging.getLogger(__name__)
_FALLBACK_LOGGED = False  # the native index's fallback is logged once a process

_REG = metrics_mod.get_registry()
STORE_SEARCH_SECONDS = _REG.histogram(
    "genai_vectorstore_search_seconds",
    "Similarity/lexical search wall time, by store backend.",
    ("store",),
)
STORE_ADD_SECONDS = _REG.histogram(
    "genai_vectorstore_add_seconds",
    "Chunk-insertion (index ingest) wall time, by store backend.",
    ("store",),
)
STORE_CHUNKS = _REG.gauge(
    "genai_vectorstore_chunks",
    "Chunks currently indexed, by store backend and collection.",
    ("store", "collection"),
)


@dataclasses.dataclass
class Chunk:
    """One ingested text chunk with its source document."""

    text: str
    source: str
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SearchHit:
    chunk: Chunk
    score: float


class VectorStore(ABC):
    """Similarity index over embedded chunks."""

    @abstractmethod
    def add(self, chunks: Sequence[Chunk], embeddings: np.ndarray) -> None:
        """Insert chunks with their [N, D] embeddings."""

    @abstractmethod
    def search(
        self, query_embedding: np.ndarray, top_k: int, score_threshold: float = 0.0
    ) -> List[SearchHit]:
        """Return the top_k most similar chunks with scores in [0, 1]."""

    @abstractmethod
    def sources(self) -> List[str]:
        """List distinct source document names."""

    @abstractmethod
    def delete_sources(self, sources: Sequence[str]) -> bool:
        """Drop every chunk belonging to the given documents."""

    @abstractmethod
    def count(self) -> int: ...

    def persist(self) -> None:  # optional
        """Flush to durable storage."""


def create_vector_store(name: str, dimensions: int, persist_dir: str = "", url: str = "",
                        collection: str = "default", device=None, **ann_opts) -> VectorStore:
    """The store a vector-store name selects, with the JAX package's
    dispatch and messages: ``tpu``/``memory`` the in-process store (on the
    card unless ``device="cpu"``; ``ann_opts``: ann_mode, ann_capacity,
    ann_max_batch, nlist, nprobe), ``faiss``/``native`` (flat) and ``ivf``
    (nlist 64) the C++ index on the host, ``milvus`` and ``pgvector`` the
    clients of those servers at ``url``. ``ann_opts`` and ``device`` are
    dropped for the other backends. Where the C++ index does not build,
    ``faiss``/``native``/``ivf`` serve the in-process store, as JAX's
    factory does, and the fallback is logged once with the build's error."""
    global _FALLBACK_LOGGED
    name = (name or "tpu").lower()
    if name in ("faiss", "native", "ivf"):
        from generativeaiexamples_tpu_torch.retrieval import native_index

        if native_index.available():
            from generativeaiexamples_tpu_torch.retrieval.native_store import NativeVectorStore

            return NativeVectorStore(
                dimensions, persist_dir=persist_dir, collection=collection,
                nlist=0 if name != "ivf" else 64,
            )
        if not _FALLBACK_LOGGED:
            _FALLBACK_LOGGED = True
            logger.warning("vector store %r: the native index is unavailable (%s); serving the "
                           "in-process store instead", name, native_index.unavailable_reason())
        name = "tpu"
    if name in ("tpu", "memory"):
        from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore

        return TorchVectorStore(
            dimensions, persist_dir=persist_dir, collection=collection, device=device, **ann_opts,
        )
    if name == "milvus":
        from generativeaiexamples_tpu_torch.retrieval.milvus_store import MilvusVectorStore

        return MilvusVectorStore(dimensions, url=url, collection=collection)
    if name == "pgvector":
        from generativeaiexamples_tpu_torch.retrieval.pgvector_store import PgVectorStore

        return PgVectorStore(dimensions, url=url, collection=collection)
    raise ValueError(f"Unknown vector store {name!r} (tpu|faiss|milvus|pgvector)")
