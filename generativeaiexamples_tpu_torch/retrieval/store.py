"""Vector store abstraction.

Counterpart of generativeaiexamples_tpu/retrieval/store.py: one small
typed interface with the operations the chains use (ingest chunks,
similarity search with scores, list source documents, delete by source).
``create_vector_store`` serves the JAX package's in-process names (``tpu``,
``memory``) with ``TorchVectorStore``; the other backends raise, naming
the ROADMAP item that will serve them. The store families (search and
ingest time by backend, chunks by backend and collection) are JAX's,
shared by every backend and the BM25 sidecar.
"""
from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Dict, List, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

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


def create_vector_store(name: str, dimensions: int, persist_dir: str = "",
                        collection: str = "default", device=None, **ann_opts) -> VectorStore:
    """The store a vector-store name selects (the JAX package's names).
    ``ann_opts`` (ann_mode, ann_capacity, ann_max_batch, nlist, nprobe)
    configure the in-process store's search engine; its corpus lives on
    the card unless ``device="cpu"``."""
    name = (name or "tpu").lower()
    if name in ("tpu", "memory"):
        from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore

        return TorchVectorStore(
            dimensions, persist_dir=persist_dir, collection=collection, device=device, **ann_opts,
        )
    if name in ("faiss", "native", "ivf", "milvus", "pgvector"):
        raise ValueError(
            f"vector store {name!r} is not served by the port: the native index and the "
            "milvus/pgvector connectors arrive with the rest of the package (ROADMAP queue 1 "
            "item 13); 'tpu' (or 'memory') is the in-process store on the card"
        )
    raise ValueError(f"Unknown vector store {name!r} (tpu|faiss|milvus|pgvector)")
