"""VectorStore backed by the native C++ ANN index on the host.

Counterpart of generativeaiexamples_tpu/retrieval/native_store.py: the
store behind the vector-store names ``faiss``, ``native`` (flat, exact)
and ``ivf`` (IVF-flat, trained on the first batch added), with JAX's store
semantics (add, search, sources, delete, persist), its on-disk layout
(``<collection>.vecidx``, the index, and ``<collection>.meta.jsonl``, one
chunk a line with its id) and its error messages, so that either package
opens what the other persisted. Embeddings are normalized before they go
in, so inner product is the cosine score.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError
from generativeaiexamples_tpu_torch.retrieval.store import (
    STORE_ADD_SECONDS, STORE_CHUNKS, STORE_SEARCH_SECONDS, Chunk, SearchHit, VectorStore,
)
from generativeaiexamples_tpu_torch.utils import resilience

logger = logging.getLogger(__name__)


class NativeVectorStore(VectorStore):
    """Cosine-similarity store on the port's C++ index (ctypes)."""

    def __init__(
        self,
        dimensions: int,
        persist_dir: str = "",
        collection: str = "default",
        nlist: int = 0,
        nprobe: int = 8,
    ):
        from generativeaiexamples_tpu_torch.retrieval import native_index

        self._ni = native_index
        self._dim = dimensions
        self._persist_dir = persist_dir
        self._collection = collection
        self._nlist = nlist
        self._nprobe = nprobe
        self._lock = threading.RLock()
        self._chunks: Dict[int, Chunk] = {}
        self._index = None
        if persist_dir and os.path.exists(self._index_path()):
            self._load()
        else:
            self._index = native_index.NativeIndex(
                dimensions, metric=native_index.METRIC_IP, nlist=nlist
            )

    # -- persistence ----------------------------------------------------
    def _index_path(self) -> str:
        return os.path.join(self._persist_dir, self._collection + ".vecidx")

    def _meta_path(self) -> str:
        return os.path.join(self._persist_dir, self._collection + ".meta.jsonl")

    def _load(self) -> None:
        try:
            self._index = self._ni.NativeIndex.load(self._index_path())
            with open(self._meta_path(), "r", encoding="utf-8") as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    self._chunks[int(row["id"])] = Chunk(
                        text=row["text"], source=row["source"], metadata=row.get("metadata", {})
                    )
            logger.info(
                "Loaded %d chunks into native collection %s", len(self._chunks), self._collection
            )
        except Exception as exc:  # noqa: BLE001 - any failure means corrupt state
            raise VectorStoreError(
                f"Corrupt native store state in {self._persist_dir}: {exc}"
            )

    def persist(self) -> None:
        if not self._persist_dir:
            return
        with self._lock:
            os.makedirs(self._persist_dir, exist_ok=True)
            self._index.save(self._index_path())
            with open(self._meta_path(), "w", encoding="utf-8") as fh:
                for cid, chunk in self._chunks.items():
                    fh.write(json.dumps({"id": cid, "text": chunk.text, "source": chunk.source,
                                         "metadata": chunk.metadata}) + "\n")

    # -- core ops -------------------------------------------------------
    def add(self, chunks: Sequence[Chunk], embeddings: np.ndarray) -> None:
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim != 2 or embeddings.shape[1] != self._dim:
            raise VectorStoreError(
                f"Expected [N, {self._dim}] embeddings, got {embeddings.shape}"
            )
        if len(chunks) != embeddings.shape[0]:
            raise VectorStoreError("chunks and embeddings length mismatch")
        norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
        embeddings = embeddings / np.maximum(norms, 1e-12)
        t0 = time.time()
        with self._lock:
            if not self._index.is_trained:
                self._index.train(embeddings)
            first = self._index.add(embeddings)
            for offset, chunk in enumerate(chunks):
                self._chunks[first + offset] = chunk
            self.persist()
            count = len(self._chunks)
        STORE_ADD_SECONDS.labels(store="native").observe(time.time() - t0)
        STORE_CHUNKS.labels(store="native", collection=self._collection).set(count)

    # Breaker only (attempts=1): retrying a deterministic in-process failure
    # is useless, but repeated failures open the "native_store" breaker and
    # the chains degrade to LLM-only answers instead of answering 500.
    @resilience.resilient("native_store", attempts=1)
    def search(
        self, query_embedding: np.ndarray, top_k: int, score_threshold: float = 0.0
    ) -> List[SearchHit]:
        t0 = time.time()
        with self._lock:
            if len(self._chunks) == 0 or top_k <= 0:
                return []
            q = np.asarray(query_embedding, np.float32).reshape(-1)
            q = q / max(float(np.linalg.norm(q)), 1e-12)
            k = min(top_k, len(self._chunks))
            scores, ids = self._index.search(q, k, nprobe=self._nprobe)
            hits: List[SearchHit] = []
            for score, cid in zip(scores[0], ids[0]):
                if cid < 0 or int(cid) not in self._chunks:
                    continue
                score01 = max(0.0, float(score))
                if score01 < score_threshold:
                    continue
                hits.append(SearchHit(chunk=self._chunks[int(cid)], score=score01))
        STORE_SEARCH_SECONDS.labels(store="native").observe(time.time() - t0)
        return hits

    def sources(self) -> List[str]:
        with self._lock:
            seen, out = set(), []
            for chunk in self._chunks.values():
                if chunk.source not in seen:
                    seen.add(chunk.source)
                    out.append(chunk.source)
            return out

    def delete_sources(self, sources: Sequence[str]) -> bool:
        drop = set(sources)
        with self._lock:
            doomed = [cid for cid, c in self._chunks.items() if c.source in drop]
            if not doomed:
                return True
            self._index.remove(np.asarray(doomed, np.int64))
            for cid in doomed:
                del self._chunks[cid]
            self.persist()
            STORE_CHUNKS.labels(store="native", collection=self._collection).set(
                len(self._chunks)
            )
            return True

    def count(self) -> int:
        with self._lock:
            return len(self._chunks)
