"""In-process vector index with its search on the card.

Counterpart of generativeaiexamples_tpu/retrieval/tpu_store.py: cosine
similarity through ``ANNSearchEngine`` (exact or IVF top-k over a padded
corpus matrix on the device). Embeddings are kept normalized, so inner
product is the cosine score.

Persistence is the JAX store's on-disk format, so either package loads
what the other wrote: per collection, ``<collection>.npz`` (the
``embeddings`` matrix) and ``<collection>.jsonl`` (one chunk per line:
text, source, metadata) under ``persist_dir``.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import List, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError
from generativeaiexamples_tpu_torch.retrieval.store import Chunk, SearchHit, VectorStore

logger = logging.getLogger(__name__)


class TorchVectorStore(VectorStore):
    """Cosine-similarity store searched on the card (``device=None``) or,
    for tests, on the CPU."""

    def __init__(
        self,
        dimensions: int,
        persist_dir: str = "",
        collection: str = "default",
        ann_mode: str = "exact",
        ann_capacity: int = 0,
        ann_max_batch: int = 8,
        nlist: int = 64,
        nprobe: int = 16,
        device=None,
    ):
        from generativeaiexamples_tpu_torch.engine.llm_engine import resolve_device

        self.device = resolve_device(device, "TorchVectorStore")
        self._dim = dimensions
        self._persist_dir = persist_dir
        self._collection = collection
        self._lock = threading.RLock()
        self._chunks: List[Chunk] = []
        self._matrix = np.zeros((0, dimensions), np.float32)
        self._version = 0  # bumped on every mutation
        self._persisted_chunks = 0  # JSONL rows already on disk
        self._ann_opts = dict(
            mode=ann_mode, capacity=ann_capacity, max_batch=ann_max_batch,
            nlist=nlist, nprobe=nprobe, device=self.device,
        )
        self._ann = None  # lazy ANNSearchEngine; guarded by self._lock
        if persist_dir:
            self._load()

    # -- persistence ---------------------------------------------------- #
    def _paths(self):
        base = os.path.join(self._persist_dir, self._collection)
        return base + ".npz", base + ".jsonl"

    def _load(self) -> None:
        npz_path, jsonl_path = self._paths()
        if not (os.path.exists(npz_path) and os.path.exists(jsonl_path)):
            return
        try:
            self._matrix = np.load(npz_path)["embeddings"].astype(np.float32)
            with open(jsonl_path, "r", encoding="utf-8") as fh:
                self._chunks = [Chunk(**json.loads(line)) for line in fh if line.strip()]
        except (OSError, ValueError, KeyError, TypeError) as exc:
            raise VectorStoreError(f"Corrupt vector-store state in {self._persist_dir}: {exc}") from exc
        self._persisted_chunks = len(self._chunks)
        logger.info("Loaded %d chunks into collection %s", len(self._chunks), self._collection)

    def persist(self) -> None:
        if not self._persist_dir:
            return
        with self._lock:
            os.makedirs(self._persist_dir, exist_ok=True)
            npz_path, jsonl_path = self._paths()
            np.savez_compressed(npz_path, embeddings=self._matrix)
            # appends write only the new JSONL rows; deletions rewrite the file
            if self._persisted_chunks <= len(self._chunks):
                mode = "a" if self._persisted_chunks else "w"
                new_chunks = self._chunks[self._persisted_chunks:]
            else:
                mode, new_chunks = "w", self._chunks
            with open(jsonl_path, mode, encoding="utf-8") as fh:
                for chunk in new_chunks:
                    fh.write(json.dumps(
                        {"text": chunk.text, "source": chunk.source, "metadata": chunk.metadata}
                    ) + "\n")
            self._persisted_chunks = len(self._chunks)

    # -- core ops ------------------------------------------------------- #
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
        with self._lock:
            self._chunks.extend(chunks)
            self._matrix = np.concatenate([self._matrix, embeddings], axis=0)
            self._version += 1
            self.persist()
            ann, matrix, version = self._ann, self._matrix, self._version
        if ann is not None:
            ann.refresh(matrix, version)  # the upload happens at ingest, not at a query

    def _ann_engine(self):
        """The search engine, refreshed to the current corpus version
        (built at the first search)."""
        with self._lock:
            if self._ann is None:
                from generativeaiexamples_tpu_torch.retrieval.ann import ANNSearchEngine

                self._ann = ANNSearchEngine(self._dim, **self._ann_opts)
            ann, matrix, version = self._ann, self._matrix, self._version
        ann.refresh(matrix, version)
        return ann

    def search_batch(
        self,
        query_embeddings: np.ndarray,
        top_k: int,
        score_threshold: float = 0.0,
    ) -> List[List[SearchHit]]:
        """Top-k for many queries in one pass of device dispatches (the
        retrieval tier's path): each dispatch padded to ``max_batch``
        rows, so a query's hits do not depend on the others in its batch.
        They may differ from :meth:`search`'s in the scores' last bits."""
        return self._search_rows(query_embeddings, top_k, score_threshold, pad_rows=True)

    def _search_rows(self, query_embeddings: np.ndarray, top_k: int, score_threshold: float,
                     pad_rows: bool) -> List[List[SearchHit]]:
        with self._lock:
            chunks = list(self._chunks)
        queries = np.asarray(query_embeddings, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        n = queries.shape[0]
        if not chunks or top_k <= 0 or n == 0:
            return [[] for _ in range(n)]
        norms = np.linalg.norm(queries, axis=1, keepdims=True)
        queries = queries / np.maximum(norms, 1e-12)
        scores, idx = self._ann_engine().search(queries, top_k, pad_rows=pad_rows)
        results: List[List[SearchHit]] = []
        for row in range(n):
            hits: List[SearchHit] = []
            for score, i in zip(scores[row], idx[row]):
                # padded rows mask to -inf; a search racing a delete may
                # also see indices past its chunk snapshot
                if not np.isfinite(score) or int(i) >= len(chunks):
                    continue
                # clamped cosine: the reference's score_threshold assumes
                # a [0, 1] scale
                score01 = max(0.0, float(score))
                if score01 < score_threshold:
                    continue
                hits.append(SearchHit(chunk=chunks[int(i)], score=score01))
            results.append(hits)
        return results

    def search(
        self, query_embedding: np.ndarray, top_k: int, score_threshold: float = 0.0
    ) -> List[SearchHit]:
        q = np.asarray(query_embedding, np.float32).reshape(1, -1)
        return self._search_rows(q, top_k, score_threshold, pad_rows=False)[0]

    def sources(self) -> List[str]:
        with self._lock:
            seen, out = set(), []
            for chunk in self._chunks:
                if chunk.source not in seen:
                    seen.add(chunk.source)
                    out.append(chunk.source)
            return out

    def delete_sources(self, sources: Sequence[str]) -> bool:
        drop = set(sources)
        with self._lock:
            keep = [i for i, c in enumerate(self._chunks) if c.source not in drop]
            if len(keep) == len(self._chunks):
                return True
            self._chunks = [self._chunks[i] for i in keep]
            self._matrix = self._matrix[keep] if keep else np.zeros((0, self._dim), np.float32)
            self._version += 1
            self._persisted_chunks = len(self._chunks) + 1  # force a JSONL rewrite
            self.persist()
            return True

    def count(self) -> int:
        with self._lock:
            return len(self._chunks)
