"""Milvus vector-store connector (optional dependency).

Counterpart of generativeaiexamples_tpu/retrieval/milvus_store.py, with
its schema (``pk``, ``text``, ``source``, ``vector``), IVF_FLAT index over
inner product (cosine on normalized vectors), search and delete
expressions, escaping, score mapping and messages. pymilvus is imported
only when the store is built, so the package is needed only where
``vector_store.name`` is ``milvus``. Calls go through the port's
utils/resilience.py behind the shared ``milvus`` breaker.
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError
from generativeaiexamples_tpu_torch.retrieval.store import (
    STORE_ADD_SECONDS, STORE_CHUNKS, STORE_SEARCH_SECONDS, Chunk, SearchHit, VectorStore,
)
from generativeaiexamples_tpu_torch.utils import resilience


class MilvusVectorStore(VectorStore):
    def __init__(self, dimensions: int, url: str, collection: str = "default",
                 nlist: int = 64, nprobe: int = 16):
        try:
            from pymilvus import (  # noqa: F401
                Collection,
                CollectionSchema,
                DataType,
                FieldSchema,
                connections,
                utility,
            )
        except ImportError as exc:
            raise VectorStoreError(
                "pymilvus is not installed; use vector_store.name=tpu or install pymilvus"
            ) from exc
        self._dim = dimensions
        self._nprobe = nprobe
        host, _, port = url.replace("http://", "").partition(":")
        connections.connect(host=host or "localhost", port=port or "19530")
        fields = [
            FieldSchema("pk", DataType.INT64, is_primary=True, auto_id=True),
            FieldSchema("text", DataType.VARCHAR, max_length=65535),
            FieldSchema("source", DataType.VARCHAR, max_length=4096),
            FieldSchema("vector", DataType.FLOAT_VECTOR, dim=dimensions),
        ]
        schema = CollectionSchema(fields)
        self._coll = Collection(collection, schema)
        if not self._coll.has_index():
            self._coll.create_index(
                "vector",
                {"index_type": "IVF_FLAT", "metric_type": "IP", "params": {"nlist": nlist}},
            )
        self._coll.load()

    def add(self, chunks: Sequence[Chunk], embeddings: np.ndarray) -> None:
        embeddings = np.asarray(embeddings, np.float32)
        norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
        embeddings = embeddings / np.maximum(norms, 1e-12)
        t0 = time.time()

        def _insert():
            self._coll.insert(
                [
                    [c.text for c in chunks],
                    [c.source for c in chunks],
                    embeddings.tolist(),
                ]
            )
            self._coll.flush()

        # Breaker only (attempts=1): a blind retry of insert+flush could
        # double-index chunks; a dead Milvus still opens the breaker so
        # later calls fail fast.
        resilience.call_with_resilience("milvus", _insert, attempts=1)
        STORE_ADD_SECONDS.labels(store="milvus").observe(time.time() - t0)
        # inc by the inserted count instead of a num_entities stats RPC
        # per add (flush-dependent and a server round-trip); deletes
        # resync the gauge to the server's count.
        STORE_CHUNKS.labels(store="milvus", collection=self._coll.name).inc(
            len(chunks)
        )

    def search(self, query_embedding: np.ndarray, top_k: int, score_threshold: float = 0.0) -> List[SearchHit]:
        q = np.asarray(query_embedding, np.float32).reshape(1, -1)
        q = q / max(float(np.linalg.norm(q)), 1e-12)
        t0 = time.time()
        # Idempotent read: retried with jittered backoff behind the
        # shared "milvus" breaker — a slow/flapping Milvus degrades to a
        # typed DependencyUnavailable the chains turn into an LLM-only
        # answer instead of a 500.
        res = resilience.call_with_resilience(
            "milvus",
            lambda: self._coll.search(
                q.tolist(),
                "vector",
                {"metric_type": "IP", "params": {"nprobe": self._nprobe}},
                limit=top_k,
                output_fields=["text", "source"],
            ),
        )
        STORE_SEARCH_SECONDS.labels(store="milvus").observe(time.time() - t0)
        hits = []
        for hit in res[0]:
            score01 = max(0.0, float(hit.score))
            if score01 < score_threshold:
                continue
            hits.append(
                SearchHit(
                    chunk=Chunk(text=hit.entity.get("text"), source=hit.entity.get("source")),
                    score=score01,
                )
            )
        return hits

    def sources(self) -> List[str]:
        res = self._coll.query(expr="pk >= 0", output_fields=["source"])
        seen, out = set(), []
        for row in res:
            src = row["source"]
            if src not in seen:
                seen.add(src)
                out.append(src)
        return out

    def delete_sources(self, sources: Sequence[str]) -> bool:
        for src in sources:
            escaped = src.replace("\\", "\\\\").replace('"', '\\"')
            self._coll.delete(expr=f'source == "{escaped}"')
        self._coll.flush()
        STORE_CHUNKS.labels(store="milvus", collection=self._coll.name).set(
            self.count()
        )
        return True

    def count(self) -> int:
        return int(self._coll.num_entities)
