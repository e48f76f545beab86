"""pgvector vector-store connector (optional dependency).

Counterpart of generativeaiexamples_tpu/retrieval/pgvector_store.py, with
its connection settings, DDL (``chunks_<collection>`` with a
``vector(<dimensions>)`` column), SQL and messages: cosine distance over
normalized vectors. psycopg2 is imported only when the store is built, so
the package is needed only where ``vector_store.name`` is ``pgvector``.
"""
from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError
from generativeaiexamples_tpu_torch.retrieval.store import Chunk, SearchHit, VectorStore


class PgVectorStore(VectorStore):
    def __init__(self, dimensions: int, url: str, collection: str = "default"):
        try:
            import psycopg2  # noqa: F401
        except ImportError as exc:
            raise VectorStoreError(
                "psycopg2 is not installed; use vector_store.name=tpu or install psycopg2"
            ) from exc
        import psycopg2

        host, _, port = url.replace("http://", "").partition(":")
        self._dim = dimensions
        self._table = f"chunks_{collection}"
        self._conn = psycopg2.connect(
            host=host or "localhost",
            port=int(port or 5432),
            user="postgres",
            password="password",
            dbname="api",
        )
        with self._conn.cursor() as cur:
            cur.execute("CREATE EXTENSION IF NOT EXISTS vector")
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {self._table} ("
                "id SERIAL PRIMARY KEY, text TEXT, source TEXT, "
                f"embedding vector({dimensions}))"
            )
        self._conn.commit()

    def add(self, chunks: Sequence[Chunk], embeddings: np.ndarray) -> None:
        embeddings = np.asarray(embeddings, np.float32)
        norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
        embeddings = embeddings / np.maximum(norms, 1e-12)
        with self._conn.cursor() as cur:
            for chunk, emb in zip(chunks, embeddings):
                cur.execute(
                    f"INSERT INTO {self._table} (text, source, embedding) VALUES (%s, %s, %s)",
                    (chunk.text, chunk.source, json.dumps(emb.tolist())),
                )
        self._conn.commit()

    def search(self, query_embedding: np.ndarray, top_k: int, score_threshold: float = 0.0) -> List[SearchHit]:
        q = np.asarray(query_embedding, np.float32).reshape(-1)
        q = q / max(float(np.linalg.norm(q)), 1e-12)
        with self._conn.cursor() as cur:
            cur.execute(
                f"SELECT text, source, 1 - (embedding <=> %s::vector) FROM {self._table} "
                "ORDER BY embedding <=> %s::vector LIMIT %s",
                (json.dumps(q.tolist()), json.dumps(q.tolist()), top_k),
            )
            rows = cur.fetchall()
        hits = []
        for text, source, cos in rows:
            score01 = max(0.0, float(cos))
            if score01 >= score_threshold:
                hits.append(SearchHit(chunk=Chunk(text=text, source=source), score=score01))
        return hits

    def sources(self) -> List[str]:
        with self._conn.cursor() as cur:
            cur.execute(f"SELECT DISTINCT source FROM {self._table} ORDER BY source")
            return [r[0] for r in cur.fetchall()]

    def delete_sources(self, sources: Sequence[str]) -> bool:
        with self._conn.cursor() as cur:
            for src in sources:
                cur.execute(f"DELETE FROM {self._table} WHERE source = %s", (src,))
        self._conn.commit()
        return True

    def count(self) -> int:
        with self._conn.cursor() as cur:
            cur.execute(f"SELECT COUNT(*) FROM {self._table}")
            return int(cur.fetchone()[0])
