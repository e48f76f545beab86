"""The lexical BM25 leg of the hybrid retrieval pipelines.

A copy of the JAX package's generativeaiexamples_tpu/retrieval/bm25.py,
pure Python, so scores are bitwise the JAX package's: one ``BM25Index`` per
collection beside the vector store, Okapi BM25 (k1 1.5, b 0.75), scores
min-max normalized per query, and ``rrf_fuse`` for reciprocal-rank fusion
with the dense hits. An index persists as ``bm25_<collection>.jsonl``
under ``persist_dir`` (one chunk a line: text, source, metadata), the JAX
format, so either package loads what the other wrote; term statistics
rebuild on load. ``search`` runs behind the ``bm25`` circuit breaker with
one attempt, as in JAX (a persistently failing index opens it and
retrieval degrades with a typed error). Ingest and search time and the
chunk count go to the store families under ``store="bm25"``, as in JAX.

Unlike the JAX package's, an index is safe to share between threads:
``add``, ``delete_sources``, ``search`` and ``persist`` run under one
lock, so a search never sees a half-added chunk and two writers never
share the sidecar's ``.tmp`` file.
"""
from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
import time
from collections import Counter
from typing import Dict, List, Sequence

from generativeaiexamples_tpu_torch.retrieval.store import (
    STORE_ADD_SECONDS, STORE_CHUNKS, STORE_SEARCH_SECONDS, Chunk, SearchHit,
)
from generativeaiexamples_tpu_torch.utils import resilience

logger = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"[a-z0-9_]+")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


class BM25Index:
    """Okapi BM25 over ingested chunks."""

    def __init__(self, persist_dir: str = "", collection: str = "default",
                 k1: float = 1.5, b: float = 0.75) -> None:
        self.k1 = k1
        self.b = b
        self._collection = collection
        self._persist_path = (
            os.path.join(persist_dir, f"bm25_{collection}.jsonl") if persist_dir else "")
        self._chunks: List[Chunk] = []
        self._tf: List[Counter] = []
        self._lens: List[int] = []
        self._df: Counter = Counter()
        self._lock = threading.RLock()
        if self._persist_path and os.path.exists(self._persist_path):
            self._load()

    def add(self, chunks: Sequence[Chunk]) -> None:
        t0 = time.time()
        with self._lock:
            for c in chunks:
                toks = tokenize(c.text)
                tf = Counter(toks)
                self._chunks.append(c)
                self._tf.append(tf)
                self._lens.append(len(toks))
                self._df.update(tf.keys())
            if self._persist_path:
                self.persist()
            count = len(self._chunks)
        STORE_ADD_SECONDS.labels(store="bm25").observe(time.time() - t0)
        STORE_CHUNKS.labels(store="bm25", collection=self._collection).set(count)

    def delete_sources(self, sources: Sequence[str]) -> bool:
        drop = set(sources)
        with self._lock:
            keep = [i for i, c in enumerate(self._chunks) if c.source not in drop]
            if len(keep) == len(self._chunks):
                return False
            self._chunks = [self._chunks[i] for i in keep]
            self._tf = [self._tf[i] for i in keep]
            self._lens = [self._lens[i] for i in keep]
            self._df = Counter()
            for tf in self._tf:
                self._df.update(tf.keys())
            if self._persist_path:
                self.persist()
            STORE_CHUNKS.labels(store="bm25", collection=self._collection).set(len(self._chunks))
            return True

    def count(self) -> int:
        return len(self._chunks)

    @resilience.resilient("bm25", attempts=1)
    def search(self, query: str, top_k: int) -> List[SearchHit]:
        """Top-k chunks by BM25, scores min-max normalized to [0, 1]."""
        t0 = time.time()
        with self._lock:
            hits = self._search(query, top_k)
        STORE_SEARCH_SECONDS.labels(store="bm25").observe(time.time() - t0)
        return hits

    def _search(self, query: str, top_k: int) -> List[SearchHit]:
        if not self._chunks:
            return []
        q_terms = tokenize(query)
        if not q_terms:
            return []
        N = len(self._chunks)
        avg_len = sum(self._lens) / N
        scores = [0.0] * N
        for term in set(q_terms):
            df = self._df.get(term)
            if not df:
                continue
            idf = math.log(1.0 + (N - df + 0.5) / (df + 0.5))
            for i, tf in enumerate(self._tf):
                f = tf.get(term)
                if not f:
                    continue
                denom = f + self.k1 * (1.0 - self.b + self.b * self._lens[i] / max(avg_len, 1e-9))
                scores[i] += idf * f * (self.k1 + 1.0) / denom
        order = sorted(range(N), key=lambda i: -scores[i])[:top_k]
        order = [i for i in order if scores[i] > 0.0]
        if not order:
            return []
        hi = scores[order[0]]
        lo = min(scores[i] for i in order)
        span = max(hi - lo, 1e-9)
        return [
            SearchHit(chunk=self._chunks[i],
                      score=(scores[i] - lo) / span if len(order) > 1 else 1.0)
            for i in order
        ]

    def persist(self) -> None:
        if not self._persist_path:
            return
        with self._lock:
            os.makedirs(os.path.dirname(self._persist_path), exist_ok=True)
            tmp = self._persist_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                for c in self._chunks:
                    fh.write(json.dumps({"text": c.text, "source": c.source,
                                         "metadata": c.metadata}) + "\n")
            os.replace(tmp, self._persist_path)

    def _load(self) -> None:
        chunks = []
        try:
            with open(self._persist_path, "r", encoding="utf-8") as fh:
                for line in fh:
                    if line.strip():
                        d = json.loads(line)
                        chunks.append(Chunk(text=d["text"], source=d["source"],
                                            metadata=d.get("metadata", {})))
        except Exception as exc:  # noqa: BLE001 - a corrupt sidecar starts empty
            logger.warning("BM25 sidecar %s unreadable (%s); rebuilding empty",
                           self._persist_path, exc)
            return
        path = self._persist_path
        self._persist_path = ""  # no re-persist during the bulk re-add
        self.add(chunks)
        self._persist_path = path


def rrf_fuse(result_lists: Sequence[List[SearchHit]], k: int = 60) -> List[SearchHit]:
    """Reciprocal-rank fusion of ranked lists, joined on (source, text);
    the fused score is normalized to [0, 1] by the best attainable sum."""
    best = len(result_lists) / (k + 1.0)
    fused: Dict[tuple, List] = {}
    for hits in result_lists:
        for rank, hit in enumerate(hits):
            entry = fused.setdefault((hit.chunk.source, hit.chunk.text), [hit, 0.0])
            entry[1] += 1.0 / (k + rank + 1.0)
    out = [SearchHit(chunk=entry[0].chunk, score=entry[1] / best) for entry in fused.values()]
    out.sort(key=lambda h: -h.score)
    return out
