"""Per-source transcript accumulation -> chunk -> embed -> store.

Counterpart of the JAX repository's experimental/fm_streaming_rag/
accumulator.py: streamed text fragments append to a per-source buffer;
whenever the buffer splits into more than one chunk, the full chunks are
embedded and written to the vector store and the timestamp database, and
the trailing partial chunk stays buffered. Updates take a lock, so several
streams can feed one server.
"""
from __future__ import annotations

import threading
from typing import Dict

from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.timestamps import TimestampDB
from generativeaiexamples_tpu_torch.retrieval.splitter import RecursiveCharacterTextSplitter
from generativeaiexamples_tpu_torch.retrieval.store import Chunk, VectorStore


class TextAccumulator:
    def __init__(
        self,
        embedder,
        store: VectorStore,
        timestamp_db: TimestampDB | None = None,
        chunk_size: int = 256,
        chunk_overlap: int = 32,
    ):
        self.splitter = RecursiveCharacterTextSplitter(
            chunk_size=chunk_size, chunk_overlap=chunk_overlap
        )
        self.embedder = embedder
        self.store = store
        self.timestamp_db = timestamp_db or TimestampDB()
        self._buffers: Dict[str, str] = {}
        self._lock = threading.Lock()

    def update(self, source_id: str, text: str) -> Dict[str, str]:
        """Fold new transcript text in; embed any newly complete chunks."""
        with self._lock:
            buffered = self._buffers.get(source_id, "")
            merged = f"{buffered} {text}".strip() if buffered else text
            docs = self.splitter.split_text(merged)
            if not docs:
                return {"status": "Added 0 entries"}
            self._buffers[source_id], new_docs = docs[-1], docs[:-1]
        if new_docs:
            self.timestamp_db.insert_docs(new_docs, source_id)
            embeddings = self.embedder.embed_documents(new_docs)
            self.store.add(
                [Chunk(text=d, source=source_id) for d in new_docs], embeddings
            )
        return {"status": f"Added {len(new_docs)} entries"}

    def flush(self, source_id: str) -> Dict[str, str]:
        """Embed whatever is buffered for a source (the stream ended)."""
        with self._lock:
            rest = self._buffers.pop(source_id, "").strip()
        if not rest:
            return {"status": "Added 0 entries"}
        self.timestamp_db.insert_docs([rest], source_id)
        self.store.add(
            [Chunk(text=rest, source=source_id)],
            self.embedder.embed_documents([rest]),
        )
        return {"status": "Added 1 entries"}
