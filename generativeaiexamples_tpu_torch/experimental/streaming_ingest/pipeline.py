"""The ingest pipeline: sources -> chunks -> embed (N workers) -> store.

Counterpart of the JAX repository's experimental/streaming_ingest/pipeline.py,
an asyncio graph: each source is pumped through the port's splitter (in
an executor thread) into one bounded queue (``queue_depth``: a full queue
holds the sources back); ``embed_workers`` workers each gather up to
``embed_batch`` chunks, or fewer when the queue runs dry, embed them with
one ``embed_documents`` call in an executor thread (the in-process
encoder batches them on the card) and add them to the store under one
lock. The store is persisted at the end where it can be. Which worker
takes which chunks, and so the store's row order and
``batches_embedded``, depends on timing; ``docs_in``, ``chunks_out`` and
the stored (source, text) chunks do not.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import List, Optional, Sequence

from generativeaiexamples_tpu_torch.experimental.streaming_ingest.config import PipelineConfig
from generativeaiexamples_tpu_torch.experimental.streaming_ingest.sources import build_source
from generativeaiexamples_tpu_torch.retrieval.splitter import get_text_splitter
from generativeaiexamples_tpu_torch.retrieval.store import Chunk, VectorStore

_STOP = object()


@dataclasses.dataclass
class PipelineStats:
    docs_in: int = 0
    chunks_out: int = 0
    batches_embedded: int = 0
    seconds: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class IngestPipeline:
    def __init__(
        self,
        config: PipelineConfig,
        embedder,
        store: VectorStore,
        sources: Optional[Sequence[object]] = None,
    ):
        self.config = config
        self.embedder = embedder
        self.store = store
        self.sources = (
            list(sources) if sources is not None else [build_source(s) for s in config.sources]
        )
        self.splitter = get_text_splitter(config.chunk_size, config.chunk_overlap)
        self.stats = PipelineStats()

    async def _pump_source(self, source, chunk_q: asyncio.Queue) -> None:
        async for raw in source:
            self.stats.docs_in += 1
            pieces = await asyncio.get_running_loop().run_in_executor(
                None, self.splitter.split_text, raw.text
            )
            for piece in pieces:
                await chunk_q.put(Chunk(text=piece, source=raw.doc_id))

    async def _embed_worker(self, chunk_q: asyncio.Queue, write_lock: asyncio.Lock) -> None:
        """Drain chunks into groups of up to embed_batch; embed and write each."""
        batch: List[Chunk] = []
        loop = asyncio.get_running_loop()

        async def flush() -> None:
            if not batch:
                return
            chunks, texts = list(batch), [c.text for c in batch]
            batch.clear()
            embeddings = await loop.run_in_executor(
                None, self.embedder.embed_documents, texts
            )
            async with write_lock:  # one writer at a time
                await loop.run_in_executor(None, self.store.add, chunks, embeddings)
            self.stats.batches_embedded += 1
            self.stats.chunks_out += len(chunks)

        while True:
            item = await chunk_q.get()
            if item is _STOP:
                await flush()
                return
            batch.append(item)
            if len(batch) >= self.config.embed_batch:
                await flush()
            elif chunk_q.empty():
                # the stream went quiet: do not sit on a partial batch
                await flush()

    async def run(self) -> PipelineStats:
        t0 = time.time()
        chunk_q: asyncio.Queue = asyncio.Queue(maxsize=self.config.queue_depth)
        write_lock = asyncio.Lock()

        workers = [
            asyncio.create_task(self._embed_worker(chunk_q, write_lock))
            for _ in range(max(1, self.config.embed_workers))
        ]
        pumps = [asyncio.create_task(self._pump_source(s, chunk_q)) for s in self.sources]
        try:
            await asyncio.gather(*pumps)
        finally:
            for _ in workers:
                await chunk_q.put(_STOP)
            await asyncio.gather(*workers)
        if hasattr(self.store, "persist"):
            self.store.persist()
        self.stats.seconds = time.time() - t0
        return self.stats

    def run_sync(self) -> PipelineStats:
        return asyncio.run(self.run())
