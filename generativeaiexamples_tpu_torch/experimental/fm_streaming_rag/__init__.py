"""Streaming-text RAG over a live transcript feed (counterpart of the JAX
repository's experimental/fm_streaming_rag/): transcript text accumulates
per source, is chunked into a time-aware store, and questions are answered
with intent-routed retrieval (recent summary, time window or semantic),
served over HTTP with SSE on the port's embedder and LLM engine."""
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.accumulator import (
    TextAccumulator,
)
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.chains import StreamingRagChain
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.timestamps import TimestampDB

__all__ = ["TextAccumulator", "StreamingRagChain", "TimestampDB"]
