"""Streaming document ingestion into a vector store (counterpart of the JAX
repository's experimental/streaming_ingest/): file, RSS/Atom and Kafka
sources feed a bounded queue of chunks that several workers embed in
batches with the port's embedder and write to a port store."""
from generativeaiexamples_tpu_torch.experimental.streaming_ingest.config import (
    PipelineConfig,
    SourceConfig,
)
from generativeaiexamples_tpu_torch.experimental.streaming_ingest.pipeline import (
    IngestPipeline,
    PipelineStats,
)

__all__ = ["IngestPipeline", "PipelineStats", "PipelineConfig", "SourceConfig"]
