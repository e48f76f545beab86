"""Retrieval-layer error types (a copy of the JAX package's
generativeaiexamples_tpu/retrieval/errors.py)."""


class VectorStoreError(Exception):
    """The vector store is unavailable or the query/ingest failed."""
