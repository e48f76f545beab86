"""The ingest pipeline's configuration, from a dict or a YAML file.

Counterpart of the JAX repository's experimental/streaming_ingest/config.py:
a list of sources (``filesystem``, ``rss`` or ``kafka``; any other type
raises) and the chunking, batching and queue settings, with JAX's
defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List


@dataclasses.dataclass
class SourceConfig:
    type: str  # "filesystem" | "rss" | "kafka"
    name: str = ""
    # filesystem
    filenames: List[str] = dataclasses.field(default_factory=list)
    watch: bool = False
    poll_interval: float = 1.0
    # rss
    feed_paths: List[str] = dataclasses.field(default_factory=list)
    # kafka (an injected consumer)
    topic: str = ""

    def __post_init__(self) -> None:
        if self.type not in ("filesystem", "rss", "kafka"):
            raise ValueError(f"Unknown source type: {self.type!r}")
        if not self.name:
            self.name = self.type


@dataclasses.dataclass
class PipelineConfig:
    sources: List[SourceConfig] = dataclasses.field(default_factory=list)
    chunk_size: int = 512
    chunk_overlap: int = 64
    embed_batch: int = 64
    embed_workers: int = 2
    queue_depth: int = 128
    collection: str = "streaming_ingest"

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "PipelineConfig":
        sources = [SourceConfig(**s) for s in raw.get("sources", [])]
        keys = {f.name for f in dataclasses.fields(cls)} - {"sources"}
        return cls(sources=sources, **{k: v for k, v in raw.items() if k in keys})

    @classmethod
    def from_yaml(cls, path: str) -> "PipelineConfig":
        import yaml

        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_dict(yaml.safe_load(fh) or {})
