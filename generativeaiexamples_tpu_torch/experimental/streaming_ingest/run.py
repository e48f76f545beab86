"""The ingest pipeline's command line.

Counterpart of the JAX repository's experimental/streaming_ingest/run.py:

    python -m generativeaiexamples_tpu_torch.experimental.streaming_ingest.run --config ingest.yaml
    python -m generativeaiexamples_tpu_torch.experimental.streaming_ingest.run --files 'docs/**/*.md'

It ingests into the runtime's store for the collection with the
runtime's embedder, both on the card; with no card it raises unless
``--device cpu`` asks for the CPU. It prints the run's stats as one JSON
line.
"""
from __future__ import annotations

import argparse
import json

from generativeaiexamples_tpu_torch.experimental.streaming_ingest.config import (
    PipelineConfig,
    SourceConfig,
)
from generativeaiexamples_tpu_torch.experimental.streaming_ingest.pipeline import IngestPipeline


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Streaming ingest → vector store")
    parser.add_argument("--config", help="pipeline YAML")
    parser.add_argument("--files", nargs="*", help="file globs (filesystem source)")
    parser.add_argument("--rss", nargs="*", help="RSS/Atom XML paths")
    parser.add_argument("--collection", default=None)
    parser.add_argument("--embed-workers", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="device of the embedder and the store (default: the card)")
    args = parser.parse_args(argv)

    if args.config:
        config = PipelineConfig.from_yaml(args.config)
    else:
        sources = []
        if args.files:
            sources.append(SourceConfig(type="filesystem", filenames=args.files))
        if args.rss:
            sources.append(SourceConfig(type="rss", feed_paths=args.rss))
        if not sources:
            parser.error("need --config, --files, or --rss")
        config = PipelineConfig(sources=sources)
    if args.collection:
        config.collection = args.collection
    if args.embed_workers:
        config.embed_workers = args.embed_workers

    from generativeaiexamples_tpu_torch.chains import runtime

    if args.device is not None:
        runtime.set_device(args.device)
    runtime.check_device("the ingest pipeline")
    pipeline = IngestPipeline(
        config, runtime.get_embedder(), runtime.get_vector_store(config.collection)
    )
    stats = pipeline.run_sync()
    print(json.dumps(stats.as_dict()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
