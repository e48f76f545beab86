"""The port's streaming ingest (generativeaiexamples_tpu_torch/experimental/
streaming_ingest/) against the JAX repository's experimental/
streaming_ingest/ on the CPU:

- the ingest tests of tests/test_experimental_streaming.py on the port;
- ``PipelineConfig.from_dict`` and ``from_yaml`` equal to JAX's;
- ``RSSSource.parse_feed`` equal on RSS 2.0 and Atom feeds;
- the file source (globs, a directory and an unreadable file skipped, the
  watch mode bounded by ``max_polls``) and the Kafka source (its error
  text, its keys and idle limit) yield JAX's documents;
- the slice: both pipelines over ``HashEmbedder`` with each worker and
  batch setting: the same ``docs_in`` and ``chunks_out`` and the same
  multiset of (source, text, vector) rows in the store (row order and
  ``batches_embedded`` depend on which worker flushed first); ``run.main``
  of both prints the same stats but ``seconds`` and ``batches_embedded``;
- the CLI raises with no card and no ``--device``; the new modules import
  no JAX, no JAX package, no root ``experimental`` or ``tools``, no aiohttp
  or requests.
"""
import asyncio
import glob
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from experimental.streaming_ingest import config as jconfig
from experimental.streaming_ingest import pipeline as jpipeline
from experimental.streaming_ingest import run as jrun
from experimental.streaming_ingest import sources as jsources
from generativeaiexamples_tpu.chains import runtime as jruntime
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JHash
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.chains import runtime as truntime
from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder
from generativeaiexamples_tpu_torch.experimental.streaming_ingest import (
    IngestPipeline,
    PipelineConfig,
    SourceConfig,
)
from generativeaiexamples_tpu_torch.experimental.streaming_ingest import run as trun
from generativeaiexamples_tpu_torch.experimental.streaming_ingest import sources as tsources
from generativeaiexamples_tpu_torch.experimental.streaming_ingest.sources import (
    FilesystemSource,
    KafkaSource,
    RSSSource,
)
from generativeaiexamples_tpu_torch.retrieval.store import create_vector_store

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "generativeaiexamples_tpu", "experimental", "tools", "aiohttp", "requests")
NEW_MODULES = [
    "generativeaiexamples_tpu_torch.experimental.streaming_ingest",
    "generativeaiexamples_tpu_torch.experimental.streaming_ingest.config",
    "generativeaiexamples_tpu_torch.experimental.streaming_ingest.sources",
    "generativeaiexamples_tpu_torch.experimental.streaming_ingest.pipeline",
    "generativeaiexamples_tpu_torch.experimental.streaming_ingest.run",
]

RSS = """<?xml version="1.0"?>
<rss version="2.0"><channel><title>t</title>
<item><title>Story A</title><link>http://x/a</link>
  <description>alpha body text</description></item>
<item><title>Story B</title><link>http://x/b</link>
  <description>beta body text</description></item>
</channel></rss>"""

ATOM = """<?xml version="1.0" encoding="utf-8"?>
<feed xmlns="http://www.w3.org/2005/Atom"><title>f</title>
<entry><title>Entry one</title><id>urn:uuid:1</id><link href="http://y/1"/>
  <summary>first summary words</summary></entry>
<entry><title>Entry two</title><id>urn:uuid:2</id>
  <content type="text">second content words</content></entry>
<entry><id>urn:uuid:3</id><summary>  untitled  </summary></entry>
</feed>"""

FEEDS = {
    "rss": RSS,
    "atom": ATOM,
    "rss_sparse": """<rss><channel><item><title>Only title</title></item>
        <item><description>only body</description><guid>g1</guid></item>
        <item></item></channel></rss>""",
    "rss_cdata": """<rss version="2.0"><channel><item><title><![CDATA[Tagged <b>title</b>]]></title>
        <link>http://z/c</link><description><![CDATA[<p>html body</p>]]></description></item>
        </channel></rss>""",
    "nested": """<root><item><title>outer</title><entry><title>inner</title></entry></item></root>""",
}


def _docs(source):
    async def collect():
        return [(d.source, d.doc_id, d.text) async for d in source]

    return asyncio.run(collect())


def _rows(store):
    """The (source, text) rows of a faiss-named store of either package (the
    native index), sorted: a multiset."""
    return sorted((c.source, c.text) for c in store._chunks.values())


class _ListStore:
    """A store that keeps every (source, text, vector) row it is given."""

    def __init__(self):
        self.rows = []

    def add(self, chunks, embeddings):
        for chunk, vec in zip(chunks, np.asarray(embeddings, np.float32)):
            self.rows.append((chunk.source, chunk.text, vec.tobytes()))

    def count(self):
        return len(self.rows)


# --------------------------------------------------------------------------- #
# tests/test_experimental_streaming.py (streaming_ingest) on the port


def test_ingest_filesystem_pipeline(tmp_path):
    for i in range(3):
        (tmp_path / f"doc{i}.txt").write_text(f"document {i} body with plenty of words " * 20)
    config = PipelineConfig(
        sources=[SourceConfig(type="filesystem", filenames=[str(tmp_path / "*.txt")])],
        chunk_size=50, chunk_overlap=5, embed_batch=8, embed_workers=2,
    )
    store = create_vector_store("faiss", dimensions=64)
    stats = IngestPipeline(config, HashEmbedder(dimensions=64), store).run_sync()
    assert stats.docs_in == 3
    assert stats.chunks_out == store.count() > 0
    assert stats.batches_embedded >= 1


def test_ingest_rss_source(tmp_path):
    feed = tmp_path / "feed.xml"
    feed.write_text(RSS)
    assert [e["title"] for e in RSSSource.parse_feed(feed.read_text())] == ["Story A", "Story B"]
    config = PipelineConfig(sources=[SourceConfig(type="rss", feed_paths=[str(feed)])],
                            chunk_size=100)
    store = create_vector_store("faiss", dimensions=32)
    stats = IngestPipeline(config, HashEmbedder(dimensions=32), store).run_sync()
    assert stats.docs_in == 2
    assert store.count() >= 2


def test_ingest_kafka_injected_consumer():
    messages = [("k1", "kafka message about tpu chips " * 5), ("k2", "another message " * 5)]

    def poll():
        return messages.pop(0) if messages else None

    source = KafkaSource(poll=poll, idle_limit=2, poll_interval=0.01)
    config = PipelineConfig(chunk_size=40, chunk_overlap=4, embed_batch=4)
    store = create_vector_store("faiss", dimensions=32)
    stats = IngestPipeline(config, HashEmbedder(dimensions=32), store, sources=[source]).run_sync()
    assert stats.docs_in == 2
    assert store.count() > 0


def test_kafka_source_requires_client():
    with pytest.raises(RuntimeError, match="poll"):
        KafkaSource()


def test_ingest_watch_mode_picks_up_new_files(tmp_path):
    (tmp_path / "first.txt").write_text("first file content " * 10)
    source = FilesystemSource([str(tmp_path / "*.txt")], watch=True, poll_interval=0.05,
                              max_polls=6)

    async def drop_file_later():
        await asyncio.sleep(0.1)
        (tmp_path / "second.txt").write_text("second file content " * 10)

    config = PipelineConfig(chunk_size=60, chunk_overlap=4, embed_batch=4)
    pipeline = IngestPipeline(config, HashEmbedder(dimensions=32),
                              create_vector_store("faiss", dimensions=32), sources=[source])

    async def scenario():
        task = asyncio.create_task(drop_file_later())
        stats = await pipeline.run()
        await task
        return stats

    assert asyncio.run(scenario()).docs_in == 2


def test_pipeline_config_from_dict():
    config = PipelineConfig.from_dict({
        "sources": [{"type": "filesystem", "filenames": ["x.txt"]}],
        "chunk_size": 99, "embed_workers": 4,
    })
    assert config.chunk_size == 99
    assert config.embed_workers == 4
    assert config.sources[0].type == "filesystem"
    with pytest.raises(ValueError, match="Unknown source type"):
        PipelineConfig.from_dict({"sources": [{"type": "carrier-pigeon"}]})


# --------------------------------------------------------------------------- #
# the config against JAX's

CONFIG_DICTS = [
    {},
    {"sources": [{"type": "filesystem", "filenames": ["a/*.md"], "watch": True,
                  "poll_interval": 0.5}], "chunk_size": 99, "embed_workers": 4},
    {"sources": [{"type": "rss", "feed_paths": ["f.xml"], "name": "news"},
                 {"type": "kafka", "topic": "docs"}], "collection": "c", "queue_depth": 8,
     "embed_batch": 3, "chunk_overlap": 7, "unknown_key": 1},
]


@pytest.mark.parametrize("raw", CONFIG_DICTS, ids=["empty", "filesystem", "rss_kafka"])
def test_config_from_dict_equals_jax(raw):
    port, ref = PipelineConfig.from_dict(raw), jconfig.PipelineConfig.from_dict(raw)
    assert port.__dict__.keys() == ref.__dict__.keys()
    assert {k: v for k, v in port.__dict__.items() if k != "sources"} == \
        {k: v for k, v in ref.__dict__.items() if k != "sources"}
    assert [s.__dict__ for s in port.sources] == [s.__dict__ for s in ref.sources]


def test_config_defaults_are_jax_s():
    port, ref = PipelineConfig(), jconfig.PipelineConfig()
    assert (port.chunk_size, port.chunk_overlap, port.embed_batch, port.embed_workers,
            port.queue_depth, port.collection) == (512, 64, 64, 2, 128, "streaming_ingest")
    assert port.__dict__ == ref.__dict__


@pytest.mark.parametrize("bad", ["carrier-pigeon", "", "FILESYSTEM"])
def test_source_type_check_equals_jax(bad):
    with pytest.raises(ValueError) as port:
        SourceConfig(type=bad)
    with pytest.raises(ValueError) as ref:
        jconfig.SourceConfig(type=bad)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("raw", CONFIG_DICTS[1:] + [None], ids=["filesystem", "rss_kafka", "null"])
def test_config_from_yaml_equals_jax(tmp_path, raw):
    import yaml

    path = tmp_path / "ingest.yaml"
    path.write_text(yaml.safe_dump(raw) if raw is not None else "")
    port, ref = PipelineConfig.from_yaml(str(path)), jconfig.PipelineConfig.from_yaml(str(path))
    assert {k: v for k, v in port.__dict__.items() if k != "sources"} == \
        {k: v for k, v in ref.__dict__.items() if k != "sources"}
    assert [s.__dict__ for s in port.sources] == [s.__dict__ for s in ref.sources]


# --------------------------------------------------------------------------- #
# the sources against JAX's


@pytest.mark.parametrize("name", sorted(FEEDS))
def test_parse_feed_equals_jax(name):
    assert RSSSource.parse_feed(FEEDS[name]) == jsources.RSSSource.parse_feed(FEEDS[name])


def test_rss_source_documents_equal_jax(tmp_path):
    paths = []
    for name, xml in FEEDS.items():
        paths.append(str(tmp_path / f"{name}.xml"))
        pathlib.Path(paths[-1]).write_text(xml)
    port = _docs(RSSSource(paths, name="news"))
    assert port == _docs(jsources.RSSSource(paths, name="news"))
    # an Atom <link href=...> has no text, so the title is the id
    assert ("news", "Entry one", "Entry one\nfirst summary words") in port
    assert ("news", "urn:uuid:3", "untitled") in port  # no link element: the id
    assert any(d[1] == "urn:uuid:2" for d in port)


def _tree(tmp_path):
    (tmp_path / "docs" / "sub").mkdir(parents=True)
    (tmp_path / "docs" / "a.txt").write_text("alpha words " * 30)
    (tmp_path / "docs" / "b.md").write_text("# Title\n\nbeta *words* `code` " * 10)
    (tmp_path / "docs" / "sub" / "c.txt").write_text("gamma words " * 12)
    (tmp_path / "docs" / "empty.txt").write_text("")
    (tmp_path / "docs" / "sub.txt").mkdir()  # a directory the glob matches
    os.symlink(tmp_path / "gone.txt", tmp_path / "docs" / "broken.txt")  # unreadable: skipped
    return [str(tmp_path / "docs" / "**" / "*.txt"), str(tmp_path / "docs" / "*.md"),
            str(tmp_path / "docs" / "a.txt"), str(tmp_path / "no_such_*.txt"),
            str(tmp_path / "docs" / "sub")]


def test_filesystem_source_documents_equal_jax(tmp_path):
    patterns = _tree(tmp_path)
    port = _docs(FilesystemSource(patterns, name="fs"))
    assert port == _docs(jsources.FilesystemSource(patterns, name="fs"))
    names = [os.path.basename(d[1]) for d in port]
    assert "broken.txt" not in names and "sub.txt" not in names
    assert sorted(names) == ["a.txt", "b.md", "c.txt", "empty.txt"]


def test_watch_mode_max_polls_equals_jax(tmp_path):
    (tmp_path / "first.txt").write_text("first file content " * 10)

    def scenario(cls):
        source = cls([str(tmp_path / "*.txt")], watch=True, poll_interval=0.02, max_polls=3)

        async def run():
            out = []
            async for d in source:
                out.append(os.path.basename(d.doc_id))
                if len(out) == 1:
                    (tmp_path / f"second_{cls.__module__.split('.')[0]}.txt").write_text("x " * 5)
            return out

        return asyncio.run(run())

    port = scenario(FilesystemSource)
    ref = scenario(jsources.FilesystemSource)
    assert port == ["first.txt", "second_generativeaiexamples_tpu_torch.txt"]
    assert ref[0] == "first.txt" and len(ref) == 3  # it also finds the port's second file


def test_kafka_error_text_equals_jax():
    with pytest.raises(RuntimeError) as port:
        KafkaSource()
    with pytest.raises(RuntimeError) as ref:
        jsources.KafkaSource()
    assert str(port.value) == str(ref.value)


def test_kafka_documents_equal_jax():
    def feed():
        msgs = [("k1", "one"), None, ("", "no key"), (0, 12345), None, None, ("k9", "late")]
        return lambda: msgs.pop(0) if msgs else None

    port = _docs(KafkaSource(poll=feed(), name="bus", idle_limit=2, poll_interval=0.0))
    ref = _docs(jsources.KafkaSource(poll=feed(), name="bus", idle_limit=2, poll_interval=0.0))
    assert port == ref == [("bus", "k1", "one"), ("bus", "2", "no key"), ("bus", "3", "12345")]


@pytest.mark.parametrize("kind", ["filesystem", "rss", "kafka"])
def test_build_source_equals_jax(kind):
    cfg = dict(type=kind, name="n", filenames=["x"], watch=True, poll_interval=0.3,
               feed_paths=["f.xml"], topic="t")
    if kind == "kafka":
        with pytest.raises(RuntimeError) as port:
            tsources.build_source(SourceConfig(**cfg))
        with pytest.raises(RuntimeError) as ref:
            jsources.build_source(jconfig.SourceConfig(**cfg))
        assert str(port.value) == str(ref.value)
        return
    port = tsources.build_source(SourceConfig(**cfg))
    ref = jsources.build_source(jconfig.SourceConfig(**cfg))
    assert type(port).__name__ == type(ref).__name__
    assert port.__dict__ == ref.__dict__


# --------------------------------------------------------------------------- #
# the slice: both pipelines over HashEmbedder


def _corpus(tmp_path):
    rng = np.random.RandomState(25)
    words = ["w%03d" % i for i in range(400)]
    (tmp_path / "files").mkdir()
    for i in range(9):
        body = " ".join(rng.choice(words, int(rng.randint(20, 260))))
        suffix = ".md" if i % 3 == 0 else ".txt"
        (tmp_path / "files" / f"f{i}{suffix}").write_text(f"planted{i} " + body)
    items = "".join(f"<item><title>t{i}</title><link>http://n/{i}</link><description>"
                    f"{' '.join(rng.choice(words, int(rng.randint(5, 90))))}</description></item>"
                    for i in range(7))
    (tmp_path / "feed.xml").write_text(f"<rss><channel>{items}</channel></rss>")
    msgs = [(f"m{i}", " ".join(rng.choice(words, int(rng.randint(3, 70))))) for i in range(11)]
    return [str(tmp_path / "files" / "*")], [str(tmp_path / "feed.xml")], msgs


@pytest.mark.parametrize("workers,batch", [(1, 64), (2, 8), (3, 5), (2, 1)])
def test_pipelines_store_jax_s_chunks_and_vectors(tmp_path, workers, batch):
    files, feeds, msgs = _corpus(tmp_path)

    def run(pkg):
        src_cfg, pipe_cls, emb = (
            (SourceConfig, IngestPipeline, HashEmbedder(dimensions=48)) if pkg == "port" else
            (jconfig.SourceConfig, jpipeline.IngestPipeline, JHash(dimensions=48)))
        kafka_cls = KafkaSource if pkg == "port" else jsources.KafkaSource
        queue = list(msgs)
        config = (PipelineConfig if pkg == "port" else jconfig.PipelineConfig)(
            sources=[src_cfg(type="filesystem", filenames=files),
                     src_cfg(type="rss", feed_paths=feeds)],
            chunk_size=40, chunk_overlap=6, embed_batch=batch, embed_workers=workers,
            queue_depth=4)
        pipeline = pipe_cls(config, emb, _ListStore())
        pipeline.sources.append(kafka_cls(poll=lambda: queue.pop(0) if queue else None,
                                          idle_limit=2, poll_interval=0.0))
        stats = pipeline.run_sync()
        return stats, pipeline.store

    port_stats, port_store = run("port")
    ref_stats, ref_store = run("jax")
    assert port_stats.docs_in == ref_stats.docs_in == 9 + 7 + 11
    assert port_stats.chunks_out == ref_stats.chunks_out == port_store.count() == ref_store.count()
    assert sorted(port_store.rows) == sorted(ref_store.rows)
    assert port_stats.batches_embedded >= -(-port_stats.chunks_out // batch)


def test_pipeline_chunks_are_the_splitter_s(tmp_path):
    """Every stored chunk is a window the splitter makes of its document,
    each as often as the splitter makes it."""
    from generativeaiexamples_tpu_torch.retrieval.loaders import load_document
    from generativeaiexamples_tpu_torch.retrieval.splitter import get_text_splitter

    files, _, _ = _corpus(tmp_path)
    config = PipelineConfig(sources=[SourceConfig(type="filesystem", filenames=files)],
                            chunk_size=30, chunk_overlap=10, embed_batch=3, embed_workers=2)
    store = _ListStore()
    IngestPipeline(config, HashEmbedder(dimensions=32), store).run_sync()
    split = get_text_splitter(30, 10)
    want = sorted((p, c) for p in glob.glob(files[0]) for c in split.split_text(load_document(p)))
    assert sorted(row[:2] for row in store.rows) == want


class _Persisting:
    """A store stand-in recording adds and the one persist at the end."""

    def __init__(self):
        self.added, self.persisted = [], 0

    def add(self, chunks, embeddings):
        self.added.append(len(chunks))

    def persist(self):
        self.persisted += 1


def test_persist_is_called_once_where_the_store_has_it(tmp_path):
    (tmp_path / "a.txt").write_text("words " * 100)
    port, ref = _Persisting(), _Persisting()
    cfg = dict(chunk_size=10, chunk_overlap=2, embed_batch=4)
    IngestPipeline(PipelineConfig(**cfg), HashEmbedder(16), port,
                   sources=[FilesystemSource([str(tmp_path / "a.txt")])]).run_sync()
    jpipeline.IngestPipeline(jconfig.PipelineConfig(**cfg), JHash(16), ref,
                             sources=[jsources.FilesystemSource([str(tmp_path / "a.txt")])]
                             ).run_sync()
    assert port.persisted == ref.persisted == 1
    assert sum(port.added) == sum(ref.added) == 13
    assert max(port.added) <= 4


@pytest.fixture
def ingest_env(monkeypatch, tmp_path):
    """A clean APP_* environment (hash embeddings, the faiss store), each
    package's store under its own directory; the port on the CPU."""
    for key in list(os.environ):
        if key.startswith("APP_") or key in ("EXAMPLE_NAME", "COLLECTION_NAME"):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", "64")
    monkeypatch.setenv("APP_VECTORSTORE_NAME", "faiss")
    jruntime.reset_runtime()
    truntime.reset_runtime()
    truntime.set_device("cpu")
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "jax"))
    jget_config()
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "port"))
    tconfig.get_config()
    yield
    jruntime.reset_runtime()
    truntime.reset_runtime()
    truntime.set_device(None)
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()


@pytest.mark.parametrize("how", ["flags", "yaml"])
def test_run_main_prints_jax_s_stats(ingest_env, tmp_path, capsys, how):
    files, feeds, _ = _corpus(tmp_path)
    if how == "flags":
        args = ["--files", *files, "--rss", *feeds, "--collection", "news", "--embed-workers", "3"]
    else:
        import yaml

        cfg = tmp_path / "ingest.yaml"
        cfg.write_text(yaml.safe_dump({"sources": [{"type": "filesystem", "filenames": files},
                                                   {"type": "rss", "feed_paths": feeds}],
                                       "chunk_size": 25, "chunk_overlap": 5, "embed_batch": 7,
                                       "collection": "yamlcoll"}))
        args = ["--config", str(cfg)]
    assert trun.main(args + ["--device", "cpu"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jrun.main(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(port) == set(ref) == {"docs_in", "chunks_out", "batches_embedded", "seconds"}
    for key in ("seconds", "batches_embedded"):
        port.pop(key), ref.pop(key)
    assert port == ref
    coll = "news" if how == "flags" else "yamlcoll"
    assert truntime.get_vector_store(coll).count() == port["chunks_out"] > 0
    assert _rows(truntime.get_vector_store(coll)) == _rows(jruntime.get_vector_store(coll))


def test_run_main_needs_a_source(ingest_env, capsys):
    with pytest.raises(SystemExit) as port:
        trun.main(["--device", "cpu"])
    port_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as ref:
        jrun.main([])
    assert port.value.code == ref.value.code == 2
    assert port_err.splitlines()[-1] == capsys.readouterr().err.splitlines()[-1]


def test_cli_raises_with_no_card_and_no_device(ingest_env, tmp_path, monkeypatch):
    files, _, _ = _corpus(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    truntime.set_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--files", *files])


def test_new_modules_import_no_jax_and_no_root_packages():
    code = ("import importlib, json, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(NEW_MODULES) <= set(loaded)
    assert "yaml" not in loaded  # from_yaml imports it when called
    assert [m for m in loaded if m.split(".")[0] in FORBIDDEN] == []
