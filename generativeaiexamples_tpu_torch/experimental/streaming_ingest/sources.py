"""Ingest sources: files (with a watch mode), RSS/Atom feeds, Kafka.

Counterpart of the JAX repository's experimental/streaming_ingest/sources.py:
each source is an async iterator of ``RawDoc(source, doc_id, text)``.
Files are read by the port's ``load_document`` in an executor thread; a
file it cannot read is skipped. Feeds are parsed with the standard
library from local paths. Kafka wraps an injected ``poll()`` callable
(no broker client is bundled).
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import AsyncIterator, Callable, Iterable, List, Optional

from generativeaiexamples_tpu_torch.retrieval.loaders import load_document


@dataclasses.dataclass
class RawDoc:
    source: str  # the source's name
    doc_id: str  # file path / feed entry link / kafka key
    text: str


class FilesystemSource:
    """Emit each file once; in watch mode keep polling for new files."""

    def __init__(
        self,
        filenames: Iterable[str],
        name: str = "filesystem",
        watch: bool = False,
        poll_interval: float = 1.0,
        max_polls: Optional[int] = None,
    ):
        self.filenames = list(filenames)
        self.name = name
        self.watch = watch
        self.poll_interval = poll_interval
        self.max_polls = max_polls  # bounds the watch (tests)

    def _expand(self) -> List[str]:
        import glob

        out: List[str] = []
        for pattern in self.filenames:
            hits = sorted(glob.glob(pattern, recursive=True))
            out.extend(hits if hits else ([pattern] if os.path.exists(pattern) else []))
        return out

    async def __aiter__(self) -> AsyncIterator[RawDoc]:
        seen = set()
        polls = 0
        while True:
            for path in self._expand():
                if path in seen or os.path.isdir(path):
                    continue
                seen.add(path)
                try:
                    text = await asyncio.get_running_loop().run_in_executor(
                        None, load_document, path
                    )
                except Exception:  # noqa: BLE001 - an unreadable file is skipped, as in JAX
                    continue
                yield RawDoc(source=self.name, doc_id=path, text=text)
            if not self.watch:
                return
            polls += 1
            if self.max_polls is not None and polls >= self.max_polls:
                return
            await asyncio.sleep(self.poll_interval)


class RSSSource:
    """RSS 2.0 or Atom XML from local files; one document an entry."""

    def __init__(self, feed_paths: Iterable[str], name: str = "rss"):
        self.feed_paths = list(feed_paths)
        self.name = name

    @staticmethod
    def parse_feed(xml_text: str) -> List[dict]:
        root = ET.fromstring(xml_text)
        entries = []
        # RSS 2.0: channel/item; Atom: {ns}entry
        for item in root.iter():
            tag = item.tag.rsplit("}", 1)[-1]
            if tag not in ("item", "entry"):
                continue
            fields = {}
            for child in item:
                ctag = child.tag.rsplit("}", 1)[-1]
                fields[ctag] = (child.text or "").strip()
            entries.append(
                {
                    "title": fields.get("title", ""),
                    "link": fields.get("link", fields.get("id", "")),
                    "content": fields.get("description",
                                          fields.get("summary", fields.get("content", ""))),
                }
            )
        return entries

    async def __aiter__(self) -> AsyncIterator[RawDoc]:
        for path in self.feed_paths:
            with open(path, "r", encoding="utf-8", errors="replace") as fh:
                xml_text = fh.read()
            for entry in self.parse_feed(xml_text):
                text = f"{entry['title']}\n{entry['content']}".strip()
                if text:
                    yield RawDoc(
                        source=self.name, doc_id=entry["link"] or entry["title"], text=text
                    )


class KafkaSource:
    """An injected ``poll() -> Optional[(key, value)]``; the stream ends
    after ``idle_limit`` empty polls in a row."""

    def __init__(
        self,
        poll: Optional[Callable[[], Optional[tuple]]] = None,
        name: str = "kafka",
        topic: str = "",
        idle_limit: int = 3,
        poll_interval: float = 0.1,
    ):
        if poll is None:
            raise RuntimeError(
                "KafkaSource needs an injected poll() callable; no Kafka client "
                "is available in this image (deploy with your broker's client)."
            )
        self.poll = poll
        self.name = name
        self.topic = topic
        self.idle_limit = idle_limit
        self.poll_interval = poll_interval

    async def __aiter__(self) -> AsyncIterator[RawDoc]:
        idle = 0
        n = 0
        while idle < self.idle_limit:
            msg = self.poll()
            if msg is None:
                idle += 1
                await asyncio.sleep(self.poll_interval)
                continue
            idle = 0
            key, value = msg
            n += 1
            yield RawDoc(source=self.name, doc_id=str(key or n), text=str(value))


def build_source(cfg) -> object:
    if cfg.type == "filesystem":
        return FilesystemSource(
            cfg.filenames, name=cfg.name, watch=cfg.watch, poll_interval=cfg.poll_interval
        )
    if cfg.type == "rss":
        return RSSSource(cfg.feed_paths, name=cfg.name)
    if cfg.type == "kafka":
        return KafkaSource(name=cfg.name, topic=cfg.topic)
    raise ValueError(f"Unknown source type {cfg.type!r}")
