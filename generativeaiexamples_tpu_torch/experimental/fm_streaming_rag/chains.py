"""Intent-routed streaming RAG chain.

Counterpart of the JAX repository's experimental/fm_streaming_rag/
chains.py: ``answer()`` is a token generator that (1) chats directly when
the knowledge base is off, (2) classifies the intent, (3) answers
RecentSummary and TimeWindow questions from the timestamp database, with
recursive LLM summarization when too many entries match, and (4) falls
back to semantic retrieval. Status lines (*...*) interleave with the
generated tokens, so a frontend can render progress.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Generator, List, Sequence

from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag import intent as intent_mod
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.accumulator import (
    TextAccumulator,
)
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.intent import (
    RAG_PROMPT,
    SUMMARIZATION_PROMPT,
    TimeResponse,
)

MAX_SUMMARIZATION_ATTEMPTS = 3


@dataclasses.dataclass
class StreamingConfig:
    question: str = ""
    use_knowledge_base: bool = True
    max_docs: int = 8
    allow_summary: bool = True
    temperature: float = 0.2
    max_tokens: int = 512
    window_seconds: float = 90.0


class StreamingRagChain:
    def __init__(self, llm, accumulator: TextAccumulator, config: StreamingConfig):
        self.llm = llm
        self.accumulator = accumulator
        self.timestamp_db = accumulator.timestamp_db
        self.config = config

    # -- generation helpers -------------------------------------------------

    def _generate(self, texts: Sequence[str]) -> Generator[str, None, None]:
        context = "\n".join(texts)
        messages = [
            ("system", RAG_PROMPT),
            ("user", f"Transcript: '{context}'\nUser: '{self.config.question}'\nAI:"),
        ]
        yield from self.llm.stream_chat(
            messages, temperature=self.config.temperature, max_tokens=self.config.max_tokens
        )

    def _summarize(self, texts: List[str]) -> List[str]:
        """Reduce context by summarizing groups of max_docs entries."""
        pieces = []
        for i in range(0, len(texts), self.config.max_docs):
            block = " ".join(texts[i: i + self.config.max_docs])
            pieces.append(
                self.llm.complete(
                    [("system", SUMMARIZATION_PROMPT), ("user", block)],
                    temperature=0.0,
                    max_tokens=self.config.max_tokens,
                )
            )
        summary = " ".join(pieces)
        return self.accumulator.splitter.split_text(summary)

    def _reduce(self, texts: List[str]) -> Generator[str, None, List[str]]:
        """Shrink an over-long doc list, narrating what happened."""
        if len(texts) <= self.config.max_docs:
            return texts
        if self.config.allow_summary:
            yield "*Using summarization to reduce context*\n"
            for attempt in range(MAX_SUMMARIZATION_ATTEMPTS):
                texts = self._summarize(texts)
                yield f"*Reduced to {len(texts)} entries on attempt {attempt + 1}*\n"
                if len(texts) <= self.config.max_docs:
                    break
        texts = texts[-self.config.max_docs:]
        return texts

    # -- answer modes -------------------------------------------------------

    def answer(self) -> Generator[str, None, None]:
        if not self.config.use_knowledge_base:
            yield from self.llm.stream_chat(
                [("user", self.config.question)],
                temperature=self.config.temperature,
                max_tokens=self.config.max_tokens,
            )
            return

        user_intent = intent_mod.classify_intent(self.llm, self.config.question)
        if user_intent.intentType in ("RecentSummary", "TimeWindow"):
            recency = intent_mod.classify_recency(self.llm, self.config.question)
            if recency is not None:
                try:
                    if user_intent.intentType == "RecentSummary":
                        yield from self.answer_by_recent(recency)
                    else:
                        yield from self.answer_by_past(recency)
                    return
                except Exception:  # noqa: BLE001 - degrade: fall back to RAG
                    pass
        yield from self.answer_by_relevance()

    def answer_by_relevance(self) -> Generator[str, None, None]:
        hits = self.accumulator.store.search(
            self.accumulator.embedder.embed_query(self.config.question),
            self.config.max_docs,
        )
        if not hits:
            yield "*Found no documents related to the query*"
            return
        yield f"*Returned {len(hits)} related entries*\n\n"
        yield from self._generate([h.chunk.text for h in hits])

    def answer_by_recent(self, recency: TimeResponse) -> Generator[str, None, None]:
        seconds = recency.to_seconds()
        docs = self.timestamp_db.recent(time.time() - seconds)
        yield f"*Found {len(docs)} entries from the last {seconds:.0f}s*\n"
        texts = [d.content for d in docs]
        texts = yield from self._reduce(texts)
        if texts:
            yield "\n"
            yield from self._generate(texts)

    def answer_by_past(self, recency: TimeResponse) -> Generator[str, None, None]:
        seconds = recency.to_seconds()
        tstamp = time.time() - seconds
        window = self.config.window_seconds
        docs = self.timestamp_db.past(tstamp, window=window)
        yield f"*Found {len(docs)} entries from {seconds:.0f}s ago (+/- {window:.0f}s)*\n"
        if len(docs) > self.config.max_docs and not self.config.allow_summary:
            # keep the entries closest to the asked-about moment
            docs = sorted(docs, key=lambda d: abs(d.tstamp - tstamp))[: self.config.max_docs]
            texts = [d.content for d in docs]
        else:
            texts = [d.content for d in docs]
            texts = yield from self._reduce(texts)
        if texts:
            yield "\n"
            yield from self._generate(texts)
