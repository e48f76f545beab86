"""Conversation summary memory.

Counterpart of the JAX repository's experimental/oran_chatbot/memory.py:
it keeps the last K turns verbatim and folds older turns into a rolling
LLM-written summary, so long conversations fit the context cap.
"""
from __future__ import annotations

from typing import List, Tuple

SUMMARY_PROMPT = (
    "Condense the following conversation into a short summary that keeps "
    "all facts, names, and open questions. Output only the summary."
)


class SummaryMemory:
    def __init__(self, llm, keep_last: int = 4, summarize_after: int = 8):
        self.llm = llm
        self.keep_last = keep_last
        self.summarize_after = summarize_after
        self.turns: List[Tuple[str, str]] = []  # (role, content)
        self.summary: str = ""

    def add(self, role: str, content: str) -> None:
        self.turns.append((role, content))
        if len(self.turns) > self.summarize_after:
            self._compact()

    def _compact(self) -> None:
        old, self.turns = self.turns[: -self.keep_last], self.turns[-self.keep_last:]
        transcript = "\n".join(f"{r}: {c}" for r, c in old)
        if self.summary:
            transcript = f"Previous summary: {self.summary}\n{transcript}"
        self.summary = self.llm.complete(
            [("system", SUMMARY_PROMPT), ("user", transcript)],
            temperature=0.0,
            max_tokens=256,
        ).strip()

    def context(self) -> str:
        """What the chain should prepend to the prompt."""
        parts = []
        if self.summary:
            parts.append(f"Conversation summary: {self.summary}")
        parts.extend(f"{r}: {c}" for r, c in self.turns)
        return "\n".join(parts)

    def clear(self) -> None:
        self.turns, self.summary = [], ""
