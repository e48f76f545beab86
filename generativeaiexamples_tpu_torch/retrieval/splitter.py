"""Text splitters.

A copy of the JAX package's generativeaiexamples_tpu/retrieval/splitter.py:

- ``TokenTextSplitter``: windows of ``chunk_size`` tokens overlapping by
  ``chunk_overlap``, over a tokenizer's ids (encode/decode) or, with no
  tokenizer, over whitespace words (the chain runtime's path);
- ``RecursiveCharacterTextSplitter``: a character budget that prefers
  paragraph, then line, sentence and word boundaries.
"""
from __future__ import annotations

from typing import List


class TokenTextSplitter:
    """Split on token windows with overlap, using any tokenizer with
    encode/decode, or whitespace words when ``tokenizer`` is None."""

    def __init__(self, chunk_size: int = 510, chunk_overlap: int = 200, tokenizer=None):
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be < chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self._tok = tokenizer

    def split_text(self, text: str) -> List[str]:
        if not text.strip():
            return []
        if self._tok is None:
            return self._windows(text.split(), " ".join)
        ids = self._tok.encode(text)
        return self._windows(ids, self._tok.decode)

    def _windows(self, units: list, join) -> List[str]:
        chunks, start, step = [], 0, self.chunk_size - self.chunk_overlap
        while start < len(units):
            piece = join(units[start : start + self.chunk_size]).strip()
            if piece:
                chunks.append(piece)
            if start + self.chunk_size >= len(units):
                break
            start += step
        return chunks


class RecursiveCharacterTextSplitter:
    """Character-budget splitter that prefers paragraph, then sentence,
    then word boundaries."""

    SEPARATORS = ["\n\n", "\n", ". ", " ", ""]

    def __init__(self, chunk_size: int = 1000, chunk_overlap: int = 100):
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap

    def split_text(self, text: str) -> List[str]:
        # merge small pieces up to chunk_size, carrying overlap
        chunks: List[str] = []
        current = ""
        for piece in self._split(text, 0):
            if len(current) + len(piece) <= self.chunk_size:
                current += piece
            else:
                if current.strip():
                    chunks.append(current.strip())
                tail = current[-self.chunk_overlap :] if self.chunk_overlap else ""
                current = tail + piece
        if current.strip():
            chunks.append(current.strip())
        return chunks

    def _split(self, text: str, depth: int) -> List[str]:
        if len(text) <= self.chunk_size:
            return [text]
        sep = self.SEPARATORS[depth] if depth < len(self.SEPARATORS) else ""
        if sep == "":
            return [text[i : i + self.chunk_size] for i in range(0, len(text), self.chunk_size)]
        out: List[str] = []
        for part in text.split(sep):
            part = part + sep if part else part
            if len(part) > self.chunk_size:
                out.extend(self._split(part, depth + 1))
            elif part:
                out.append(part)
        return out


def get_text_splitter(chunk_size: int = 510, chunk_overlap: int = 200,
                      tokenizer=None) -> TokenTextSplitter:
    return TokenTextSplitter(chunk_size, chunk_overlap, tokenizer)
