"""Synthetic QnA generation for RAG evaluation.

Counterpart of the JAX repository's tools/evaluation/
synthetic_data_generator.py: chunk documents (3000/100), ask the LLM for N
question/answer pairs per chunk as JSON, parse the reply robustly, write
``qna.json``. The LLM is any ``LLMBackend`` (the runtime's, on the card,
by default).
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, List, Optional, Sequence

from generativeaiexamples_tpu_torch.retrieval.loaders import load_document
from generativeaiexamples_tpu_torch.retrieval.splitter import get_text_splitter

logger = logging.getLogger(__name__)

GENERATION_PROMPT = """\
Given the previous paragraph, create {n} very good question answer pairs.
Restrict the question to the context information provided.
Return ONLY a JSON list like:
[{{"question": "...", "answer": "..."}}, {{"question": "...", "answer": "..."}}]
"""


def parse_qna_json(text: str) -> List[Dict[str, str]]:
    """Question/answer pairs from a model's reply: the whole text as JSON,
    then its first ``[...]`` block, then ``Q:``/``A:`` pairs."""
    pairs: List[Dict[str, str]] = []
    candidates = [text]
    match = re.search(r"\[.*\]", text, re.DOTALL)
    if match:
        candidates.append(match.group(0))
    for candidate in candidates:
        try:
            data = json.loads(candidate)
            if isinstance(data, list):
                for item in data:
                    if isinstance(item, dict) and "question" in item and "answer" in item:
                        pairs.append(
                            {"question": str(item["question"]), "answer": str(item["answer"])}
                        )
                if pairs:
                    return pairs
        except json.JSONDecodeError:
            continue
    for q, a in re.findall(
        r"Q(?:uestion)?\s*\d*\s*:\s*(.+?)\s*A(?:nswer)?\s*\d*\s*:\s*(.+?)(?=Q(?:uestion)?\s*\d*\s*:|\Z)",
        text,
        re.DOTALL | re.IGNORECASE,
    ):
        pairs.append({"question": q.strip(), "answer": a.strip()})
    return pairs


def generate_synthetic_data(
    docs: Sequence[str],
    output_path: str,
    llm=None,
    chunk_size: int = 3000,
    chunk_overlap: int = 100,
    pairs_per_chunk: int = 2,
    max_chunks: Optional[int] = None,
) -> List[Dict[str, str]]:
    """docs: file paths. Writes and returns the qna list
    [{question, ground_truth_answer, ground_truth_context, document}]."""
    if llm is None:
        from generativeaiexamples_tpu_torch.chains.runtime import get_llm

        llm = get_llm()
    splitter = get_text_splitter(chunk_size, chunk_overlap)
    qna: List[Dict[str, str]] = []
    for path in docs:
        text = load_document(path)
        chunks = splitter.split_text(text)
        if max_chunks:
            chunks = chunks[:max_chunks]
        for chunk in chunks:
            prompt = chunk + "\n\n" + GENERATION_PROMPT.format(n=pairs_per_chunk)
            raw = llm.complete([("user", prompt)], temperature=0.2, max_tokens=512)
            for pair in parse_qna_json(raw)[:pairs_per_chunk]:
                qna.append(
                    {
                        "question": pair["question"],
                        "ground_truth_answer": pair["answer"],
                        "ground_truth_context": chunk,
                        "document": os.path.basename(path),
                    }
                )
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as fh:
        json.dump(qna, fh, indent=2)
    logger.info("Wrote %d synthetic QnA pairs to %s", len(qna), output_path)
    return qna
