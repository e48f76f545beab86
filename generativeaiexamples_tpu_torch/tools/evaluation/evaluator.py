"""RAG answer evaluation: RAGAS-style metrics and a Likert LLM judge.

Counterpart of the JAX repository's tools/evaluation/evaluator.py:
``eval_ragas`` scores faithfulness, context precision, context recall,
context relevancy, answer relevancy and answer similarity and their
harmonic mean ``ragas_score``; ``eval_llm_judge`` runs a few-shot Likert
1-5 judge. The judge is any ``LLMBackend`` (the runtime's engine, a remote
endpoint or a test fake); answer similarity is the configured embedder's
cosine. The prompts are the JAX package's, byte for byte.
"""
from __future__ import annotations

import json
import logging
import os
import re
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

JUDGE_SCALE_PROMPT = """\
You are grading an answer to a question on a scale of 0.0 to 1.0.
Respond with ONLY a number between 0.0 and 1.0.

{criterion}

Question: {question}
{extra}
Answer being graded: {answer}

Score (0.0-1.0):"""

CRITERIA = {
    "faithfulness": (
        "Score 1.0 if every claim in the answer is directly supported by the "
        "provided context, 0.0 if the answer contradicts or invents facts.",
        "context",
    ),
    "answer_relevancy": (
        "Score 1.0 if the answer directly and completely addresses the "
        "question, 0.0 if it is off-topic or empty.",
        None,
    ),
    "context_relevancy": (
        "Score 1.0 if the provided context is relevant to answering the "
        "question, 0.0 if it is unrelated.",
        "context",
    ),
    "context_precision": (
        "Score 1.0 if the most relevant parts of the context appear first, "
        "0.0 if relevant content is buried after irrelevant content.",
        "context",
    ),
    "context_recall": (
        "Score 1.0 if the context contains all information needed to produce "
        "the ground-truth answer, 0.0 if the needed facts are missing.",
        "ground_truth",
    ),
}

LLM_JUDGE_PROMPT = """\
You are evaluating a generated answer against a reference answer for a
given question. Rate the generated answer on a Likert scale of 1 to 5:
1 = completely wrong or irrelevant
2 = mostly wrong, minor overlap with the reference
3 = partially correct but incomplete
4 = mostly correct, minor omissions
5 = fully correct and complete

Example:
Question: What color is the sky on a clear day?
Reference answer: Blue.
Generated answer: The sky is blue.
Rating: 5

Question: {question}
Reference answer: {reference}
Generated answer: {answer}
Respond with ONLY the rating number.
Rating:"""


def parse_score(text: str, low: float = 0.0, high: float = 1.0) -> Optional[float]:
    """The first number in ``text`` clamped to [low, high], or None."""
    match = re.search(r"-?\d+(?:\.\d+)?", text)
    if not match:
        return None
    value = float(match.group(0))
    return min(high, max(low, value))


def _judge(llm, prompt: str) -> Optional[float]:
    raw = llm.complete([("user", prompt)], temperature=0.0, max_tokens=16)
    return parse_score(raw)


def eval_ragas(
    rows: Sequence[Dict],
    llm=None,
    embedder=None,
) -> Dict[str, float]:
    """Score eval rows (question/answer/contexts/ground_truth_answer);
    returns metric -> mean score plus the harmonic-mean ragas_score."""
    if llm is None:
        from generativeaiexamples_tpu_torch.chains.runtime import get_llm

        llm = get_llm()
    if embedder is None:
        from generativeaiexamples_tpu_torch.chains.runtime import get_embedder

        embedder = get_embedder()

    per_metric: Dict[str, List[float]] = {name: [] for name in CRITERIA}
    per_metric["answer_similarity"] = []
    for row in rows:
        context = "\n\n".join(row.get("contexts", []))[:6000]
        for name, (criterion, extra_kind) in CRITERIA.items():
            if extra_kind == "context":
                extra = f"Context: {context}"
            elif extra_kind == "ground_truth":
                extra = (
                    f"Context: {context}\n"
                    f"Ground-truth answer: {row.get('ground_truth_answer', '')}"
                )
            else:
                extra = ""
            score = _judge(
                llm,
                JUDGE_SCALE_PROMPT.format(
                    criterion=criterion,
                    question=row["question"],
                    extra=extra,
                    answer=row["answer"],
                ),
            )
            if score is not None:
                per_metric[name].append(score)
        # embedding cosine between the generated and the ground-truth answer
        truth = row.get("ground_truth_answer", "")
        if truth and row.get("answer"):
            vecs = embedder.embed_documents([row["answer"], truth])
            a, b = np.asarray(vecs[0]), np.asarray(vecs[1])
            denom = float(np.linalg.norm(a) * np.linalg.norm(b))
            if denom > 0:
                per_metric["answer_similarity"].append(
                    max(0.0, float(a @ b) / denom)
                )

    results = {
        name: round(statistics.mean(scores), 4)
        for name, scores in per_metric.items()
        if scores
    }
    positives = [v for v in results.values() if v > 0]
    if positives:
        results["ragas_score"] = round(
            len(positives) / sum(1.0 / v for v in positives), 4
        )
    return results


def eval_llm_judge(rows: Sequence[Dict], llm=None) -> Dict[str, float]:
    """Likert 1-5 judgment of generated against ground-truth answers."""
    if llm is None:
        from generativeaiexamples_tpu_torch.chains.runtime import get_llm

        llm = get_llm()
    ratings: List[float] = []
    for row in rows:
        raw = llm.complete(
            [
                (
                    "user",
                    LLM_JUDGE_PROMPT.format(
                        question=row["question"],
                        reference=row.get("ground_truth_answer", ""),
                        answer=row["answer"],
                    ),
                )
            ],
            temperature=0.0,
            max_tokens=8,
        )
        rating = parse_score(raw, low=1.0, high=5.0)
        if rating is not None:
            ratings.append(rating)
    if not ratings:
        return {}
    return {
        "llm_judge_mean": round(statistics.mean(ratings), 4),
        "llm_judge_ratings": ratings,
    }


def write_results(results: Dict, output_path: str) -> None:
    """JSON always; a parquet twin beside it where pandas and a parquet
    engine are installed."""
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as fh:
        json.dump(results, fh, indent=2)
    logger.info("Wrote evaluation results to %s", output_path)
    try:
        import pandas as pd

        flat = {
            k: v for k, v in results.items() if isinstance(v, (int, float, str))
        }
        pq = os.path.splitext(output_path)[0] + ".parquet"
        pd.DataFrame([flat]).to_parquet(pq)
        logger.info("Wrote evaluation results to %s", pq)
    except Exception as exc:  # noqa: BLE001 - parquet is optional
        logger.debug("parquet output skipped: %s", exc)
