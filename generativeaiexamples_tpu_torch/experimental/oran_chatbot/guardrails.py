"""Answer fact-checking against retrieved evidence.

Counterpart of the JAX repository's experimental/oran_chatbot/
guardrails.py: after the RAG chain answers, a second LLM pass checks the
answer strictly against the retrieved context and streams a verdict that
leads with TRUE or FALSE, then follow-up suggestions; ``parse_verdict``
reads it into a structured result a caller can gate on.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Generator

FACT_CHECK_PROMPT = (
    "Fact-check a model response. You get context documents as [[CONTEXT]], "
    "the user's question as [[QUESTION]], and the model's response as "
    "[[RESPONSE]]. Verify every claim in the response strictly against the "
    "context — use no outside knowledge. Decide whether the response is "
    "entirely supported by the context and answers the question. Start your "
    "reply with 'TRUE' if it is, or 'FALSE' if it is not, then explain "
    "which claims are or are not supported, and suggest follow-up questions "
    "the context could answer."
)


@dataclasses.dataclass
class FactCheckResult:
    passed: bool
    explanation: str


def fact_check_stream(
    llm, evidence: str, query: str, response: str
) -> Generator[str, None, None]:
    user = f"[[CONTEXT]]\n\n{evidence}\n\n[[QUESTION]]\n\n{query}\n\n[[RESPONSE]]\n\n{response}"
    yield from llm.stream_chat(
        [("system", FACT_CHECK_PROMPT), ("user", user)], temperature=0.0, max_tokens=1024
    )


def parse_verdict(text: str) -> FactCheckResult:
    head = text.strip()[:64].upper()
    passed = bool(re.match(r"[^A-Z]*TRUE", head))
    return FactCheckResult(passed=passed, explanation=text.strip())


def fact_check(llm, evidence: str, query: str, response: str) -> FactCheckResult:
    return parse_verdict("".join(fact_check_stream(llm, evidence, query, response)))
