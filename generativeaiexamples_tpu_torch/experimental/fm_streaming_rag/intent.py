"""LLM-driven intent and recency classification for streaming RAG.

Counterpart of the JAX repository's experimental/fm_streaming_rag/
intent.py: a small LLM call decides whether the user wants a semantic
lookup, a recent summary or a time-window answer, and a second call
extracts "how far back". Replies are asked for as JSON and parsed
defensively (the first {...} block wins); a failed classification falls
back to plain RAG rather than an error. The prompts are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Optional

INTENT_TYPES = ("SpecificTopic", "RecentSummary", "TimeWindow", "Unknown")

INTENT_PROMPT = (
    "You classify a user's question about a live audio transcript into an "
    "intent. Reply with ONLY a JSON object {\"intentType\": <type>} where "
    "<type> is one of: \"SpecificTopic\" (asking about a topic, e.g. 'what "
    "was said about the weather?'), \"RecentSummary\" (asking what happened "
    "recently, e.g. 'summarize the last 5 minutes'), \"TimeWindow\" (asking "
    "about a specific past moment, e.g. 'what was discussed 10 minutes "
    "ago?'), or \"Unknown\"."
)

RECENCY_PROMPT = (
    "Extract the time span a question refers to. Reply with ONLY a JSON "
    "object {\"timeNum\": <number>, \"timeUnit\": \"seconds\"|\"minutes\"|"
    "\"hours\"|\"days\"}. Example: 'what happened in the last 5 minutes?' "
    "-> {\"timeNum\": 5, \"timeUnit\": \"minutes\"}."
)

RAG_PROMPT = (
    "You are a helpful assistant answering questions about a live radio "
    "transcript. Use only the transcript excerpts provided. If the "
    "transcript does not contain the answer, say so."
)

SUMMARIZATION_PROMPT = (
    "Summarize the following transcript excerpt in a few sentences, "
    "keeping names, numbers, and topics."
)

_UNITS = {"seconds": 1.0, "minutes": 60.0, "hours": 3600.0, "days": 86400.0}


@dataclasses.dataclass
class UserIntent:
    intentType: str = "Unknown"


@dataclasses.dataclass
class TimeResponse:
    timeNum: float = 0.0
    timeUnit: str = "seconds"

    def to_seconds(self) -> float:
        return float(self.timeNum) * _UNITS.get(self.timeUnit, 1.0)


def _first_json(text: str) -> Optional[dict]:
    match = re.search(r"\{.*?\}", text, re.DOTALL)
    if not match:
        return None
    try:
        obj = json.loads(match.group(0))
    except json.JSONDecodeError:
        return None
    return obj if isinstance(obj, dict) else None


def classify_intent(llm, question: str) -> UserIntent:
    raw = llm.complete([("system", INTENT_PROMPT), ("user", question)], temperature=0.0, max_tokens=64)
    obj = _first_json(raw) or {}
    intent = obj.get("intentType", "Unknown")
    return UserIntent(intentType=intent if intent in INTENT_TYPES else "Unknown")


def classify_recency(llm, question: str) -> Optional[TimeResponse]:
    raw = llm.complete([("system", RECENCY_PROMPT), ("user", question)], temperature=0.0, max_tokens=64)
    obj = _first_json(raw)
    if not obj:
        return None
    try:
        return TimeResponse(
            timeNum=float(obj.get("timeNum", 0)), timeUnit=str(obj.get("timeUnit", "seconds"))
        )
    except (TypeError, ValueError):
        return None
