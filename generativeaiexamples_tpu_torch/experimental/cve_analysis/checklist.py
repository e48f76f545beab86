"""Checklist generation: a CVE's description -> assessment steps.

Counterpart of the JAX repository's experimental/cve_analysis/checklist.py:
the LLM is asked (``CHECKLIST_PROMPT``, JAX's byte for byte) for a JSON
array of checklist strings, greedily and at most 512 tokens; the reply is
read as a JSON array (possibly inside prose), else as numbered or
bulleted lines, else as sentences, in that order.
"""
from __future__ import annotations

import json
import re
from typing import List

CHECKLIST_PROMPT = (
    "You are an expert security analyst. Given CVE details, produce an "
    "exploitability-assessment checklist for a containerized environment. "
    "Each item starts with an action verb and is specific to this CVE "
    "(affected package, vulnerable versions, vulnerable functions). "
    "Reply with ONLY a JSON array of checklist strings, e.g. "
    '["Check the installed version of lxml; versions up to 4.9.1 are affected.", '
    '"Check whether the code calls iterwalk or canonicalize."].'
)


def parse_checklist(raw: str) -> List[str]:
    raw = raw.strip()
    # a JSON array, possibly inside prose
    match = re.search(r"\[.*\]", raw, re.DOTALL)
    if match:
        try:
            items = json.loads(match.group(0))
            if isinstance(items, list):
                cleaned = [str(i).strip() for i in items if str(i).strip()]
                if cleaned:
                    return cleaned
        except json.JSONDecodeError:
            pass
    # numbered or bulleted lines
    items = []
    for line in raw.splitlines():
        line = line.strip()
        stripped = re.sub(r"^(\d+[.)]\s*|[-*•]\s*)", "", line)
        if stripped and stripped != line:
            items.append(stripped)
    if items:
        return items
    # sentences
    return [s.strip() for s in raw.split(". ") if len(s.strip()) > 10]


def generate_checklist(llm, cve_info: str, max_tokens: int = 512) -> List[str]:
    raw = llm.complete(
        [("system", CHECKLIST_PROMPT), ("user", f"CVE details: {cve_info}")],
        temperature=0.0,
        max_tokens=max_tokens,
    )
    return parse_checklist(raw)
