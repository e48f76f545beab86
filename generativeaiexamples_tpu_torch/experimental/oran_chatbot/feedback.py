"""User feedback capture (thumbs up or down, and comments).

Counterpart of the JAX repository's experimental/oran_chatbot/
feedback.py: an append-only JSONL log, one record per rated answer, with
a summary for evaluation.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List


class FeedbackLog:
    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def record(
        self, question: str, answer: str, rating: int, comment: str = "", sources: List[str] = ()
    ) -> Dict:
        entry = {
            "ts": time.time(),
            "question": question,
            "answer": answer,
            "rating": int(rating),  # +1 / -1
            "comment": comment,
            "sources": list(sources),
        }
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(entry) + "\n")
        return entry

    def entries(self) -> List[Dict]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def summary(self) -> Dict:
        entries = self.entries()
        up = sum(1 for e in entries if e.get("rating", 0) > 0)
        down = sum(1 for e in entries if e.get("rating", 0) < 0)
        return {"total": len(entries), "up": up, "down": down}
