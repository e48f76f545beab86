"""Black-box answer generation against a running chain server.

Counterpart of the JAX repository's tools/evaluation/answer_generator.py
on ``urllib.request``: upload documents through ``POST /documents``, then
for each QnA question replay ``POST /generate`` (SSE) and ``POST
/search``, writing ``eval.json`` rows with the generated answer and the
retrieved contexts. The routes, bodies, SSE parsing, ``/internal/ready``
probe and timeouts are the JAX client's.
"""
from __future__ import annotations

import json
import logging
import math
import os
import time
import urllib.error
import urllib.request
from typing import Dict, List, Sequence

from generativeaiexamples_tpu_torch.utils import multipart

logger = logging.getLogger(__name__)


def _status(url: str, timeout: float) -> int:
    """The status of a GET (an HTTP error's code too)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status
    except urllib.error.HTTPError as exc:
        exc.close()
        return exc.code


def _post(url: str, data: bytes, content_type: str, timeout: float):
    """An open response to a POST; an HTTP error status raises
    ``urllib.error.HTTPError``."""
    req = urllib.request.Request(url, data=data, headers={"Content-Type": content_type})
    return urllib.request.urlopen(req, timeout=timeout)


class ChainServerClient:
    """Minimal REST client for the chain-server public API."""

    def __init__(self, base_url: str = "http://localhost:8081", timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def health(self) -> bool:
        try:
            return _status(f"{self.base_url}/health", 10) == 200
        except OSError:
            return False

    def ready(self) -> bool:
        """Whether the engine's warmup has finished (``/internal/ready``).
        Servers without the endpoint count as ready."""
        try:
            return _status(f"{self.base_url}/internal/ready", 10) in (200, 404)
        except OSError:
            return False

    def upload_document(self, path: str) -> None:
        with open(path, "rb") as fh:
            body, ctype = multipart.encode(files={"file": (os.path.basename(path), fh.read())})
        with _post(f"{self.base_url}/documents", body, ctype, self.timeout) as resp:
            resp.read()

    def generate(
        self,
        question: str,
        use_knowledge_base: bool = True,
        **settings,
    ) -> str:
        """POST /generate and collect the SSE stream into the final answer."""
        answer, _ = self.generate_timed(question, use_knowledge_base, **settings)
        return answer

    def generate_timed(
        self,
        question: str,
        use_knowledge_base: bool = True,
        **settings,
    ) -> tuple:
        """Like generate(), also returning {latency_s, ttft_s}."""
        payload = {
            "messages": [{"role": "user", "content": question}],
            "use_knowledge_base": use_knowledge_base,
            **settings,
        }
        t0 = time.time()
        ttft = None
        answer = []
        with _post(f"{self.base_url}/generate", json.dumps(payload).encode(),
                   "application/json", self.timeout) as resp:
            for raw in resp:
                line = raw.decode("utf-8").rstrip("\r\n")
                if not line or not line.startswith("data: "):
                    continue
                frame = json.loads(line[len("data: "):])
                for choice in frame.get("choices", []):
                    # a degraded error stream carries its message in the
                    # [DONE] frame: it is kept, not dropped as empty
                    content = choice.get("message", {}).get("content", "")
                    if content and ttft is None:
                        ttft = time.time() - t0
                    answer.append(content)
        latency = time.time() - t0
        return "".join(answer), {"latency_s": latency, "ttft_s": ttft if ttft is not None else latency}

    def search(self, query: str, top_k: int = 4) -> List[Dict]:
        body = json.dumps({"query": query, "top_k": top_k}).encode()
        with _post(f"{self.base_url}/search", body, "application/json", self.timeout) as resp:
            return json.loads(resp.read()).get("chunks", [])


def generate_answers(
    qna: Sequence[Dict],
    output_path: str,
    server_url: str = "http://localhost:8081",
    docs: Sequence[str] = (),
    top_k: int = 4,
    use_knowledge_base: bool = True,
) -> List[Dict]:
    """Drive the server for every question; returns and writes eval rows."""
    client = ChainServerClient(server_url)
    if not client.health():
        raise RuntimeError(f"chain-server at {server_url} is not healthy")
    for path in docs:
        logger.info("Uploading %s", path)
        client.upload_document(path)

    rows: List[Dict] = []
    t_start = time.time()
    for i, item in enumerate(qna):
        question = item["question"]
        answer, timing = client.generate_timed(question, use_knowledge_base=use_knowledge_base)
        contexts = [c.get("content", "") for c in client.search(question, top_k)]
        rows.append(
            {
                "question": question,
                "ground_truth_answer": item.get("ground_truth_answer", ""),
                "ground_truth_context": item.get("ground_truth_context", ""),
                "answer": answer,
                "contexts": contexts,
                "latency_s": round(timing["latency_s"], 4),
                "ttft_s": round(timing["ttft_s"], 4),
            }
        )
        logger.info("Answered %d/%d", i + 1, len(qna))
    wall = time.time() - t_start
    if rows:
        latencies = sorted(r["latency_s"] for r in rows)
        summary = {
            "questions": len(rows),
            "qps": round(len(rows) / wall, 4),
            "p50_latency_s": latencies[len(latencies) // 2],
            "p95_latency_s": latencies[math.ceil(len(latencies) * 0.95) - 1],
            "p50_ttft_s": sorted(r["ttft_s"] for r in rows)[len(rows) // 2],
        }
        logger.info("e2e timing: %s", summary)
    else:
        summary = {"questions": 0}
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    # eval.json stays a plain row list (what the evaluate phase reads); the
    # timing summary goes to a file beside it
    with open(output_path, "w", encoding="utf-8") as fh:
        json.dump(rows, fh, indent=2)
    with open(output_path + ".timing.json", "w", encoding="utf-8") as fh:
        json.dump(summary, fh, indent=2)
    return rows
