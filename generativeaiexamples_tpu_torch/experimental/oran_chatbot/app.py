"""Guardrailed spec-chatbot service.

Counterpart of the JAX repository's experimental/oran_chatbot/app.py (an
aiohttp app) on ``http.server``, with its routes, status codes and JSON
bodies:

- ``POST /documents``: a multipart upload whose first field is ``file``
  (else 422), ingested through the runtime's splitter and embedder;
- ``POST /chat``: ``{"question", "fact_check": bool, "top_k"}`` -> the
  answer, its sources and, when asked, the guardrail's verdict;
- ``POST /feedback``: ``{"question", "answer", "rating", "comment",
  "sources"}``;
- ``GET /feedback/summary``.

    python -m generativeaiexamples_tpu_torch.experimental.oran_chatbot.app --port 8072

It builds the runtime's embedder, store and LLM on the card; with no card
it raises unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import logging
import os
import tempfile
from http.server import ThreadingHTTPServer
from typing import Optional

from generativeaiexamples_tpu_torch.experimental.http_app import (
    AppHandler,
    json_reply,
    make_app_server,
)
from generativeaiexamples_tpu_torch.experimental.oran_chatbot.feedback import FeedbackLog
from generativeaiexamples_tpu_torch.experimental.oran_chatbot.guardrails import fact_check
from generativeaiexamples_tpu_torch.experimental.oran_chatbot.memory import SummaryMemory
from generativeaiexamples_tpu_torch.utils import multipart

logger = logging.getLogger(__name__)


def create_oran_app(
    llm=None, embedder=None, store=None, feedback_path: Optional[str] = None,
    host: str = "127.0.0.1", port: int = 0,
) -> ThreadingHTTPServer:
    """A bound, not yet serving, chatbot server (``port=0``: a free port,
    ``server_address``) over ``llm``, ``embedder`` and ``store``, or the
    runtime's LLM, embedder and ``oran`` store."""
    from generativeaiexamples_tpu_torch.chains import runtime

    llm = llm or runtime.get_llm()
    embedder = embedder or runtime.get_embedder()
    store = store if store is not None else runtime.get_vector_store("oran")
    feedback = FeedbackLog(feedback_path or os.path.join(tempfile.gettempdir(), "oran_feedback.jsonl"))
    memory = SummaryMemory(llm)

    def upload(h: AppHandler):
        fields = multipart.parts(h.headers.get("Content-Type", ""), h.body())
        if fields is None:
            raise ValueError("multipart/* content type expected")
        if not fields or fields[0][0] != "file":
            return json_reply({"message": "expected multipart field 'file'"}, status=422)
        _, filename, data = fields[0]
        filename = os.path.basename(filename or "upload.txt")
        with tempfile.NamedTemporaryFile(delete=False, suffix=f"-{filename}") as tmp:
            tmp.write(data)
            tmp_path = tmp.name
        try:
            from generativeaiexamples_tpu_torch.retrieval.loaders import load_document
            from generativeaiexamples_tpu_torch.retrieval.store import Chunk

            text = load_document(tmp_path)
            pieces = runtime.get_splitter().split_text(text)
            if pieces:
                store.add(
                    [Chunk(text=p, source=filename) for p in pieces],
                    embedder.embed_documents(pieces),
                )
        finally:
            os.unlink(tmp_path)
        return json_reply({"message": "File uploaded successfully", "chunks": len(pieces)})

    def chat(h: AppHandler):
        body = h.json()
        question = str(body.get("question", ""))
        want_fact_check = bool(body.get("fact_check", True))
        top_k = int(body.get("top_k", 4))

        hits = store.search(embedder.embed_query(question), top_k)
        evidence = "\n\n".join(hit.chunk.text for hit in hits)
        context = memory.context()
        system = (
            "You answer questions about technical specification documents "
            "using only the provided excerpts."
        )
        user = (
            (f"{context}\n\n" if context else "")
            + f"Excerpts:\n{evidence}\n\nQuestion: {question}"
        )
        text = llm.complete([("system", system), ("user", user)], max_tokens=512)
        memory.add("user", question)
        memory.add("assistant", text)
        result = {
            "answer": text,
            "sources": sorted({hit.chunk.source for hit in hits}),
        }
        if want_fact_check:
            verdict = fact_check(llm, evidence, question, text)
            result["fact_check"] = {
                "passed": verdict.passed,
                "explanation": verdict.explanation,
            }
        return json_reply(result)

    def post_feedback(h: AppHandler):
        body = h.json()
        entry = feedback.record(
            question=str(body.get("question", "")),
            answer=str(body.get("answer", "")),
            rating=int(body.get("rating", 0)),
            comment=str(body.get("comment", "")),
            sources=body.get("sources", []),
        )
        return json_reply({"recorded": True, "ts": entry["ts"]})

    def feedback_summary(h: AppHandler):
        return json_reply(feedback.summary())

    routes = {
        ("POST", "/documents"): upload,
        ("POST", "/chat"): chat,
        ("POST", "/feedback"): post_feedback,
        ("GET", "/feedback/summary"): feedback_summary,
    }
    return make_app_server(routes, host, port, "OranChatbotHandler")


def main(argv=None) -> None:
    import argparse

    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.utils.logging import configure_root

    parser = argparse.ArgumentParser(description="Guardrailed spec chatbot")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8072)
    parser.add_argument("--device", default=None,
                        help="device of the embedder, the store and the LLM (default: the card)")
    args = parser.parse_args(argv)
    configure_root()
    if args.device is not None:
        runtime.set_device(args.device)
    runtime.check_device("the O-RAN chatbot")
    server = create_oran_app(host=args.host, port=args.port)
    logger.info("O-RAN chatbot on %s:%d", args.host, server.server_address[1])
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
