"""Streaming-RAG server.

Counterpart of the JAX repository's experimental/fm_streaming_rag/
server.py (an aiohttp app) on ``http.server``, with its routes, status
codes and bytes: ``GET /serverStatus``, ``POST /storeStreamingText``
(``{source_id, transcript}`` into the accumulator), ``POST /flushStream``
(embed a stream's tail) and ``POST /generate``, which streams the answer
as SSE ``data:`` frames in the chain server's wire format: one frame a
chain token, ``*error: ...*`` in a frame of its own when the chain raises,
then the ``finish_reason: "[DONE]"`` frame. Each request runs in a thread
of its own, so transcript updates keep landing while an answer decodes.

    python -m generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.server --port 8071

It builds the runtime's embedder and LLM on the card; with no card it
raises unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import json
import logging
from http.server import ThreadingHTTPServer
from typing import Optional

from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.accumulator import (
    TextAccumulator,
)
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.chains import (
    StreamingConfig,
    StreamingRagChain,
)
from generativeaiexamples_tpu_torch.experimental.http_app import (
    AppHandler,
    json_reply,
    make_app_server,
)

logger = logging.getLogger(__name__)

SSE_HEADERS = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}


def _frame(content: str, finish_reason: str = "") -> bytes:
    frame = {"choices": [{"message": {"content": content}, "finish_reason": finish_reason}]}
    return f"data: {json.dumps(frame)}\n\n".encode()


def create_streaming_app(
    accumulator: Optional[TextAccumulator] = None, llm=None,
    host: str = "127.0.0.1", port: int = 0,
) -> ThreadingHTTPServer:
    """A bound, not yet serving, streaming-RAG server (``port=0``: a free
    port, ``server_address``) over ``accumulator`` and ``llm``, or the
    runtime's embedder, ``stream`` store and LLM."""
    if accumulator is None:
        from generativeaiexamples_tpu_torch.chains.runtime import get_embedder, get_vector_store

        embedder = get_embedder()
        accumulator = TextAccumulator(embedder, get_vector_store("stream"))
    if llm is None:
        from generativeaiexamples_tpu_torch.chains.runtime import get_llm

        llm = get_llm()

    def server_status(h: AppHandler):
        return json_reply({"is_ready": True})

    def store_streaming_text(h: AppHandler):
        body = h.json()
        source_id = str(body.get("source_id", "default"))
        transcript = str(body.get("transcript", ""))
        return json_reply(accumulator.update(source_id, transcript))

    def flush_stream(h: AppHandler):
        body = h.json()
        source_id = str(body.get("source_id", "default"))
        return json_reply(accumulator.flush(source_id))

    def generate(h: AppHandler):
        body = h.json()
        config = StreamingConfig(
            question=str(body.get("question", "")),
            use_knowledge_base=bool(body.get("use_knowledge_base", True)),
            max_docs=int(body.get("max_docs", 8)),
            allow_summary=bool(body.get("allow_summary", True)),
            temperature=float(body.get("temperature", 0.2)),
            max_tokens=int(body.get("max_tokens", 512)),
        )
        chain = StreamingRagChain(llm, accumulator, config)
        h.start_stream(SSE_HEADERS)
        tokens = chain.answer()
        try:
            try:
                for token in tokens:
                    h.write(_frame(token))
            except (BrokenPipeError, ConnectionResetError):
                raise
            except Exception as exc:  # noqa: BLE001 - an error frame keeps the SSE shape
                h.write(_frame(f"*error: {exc}*"))
            h.write(_frame("", "[DONE]"))
        except (BrokenPipeError, ConnectionResetError):
            logger.info("Client disconnected mid-stream.")
        finally:
            tokens.close()
        return None

    routes = {
        ("GET", "/serverStatus"): server_status,
        ("POST", "/storeStreamingText"): store_streaming_text,
        ("POST", "/flushStream"): flush_stream,
        ("POST", "/generate"): generate,
    }
    return make_app_server(routes, host, port, "StreamingRagHandler")


def main(argv=None) -> None:
    import argparse

    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.utils.logging import configure_root

    parser = argparse.ArgumentParser(description="Streaming-text RAG server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8071)
    parser.add_argument("--device", default=None,
                        help="device of the embedder, the store and the LLM (default: the card)")
    args = parser.parse_args(argv)
    configure_root()
    if args.device is not None:
        runtime.set_device(args.device)
    runtime.check_device("the streaming-RAG server")
    server = create_streaming_app(host=args.host, port=args.port)
    logger.info("streaming-RAG server on %s:%d", args.host, server.server_address[1])
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
