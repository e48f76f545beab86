"""OpenAI-compatible model server for the port's engine.

Counterpart of generativeaiexamples_tpu/engine/server.py, with the same
routes and JSON wire shapes, on the standard library's
``http.server.ThreadingHTTPServer`` (one thread per connection):

- ``GET /v1/health/ready``, ``GET /v1/models``;
- ``POST /v1/chat/completions`` (SSE when ``"stream": true``, ending in
  ``data: [DONE]``) and ``POST /v1/completions``;
- ``POST /v1/embeddings`` answers 501 until the embedder is ported.

Run on the card::

    python -m generativeaiexamples_tpu_torch.engine.server --port 8000
"""
from __future__ import annotations

import argparse
import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from generativeaiexamples_tpu_torch.config import EngineConfig

logger = logging.getLogger(__name__)


def _now() -> int:
    return int(time.time())


class ModelServer:
    """Routes and wire shapes; ``engine=None`` builds the process engine on
    the first request that needs it (health and models never build it)."""

    def __init__(self, engine=None, model_name: str = ""):
        self._engine = engine
        self._engine_lock = threading.Lock()
        self.model_name = model_name or "torch-llama"

    @property
    def engine(self):
        with self._engine_lock:
            if self._engine is None:
                from generativeaiexamples_tpu_torch.engine.llm_engine import get_engine

                self._engine = get_engine()
            return self._engine

    def sampling(self, body: Dict[str, Any]):
        """The JAX server's request defaults (temperature 0.2, top_p 0.7,
        max_tokens 1024)."""
        from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        return SamplingParams(
            temperature=float(body.get("temperature", 0.2)),
            top_p=float(body.get("top_p", 0.7)),
            max_tokens=int(body.get("max_tokens", 1024)),
            stop=tuple(stop),
            seed=int(body.get("seed", 0) or 0),
        )

    def models_body(self) -> Dict[str, Any]:
        return {
            "object": "list",
            "data": [{"id": self.model_name, "object": "model", "created": _now(), "owned_by": "gpu"}],
        }

    def chat_body(self, rid: str, text: str) -> Dict[str, Any]:
        return {
            "id": rid,
            "object": "chat.completion",
            "created": _now(),
            "model": self.model_name,
            "choices": [
                {"index": 0, "message": {"role": "assistant", "content": text}, "finish_reason": "stop"}
            ],
            "usage": {},
        }

    def chunk_frame(self, rid: str, delta: Dict[str, Any], finish: Optional[str]) -> Dict[str, Any]:
        return {
            "id": rid,
            "object": "chat.completion.chunk",
            "created": _now(),
            "model": self.model_name,
            "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
        }

    def completion_body(self, text: str) -> Dict[str, Any]:
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "created": _now(),
            "model": self.model_name,
            "choices": [{"index": 0, "text": text, "finish_reason": "stop"}],
        }


class _Handler(BaseHTTPRequestHandler):
    server_version = "genai-torch/1"
    protocol_version = "HTTP/1.1"
    app: ModelServer  # set on the subclass make_server builds

    def log_message(self, fmt, *args):  # route access logs through logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, status: int, body: Dict[str, Any]) -> None:
        data = json.dumps(body).encode()
        self.responded = True
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> Optional[Dict[str, Any]]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return None
        return body if isinstance(body, dict) else None

    def do_GET(self):  # noqa: N802 - http.server's naming
        if self.path == "/v1/health/ready":
            self._json(200, {"object": "health", "message": "Service is ready."})
        elif self.path == "/v1/models":
            self._json(200, self.app.models_body())
        else:
            self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802 - http.server's naming
        routes = {
            "/v1/chat/completions": self._chat,
            "/v1/completions": self._completions,
            "/v1/embeddings": self._embeddings,
        }
        route = routes.get(self.path)
        if route is None:
            self._json(404, {"error": f"no route {self.path}"})
            return
        body = self._body()
        if body is None:
            self._json(400, {"error": "invalid request body"})
            return
        self.responded = False
        try:
            route(body)
        except Exception as exc:  # noqa: BLE001 - one failed request must not kill the connection silently
            logger.exception("request to %s failed", self.path)
            if not self.responded:
                self._json(500, {"error": {"message": str(exc), "type": "server_error"}})

    def _chat(self, body: Dict[str, Any]) -> None:
        try:
            messages = [(m["role"], m["content"]) for m in body["messages"]]
        except (KeyError, TypeError):
            self._json(400, {"error": "invalid request body"})
            return
        app = self.app
        params = app.sampling(body)
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        gen = app.engine.chat(messages, params)
        if not body.get("stream", False):
            self._json(200, app.chat_body(rid, "".join(gen)))
            return
        self.responded = True
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            first = True
            for chunk in gen:
                delta: Dict[str, Any] = {"content": chunk}
                if first:
                    delta["role"] = "assistant"
                    first = False
                self._sse(app.chunk_frame(rid, delta, None))
            self._sse(app.chunk_frame(rid, {}, "stop"))
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        finally:
            gen.close()  # a gone client aborts the request

    def _sse(self, frame: Dict[str, Any]) -> None:
        self.wfile.write(f"data: {json.dumps(frame)}\n\n".encode())
        self.wfile.flush()

    def _completions(self, body: Dict[str, Any]) -> None:
        prompt = body.get("prompt")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else None
        if not isinstance(prompt, str):
            self._json(400, {"error": "invalid request body"})
            return
        app = self.app
        ids = app.engine.tokenizer.encode(prompt, add_bos=True)
        text = "".join(app.engine.stream_text(ids, app.sampling(body)))
        self._json(200, app.completion_body(text))

    def _embeddings(self, body: Dict[str, Any]) -> None:
        self._json(501, {"error": {
            "message": "embeddings are not served by the PyTorch port yet (the embedder "
                       "is a later slice)",
            "type": "not_implemented",
        }})


def make_server(host: str = "127.0.0.1", port: int = 8000, engine=None,
                model_name: str = "") -> ThreadingHTTPServer:
    """A bound, not yet serving, HTTP server over ``engine`` (or the
    process engine). ``port=0`` picks a free port (``server_address``)."""
    app = ModelServer(engine, model_name)
    handler = type("Handler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def main() -> None:
    """Serve llama3-8b with int8 weights (random, seed 0, until checkpoints
    ship), the slice's served recipe, on the card."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import get_engine

    parser = argparse.ArgumentParser(description="OpenAI-compatible server for the PyTorch port")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    server = make_server(args.host, args.port, engine=get_engine(EngineConfig(quantization="int8")))
    logger.info("serving on %s:%d", args.host, args.port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
