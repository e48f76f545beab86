"""OpenAI-compatible model server for the port's engine.

Counterpart of generativeaiexamples_tpu/engine/server.py, with the same
routes and JSON wire shapes, on the standard library's
``http.server.ThreadingHTTPServer`` (one thread per connection):

- ``GET /v1/health/ready`` (503 while the engine is wedged),
  ``GET /internal/ready`` (``{"ready", "wedged"}``, 200 or 503) and
  ``GET /v1/models`` (the LLM and the embed model, as in JAX);
- ``POST /v1/chat/completions`` (SSE when ``"stream": true``, ending in
  ``data: [DONE]``) and ``POST /v1/completions``; a full admission queue
  (``max_queued_requests``) answers 429 with ``Retry-After`` and
  ``X-GenAI-Queue-Depth``, a stream before its first frame;
- ``POST /v1/embeddings`` (``embed_documents``, no query prefix; 400 on
  a body without ``input``).

The engine and the embedder are built on first use when not given
(health, readiness and models never build them). Run on the card::

    python -m generativeaiexamples_tpu_torch.engine.server --port 8000

``APP_EMBEDDINGS_MODELENGINE`` picks the embedder: ``tpu`` (the default:
arctic-embed-l on the card) or ``hash`` (no weights).
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

from generativeaiexamples_tpu_torch.config import AppConfig
from generativeaiexamples_tpu_torch.engine.llm_engine import EngineOverloaded, engine_wedged

logger = logging.getLogger(__name__)


def _now() -> int:
    return int(time.time())


class ModelServer:
    """Routes and wire shapes; ``engine=None`` builds the process engine and
    ``embedder=None`` the configured embedder (``create_embedder``) on the
    first request that needs it (health and models never build them)."""

    def __init__(self, engine=None, model_name: str = "", embedder=None,
                 embed_model_name: str = ""):
        self._engine = engine
        self._engine_lock = threading.Lock()
        self._embedder = embedder
        self._embedder_lock = threading.Lock()
        self.model_name = model_name or "torch-llama"
        self.embed_model_name = embed_model_name or "torch-arctic-embed"

    @property
    def engine(self):
        with self._engine_lock:
            if self._engine is None:
                from generativeaiexamples_tpu_torch.engine.llm_engine import get_engine

                self._engine = get_engine()
            return self._engine

    @property
    def embedder(self):
        with self._embedder_lock:
            if self._embedder is None:
                from generativeaiexamples_tpu_torch.engine.embedder import create_embedder

                self._embedder = create_embedder()
            return self._embedder

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

    def ready(self) -> bool:
        """Ready once the engine is built (the port has no warmup) and
        while it is not wedged; never builds it."""
        return self._engine is not None and not engine_wedged()

    def models_body(self) -> Dict[str, Any]:
        return {
            "object": "list",
            "data": [
                {"id": self.model_name, "object": "model", "created": _now(), "owned_by": "gpu"},
                {"id": self.embed_model_name, "object": "model", "created": _now(), "owned_by": "gpu"},
            ],
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

    def embeddings_body(self, model: str, vectors) -> Dict[str, Any]:
        return {
            "object": "list",
            "model": model,
            "data": [
                {"object": "embedding", "index": i, "embedding": vec.tolist()}
                for i, vec in enumerate(vectors)
            ],
            "usage": {},
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

    def _json(self, status: int, body: Dict[str, Any], headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(body).encode()
        self.responded = True
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def _overloaded(self, exc: EngineOverloaded) -> None:
        """429 + Retry-After for an admission-queue rejection (OpenAI wire
        error shape), with the queue depth for a router's bounded-load
        spill."""
        headers = {
            "Retry-After": str(max(1, int(exc.retry_after))),
            "X-GenAI-Queue-Depth": str(self.app.engine.queue_depth()),
        }
        self._json(429, {"error": {"message": str(exc), "type": "overloaded_error"}}, headers)

    def _body(self) -> Optional[Dict[str, Any]]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return None
        return body if isinstance(body, dict) else None

    def do_GET(self):  # noqa: N802 - http.server's naming
        if self.path == "/v1/health/ready":
            if engine_wedged():
                self._json(503, {"object": "health", "message": "Engine wedged."})
            else:
                self._json(200, {"object": "health", "message": "Service is ready."})
        elif self.path == "/internal/ready":
            ready = self.app.ready()
            self._json(200 if ready else 503, {"ready": ready, "wedged": engine_wedged()})
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
        except EngineOverloaded as exc:
            self._overloaded(exc)
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
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not isinstance(inputs, list) or not all(isinstance(t, str) for t in inputs):
            self._json(400, {"error": "invalid request body"})
            return
        app = self.app
        vectors = app.embedder.embed_documents(inputs)
        self._json(200, app.embeddings_body(body.get("model", app.embed_model_name), vectors))


def make_server(host: str = "127.0.0.1", port: int = 8000, engine=None,
                model_name: str = "", embedder=None) -> ThreadingHTTPServer:
    """A bound, not yet serving, HTTP server over ``engine`` and
    ``embedder`` (or the process engine and the configured embedder).
    ``port=0`` picks a free port (``server_address``)."""
    app = ModelServer(engine, model_name, embedder)
    handler = type("Handler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def main() -> None:
    """Serve on the card the engine and the embedder that the ``APP_*``
    environment configures, as the JAX engine server reads it
    (``AppConfig.from_env``; e.g. ``APP_ENGINE_QUANTIZATION=int8
    APP_ENGINE_KVCACHEDTYPE=int8``, ``APP_EMBEDDINGS_MODELENGINE=hash``).
    Weights are random (seed 0) until checkpoints ship."""
    from generativeaiexamples_tpu_torch.engine.batcher import validate_config
    from generativeaiexamples_tpu_torch.engine.embedder import create_embedder
    from generativeaiexamples_tpu_torch.engine.llm_engine import get_engine

    parser = argparse.ArgumentParser(description="OpenAI-compatible server for the PyTorch port")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    config = AppConfig.from_env()
    config.engine.validate()
    validate_config(config)
    logger.info("config: %s", config)
    server = make_server(args.host, args.port, engine=get_engine(config.engine),
                         embedder=create_embedder(config))
    logger.info("serving on %s:%d", args.host, args.port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
