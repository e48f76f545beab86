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
  a body without ``input``);
- the drain lifecycle, with the chain server's functions and answers
  (server/api.py, as the JAX servers share their handlers):
  ``POST /internal/drain``, ``GET /internal/snapshots``,
  ``GET /internal/snapshots/{id}`` and ``POST /internal/restore``. A chat
  stream that a drain preempts ends with a chunk whose ``finish_reason``
  is ``"PREEMPTED"`` and whose ``warnings`` name the snapshot id, then
  ``data: [DONE]`` (the JAX engine server drops the connection there).

- the observability routes of server/observability.py (``/metrics``,
  ``/internal/metrics``, ``/internal/requests[/{id}]``,
  ``/internal/timeline``, ``/internal/slo``,
  ``/internal/debug/bundles[/{id}]``, ``/internal/profile/start|stop``),
  with every request counted by route pattern and run under a span whose
  context the engine's submits carry (a ``traceparent`` header is its
  remote parent), as the JAX engine server's middleware does.

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
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from generativeaiexamples_tpu_torch.config import load_config
from generativeaiexamples_tpu_torch.engine.llm_engine import engine_wedged
from generativeaiexamples_tpu_torch.server import observability
from generativeaiexamples_tpu_torch.utils.resilience import EngineOverloaded, RequestPreempted
from generativeaiexamples_tpu_torch.utils.tracing import get_tracer

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
        max_tokens 1024) and its ``spec_decode`` parsing."""
        from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        # spec_decode: the JAX server's per-request speculative-decoding
        # switch; absent follows the engine, False opts out. Strings parse
        # by value ("false" opts out, where bool("false") would not).
        spec = body.get("spec_decode")
        if isinstance(spec, str):
            spec = spec.strip().lower() in ("1", "true", "on", "yes")
        elif spec is not None:
            spec = bool(spec)
        return SamplingParams(
            temperature=float(body.get("temperature", 0.2)),
            top_p=float(body.get("top_p", 0.7)),
            max_tokens=int(body.get("max_tokens", 1024)),
            stop=tuple(stop),
            seed=int(body.get("seed", 0) or 0),
            spec_decode=spec,
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


_ROUTES = {
    "GET": ("/v1/health/ready", "/internal/ready", "/v1/models", "/internal/snapshots"),
    "POST": ("/v1/chat/completions", "/v1/completions", "/v1/embeddings", "/internal/drain",
             "/internal/restore"),
}


def _route_pattern(method: str, path: str) -> str:
    """The route pattern a request counts under (bounded cardinality)."""
    if path in _ROUTES.get(method, ()):
        return path
    if method == "GET" and path.startswith("/internal/snapshots/"):
        return "/internal/snapshots/{id}"
    return "unmatched"


class _Handler(BaseHTTPRequestHandler):
    server_version = "genai-torch/1"
    protocol_version = "HTTP/1.1"
    app: ModelServer  # set on the subclass make_server builds
    status = 500  # the status sent, for the request accounting

    def log_message(self, fmt, *args):  # route access logs through logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def send_response(self, code, message=None):
        self.status = code
        super().send_response(code, message)

    def _traced(self, method: str, serve) -> None:
        """Run ``serve`` under the request's span (its context attached
        to this thread, so the engine's submits carry the trace id) and
        count the request by route pattern."""
        tracer = get_tracer()
        path = urllib.parse.urlsplit(self.path).path
        span = tracer.start_span(
            f"{method} {path}", remote_ctx=tracer.extract(self.headers),
            attributes={"http.method": method, "http.target": path},
        )
        self.status = 500
        start = observability.request_started()
        route = "unmatched"
        tracer.attach_context(getattr(span, "context", None))
        try:
            hit = observability.dispatch(method, self.path, self.headers, self._raw)
            if hit is not None:
                route, (status, headers, body) = hit
                self._send(status, headers, body)
            else:
                route = _route_pattern(method, path)
                serve()
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            tracer.attach_context(None)
            span.set_attribute("http.status_code", self.status)
            if self.status >= 500:
                span.status = "ERROR"
            tracer.finish_span(span, system_metrics=True)
            observability.request_finished(route, method, self.status, start, span)

    def _send(self, status: int, headers: Dict[str, str], data: bytes) -> None:
        self.responded = True
        self.send_response(status)
        for name, value in headers.items():
            self.send_header(name, value)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

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

    def _lifecycle(self, method: str) -> bool:
        """The drain lifecycle's routes; False for any other path."""
        from generativeaiexamples_tpu_torch.server import api

        path = urllib.parse.urlsplit(self.path).path
        eng = self.app._engine  # never built here
        if method == "GET" and path == "/internal/snapshots":
            self._json(*api.snapshots_route(eng))
        elif method == "GET" and path.startswith("/internal/snapshots/"):
            self._json(*api.snapshot_route(urllib.parse.unquote(path.rsplit("/", 1)[1]), eng))
        elif method == "POST" and path == "/internal/drain":
            self._json(*api.drain_route(self._raw(), eng))
        elif method == "POST" and path == "/internal/restore":
            status, body, frames = api.restore_route(self._raw(), eng)
            if frames is None:
                self._json(status, body)
                return True
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            for name, value in {**body, "Access-Control-Allow-Origin": "*"}.items():
                self.send_header(name, value)
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            try:
                for frame in frames:
                    self.wfile.write(frame)
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                frames.close()
        else:
            return False
        return True

    def _raw(self) -> bytes:
        n = int(self.headers.get("Content-Length", "0") or 0)
        return self.rfile.read(n) if n > 0 else b""

    def do_GET(self):  # noqa: N802 - http.server's naming
        self._traced("GET", self._get)

    def do_POST(self):  # noqa: N802 - http.server's naming
        self._traced("POST", self._post)

    def _get(self) -> None:
        if self._lifecycle("GET"):
            return
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

    def _post(self) -> None:
        if self._lifecycle("POST"):
            return
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
        except RequestPreempted as exc:
            frame = app.chunk_frame(rid, {}, "PREEMPTED")
            frame["warnings"] = [f"preempted snapshot_id={exc.snapshot_id or ''}"]
            self._sse(frame)
        finally:
            gen.close()  # a gone client aborts the request
        self.wfile.write(b"data: [DONE]\n\n")
        self.wfile.flush()

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
    """Serve on the card the engine and the embedder that the
    configuration file (``APP_CONFIG_FILE``) and the ``APP_*`` environment
    configure, as the JAX engine server reads them (``load_config``;
    e.g. ``APP_ENGINE_QUANTIZATION=int8 APP_ENGINE_KVCACHEDTYPE=int8``,
    ``APP_EMBEDDINGS_MODELENGINE=hash``).
    Weights come from ``APP_ENGINE_CHECKPOINTPATH`` (random, seed 0,
    without one)."""
    from generativeaiexamples_tpu_torch import config_validate
    from generativeaiexamples_tpu_torch.engine.batcher import validate_config
    from generativeaiexamples_tpu_torch.engine.embedder import create_embedder
    from generativeaiexamples_tpu_torch.engine.llm_engine import get_engine

    parser = argparse.ArgumentParser(description="OpenAI-compatible server for the PyTorch port")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args()
    from generativeaiexamples_tpu_torch.utils.logging import configure_root

    configure_root()
    config = load_config()
    config.engine.validate()
    validate_config(config)
    config_validate.validate_observability(config)
    config_validate.configure_observability(config)
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
