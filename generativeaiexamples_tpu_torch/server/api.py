"""The chain-server HTTP API.

Counterpart of the JAX package's generativeaiexamples_tpu/server/api.py on
the standard library's ``http.server.ThreadingHTTPServer`` (one thread per
connection), with its status codes, JSON bodies and SSE bytes:

- ``GET /health`` -> ``{"message": "Service is up."}``; ``GET
  /internal/ready`` -> ``{"ready", "wedged"}`` (503 while the engine is
  wedged; the port has no warmup to wait for);
- ``POST /generate`` -> ``text/event-stream`` of ``data: {ChainResponse}``
  frames ending in one with ``finish_reason`` ``"[DONE]"``. Admission
  (``resilience``): an injected fault at ``server.admission``, more than
  ``max_active_streams`` streams, or the live engine's queue at
  ``engine_queue_cap`` requests, 429 with ``Retry-After`` and
  ``X-GenAI-Queue-Depth`` (no engine is ever built to answer it);
  ``EngineOverloaded`` at submit -> 429; a deadline spent before the
  stream -> 504, during it -> a ``[DONE]`` frame with a
  ``deadline_exceeded`` warning; a chain's ``DegradedWarning`` -> a
  warnings-only frame; a drain mid-stream -> a ``finish_reason``
  ``"PREEMPTED"`` frame whose warning names the snapshot id;
  ``VectorStoreError`` and other errors -> a single-frame 500 stream;
- ``POST /documents`` (multipart upload, saved under ``DOC_UPLOAD_DIR``
  by its base name, then ``ingest_docs``), ``GET /documents``,
  ``DELETE /documents?filename=``, ``POST /search``;
- the drain lifecycle, served by both of the port's servers (the engine
  server takes the same functions, as the JAX servers share handlers):
  ``POST /internal/drain`` (``{"resume": true}`` lifts a drain) answers
  the drain summary, ``GET /internal/snapshots`` the spool's inventory,
  ``GET /internal/snapshots/{id}`` the document (404 when unknown), and
  ``POST /internal/restore`` streams a snapshot's continuation as
  ``/generate`` frames with ``X-GenAI-Restore: <id>; mode=<mode>`` (409
  on a fingerprint or geometry mismatch, 422 on a body that is no
  snapshot, 503 while this engine drains), at any shard count (a
  sharded engine's snapshot carries the full model's heads); each
  answers 503 without a live engine and never builds one;
- 422 ``{"detail": [...]}`` on a body that fails validation; CORS on
  every answer; ``OPTIONS`` -> 204.

The request's thread binds its ``Deadline`` and runs the chain and its
generator itself, so the engine's stream timeout is the request's
remaining budget; a client that goes away closes the generator, which
aborts the engine request. ``make_server`` installs ``resilience.faults``.

Observability, as in the JAX server: every request opens a span
(utils/tracing.py; a ``traceparent`` header is its remote parent) and is
counted by route pattern (server/observability.py, which also serves
``/metrics``, ``/internal/metrics``, ``/internal/requests[/{id}]``,
``/internal/timeline``, ``/internal/slo``, ``/internal/debug/bundles[/{id}]``
and ``/internal/profile/start|stop``). ``/generate`` opens a flight
record (``http_request``, then ``admitted``, ``shed`` or
``deadline_exceeded``), binds it and the span's context to the request
thread for the chain and the engine, counts sheds, deadlines and active
streams, and feeds the SLO tracker and the black box.
"""
from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Optional, Type

from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.chains.registry import resolve_example
from generativeaiexamples_tpu_torch.chains.runtime import DegradedWarning
from generativeaiexamples_tpu_torch.engine.llm_engine import engine_wedged
from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError
from generativeaiexamples_tpu_torch.server import observability
from generativeaiexamples_tpu_torch.server.observability import (
    ACTIVE_STREAMS,
    DEADLINE_EXCEEDED,
    REQUESTS_SHED,
)
from generativeaiexamples_tpu_torch.server.schemas import (
    ChainResponse,
    ChainResponseChoices,
    DocumentChunk,
    DocumentSearch,
    DocumentSearchResponse,
    DocumentsResponse,
    HealthResponse,
    Message,
    Prompt,
    ValidationError,
    validation_error_body,
)
from generativeaiexamples_tpu_torch.utils import blackbox
from generativeaiexamples_tpu_torch.utils import faults as faults_mod
from generativeaiexamples_tpu_torch.utils import flight_recorder
from generativeaiexamples_tpu_torch.utils import multipart
from generativeaiexamples_tpu_torch.utils import resilience
from generativeaiexamples_tpu_torch.utils import slo as slo_mod
from generativeaiexamples_tpu_torch.utils.tracing import get_tracer
from generativeaiexamples_tpu_torch.utils.resilience import (
    Deadline,
    DeadlineExceeded,
    EngineOverloaded,
    RequestPreempted,
)

logger = logging.getLogger(__name__)

DEFAULT_UPLOAD_FOLDER = "/tmp-data/uploaded_files"
VECTOR_STORE_ERROR_MSG = (
    "Error from milvus server. Please ensure you have ingested some documents. "
    "Please check chain-server logs for more details."
)
GENERIC_ERROR_MSG = "Error from chain server. Please check chain-server logs for more details."
RESTORE_HEADER = "X-GenAI-Restore"
_NO_ENGINE = {"detail": "no live engine in this process"}
_CORS = {"Access-Control-Allow-Origin": "*", "Access-Control-Allow-Methods": "*",
         "Access-Control-Allow-Headers": "*"}
MAX_BODY = 512 * 1024 * 1024


def upload_folder() -> str:
    """Where uploads are saved: ``DOC_UPLOAD_DIR`` (read at each upload)."""
    return os.environ.get("DOC_UPLOAD_DIR", DEFAULT_UPLOAD_FOLDER)


def sse_frame(resp: ChainResponse) -> bytes:
    return ("data: " + resp.to_json() + "\n\n").encode()


def chunk_frame(resp_id: str, chunk: str, finish_reason: str = "") -> bytes:
    return sse_frame(ChainResponse(id=resp_id, choices=[ChainResponseChoices(
        index=0, message=Message.make("assistant", chunk), finish_reason=finish_reason)]))


def done_frame(resp_id: str, warnings=None) -> bytes:
    return sse_frame(ChainResponse(
        id=resp_id, choices=[ChainResponseChoices(finish_reason="[DONE]")], warnings=warnings))


def error_stream_body(msg: str) -> bytes:
    return sse_frame(ChainResponse(choices=[ChainResponseChoices(
        index=0, message=Message.make("assistant", msg), finish_reason="[DONE]")]))


def preempt_frame(resp_id: str, exc: RequestPreempted) -> bytes:
    """The drain's terminator: ``finish_reason`` ``"PREEMPTED"`` and a
    warning with the snapshot id a router restores elsewhere (empty: replay
    from the original prompt)."""
    sid = getattr(exc, "snapshot_id", None) or ""
    return sse_frame(ChainResponse(
        id=resp_id, choices=[ChainResponseChoices(index=0, finish_reason="PREEMPTED")],
        warnings=[f"preempted snapshot_id={sid}"]))


def request_deadline(rcfg, header: Optional[str], prompt: Prompt) -> Optional[Deadline]:
    """The request's budget: the ``X-Request-Deadline-Ms`` header, else the
    body's ``deadline_ms``, else ``resilience.request_deadline_ms``; 0 at
    any level disables it."""
    ms: Optional[int] = None
    if header:
        try:
            ms = int(header)
        except ValueError:
            logger.warning("Ignoring malformed X-Request-Deadline-Ms: %r", header)
        else:
            if ms <= 0:
                return None
    if ms is None and prompt.deadline_ms is not None:
        if prompt.deadline_ms <= 0:
            return None
        ms = prompt.deadline_ms
    if ms is None:
        ms = rcfg.request_deadline_ms
    return Deadline(ms / 1000.0) if ms and ms > 0 else None


def _live_engine():
    """The process engine, if one was built: never builds one."""
    from generativeaiexamples_tpu_torch.engine import llm_engine

    return llm_engine._ENGINE


# --------------------------------------------------------------------------- #
# The drain lifecycle, shared by the chain server and the engine server:
# each function answers (status, JSON body), or a restore's stream, for
# ``eng`` (the engine server's own) or else the process engine.

def drain_route(raw: bytes, eng=None):
    """``POST /internal/drain``: drain the live engine (its summary), or
    lift a drain when the body is ``{"resume": true}``, at any shard
    count."""
    eng = eng or _live_engine()
    if eng is None:
        return 503, _NO_ENGINE
    try:
        body = json.loads(raw) if raw else None
    except (ValueError, UnicodeDecodeError):  # an empty body is the common case
        body = None
    if isinstance(body, dict) and body.get("resume"):
        eng.resume_from_drain()
        return 200, {"draining": False}
    return 200, eng.drain()


def snapshots_route(eng=None):
    """``GET /internal/snapshots``: the spool's inventory."""
    eng = eng or _live_engine()
    if eng is None:
        return 503, _NO_ENGINE
    return 200, {"snapshots": eng.snapshot_spool.list()}


def snapshot_route(sid: str, eng=None):
    """``GET /internal/snapshots/{id}``: the raw document, relayed as it is
    into another replica's ``/internal/restore``."""
    from generativeaiexamples_tpu_torch.engine import request_snapshot as snap_mod

    eng = eng or _live_engine()
    if eng is None:
        return 503, _NO_ENGINE
    try:
        return 200, eng.snapshot_spool.load_doc(sid)
    except snap_mod.SnapshotError as exc:
        return 404, {"detail": str(exc)}


def restore_route(raw: bytes, eng=None):
    """``POST /internal/restore``: re-admit a snapshot document on the live
    engine. Returns ``(status, body, None)`` for a refusal, or ``(200,
    headers, frames)`` where ``frames`` yields the continuation's SSE
    frames (the spooled prefix first) and the terminator."""
    from generativeaiexamples_tpu_torch.engine import request_snapshot as snap_mod

    eng = eng or _live_engine()
    if eng is None:
        return 503, _NO_ENGINE, None
    try:
        snap = snap_mod.RequestSnapshot.from_doc(json.loads(raw))
    except snap_mod.SnapshotMismatch as exc:
        return 409, {"detail": str(exc)}, None
    except Exception:  # noqa: BLE001 - a malformed body
        return 422, {"detail": "body must be a snapshot document"}, None
    try:
        req, params, prior_ids, mode = eng.restore_snapshot(snap)
    except snap_mod.SnapshotMismatch as exc:
        return 409, {"detail": str(exc)}, None
    except EngineOverloaded as exc:
        return 503, {"detail": str(exc)}, None
    except (snap_mod.SnapshotError, TimeoutError) as exc:
        logger.error("Restore of %s failed: %s", snap.snapshot_id, exc)
        return 500, {"detail": str(exc)}, None

    def frames():
        resp_id = str(uuid.uuid4())
        gen = eng.stream_restored(req, params, prior_ids)
        try:
            for chunk in gen:
                yield chunk_frame(resp_id, chunk)
            yield done_frame(resp_id)
        except RequestPreempted as exc:
            # drained again mid-restore: the new snapshot id goes back
            yield preempt_frame(resp_id, exc)
        except Exception as exc:  # noqa: BLE001
            logger.error("Error mid-stream in /internal/restore: %s", exc)
            yield error_stream_body(GENERIC_ERROR_MSG)
        finally:
            gen.close()

    return 200, {RESTORE_HEADER: f"{snap.snapshot_id}; mode={mode}"}, frames()


class _Reply(Exception):
    """A complete non-streamed answer (with the CORS headers unless the
    route was not found, as in the JAX server)."""

    def __init__(self, status: int, body, headers: Optional[Dict[str, str]] = None,
                 content_type: str = "application/json; charset=utf-8", cors: bool = True):
        super().__init__(status)
        self.status, self.body, self.content_type = status, body, content_type
        self.headers = {**(headers or {}), **(_CORS if cors else {})}


class ChainServer:
    """The routes over one example-chain class (``EXAMPLE_NAME`` when not
    given)."""

    def __init__(self, example_cls: Optional[Type[BaseExample]] = None):
        self._example_cls = example_cls
        self._lock = threading.Lock()
        self.active_streams = 0  # admitted /generate requests in flight

    @property
    def example_cls(self) -> Type[BaseExample]:
        if self._example_cls is None:
            self._example_cls = resolve_example()
        return self._example_cls

    # -- admission ------------------------------------------------------ #
    def admission_denied(self, rcfg) -> Optional[str]:
        cap = rcfg.max_active_streams
        if cap > 0 and self.active_streams >= cap:
            return "active_streams"
        qcap, eng = rcfg.engine_queue_cap, _live_engine()
        if qcap > 0 and eng is not None and eng.queue_depth() >= qcap:
            return "engine_queue"
        return None

    def shed(self, rcfg, reason: str, detail: str = "", span=None, rec=None) -> _Reply:
        REQUESTS_SHED.labels(reason=reason).inc()
        slo_mod.observe_event("shed")
        blackbox.notify_shed(reason)
        if rec is not None:
            rec.event("shed", reason=reason)
            flight_recorder.finish(rec, "shed")
        if span is not None:
            span.set_attribute("genai.request_shed", reason)
        logger.warning("Shedding /generate (%s): %s", reason, detail or "at capacity")
        headers = {"Retry-After": str(max(1, int(rcfg.shed_retry_after_s)))}
        eng = _live_engine()
        if eng is not None:
            headers["X-GenAI-Queue-Depth"] = str(eng.queue_depth())
        return _Reply(429, {"detail": detail or f"server overloaded ({reason}); retry later"},
                      headers)

    # -- routes --------------------------------------------------------- #
    def health(self) -> _Reply:
        return _Reply(200, HealthResponse(message="Service is up.").to_dict())

    def ready(self) -> _Reply:
        wedged = engine_wedged()
        return _Reply(200 if not wedged else 503, {"ready": not wedged, "wedged": wedged})

    def upload(self, content_type: str, body: bytes) -> _Reply:
        try:
            field = multipart.file_field(content_type, body)
            if field is None:
                return _Reply(200, {"message": "No files provided"})
            filename, data = field
            upload_file = os.path.basename(filename)
            if not upload_file:
                raise RuntimeError("Error parsing uploaded filename.")
            uploads_dir = Path(upload_folder())
            uploads_dir.mkdir(parents=True, exist_ok=True)
            file_path = str(uploads_dir / upload_file)
            with open(file_path, "wb") as fh:
                fh.write(data)
            self.example_cls().ingest_docs(file_path, upload_file)
            return _Reply(200, {"message": "File uploaded successfully"})
        except Exception as exc:  # noqa: BLE001
            logger.error("Error from POST /documents endpoint: %s", exc)
            return _Reply(500, {"message": str(exc)})

    def search(self, data: Any) -> _Reply:
        try:
            req = DocumentSearch.validate(data)
        except ValidationError as exc:
            return _Reply(422, validation_error_body(exc))
        try:
            example = self.example_cls()
            if not callable(getattr(example, "document_search", None)):
                raise NotImplementedError(
                    "Example class has not implemented the document_search method.")
            chunks = [DocumentChunk(content=e.get("content", ""), filename=e.get("source", ""),
                                    score=e.get("score", 0.0))
                      for e in example.document_search(req.query, req.top_k)]
            return _Reply(200, DocumentSearchResponse(chunks=chunks).to_dict())
        except Exception as exc:  # noqa: BLE001
            logger.error("Error from POST /search endpoint. Error details: %s", exc)
            return _Reply(500, {"message": "Error occurred while searching documents."})

    def documents(self) -> _Reply:
        try:
            example = self.example_cls()
            if not callable(getattr(example, "get_documents", None)):
                raise NotImplementedError(
                    "Example class has not implemented the get_documents method.")
            return _Reply(200, DocumentsResponse(documents=example.get_documents()).to_dict())
        except Exception as exc:  # noqa: BLE001
            logger.error("Error from GET /documents endpoint. Error details: %s", exc)
            return _Reply(500, {"message": "Error occurred while fetching documents."})

    def delete(self, filename: str) -> _Reply:
        try:
            example = self.example_cls()
            if not callable(getattr(example, "delete_documents", None)):
                raise NotImplementedError(
                    "Example class has not implemented the delete_document method.")
            if not example.delete_documents([filename]):
                raise RuntimeError(f"Error in deleting document {filename}")
            return _Reply(200, {"message": f"Document {filename} deleted successfully"})
        except Exception as exc:  # noqa: BLE001
            logger.error("Error from DELETE /documents endpoint. Error details: %s", exc)
            return _Reply(500, {"message": f"Error deleting document {filename}"})

    def generate(self, handler: "_Handler", data: Any) -> Optional[_Reply]:
        """Validate and admit; then stream through ``handler`` (returns
        None) or answer at once (returns the reply)."""
        from generativeaiexamples_tpu_torch.config import get_config

        try:
            prompt = Prompt.validate(data)
        except ValidationError as exc:
            return _Reply(422, validation_error_body(exc))
        config = get_config()
        rcfg = config.resilience
        deadline = None
        span = handler.trace_span
        ctx = getattr(span, "context", None)
        rec = flight_recorder.start(trace_id=f"{ctx.trace_id:032x}" if ctx is not None else None)
        if rec is not None:
            rec.event("http_request", path="/generate")
        if resilience.resilience_enabled(config) and faults_mod.active():
            try:
                faults_mod.fault_point("server.admission")
            except faults_mod.FaultInjected:
                # an injected error here stands for saturation
                return self.shed(rcfg, "fault_injected", span=span, rec=rec)
        with self._lock:
            if resilience.resilience_enabled(config):
                reason = self.admission_denied(rcfg)
                if reason is not None:
                    return self.shed(rcfg, reason, span=span, rec=rec)
                deadline = request_deadline(rcfg, handler.headers.get("X-Request-Deadline-Ms"),
                                            prompt)
                if deadline is not None and deadline.expired:
                    DEADLINE_EXCEEDED.labels(stage="admission").inc()
                    if span is not None:
                        span.set_attribute("genai.deadline_exceeded", "admission")
                    if rec is not None:
                        rec.event("deadline_exceeded", stage="admission")
                        flight_recorder.finish(rec, "deadline")
                    return _Reply(504, {"detail": "request deadline exhausted before admission"})
            # counted from admission on, retrieval included
            self.active_streams += 1
            ACTIVE_STREAMS.set(self.active_streams)
        slo_mod.observe_event("admitted")
        if rec is not None:
            rec.event("admitted", active_streams=self.active_streams)
        resilience.set_current_deadline(deadline)
        # the chain and the engine run on this thread: they find the
        # request's record and trace context here
        flight_recorder.bind(rec)
        tracer = get_tracer()
        tracer.attach_context(ctx)
        try:
            return self._generate_admitted(handler, prompt, rcfg, span, rec)
        finally:
            tracer.attach_context(None)
            flight_recorder.unbind()
            resilience.set_current_deadline(None)
            with self._lock:
                self.active_streams -= 1
                ACTIVE_STREAMS.set(self.active_streams)
            flight_recorder.finish(rec)
            flight_recorder.attach_span_events(rec, span)

    def _generate_admitted(self, handler: "_Handler", prompt: Prompt, rcfg, span=None,
                           rec=None) -> Optional[_Reply]:
        chat_history = list(prompt.messages)
        # the last user message is the query
        query = next((m.content for m in reversed(chat_history) if m.role == "user"), None)
        for i in reversed(range(len(chat_history))):
            if chat_history[i].role == "user":
                del chat_history[i]
                break
        try:
            example = self.example_cls()
            chain_fn = example.rag_chain if prompt.use_knowledge_base else example.llm_chain
            generator = chain_fn(query=query, chat_history=chat_history, **prompt.llm_settings())
        except EngineOverloaded as exc:
            return self.shed(rcfg, "engine_overloaded", str(exc), span=span, rec=rec)
        except DeadlineExceeded as exc:
            DEADLINE_EXCEEDED.labels(stage="admission").inc()
            if span is not None:
                span.set_attribute("genai.deadline_exceeded", "admission")
            if rec is not None:
                rec.event("deadline_exceeded", stage="admission")
            return _Reply(504, {"detail": str(exc)})
        except VectorStoreError as exc:
            logger.error("Vector store error in /generate: %s", exc)
            return _Reply(500, error_stream_body(VECTOR_STORE_ERROR_MSG),
                          content_type="text/event-stream; charset=utf-8")
        except Exception as exc:  # noqa: BLE001
            logger.error("Error from /generate endpoint. Error details: %s", exc)
            return _Reply(500, error_stream_body(GENERIC_ERROR_MSG),
                          content_type="text/event-stream; charset=utf-8")
        resp_id = str(uuid.uuid4())
        degraded_seen = False
        try:
            handler.start_stream()
            if generator:
                for chunk in generator:
                    if isinstance(chunk, DegradedWarning):
                        degraded_seen = True
                        if span is not None:
                            span.set_attribute("genai.degraded", chunk.reason)
                        handler.write_frame(sse_frame(ChainResponse(
                            id=resp_id, choices=[], warnings=[str(chunk)])))
                    else:
                        if span is not None:
                            span.add_event("llm.new_token", {"length": len(chunk)})
                        handler.write_frame(chunk_frame(resp_id, chunk))
                handler.write_frame(done_frame(resp_id))
                if not degraded_seen:
                    # degraded streams were counted by the chain
                    slo_mod.observe_event("answered")
            else:
                handler.write_frame(sse_frame(ChainResponse()))
        except (BrokenPipeError, ConnectionResetError):
            logger.info("Client disconnected mid-stream.")
        except (DeadlineExceeded, TimeoutError) as exc:
            DEADLINE_EXCEEDED.labels(stage="stream").inc()
            if span is not None:
                span.set_attribute("genai.deadline_exceeded", "stream")
            if rec is not None:
                rec.event("deadline_exceeded", stage="stream")
            logger.warning("Deadline exceeded mid-stream in /generate: %s", exc)
            handler.write_frame(done_frame(resp_id, [f"deadline_exceeded: {exc}"]))
        except RequestPreempted as exc:
            # a drain checkpointed the request: the typed terminator, never
            # a 500-style frame
            if span is not None:
                span.set_attribute("genai.preempted", exc.snapshot_id or "replay")
            logger.warning("Request preempted mid-stream (snapshot=%s)",
                           exc.snapshot_id or "replay")
            handler.write_frame(preempt_frame(resp_id, exc))
        except VectorStoreError as exc:
            logger.error("Vector store error mid-stream: %s", exc)
            handler.write_frame(error_stream_body(VECTOR_STORE_ERROR_MSG))
        except Exception as exc:  # noqa: BLE001
            logger.error("Error mid-stream in /generate. Error details: %s", exc)
            handler.write_frame(error_stream_body(GENERIC_ERROR_MSG))
        finally:
            # a generator's close() runs the engine stream's finally: a gone
            # client's request is aborted and its slot freed
            close = getattr(generator, "close", None)
            if close is not None:
                close()
        return None


class _Handler(BaseHTTPRequestHandler):
    server_version = "genai-torch-chain/1"
    protocol_version = "HTTP/1.1"
    app: ChainServer  # set on the subclass make_server builds
    trace_span = None  # the request's span (set per request)
    status = 500  # the status sent, for the request accounting
    route = "unmatched"  # the route pattern the request counts under
    _accounting = None  # (method, start) until the request is counted

    def log_message(self, fmt, *args):  # access logs through logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def send_response(self, code, message=None):
        self.status = code
        super().send_response(code, message)

    def count_request(self) -> None:
        """Count the request once, in JAX's order: a non-streamed reply
        before its bytes go out (``reply``; aiohttp writes a returned
        response after the metrics middleware has counted it), a stream
        when it ends (``_route``'s ``finally``)."""
        if self._accounting is None:
            return
        method, start = self._accounting
        self._accounting = None
        observability.request_finished(self.route, method, self.status, start, self.trace_span)

    # -- output --------------------------------------------------------- #
    def reply(self, r: _Reply) -> None:
        data = r.body if isinstance(r.body, bytes) else json.dumps(r.body).encode()
        self.status = r.status
        self.count_request()
        self.send_response(r.status)
        if r.content_type:
            self.send_header("Content-Type", r.content_type)
        self.send_header("Content-Length", str(len(data)))
        for name, value in r.headers.items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def start_stream(self, headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        for name, value in {**(headers or {}), **_CORS}.items():
            self.send_header(name, value)
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True

    def write_frame(self, frame: bytes) -> None:
        self.wfile.write(frame)
        self.wfile.flush()

    # -- input ---------------------------------------------------------- #
    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", "0") or 0)
        if n > MAX_BODY:
            raise _Reply(413, {"detail": "request body too large"})
        return self.rfile.read(n) if n > 0 else b""

    def _json(self) -> Any:
        try:
            return json.loads(self._body())
        except (ValueError, UnicodeDecodeError):
            raise _Reply(422, {"detail": "Invalid JSON body"}) from None

    def _restore(self) -> Optional[_Reply]:
        status, body, frames = restore_route(self._body())
        if frames is None:
            return _Reply(status, body)
        self.start_stream(body)
        try:
            for frame in frames:
                self.write_frame(frame)
        except (BrokenPipeError, ConnectionResetError):
            logger.info("Client disconnected mid-restore-stream.")
            frames.close()
        return None

    def _route(self, method: str) -> None:
        """One request through the JAX server's middlewares: the span
        (``traceparent`` extracted), the route accounting, then the
        route."""
        tracer = get_tracer()
        url = urllib.parse.urlsplit(self.path)
        span = tracer.start_span(
            f"{method} {url.path}", remote_ctx=tracer.extract(self.headers),
            attributes={"http.method": method, "http.target": url.path},
        )
        self.trace_span, self.status, self.route = span, 500, "unmatched"
        self._accounting = (method, observability.request_started())
        try:
            self._serve(method, url)
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            span.set_attribute("http.status_code", self.status)
            if self.status >= 500:
                span.status = "ERROR"
            tracer.finish_span(span, system_metrics=True)
            self.count_request()

    def _serve(self, method: str, url) -> None:
        """Serve the request, its route pattern in ``self.route`` before
        any reply goes out."""
        hit = observability.dispatch(method, self.path, self.headers, self._body)
        if hit is not None:
            self.route, (status, headers, body) = hit
            self.reply(_Reply(status, body, content_type=headers["Content-Type"]))
            return
        path, app = url.path, self.app
        routes = {
            ("GET", "/health"): app.health,
            ("GET", "/internal/ready"): app.ready,
            ("POST", "/generate"): lambda: app.generate(self, self._json()),
            ("POST", "/search"): lambda: app.search(self._json()),
            ("POST", "/documents"): lambda: app.upload(self.headers.get("Content-Type", ""),
                                                       self._body()),
            ("GET", "/documents"): app.documents,
            ("DELETE", "/documents"): lambda: app.delete(
                urllib.parse.parse_qs(url.query).get("filename", [""])[0]),
            ("POST", "/internal/drain"): lambda: _Reply(*drain_route(self._body())),
            ("GET", "/internal/snapshots"): lambda: _Reply(*snapshots_route()),
            ("POST", "/internal/restore"): self._restore,
        }
        self.route = path
        match = re.fullmatch(r"/internal/snapshots/([^/]+)", path)
        if match:
            self.route = "/internal/snapshots/{id}"
            routes[("GET", path)] = lambda: _Reply(
                *snapshot_route(urllib.parse.unquote(match.group(1))))
        try:
            if method == "OPTIONS":
                raise _Reply(204, b"", content_type="")
            route = routes.get((method, path))
            if route is None:
                self.route = "unmatched"
                allowed = ([m for (m, p) in routes if p == path]
                           or observability.paths_served(path))
                if allowed:
                    raise _Reply(405, b"405: Method Not Allowed", {"Allow": ",".join(allowed)},
                                 content_type="text/plain; charset=utf-8", cors=False)
                raise _Reply(404, b"404: Not Found", content_type="text/plain; charset=utf-8",
                             cors=False)
            result = route()
            if result is not None:
                self.reply(result)
        except _Reply as r:
            self.reply(r)

    def do_GET(self):  # noqa: N802 - http.server's naming
        self._route("GET")

    def do_POST(self):  # noqa: N802
        self._route("POST")

    def do_DELETE(self):  # noqa: N802
        self._route("DELETE")

    def do_OPTIONS(self):  # noqa: N802
        self._route("OPTIONS")


def make_server(host: str = "127.0.0.1", port: int = 8081,
                example_cls: Optional[Type[BaseExample]] = None) -> ThreadingHTTPServer:
    """A bound, not yet serving, chain server (``port=0`` picks a free
    port, ``server_address``). The process configuration is checked first,
    as the JAX server's startup checks it (``config_validate``, then the
    engine's, the resilience section's and the batcher's own checks), the
    observability sections configure the flight recorder, the SLO
    tracker, the black box and the dispatch timeline, and the
    ``resilience.faults`` rules are installed."""
    from generativeaiexamples_tpu_torch import config_validate
    from generativeaiexamples_tpu_torch.config import get_config
    from generativeaiexamples_tpu_torch.engine.batcher import validate_config

    config = get_config()
    config_validate.validate_config(config)
    config.engine.validate()
    config.resilience.validate()
    validate_config(config)
    config_validate.configure_observability(config)
    if config.resilience.faults:
        try:
            n = faults_mod.install(config.resilience.faults)
            logger.warning("Installed %d fault-injection rule(s) from config", n)
        except ValueError as exc:
            raise ValueError(f"invalid resilience.faults spec: {exc}") from exc
    app = ChainServer(example_cls)
    handler = type("Handler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server
