"""Distributed tracing for the chain-server and frontend.

Counterpart of generativeaiexamples_tpu/utils/tracing.py, with the same
spans, ``traceparent`` handling and exporters. Where JAX attaches psutil
readings at span end, the port attaches the process's resident set
size read from ``/proc/self/statm`` (``system.process.memory_rss_mb``)
and leaves out the CPU and machine-memory percentages (no psutil).

The reference bootstraps an OpenTelemetry TracerProvider exporting OTLP
gRPC and bridges LangChain/LlamaIndex callbacks into spans (reference:
RetrievalAugmentedGeneration/common/tracing.py:34-88,
tools/observability/langchain/opentelemetry_callback.py:161-660). This
environment ships only the OTel *API*, not the SDK, so the provider here
is in-repo: a W3C-trace-context-compatible tracer with batched background
export. Same observable contract:

- gated by ``ENABLE_TRACING`` (reference: common/tracing.py:37,44) — when
  off, every helper is a no-op;
- 128-bit trace ids / 64-bit span ids, ``traceparent`` header extraction
  and injection (W3C trace-context, as the reference's
  TraceContextTextMapPropagator);
- per-token events on LLM spans (reference: opentelemetry_callback.py:248)
  and the process's memory attached at span end
  (opentelemetry_callback.py:65-101);
- exporters: ``console`` (stderr), ``jsonl`` (file; the collector-file
  analog of the OTLP→Jaeger pipeline), ``otlp-http`` (OTLP/HTTP JSON to
  ``OTEL_EXPORTER_OTLP_ENDPOINT``), ``memory`` (tests).
"""
from __future__ import annotations

import json
import logging
import os
import random
import tempfile
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional

logger = logging.getLogger(__name__)

_TRACEPARENT_VERSION = "00"


def tracing_enabled() -> bool:
    return os.environ.get("ENABLE_TRACING", "").lower() in ("true", "1", "yes")


def current_trace_id_hex() -> Optional[str]:
    """The calling thread's active trace id (32 hex chars), or None when
    tracing is off / nothing is active. THE one accessor shared by the
    metrics exemplars, the logging correlation stamp, the flight
    recorder, and the engine's submit-time capture — resolution order is
    the span stack first, then the thread's attached remote context
    (worker threads carry the request span via ``attach_context``)."""
    tracer = get_tracer()
    span = tracer.current_span()
    if span is not None and span.context is not None:
        return f"{span.context.trace_id:032x}"
    remote = getattr(tracer, "_remote", lambda: None)()
    if remote is not None:
        return f"{remote.trace_id:032x}"
    return None


# --------------------------------------------------------------------------- #
# Span model


@dataclass
class SpanContext:
    trace_id: int
    span_id: int
    sampled: bool = True

    def to_traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"{_TRACEPARENT_VERSION}-{self.trace_id:032x}-{self.span_id:016x}-{flags}"

    @classmethod
    def from_traceparent(cls, header: str) -> Optional["SpanContext"]:
        try:
            version, trace_id, span_id, flags = header.strip().split("-")[:4]
            ctx = cls(int(trace_id, 16), int(span_id, 16), bool(int(flags, 16) & 1))
            if ctx.trace_id == 0 or ctx.span_id == 0:
                return None
            return ctx
        except (ValueError, IndexError):
            return None


@dataclass
class Span:
    name: str
    context: SpanContext
    parent_id: Optional[int]
    start_time: float
    end_time: Optional[float] = None
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[Dict[str, Any]] = field(default_factory=list)
    status: str = "OK"

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: Optional[Mapping[str, Any]] = None) -> None:
        self.events.append(
            {"name": name, "time": time.time(), "attributes": dict(attributes or {})}
        )

    def record_exception(self, exc: BaseException) -> None:
        self.status = "ERROR"
        self.add_event(
            "exception",
            {"exception.type": type(exc).__name__, "exception.message": str(exc)},
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": f"{self.context.trace_id:032x}",
            "span_id": f"{self.context.span_id:016x}",
            "parent_span_id": f"{self.parent_id:016x}" if self.parent_id else None,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "duration_ms": round(1000 * ((self.end_time or time.time()) - self.start_time), 3),
            "attributes": self.attributes,
            "events": self.events,
            "status": self.status,
        }


# --------------------------------------------------------------------------- #
# Exporters


class SpanExporter:
    def export(self, spans: List[Span]) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class ConsoleSpanExporter(SpanExporter):
    def export(self, spans: List[Span]) -> None:
        import sys

        for span in spans:
            print(json.dumps(span.to_dict(), default=str), file=sys.stderr)


class JsonlSpanExporter(SpanExporter):
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()

    def export(self, spans: List[Span]) -> None:
        with self._lock, open(self.path, "a") as fh:
            for span in spans:
                fh.write(json.dumps(span.to_dict(), default=str) + "\n")


class OTLPHttpSpanExporter(SpanExporter):
    """OTLP/HTTP JSON to an otel-collector (reference exports OTLP gRPC to
    the collector in docker-compose-observability.yaml; JSON/HTTP is the
    sibling wire format the same collector accepts on :4318)."""

    def __init__(self, endpoint: Optional[str] = None, service_name: str = "chain-server"):
        self.endpoint = (
            endpoint
            or os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT", "http://localhost:4318")
        ).rstrip("/") + "/v1/traces"
        self.service_name = service_name

    def export(self, spans: List[Span]) -> None:
        import urllib.request

        payload = {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            {
                                "key": "service.name",
                                "value": {"stringValue": self.service_name},
                            }
                        ]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "generativeaiexamples_tpu_torch"},
                            "spans": [_otlp_span(s) for s in spans],
                        }
                    ],
                }
            ]
        }
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=5).read()
        except Exception as exc:  # noqa: BLE001 - collector down must not kill serving
            logger.debug("OTLP export failed: %s", exc)


def _otlp_span(span: Span) -> Dict[str, Any]:
    def attr(k, v):
        if isinstance(v, bool):
            val = {"boolValue": v}
        elif isinstance(v, int):
            val = {"intValue": str(v)}
        elif isinstance(v, float):
            val = {"doubleValue": v}
        else:
            val = {"stringValue": str(v)}
        return {"key": k, "value": val}

    return {
        "traceId": f"{span.context.trace_id:032x}",
        "spanId": f"{span.context.span_id:016x}",
        "parentSpanId": f"{span.parent_id:016x}" if span.parent_id else "",
        "name": span.name,
        "kind": 1,
        "startTimeUnixNano": str(int(span.start_time * 1e9)),
        "endTimeUnixNano": str(int((span.end_time or time.time()) * 1e9)),
        "attributes": [attr(k, v) for k, v in span.attributes.items()],
        "events": [
            {
                "timeUnixNano": str(int(e["time"] * 1e9)),
                "name": e["name"],
                "attributes": [attr(k, v) for k, v in e["attributes"].items()],
            }
            for e in span.events
        ],
        "status": {"code": 1 if span.status == "OK" else 2},
    }


class InMemorySpanExporter(SpanExporter):
    def __init__(self):
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def export(self, spans: List[Span]) -> None:
        with self._lock:
            self.spans.extend(spans)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()


# --------------------------------------------------------------------------- #
# Tracer


class Tracer:
    """Thread-aware tracer with a batching export worker."""

    def __init__(
        self,
        service_name: str = "chain-server",
        exporter: Optional[SpanExporter] = None,
        batch_size: int = 64,
        flush_interval: float = 2.0,
    ):
        self.service_name = service_name
        self.exporter = exporter or _exporter_from_env(service_name)
        self._local = threading.local()
        self._buffer: List[Span] = []
        self._lock = threading.Condition()
        self._batch_size = batch_size
        self._flush_interval = flush_interval
        self._running = True
        self._worker = threading.Thread(
            target=self._export_loop, daemon=True, name="trace-export"
        )
        self._worker.start()
        self._rng = random.Random()

    # -- context management ------------------------------------------------
    @property
    def _stack(self) -> List[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def current_span(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def attach_context(self, ctx: Optional[SpanContext]) -> None:
        """Adopt a remote parent (extracted traceparent) for this thread."""
        self._local.remote = ctx

    def _remote(self) -> Optional[SpanContext]:
        return getattr(self._local, "remote", None)

    @contextmanager
    def span(
        self,
        name: str,
        attributes: Optional[Mapping[str, Any]] = None,
        system_metrics: bool = False,
    ) -> Iterator[Span]:
        parent = self.current_span()
        if parent is not None:
            trace_id, parent_id = parent.context.trace_id, parent.context.span_id
        elif self._remote() is not None:
            remote = self._remote()
            trace_id, parent_id = remote.trace_id, remote.span_id
        else:
            trace_id, parent_id = self._rng.getrandbits(128), None
        span = Span(
            name=name,
            context=SpanContext(trace_id, self._rng.getrandbits(64)),
            parent_id=parent_id,
            start_time=time.time(),
            attributes=dict(attributes or {}),
        )
        span.set_attribute("service.name", self.service_name)
        self._stack.append(span)
        try:
            yield span
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            self._stack.pop()
            if system_metrics:
                _attach_system_metrics(span)
            span.end_time = time.time()
            self._enqueue(span)

    def start_span(
        self,
        name: str,
        remote_ctx: Optional[SpanContext] = None,
        attributes: Optional[Mapping[str, Any]] = None,
    ) -> Span:
        """Explicitly-managed span (for async handlers, where a thread-local
        stack would interleave across concurrent requests on the loop
        thread). Pair with :meth:`finish_span`; propagate to worker threads
        via :meth:`attach_context`."""
        if remote_ctx is not None:
            trace_id, parent_id = remote_ctx.trace_id, remote_ctx.span_id
        else:
            trace_id, parent_id = self._rng.getrandbits(128), None
        span = Span(
            name=name,
            context=SpanContext(trace_id, self._rng.getrandbits(64)),
            parent_id=parent_id,
            start_time=time.time(),
            attributes=dict(attributes or {}),
        )
        span.set_attribute("service.name", self.service_name)
        return span

    def finish_span(self, span: Span, system_metrics: bool = False) -> None:
        if system_metrics:
            _attach_system_metrics(span)
        span.end_time = time.time()
        self._enqueue(span)

    # -- propagation -------------------------------------------------------
    def extract(self, headers: Mapping[str, str]) -> Optional[SpanContext]:
        header = headers.get("traceparent") or headers.get("Traceparent")
        return SpanContext.from_traceparent(header) if header else None

    def inject(self, headers: Dict[str, str]) -> Dict[str, str]:
        span = self.current_span()
        if span is not None:
            headers["traceparent"] = span.context.to_traceparent()
        return headers

    # -- export ------------------------------------------------------------
    def _enqueue(self, span: Span) -> None:
        with self._lock:
            self._buffer.append(span)
            if len(self._buffer) >= self._batch_size:
                self._lock.notify_all()

    def _export_loop(self) -> None:
        while True:
            with self._lock:
                self._lock.wait(timeout=self._flush_interval)
                batch, self._buffer = self._buffer, []
                running = self._running
            if batch:
                try:
                    self.exporter.export(batch)
                except Exception as exc:  # noqa: BLE001
                    logger.debug("span export failed: %s", exc)
            if not running:
                return

    def force_flush(self) -> None:
        with self._lock:
            batch, self._buffer = self._buffer, []
        if batch:
            self.exporter.export(batch)

    def shutdown(self) -> None:
        with self._lock:
            self._running = False
            self._lock.notify_all()
        self._worker.join(timeout=5)
        self.force_flush()
        self.exporter.shutdown()


class _NoopSpan:
    context = None

    def set_attribute(self, *a, **k):
        pass

    def add_event(self, *a, **k):
        pass

    def record_exception(self, *a, **k):
        pass


class NoopTracer:
    """When ENABLE_TRACING is off every call collapses to nothing."""

    @contextmanager
    def span(self, name, attributes=None, system_metrics=False):
        yield _NoopSpan()

    def start_span(self, name, remote_ctx=None, attributes=None):
        return _NoopSpan()

    def finish_span(self, span, system_metrics=False):
        pass

    def extract(self, headers):
        return None

    def inject(self, headers):
        return headers

    def attach_context(self, ctx):
        pass

    def current_span(self):
        return None

    def force_flush(self):
        pass

    def shutdown(self):
        pass


def _attach_system_metrics(span: Span) -> None:
    """The process's resident set size at span end, from
    ``/proc/self/statm`` (its second field, in pages). Nothing is
    attached where that file is missing."""
    try:
        with open("/proc/self/statm", encoding="ascii") as fh:
            pages = int(fh.read().split()[1])
        rss = pages * os.sysconf("SC_PAGE_SIZE")
        span.set_attribute("system.process.memory_rss_mb", round(rss / 2**20, 1))
    except (OSError, ValueError, IndexError):  # metrics must never break a request
        pass


def _exporter_from_env(service_name: str) -> SpanExporter:
    kind = os.environ.get("TRACE_EXPORTER", "console").lower()
    if kind == "jsonl":
        return JsonlSpanExporter(
            os.environ.get("TRACE_JSONL_PATH")
            or os.path.join(tempfile.gettempdir(), "generativeaiexamples_tpu_torch_traces.jsonl")
        )
    if kind in ("otlp", "otlp-http"):
        return OTLPHttpSpanExporter(service_name=service_name)
    if kind == "memory":
        return InMemorySpanExporter()
    return ConsoleSpanExporter()


# --------------------------------------------------------------------------- #
# Process-wide tracer

_TRACER: Optional[Any] = None
_TRACER_LOCK = threading.Lock()


def get_tracer():
    """Process-wide tracer; Noop unless ENABLE_TRACING (common/tracing.py:37)."""
    global _TRACER
    with _TRACER_LOCK:
        if _TRACER is None:
            _TRACER = Tracer() if tracing_enabled() else NoopTracer()
        return _TRACER


def set_tracer(tracer) -> None:
    """Testing/bootstrap hook."""
    global _TRACER
    with _TRACER_LOCK:
        old, _TRACER = _TRACER, tracer
    if old is not None and old is not tracer:
        old.shutdown()


def reset_tracer() -> None:
    set_tracer(None)  # type: ignore[arg-type]
    global _TRACER
    _TRACER = None
