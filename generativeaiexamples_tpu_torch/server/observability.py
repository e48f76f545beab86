"""HTTP observability shared by the chain server and the engine server.

Counterpart of generativeaiexamples_tpu/server/observability.py, as
handler functions for the standard library's ``http.server`` (the JAX
module holds aiohttp handlers). Each handler answers a :data:`Response`
``(status, headers, body bytes)`` with JAX's status codes and JSON keys;
both port servers route ``(method, path)`` through :func:`dispatch`:

- ``GET /metrics`` — Prometheus text exposition 0.0.4, or OpenMetrics
  (with trace exemplars) when the scraper's Accept header asks for
  ``application/openmetrics-text``;
- ``GET /internal/metrics`` — the JSON view over the same registry and
  the live engine's flat ``metrics`` (JAX ``server/api.py`` and
  ``engine/server.py`` serve it beside the shared routes);
- ``GET /internal/requests`` (``?limit``, ``?slow``, ``?trace``,
  ``?since``) and ``/internal/requests/{id}`` — the flight recorder;
- ``GET /internal/timeline`` (``?since``, ``?limit``,
  ``?format=perfetto``; with perfetto, ``?trace=<path>`` overlays the
  measured kernel spans of a torch.profiler Chrome trace where JAX takes
  ``?xplane=<logdir>``) — the dispatch timeline;
- ``GET /internal/slo`` — the SLO evaluation and the live engine's
  utilization snapshot;
- ``GET /internal/debug/bundles`` and ``/internal/debug/bundles/{id}`` —
  the anomaly black box;
- ``POST /internal/profile/start`` and ``/stop`` — utils/profiling.py.

The request accounting (:func:`request_started` / :func:`request_finished`)
is JAX's ``metrics_middleware``: per-route count by method and status, the
in-flight gauge, and the latency histogram by route pattern with the
request span's trace id as its exemplar. The shed, active-stream and
deadline families the chain server counts are registered here, as in JAX.

No handler builds an engine: each peeks at ``llm_engine._ENGINE``.
"""
from __future__ import annotations

import json
import re
import time
import urllib.parse
from typing import Callable, Dict, Mapping, Optional, Tuple

from generativeaiexamples_tpu_torch.engine import dispatch_timeline
from generativeaiexamples_tpu_torch.utils import blackbox
from generativeaiexamples_tpu_torch.utils import device_trace
from generativeaiexamples_tpu_torch.utils import flight_recorder
from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod
from generativeaiexamples_tpu_torch.utils import profiling
from generativeaiexamples_tpu_torch.utils import slo as slo_mod
from generativeaiexamples_tpu_torch.utils import trace_stitch

Response = Tuple[int, Dict[str, str], bytes]

_REG = metrics_mod.get_registry()

HTTP_REQUESTS = _REG.counter(
    "genai_http_requests_total",
    "HTTP requests served, by route pattern, method and status code.",
    ("route", "method", "status"),
)
HTTP_IN_FLIGHT = _REG.gauge(
    "genai_http_requests_in_flight",
    "HTTP requests currently being handled.",
)
HTTP_LATENCY = _REG.histogram(
    "genai_http_request_duration_seconds",
    "Wall time per HTTP request, by route pattern.",
    ("route",),
)
REQUESTS_SHED = _REG.counter(
    "genai_server_requests_shed_total",
    "/generate requests shed with 429 + Retry-After by admission "
    "control, by reason (active_streams, engine_queue, "
    "engine_overloaded, fault_injected).",
    ("reason",),
)
ACTIVE_STREAMS = _REG.gauge(
    "genai_server_active_streams",
    "SSE generation streams currently in flight on the chain-server.",
)
DEADLINE_EXCEEDED = _REG.counter(
    "genai_server_deadline_exceeded_total",
    "Requests whose deadline budget ran out, by stage (admission, "
    "stream).",
    ("stage",),
)

JSON_TYPE = "application/json; charset=utf-8"


def json_response(body, status: int = 200, default=None) -> Response:
    data = json.dumps(body, default=default).encode("utf-8")
    return status, {"Content-Type": JSON_TYPE}, data


# --------------------------------------------------------------------------- #
# Request accounting (JAX's metrics_middleware)


def request_started() -> float:
    """Count a request in flight; returns its start time."""
    HTTP_IN_FLIGHT.inc()
    return time.time()


def request_finished(route: str, method: str, status: int, start: float,
                     span=None) -> None:
    """Count a finished request under its route pattern (``unmatched``
    for a path no route serves); the request span's trace id, when there
    is one, is the latency sample's exemplar."""
    HTTP_IN_FLIGHT.dec()
    HTTP_REQUESTS.labels(route=route, method=method, status=str(status)).inc()
    ctx = getattr(span, "context", None) if span is not None else None
    HTTP_LATENCY.labels(route=route).observe(
        time.time() - start,
        trace_id=f"{ctx.trace_id:032x}" if ctx is not None else None,
    )


# --------------------------------------------------------------------------- #
# Handlers


def metrics_handler(headers: Mapping[str, str]) -> Response:
    """GET /metrics — Prometheus/OpenMetrics exposition of the registry."""
    registry = metrics_mod.get_registry()
    if "application/openmetrics-text" in (headers.get("Accept") or ""):
        return (200, {"Content-Type": metrics_mod.CONTENT_TYPE_OPENMETRICS},
                registry.render(openmetrics=True).encode("utf-8"))
    return (200, {"Content-Type": metrics_mod.CONTENT_TYPE_LATEST},
            registry.render().encode("utf-8"))


def _engine():
    from generativeaiexamples_tpu_torch.engine import llm_engine

    return llm_engine._ENGINE  # peek only: a scrape never builds an engine


def internal_metrics_handler() -> Response:
    """GET /internal/metrics — the JSON view over the registry, with the
    live engine's flat metrics and JAX's averages."""
    eng = _engine()
    out: dict = {"engine": None}
    if eng is not None:
        m = dict(eng.metrics)
        out["engine"] = m
        if m.get("ttft_n"):
            out["ttft_avg_s"] = m["ttft_sum"] / m["ttft_n"]
            out["prefill_wait_avg_s"] = m.get("prefill_wait_sum", 0.0) / m["ttft_n"]
        if m.get("queue_wait_n"):
            out["queue_wait_avg_s"] = m["queue_wait_sum"] / m["queue_wait_n"]
    out["metrics"] = metrics_mod.get_registry().collect()
    return json_response(out)


def _q(query: Mapping[str, list], key: str) -> Optional[str]:
    values = query.get(key)
    return values[0] if values else None


def internal_requests_handler(query: Mapping[str, list]) -> Response:
    """GET /internal/requests — in-flight timelines plus the newest
    completed and slow summaries; ``?trace=`` (full timelines of one W3C
    trace id, 400 on a malformed one) and ``?since=`` (the incremental
    tail, 400 on a non-integer cursor) as in JAX."""
    try:
        limit = int(_q(query, "limit") or "50")
    except ValueError:
        limit = 50
    slow_only = (_q(query, "slow") or "") in ("1", "true", "yes")
    trace_raw = _q(query, "trace")
    if trace_raw is not None:
        trace_id = trace_stitch.normalize_trace_id(trace_raw)
        if trace_id is None:
            return json_response(
                {"detail": f"?trace must be a 32-hex W3C trace id, got {trace_raw!r}"}, 400)
        return json_response({
            "enabled": flight_recorder.enabled(),
            "trace_id": trace_id,
            "timelines": flight_recorder.timelines_for_trace(trace_id),
        })
    since_raw = _q(query, "since")
    if since_raw is not None:
        try:
            since = int(since_raw)
        except ValueError:
            return json_response(
                {"detail": f"?since must be an integer cursor, got {since_raw!r}"}, 400)
        timelines, cur = flight_recorder.completed_since(since, slow=slow_only, limit=limit)
        return json_response({"enabled": flight_recorder.enabled(), "cursor": cur,
                              "timelines": timelines})
    out = {
        "enabled": flight_recorder.enabled(),
        "cursor": flight_recorder.cursor(),
        "slow": flight_recorder.slow_captures(limit),
    }
    if not slow_only:
        out["in_flight"] = flight_recorder.inflight()
        out["recent"] = flight_recorder.recent(limit)
    return json_response(out)


def internal_request_detail_handler(key: str) -> Response:
    """GET /internal/requests/{id} — one timeline by request id or rid."""
    timeline = flight_recorder.get_timeline(key)
    if timeline is None:
        return json_response({"detail": f"no timeline for request {key!r}"}, 404)
    return json_response(timeline)


def internal_timeline_handler(query: Mapping[str, list]) -> Response:
    """GET /internal/timeline — the dispatch-timeline ring (``?since=``
    cursor, 400 on a non-integer one; ``?limit=``, default 500) with the
    bubble decomposition, or with ``?format=perfetto`` a Chrome trace
    whose device track, given ``?trace=<path of a torch.profiler Chrome
    trace>``, holds the trace's measured kernel spans (none where the
    file is missing)."""
    try:
        limit = int(_q(query, "limit") or "500")
    except ValueError:
        limit = 500
    since_raw = _q(query, "since")
    since = 0
    if since_raw is not None:
        try:
            since = int(since_raw)
        except ValueError:
            return json_response(
                {"detail": f"?since must be an integer cursor, got {since_raw!r}"}, 400)
    spans, cur = dispatch_timeline.spans_since(since, limit=limit)
    if _q(query, "format") == "perfetto":
        device_events: list = []
        trace_path = _q(query, "trace")
        if trace_path:
            try:
                device_events = device_trace.device_track_events(trace_path)
            except (FileNotFoundError, ValueError):
                device_events = []  # no readable capture: the host tracks serve
        trace = dispatch_timeline.perfetto_trace(
            spans, flight=flight_recorder.recent_timelines(limit=32),
            device_events=device_events,
        )
        trace["cursor"] = cur
        trace["enabled"] = dispatch_timeline.enabled()
        return json_response(trace)
    return json_response({
        "enabled": dispatch_timeline.enabled(),
        "cursor": cur,
        "spans": spans,
        "bubble": dispatch_timeline.bubble_snapshot(),
    })


def internal_slo_handler() -> Response:
    """GET /internal/slo — the SLO evaluation plus the live engine's
    utilization snapshot (None without one)."""
    out = slo_mod.summary()
    eng = _engine()
    out["utilization"] = eng.utilization_snapshot() if eng is not None else None
    return json_response(out)


def profile_start_handler(body: bytes) -> Response:
    """POST /internal/profile/start — begin a capture; an optional JSON
    body ``{"log_dir": "..."}`` overrides PROFILE_LOG_DIR."""
    log_dir = None
    if body:
        try:
            log_dir = json.loads(body).get("log_dir") or None
        except Exception:  # noqa: BLE001 - an empty or invalid body means defaults
            pass
    status, payload = profiling.start_profile(log_dir)
    return json_response(payload, status)


def profile_stop_handler() -> Response:
    """POST /internal/profile/stop — end the active capture."""
    status, payload = profiling.stop_profile()
    return json_response(payload, status)


def debug_bundles_handler() -> Response:
    """GET /internal/debug/bundles — the black box's capture index."""
    return json_response({"enabled": blackbox.enabled(), "bundles": blackbox.list_bundles()})


def debug_bundle_detail_handler(bundle_id: str) -> Response:
    """GET /internal/debug/bundles/{id} — one bundle's full content."""
    bundle = blackbox.get_bundle(bundle_id)
    if bundle is None:
        return json_response({"detail": f"no black-box bundle {bundle_id!r}"}, 404)
    return json_response(bundle, default=str)


# --------------------------------------------------------------------------- #
# Routing


def _routes() -> Tuple[Tuple[str, str, "re.Pattern", Callable], ...]:
    def detail(fn):
        return lambda m, req: fn(urllib.parse.unquote(m.group(1)))

    return (
        ("GET", "/metrics", re.compile(r"/metrics"),
         lambda m, req: metrics_handler(req["headers"])),
        ("GET", "/internal/metrics", re.compile(r"/internal/metrics"),
         lambda m, req: internal_metrics_handler()),
        ("POST", "/internal/profile/start", re.compile(r"/internal/profile/start"),
         lambda m, req: profile_start_handler(req["body"]())),
        ("POST", "/internal/profile/stop", re.compile(r"/internal/profile/stop"),
         lambda m, req: profile_stop_handler()),
        ("GET", "/internal/requests", re.compile(r"/internal/requests"),
         lambda m, req: internal_requests_handler(req["query"])),
        ("GET", "/internal/requests/{id}", re.compile(r"/internal/requests/([^/]+)"),
         detail(internal_request_detail_handler)),
        ("GET", "/internal/timeline", re.compile(r"/internal/timeline"),
         lambda m, req: internal_timeline_handler(req["query"])),
        ("GET", "/internal/slo", re.compile(r"/internal/slo"),
         lambda m, req: internal_slo_handler()),
        ("GET", "/internal/debug/bundles", re.compile(r"/internal/debug/bundles"),
         lambda m, req: debug_bundles_handler()),
        ("GET", "/internal/debug/bundles/{id}", re.compile(r"/internal/debug/bundles/([^/]+)"),
         detail(debug_bundle_detail_handler)),
    )


ROUTES = _routes()
#: the (method, route pattern) pairs this module serves
ROUTE_TABLE = tuple((method, pattern) for method, pattern, _, _ in ROUTES)


def match(method: str, path: str):
    """``(pattern, handler, match)`` of the route serving ``(method,
    path)``, or None."""
    for m, pattern, rx, fn in ROUTES:
        if m == method:
            hit = rx.fullmatch(path)
            if hit:
                return pattern, fn, hit
    return None


def paths_served(path: str):
    """The methods some route here serves ``path`` with (for a 405)."""
    return [m for m, _, rx, _ in ROUTES if rx.fullmatch(path)]


def dispatch(method: str, target: str, headers: Mapping[str, str],
             read_body: Callable[[], bytes]) -> Optional[Tuple[str, Response]]:
    """Serve ``method target`` when it is an observability route:
    ``(route pattern, response)``, else None. ``read_body`` is called
    only by the routes that take a body."""
    url = urllib.parse.urlsplit(target)
    hit = match(method, url.path)
    if hit is None:
        return None
    pattern, fn, m = hit
    req = {"headers": headers, "query": urllib.parse.parse_qs(url.query, keep_blank_values=True), "body": read_body}
    return pattern, fn(m, req)
