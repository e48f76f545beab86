"""The router's reverse proxy (docs/router.md), on the standard library.

Counterpart of generativeaiexamples_tpu/router/app.py, whose aiohttp app
becomes an ``http.server.ThreadingHTTPServer`` (one thread per client
connection, as server/api.py) and whose aiohttp client session becomes
one ``http.client`` connection per upstream attempt. It exposes the
chain server's ``/generate`` + document API and the engine server's
``/v1`` surface unchanged, placing each request on one of N replicas:

1. **tenant admission** (router/tenants.py) — token bucket, max
   inflight, weighted fair share; sheds 429 + Retry-After before a
   byte reaches a replica;
2. **placement** (router/ring.py) — prefix-affinity consistent hash
   over the request's stable content key with bounded-load spill, or
   blind round-robin (switchable at runtime via ``POST
   /internal/policy``);
3. **proxy** — the upstream body is read as it arrives
   (``HTTPResponse.read1``) and each event-stream frame is written to
   the client at once; ``router.read_timeout_s`` is the upstream
   socket's timeout, and a client that goes away closes the upstream
   connection, so the replica's generator aborts its engine request.
   Failures before the first forwarded byte re-place on ring siblings
   within a per-request ``router.retry_budget`` (only the statuses 429,
   502, 503 and 504 retry; a 500 event stream passes through), and
   mid-stream deaths of an **event stream** are bridged instead of
   truncated: a drain terminator (``finish_reason="PREEMPTED"``, never
   forwarded) hands the spooled snapshot to a sibling's
   ``/internal/restore``, a hard death replays the original body —
   either way the sibling re-delivers the transcript and the router
   trims the already-forwarded prefix by ``str`` characters of
   ``choices[0].message.content``, so the client sees one uninterrupted
   stream. A death is what aiohttp reads as one: a socket error, a
   chunked body cut before its last chunk, a read timeout; and, since
   the port's servers end a stream by closing the connection (no
   chunked framing), a close-delimited 200 event stream that ends
   before its ``[DONE]`` frame (or the OpenAI ``data: [DONE]``);
4. **fleet state** — ``GET /internal/fleet`` (ring, health, drain,
   tenants), ``POST /internal/drain/{replica}`` /
   ``/internal/undrain/{replica}`` for rolling restarts.

Ingestion (``POST/DELETE /documents``) broadcasts to every active
replica, one thread each — each replica owns its own vector store, and
retrieval must work wherever placement lands a query. The router process
serves the shared observability routes (server/observability.py) and
evaluates the router's SLO objectives (``slo.configure_router``);
``GET /internal/trace/{trace_id}`` stitches its own hop record with
every replica's ``/internal/requests?trace=`` records
(utils/trace_stitch.py). It holds no CUDA context.
"""
from __future__ import annotations

import http.client
import json
import math
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from generativeaiexamples_tpu_torch.router import metrics as router_metrics
from generativeaiexamples_tpu_torch.router.health import HEALTHY, HealthMonitor
from generativeaiexamples_tpu_torch.router.ring import (
    AffinityPlacer,
    HashRing,
    Placement,
    RoundRobinPlacer,
)
from generativeaiexamples_tpu_torch.router.tenants import (
    TenantGovernor,
    parse_tenants,
)
from generativeaiexamples_tpu_torch.server import observability
from generativeaiexamples_tpu_torch.utils import blackbox
from generativeaiexamples_tpu_torch.utils import flight_recorder
from generativeaiexamples_tpu_torch.utils import slo as slo_mod
from generativeaiexamples_tpu_torch.utils import trace_stitch
from generativeaiexamples_tpu_torch.utils.logging import get_logger
from generativeaiexamples_tpu_torch.utils.resilience import URL_ERRORS
from generativeaiexamples_tpu_torch.utils.tracing import get_tracer

logger = get_logger(__name__)

POLICIES = ("affinity", "round_robin")

QUEUE_DEPTH_HEADER = "X-GenAI-Queue-Depth"
REPLICA_HEADER = "X-GenAI-Replica"
RESTORE_HEADER = "X-GenAI-Restore"
SESSION_HEADER = "X-GenAI-Session"

# Request headers forwarded to replicas (everything else is
# router-local or hop-by-hop).
_FORWARD_HEADERS = (
    "Content-Type",
    "Accept",
    "traceparent",
    "tracestate",
    "Authorization",
    "X-Request-Deadline-Ms",
    "X-GenAI-Tenant",
    SESSION_HEADER,
)
# Response headers forwarded back to the client.
_RESPONSE_HEADERS = ("Content-Type", "Retry-After", QUEUE_DEPTH_HEADER)

# Upstream signals that are safe to retry on a sibling when no bytes
# were forwarded: infra-ish failures, NOT application 500s (the
# chain-server's degraded 500 event-stream is a legitimate response
# that must pass through, and retrying a deterministic app error just
# duplicates work).
_RETRYABLE_STATUSES = (429, 502, 503, 504)

_CORS = {"Access-Control-Allow-Origin": "*", "Access-Control-Allow-Methods": "*",
         "Access-Control-Allow-Headers": "*"}
MAX_BODY = 512 * 1024 * 1024
_READ_SIZE = 64 * 1024

#: ``(status, headers, body)`` of a reply that is not streamed
Response = observability.Response
json_response = observability.json_response


# --------------------------------------------------------------------------- #
# SSE handover bridge (docs/router.md "Mid-stream handover"). The
# router re-frames only ``text/event-stream`` bodies — everything else
# is forwarded byte-for-byte and cannot be bridged mid-stream.


def _parse_frame(frame: bytes) -> Optional[Dict[str, Any]]:
    """``data: {json}`` SSE frame -> dict, or None for anything the
    bridge should pass through untouched (comments, non-JSON)."""
    line = frame.strip()
    if not line.startswith(b"data: "):
        return None
    try:
        doc = json.loads(line[len(b"data: "):].decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def _frame_content(doc: Dict[str, Any]) -> str:
    choices = doc.get("choices") or []
    if not choices or not isinstance(choices[0], dict):
        return ""
    message = choices[0].get("message")
    content = message.get("content") if isinstance(message, dict) else None
    return content if isinstance(content, str) else ""


def _frame_finish(doc: Dict[str, Any]) -> str:
    choices = doc.get("choices") or []
    if not choices or not isinstance(choices[0], dict):
        return ""
    return choices[0].get("finish_reason") or ""


def _frame_snapshot_id(doc: Dict[str, Any]) -> str:
    """The snapshot id a PREEMPTED terminator advertises (empty =
    replay-only preemption: nothing was spoolable)."""
    for warning in doc.get("warnings") or []:
        if isinstance(warning, str) and "snapshot_id=" in warning:
            return warning.split("snapshot_id=", 1)[1].strip()
    return ""


def _encode_frame(doc: Dict[str, Any]) -> bytes:
    return b"data: " + json.dumps(doc).encode("utf-8") + b"\n\n"


class _ClientGone(Exception):
    """The client closed its connection while the router wrote to it."""


class _ProxyState:
    """State shared across the failover attempts of ONE proxied
    request: whether the client response is committed (headers go out
    once), the count of answer characters already forwarded — which is
    the trim offset a continuation must skip, since restore and replay
    both re-deliver the transcript from the start — and the snapshot the
    last drain terminator advertised."""

    __slots__ = (
        "started", "sse", "content_chars", "skip_chars",
        "snapshot_id", "snapshot_replica", "first_byte_seen",
    )

    def __init__(self) -> None:
        self.started = False
        self.sse = False
        self.content_chars = 0
        self.skip_chars = 0
        self.snapshot_id = ""
        self.snapshot_replica = ""
        self.first_byte_seen = False


def validate_config(cfg) -> None:
    """Validate the ``router`` config section (pure host; router
    startup). Replica URLs may instead arrive via the CLI, so an empty
    ``replicas`` is legal here and checked at construction."""
    r = cfg.router if hasattr(cfg, "router") else cfg
    if r.policy not in POLICIES:
        raise ValueError(f"router.policy must be one of {POLICIES}, got {r.policy!r}")
    if r.ring_vnodes <= 0:
        raise ValueError(f"router.ring_vnodes must be > 0, got {r.ring_vnodes}")
    if r.load_bound < 0:
        raise ValueError(
            f"router.load_bound must be >= 0 (0 disables), got {r.load_bound}"
        )
    if r.load_bound and r.load_bound < 1.0:
        raise ValueError(
            f"router.load_bound must be >= 1 (a bound under fair share "
            f"saturates every replica), got {r.load_bound}"
        )
    if r.spill_queue_depth < 0:
        raise ValueError(
            f"router.spill_queue_depth must be >= 0 (0 disables), "
            f"got {r.spill_queue_depth}"
        )
    for field in ("failover_retry", "health_slo_gate"):
        if getattr(r, field) not in ("on", "off"):
            raise ValueError(
                f"router.{field} must be on|off, got {getattr(r, field)!r}"
            )
    if r.retry_budget < 0:
        raise ValueError(
            f"router.retry_budget must be >= 0 (0 disables re-placement "
            f"even with failover_retry=on), got {r.retry_budget}"
        )
    if r.health_interval_s <= 0:
        raise ValueError(
            f"router.health_interval_s must be > 0, got {r.health_interval_s}"
        )
    for field in ("health_fail_threshold", "health_ok_threshold"):
        if getattr(r, field) < 1:
            raise ValueError(
                f"router.{field} must be >= 1, got {getattr(r, field)}"
            )
    if r.max_inflight < 0:
        raise ValueError(
            f"router.max_inflight must be >= 0 (0 disables), got {r.max_inflight}"
        )
    for field in ("connect_timeout_s", "read_timeout_s"):
        if getattr(r, field) <= 0:
            raise ValueError(
                f"router.{field} must be > 0, got {getattr(r, field)}"
            )
    # Empty replicas is legal (CLI --replica flags may supply them);
    # every non-empty entry must be a base URL, caught here instead of
    # as a connect error on the first proxied request.
    for url in (r.replicas or "").split(","):
        url = url.strip()
        if url and "://" not in url:
            raise ValueError(
                f"router.replicas entry {url!r} must be a base URL "
                f"(http://host:port)"
            )
    parse_tenants(r.tenants)  # raises ValueError with the bad fragment


def placement_key(headers, body: Any) -> str:
    """The request's stable prefix identity — what the engine's radix
    cache will key reuse on. An explicit ``X-GenAI-Session`` header
    wins; otherwise the FIRST message's content (constant as a
    conversation's history grows, and identical for repeated
    questions, which co-locates their cached full-prompt entries); a
    bare completion prompt uses its own head."""
    session = headers.get(SESSION_HEADER, "").strip()
    if session:
        return session
    if isinstance(body, dict):
        messages = body.get("messages")
        if isinstance(messages, list) and messages:
            first = messages[0]
            content = first.get("content") if isinstance(first, dict) else None
            if isinstance(content, str) and content:
                return content
        # prompt: /v1/completions; query: /search; input: /v1/embeddings
        # — content-keyed so a fleet spreads retrieval/embedding load
        # by request identity instead of pinning it all on the single
        # replica that owns a constant fallback key.
        for field in ("prompt", "query", "input"):
            value = body.get(field)
            if isinstance(value, list) and value:
                value = value[0]
            if isinstance(value, str) and value:
                return value[:512]
    return "anon"


def _run_all(fn: Callable, items: List[tuple], name: str) -> None:
    """``fn(*item)`` for every item, one daemon thread each, joined."""
    threads = [threading.Thread(target=fn, args=item, name=name, daemon=True)
               for item in items]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


# (method, route pattern, path regex, RouterServer handler); a handler takes
# the request handler and the path match and answers a Response, or None
# once it has streamed its answer
_ROUTES = tuple((m, p, re.compile(rx), fn) for m, p, rx, fn in (
    ("GET", "/health", r"/health", "health"),
    ("GET", "/internal/ready", r"/internal/ready", "ready"),
    ("GET", "/internal/fleet", r"/internal/fleet", "fleet"),
    ("POST", "/internal/drain/{replica}", r"/internal/drain/([^{}/]+)", "drain"),
    ("POST", "/internal/undrain/{replica}", r"/internal/undrain/([^{}/]+)", "undrain"),
    ("POST", "/internal/policy", r"/internal/policy", "set_policy"),
    ("GET", "/internal/trace/{trace_id}", r"/internal/trace/([^{}/]+)", "stitched_trace"),
    ("POST", "/generate", r"/generate", "generate"),
    ("POST", "/search", r"/search", "search"),
    ("POST", "/documents", r"/documents", "documents_broadcast"),
    ("DELETE", "/documents", r"/documents", "documents_broadcast"),
    ("GET", "/documents", r"/documents", "documents_get"),
    # OpenAI facade passthrough (engine-server replicas).
    ("GET", "/v1/models", r"/v1/models", "v1_get"),
    ("GET", "/v1/health/ready", r"/v1/health/ready", "v1_get"),
    ("POST", "/v1/chat/completions", r"/v1/chat/completions", "v1_generate"),
    ("POST", "/v1/completions", r"/v1/completions", "v1_generate"),
    ("POST", "/v1/embeddings", r"/v1/embeddings", "v1_embeddings"),
))
#: the (method, route pattern) pairs the router serves: its own, then the
#: shared observability routes (server/observability.py)
ROUTE_TABLE = (tuple((m, p) for m, p, _, _ in _ROUTES)
               + tuple(observability.ROUTE_TABLE))


class RouterServer:
    """Owns the fleet state and builds the HTTP server."""

    def __init__(self, config, replica_urls: Optional[List[str]] = None):
        rcfg = config.router
        urls = replica_urls or [
            u.strip() for u in rcfg.replicas.split(",") if u.strip()
        ]
        if not urls:
            raise ValueError(
                "router needs at least one replica URL "
                "(router.replicas / APP_ROUTER_REPLICAS / --replica)"
            )
        self._rcfg = rcfg
        self.replicas: Dict[str, str] = {
            f"r{i}": url.rstrip("/") for i, url in enumerate(urls)
        }
        self.ring = HashRing(self.replicas, vnodes=rcfg.ring_vnodes)
        self.monitor = HealthMonitor(
            self.replicas,
            interval_s=rcfg.health_interval_s,
            fail_threshold=rcfg.health_fail_threshold,
            ok_threshold=rcfg.health_ok_threshold,
            slo_gate=rcfg.health_slo_gate == "on",
            on_state_change=self._on_state_change,
        )
        self.governor = TenantGovernor(
            parse_tenants(rcfg.tenants), total_inflight_cap=rcfg.max_inflight
        )
        self.policy = rcfg.policy
        self._affinity = AffinityPlacer(self.ring, saturated=self._saturated)
        self._round_robin = RoundRobinPlacer()
        self._failover_enabled = rcfg.failover_retry == "on"
        # Per-request re-placement budget (docs/router.md).
        self._retry_budget = max(0, int(rcfg.retry_budget))
        for rid in self.replicas:
            self._set_state_gauge(rid)
            router_metrics.REPLICA_INFLIGHT.labels(replica=rid).set(0)

    # ------------------------------------------------------------------ #
    # placement plumbing

    def _on_state_change(self, replica_id: str, new_state: str) -> None:
        self._set_state_gauge(replica_id)

    def _set_state_gauge(self, replica_id: str) -> None:
        snap = self.monitor.snapshot().get(replica_id)
        if snap is None:
            return
        if snap["draining"]:
            value = 2.0
        elif snap["state"] == HEALTHY:
            value = 1.0
        else:
            value = 0.0
        router_metrics.REPLICA_STATE.labels(replica=replica_id).set(value)

    def _saturated(self, replica_id: str) -> bool:
        """Bounded-load predicate for spill: last-seen engine queue
        depth, then router-side inflight vs. the c-bounded fair share."""
        depth_cap = self._rcfg.spill_queue_depth
        if depth_cap > 0 and self.monitor.queue_depth(replica_id) >= depth_cap:
            return True
        c = self._rcfg.load_bound
        if c > 0:
            n = max(1, len(self.monitor.placeable()))
            total = self.monitor.total_inflight()
            bound = math.ceil(c * (total + 1) / n)
            if self.monitor.inflight(replica_id) + 1 > bound:
                return True
        return False

    def _place(self, key: str) -> Placement:
        eligible = self.monitor.placeable()
        if self.policy == "round_robin":
            placement = self._round_robin.place(key, eligible)
        else:
            placement = self._affinity.place(key, eligible)
        router_metrics.PLACEMENTS.labels(
            policy=self.policy, outcome=placement.outcome
        ).inc()
        return placement

    def _failover_target(self, key: str, tried: set) -> Optional[str]:
        eligible = set(self.monitor.placeable()) - tried
        if not eligible:
            return None
        for replica in self.ring.walk(key):
            if replica in eligible:
                return replica
        return sorted(eligible)[0]

    # ------------------------------------------------------------------ #
    # server assembly

    def build_server(self, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
        """A bound, not yet serving, HTTP server over this router
        (``port=0`` picks a free port, ``server_address``); starts the
        health poller, as JAX's app does on startup. :meth:`stop` stops
        the poller."""
        handler = type("Handler", (_Handler,), {"router": self})
        server = ThreadingHTTPServer((host, port), handler)
        server.daemon_threads = True
        self.monitor.start()
        return server

    def stop(self) -> None:
        self.monitor.stop()

    # ------------------------------------------------------------------ #
    # control plane

    def health(self, h=None, m=None) -> Response:
        return json_response({"message": "Service is up."})

    def ready(self, h=None, m=None) -> Response:
        placeable = self.monitor.placeable()
        return json_response(
            {"ready": bool(placeable), "placeable": sorted(placeable)},
            status=200 if placeable else 503,
        )

    def fleet(self, h=None, m=None) -> Response:
        return json_response(
            {
                "policy": self.policy,
                "replicas": self.monitor.snapshot(),
                "placeable": sorted(self.monitor.placeable()),
                "ring": {
                    "vnodes": self.ring.vnodes,
                    "members": sorted(self.ring.members()),
                },
                "tenants": self.governor.snapshot(),
            }
        )

    def drain(self, h, m) -> Response:
        return self._set_drain(m.group(1), True)

    def undrain(self, h, m) -> Response:
        return self._set_drain(m.group(1), False)

    def _set_drain(self, token: str, draining: bool) -> Response:
        token = urllib.parse.unquote(token)
        rid = self.monitor.resolve(token)
        if rid is None:
            return json_response({"detail": f"unknown replica {token!r}"}, status=404)
        if draining:
            self.monitor.drain(rid)
        else:
            self.monitor.undrain(rid)
        self._set_state_gauge(rid)
        return json_response(
            {"replica": rid, "draining": draining,
             "inflight": self.monitor.inflight(rid)}
        )

    def stitched_trace(self, h, m) -> Response:
        """GET /internal/trace/{trace_id} — ONE merged end-to-end
        timeline for a trace: the router's own hop record (placement,
        spill, failover, first-byte) interleaved with every replica's
        engine-phase events, ordered by wall time
        (utils/trace_stitch.py). Fans out to each replica's
        ``/internal/requests?trace=`` filter; a replica that is down or
        predates the filter simply contributes nothing."""
        trace_id = trace_stitch.normalize_trace_id(urllib.parse.unquote(m.group(1)))
        if trace_id is None:
            return json_response(
                {"detail": "trace id must be 32 hex chars (W3C "
                           "trace-context)"},
                status=400,
            )
        sources: List[Tuple[str, Dict[str, Any]]] = [
            ("router", tl)
            for tl in flight_recorder.timelines_for_trace(trace_id)
        ]
        lock = threading.Lock()

        def _fetch(rid: str, base: str) -> None:
            got = self._get_json(base, f"/internal/requests?trace={trace_id}")
            if got is None or got[0] != 200 or not isinstance(got[1], dict):
                return
            with lock:
                for tl in got[1].get("timelines") or []:
                    sources.append((rid, tl))

        _run_all(_fetch, [(rid, info["url"]) for rid, info in self.monitor.snapshot().items()],
                 "router-trace-fanout")
        merged = trace_stitch.merge_timelines(sources)
        if merged is None:
            return json_response(
                {"detail": f"no timelines for trace {trace_id!r} on the "
                           f"router or any replica"},
                status=404,
            )
        return json_response(merged)

    def set_policy(self, h, m) -> Response:
        """Runtime policy switch (the bench A/B flips this between
        passes instead of rebooting the fleet)."""
        try:
            policy = json.loads(h.body())["policy"]
        except Exception:  # noqa: BLE001
            return json_response({"detail": "body must be {\"policy\": ...}"}, status=422)
        if policy not in POLICIES:
            return json_response({"detail": f"policy must be one of {POLICIES}"}, status=422)
        self.policy = policy
        return json_response({"policy": policy})

    # ------------------------------------------------------------------ #
    # upstream connections

    def _connect(self, base: str) -> Tuple[http.client.HTTPConnection, str]:
        """A connected upstream connection to ``base`` (connect within
        ``connect_timeout_s``, then ``read_timeout_s`` on the socket) and
        the base's path prefix."""
        url = urllib.parse.urlsplit(base)
        cls = http.client.HTTPSConnection if url.scheme == "https" else http.client.HTTPConnection
        conn = cls(url.hostname, url.port, timeout=self._rcfg.connect_timeout_s)
        try:
            conn.connect()
            conn.sock.settimeout(self._rcfg.read_timeout_s)
        except BaseException:
            conn.close()
            raise
        return conn, url.path.rstrip("/")

    def _request(self, base: str, method: str, path: str, body: Optional[bytes],
                 headers: Dict[str, str]):
        """``(connection, response)`` of one upstream request; the caller
        closes the connection."""
        conn, prefix = self._connect(base)
        try:
            conn.request(method, prefix + path, body=body, headers=headers)
            return conn, conn.getresponse()
        except BaseException:
            conn.close()
            raise

    def _get_json(self, base: str, path: str) -> Optional[Tuple[int, Any]]:
        """(status, JSON body) of a GET, or None when unreachable or the
        body is no JSON."""
        try:
            conn, upstream = self._request(base, "GET", path, None, {})
            try:
                return upstream.status, json.loads(upstream.read())
            finally:
                conn.close()
        except URL_ERRORS + (ValueError,):
            return None

    # ------------------------------------------------------------------ #
    # data plane

    def _forward_headers(self, headers) -> Dict[str, str]:
        out = {}
        for name in _FORWARD_HEADERS:
            value = headers.get(name)
            if value is not None:
                out[name] = value
        return out

    def _note_response(self, replica_id: str, upstream) -> None:
        depth = upstream.getheader(QUEUE_DEPTH_HEADER)
        if depth is not None:
            try:
                self.monitor.note_queue_depth(replica_id, int(depth))
                router_metrics.REPLICA_QUEUE_DEPTH.labels(
                    replica=replica_id
                ).set(float(int(depth)))
            except ValueError:
                pass

    def _shed(self, reason: str, retry_after_s: float, rec=None) -> Response:
        router_metrics.SHEDS.labels(reason=reason).inc()
        blackbox.notify_shed(reason)
        if rec is not None:
            rec.event("shed", reason=reason)
            flight_recorder.finish(rec, "shed")
        status, headers, body = json_response(
            {"detail": f"router shed ({reason}); retry later"}, status=429)
        headers["Retry-After"] = str(max(1, int(math.ceil(retry_after_s))))
        return status, headers, body

    def generate(self, h: "_Handler", m=None) -> Optional[Response]:
        return self._routed_stream(h, h.url.path)

    v1_generate = generate

    def _routed_stream(self, h: "_Handler", path: str) -> Optional[Response]:
        """Tenant admission + placement + streaming proxy with budgeted
        failover, shared by /generate, /search and the /v1 generation
        endpoints."""
        t0 = time.monotonic()
        raw = h.body()
        try:
            body = json.loads(raw) if raw else None
        except ValueError:
            body = None
        span = h.trace_span
        trace_ctx = getattr(span, "context", None) if span is not None else None
        rec = flight_recorder.start(
            trace_id=f"{trace_ctx.trace_id:032x}" if trace_ctx is not None else None,
            owner="router",
        )
        tenant = self.governor.resolve(h.headers)
        shed = self.governor.admit(tenant)
        if shed is not None:
            if rec is not None:
                rec.event("tenant", tenant=tenant)
            return self._shed(shed.reason, shed.retry_after_s, rec)
        try:
            key = placement_key(h.headers, body)
            placement = self._place(key)
            if placement.replica is None:
                router_metrics.SHEDS.labels(reason="no_replica").inc()
                if rec is not None:
                    rec.event("shed", reason="no_replica")
                    flight_recorder.finish(rec, "no_replica")
                return json_response({"detail": "no healthy replica available"}, status=503)
            if rec is not None:
                rec.event(
                    "placement",
                    replica=placement.replica,
                    outcome=placement.outcome,
                    policy=self.policy,
                    tenant=tenant,
                )
            try:
                resp = self._proxy_with_failover(h, path, raw, key, placement, rec, t0)
            except BaseException:
                # Client disconnect or post-first-byte upstream death:
                # the record must still retire, or it leaks in the
                # recorder's live table forever.
                if rec is not None:
                    rec.event("proxy_aborted")
                flight_recorder.finish(rec, "aborted")
                raise
            flight_recorder.finish(rec)
            return resp
        finally:
            self.governor.release(tenant)

    def _proxy_with_failover(self, h: "_Handler", path: str, raw: bytes, key: str,
                             placement: Placement, rec, t0: float) -> Optional[Response]:
        """Budgeted re-placement: up to ``1 + router.retry_budget``
        upstream attempts. Pre-byte failures retry with the original
        body; mid-stream deaths of an event stream continue on a sibling
        — through ``/internal/restore`` when a drain terminator
        advertised a snapshot, replaying the original body otherwise —
        with the already-forwarded prefix trimmed by character offset.
        None once the answer was streamed."""
        replica = placement.replica
        assert replica is not None
        headers = self._forward_headers(h.headers)
        tried: set = set()
        state = _ProxyState()
        attempts = 1 + (self._retry_budget if self._failover_enabled else 0)
        overhead_observed = False
        outcome, reason = "retry", None
        for attempt in range(attempts):
            # Only treat a retryable upstream status as retryable when a
            # sibling actually exists: with one placeable replica a 429
            # shed must pass through WITH its Retry-After/queue-depth
            # headers, not collapse into a generic 502.
            allow_retry = (
                attempt + 1 < attempts
                and self._failover_target(key, tried | {replica}) is not None
            )
            if not overhead_observed:
                overhead = time.monotonic() - t0
                router_metrics.PROXY_OVERHEAD.observe(overhead)
                slo_mod.observe_latency("proxy_overhead_p95", overhead)
                overhead_observed = True
            send_path, send_raw, send_headers = path, raw, headers
            if state.snapshot_id and attempt > 0:
                # Graceful handover: relay the spooled snapshot from the
                # draining (still-serving) replica into the sibling's
                # restore endpoint; fall back to replaying the original
                # body when the spool is unreachable.
                doc = self._fetch_snapshot(state.snapshot_replica, state.snapshot_id)
                if doc is not None:
                    send_path = "/internal/restore"
                    send_raw = json.dumps(doc).encode("utf-8")
                    send_headers = dict(headers)
                    send_headers["Content-Type"] = "application/json"
                    send_headers[RESTORE_HEADER] = state.snapshot_id
                elif rec is not None:
                    rec.event(
                        "restore_fallback", snapshot=state.snapshot_id,
                        reason="spool_unreachable",
                    )
            outcome, reason = self._attempt_stream(
                h, replica, send_path, send_raw, send_headers, allow_retry, rec, state,
            )
            if outcome == "complete":
                slo_mod.observe_event("proxied")
                if rec is not None:
                    rec.event("proxied", replica=replica, status=h.status)
                return None
            tried.add(replica)
            if outcome == "handover":
                # Restore and replay both re-deliver the transcript
                # from the start: trim everything already forwarded.
                state.skip_chars = state.content_chars
                if reason != "preempted":
                    # Hard death / refused continuation: the spool (if
                    # any) is unreachable — replay the original prompt.
                    state.snapshot_id = ""
                    state.snapshot_replica = ""
            sibling = self._failover_target(key, tried)
            if sibling is None or attempt + 1 >= attempts:
                break
            router_metrics.FAILOVERS.labels(reason=reason or "error").inc()
            slo_mod.observe_event("failover")
            if rec is not None:
                rec.event(
                    "failover", from_replica=replica, to_replica=sibling,
                    reason=reason or "error",
                )
            logger.warning("failover %s -> %s (%s) for %s", replica, sibling, reason, path)
            replica = sibling
        router_metrics.RETRY_BUDGET_EXHAUSTED.inc()
        if rec is not None:
            rec.event("upstream_failed", replica=replica, reason=reason or "error")
        if state.started:
            # The stream is committed: tokens cannot be un-sent, and no
            # sibling (or budget) is left to continue it — surface the
            # truncation by closing without a [DONE] terminator.
            logger.error(
                "upstream %s failed mid-stream on %s with the retry "
                "budget spent (%s)", replica, path, reason or "error",
            )
            return None
        return json_response(
            {"detail": f"upstream replica failed ({reason or 'error'})"}, status=502
        )

    def _fetch_snapshot(self, replica_id: str, snapshot_id: str) -> Optional[Dict[str, Any]]:
        """GET the spooled snapshot document off the draining replica
        (quiesced but still serving — the graceful-kill window).
        Returns None when unreachable; the caller replays from the
        original prompt instead, so the handover never depends on the
        dying process."""
        base = self.monitor.url_of(replica_id)
        if not snapshot_id or base is None:
            return None
        got = self._get_json(base, f"/internal/snapshots/{snapshot_id}")
        if got is None or got[0] != 200:
            return None
        return got[1] if isinstance(got[1], dict) else None

    def _attempt_stream(self, h: "_Handler", replica_id: str, path: str, raw: bytes,
                        headers: Dict[str, str], allow_retry: bool, rec,
                        state: _ProxyState) -> Tuple[str, Optional[str]]:
        """One upstream attempt against ``replica_id``. Returns
        ``(outcome, reason)``:

        - ``("complete", None)`` — the client was answered (including
          forwarded error statuses);
        - ``("retry", reason)`` — ZERO bytes forwarded; the caller may
          retry a sibling with the same body;
        - ``("handover", reason)`` — the committed event stream needs a
          continuation: a drain terminator was intercepted
          (``reason="preempted"``, snapshot noted on ``state``), the
          upstream died mid-stream (``"replica_died"``), or a
          continuation upstream refused (``"http_<status>"``).

        Raises :class:`_ClientGone` when the client goes away; the
        upstream connection is closed on every way out.
        """
        base = self.monitor.url_of(replica_id)
        if base is None:
            return "retry", "error"
        self.monitor.begin_request(replica_id)
        router_metrics.REPLICA_INFLIGHT.labels(replica=replica_id).set(
            float(self.monitor.inflight(replica_id))
        )
        conn = None
        try:
            conn, upstream = self._request(base, "POST", path, raw, headers)
            self._note_response(replica_id, upstream)
            restored_ack = upstream.getheader(RESTORE_HEADER)
            if restored_ack and rec is not None:
                # The sibling's restore ack ("<snapshot_id>;
                # mode=restore|replay"): whether the handover resumed
                # token-identically or degraded to prompt replay.
                rec.event("restore", replica=replica_id, ack=restored_ack)
            if not state.started:
                if allow_retry and upstream.status in _RETRYABLE_STATUSES:
                    return "retry", "overload" if upstream.status == 429 else "error"
                resp_headers = {
                    name: upstream.getheader(name)
                    for name in _RESPONSE_HEADERS
                    if upstream.getheader(name) is not None
                }
                resp_headers[REPLICA_HEADER] = replica_id
                resp_headers["Access-Control-Allow-Origin"] = "*"
                state.sse = "text/event-stream" in (upstream.getheader("Content-Type") or "")
                h.start_stream(upstream.status, resp_headers)
                state.started = True
            elif upstream.status != 200:
                # Continuation refused (fingerprint 409, sibling
                # draining 503): never bridge an error body into the
                # committed stream — the caller falls back to replaying
                # the original prompt elsewhere.
                return "handover", f"http_{upstream.status}"
            if not state.sse:
                # Byte-for-byte passthrough (JSON bodies): no frame
                # accounting, no mid-stream bridge.
                while True:
                    chunk = upstream.read1(_READ_SIZE)
                    if not chunk:
                        return "complete", None
                    if rec is not None and not state.first_byte_seen:
                        state.first_byte_seen = True
                        rec.event("first_byte", replica=replica_id)
                    h.write(chunk)
            # A body that ends by closing: its end is no proof of a
            # complete stream (the port's servers), unlike a chunked one.
            close_delimited = not upstream.chunked and upstream.length is None
            terminated = False
            buffer = b""
            while True:
                chunk = upstream.read1(_READ_SIZE)
                if not chunk:
                    break
                if rec is not None and not state.first_byte_seen:
                    # The stitched-trace hop marker: everything before
                    # this is router+replica latency the client had no
                    # byte to show for.
                    state.first_byte_seen = True
                    rec.event("first_byte", replica=replica_id)
                buffer += chunk
                while b"\n\n" in buffer:
                    frame, buffer = buffer.split(b"\n\n", 1)
                    frame += b"\n\n"
                    doc = _parse_frame(frame)
                    if doc is None:
                        terminated = terminated or frame.strip() == b"data: [DONE]"
                        h.write(frame)
                        continue
                    if _frame_finish(doc) == "PREEMPTED":
                        # Drain terminator: intercepted, never forwarded
                        # — the handover continues this stream on a
                        # sibling.
                        state.snapshot_id = _frame_snapshot_id(doc)
                        state.snapshot_replica = replica_id
                        return "handover", "preempted"
                    content = _frame_content(doc)
                    if content and state.skip_chars:
                        # Continuation re-delivering the transcript:
                        # drop what the client already has.
                        drop = min(state.skip_chars, len(content))
                        state.skip_chars -= drop
                        content = content[drop:]
                        doc["choices"][0]["message"]["content"] = content
                        if (
                            not content
                            and not _frame_finish(doc)
                            and not doc.get("warnings")
                        ):
                            continue
                        frame = _encode_frame(doc)
                    state.content_chars += len(content)
                    h.write(frame)
                    if _frame_finish(doc) == "[DONE]":
                        return "complete", None
            if close_delimited and upstream.status == 200 and not terminated:
                raise http.client.IncompleteRead(buffer)
            if buffer:
                h.write(buffer)
            return "complete", None
        except URL_ERRORS as exc:
            self.monitor.note_failure(replica_id, f"{type(exc).__name__}: {exc}")
            if not state.started:
                return "retry", "error"
            if state.sse:
                logger.error(
                    "upstream %s died mid-stream on %s: %s — attempting "
                    "handover", replica_id, path, exc,
                )
                return "handover", "replica_died"
            # Committed non-SSE body: nothing to bridge — surface the
            # truncation by closing the stream.
            logger.error("upstream %s failed mid-stream on %s: %s", replica_id, path, exc)
            raise
        finally:
            if conn is not None:
                conn.close()
            self.monitor.end_request(replica_id)
            router_metrics.REPLICA_INFLIGHT.labels(replica=replica_id).set(
                float(self.monitor.inflight(replica_id))
            )

    # ------------------------------------------------------------------ #
    # retrieval/document surface

    def search(self, h: "_Handler", m=None) -> Optional[Response]:
        """Proxy /search to any placeable replica (stores converge via
        broadcast ingest, so any replica can answer)."""
        return self._routed_stream(h, h.url.path)

    v1_embeddings = search

    def v1_get(self, h: "_Handler", m=None) -> Response:
        """Proxy a GET endpoint to the first placeable replica."""
        placeable = sorted(self.monitor.placeable())
        if not placeable:
            return json_response({"detail": "no healthy replica available"}, status=503)
        rid = placeable[0]
        base = self.monitor.url_of(rid)
        try:
            conn, upstream = self._request(
                base, "GET", h.url.path, None, self._forward_headers(h.headers))
            try:
                body = upstream.read()
            finally:
                conn.close()
        except URL_ERRORS as exc:
            self.monitor.note_failure(rid, f"{type(exc).__name__}: {exc}")
            return json_response({"detail": "upstream replica failed"}, status=502)
        ctype = (upstream.getheader("Content-Type") or "application/octet-stream")
        return upstream.status, {"Content-Type": ctype.split(";")[0].strip(),
                                 REPLICA_HEADER: rid}, body

    documents_get = v1_get

    def documents_broadcast(self, h: "_Handler", m=None) -> Response:
        """POST/DELETE /documents to EVERY active replica (draining
        replicas included — they may re-enter placement after the
        restart and must not miss corpus updates), one thread each. 200
        only when every replica accepted (the body is the first
        replica's, by id, plus the per-replica statuses); per-replica
        statuses otherwise."""
        raw = h.body()
        headers = self._forward_headers(h.headers)
        targets = [
            (rid, info["url"])
            for rid, info in self.monitor.snapshot().items()
            if info["state"] == HEALTHY or info["draining"]
        ]
        if not targets:
            return json_response({"detail": "no healthy replica available"}, status=503)
        results: Dict[str, Dict[str, Any]] = {}

        def _send(rid: str, base: str) -> None:
            try:
                conn, upstream = self._request(base, h.command, h.path, raw, headers)
                try:
                    body_text = upstream.read().decode("utf-8", errors="replace")
                finally:
                    conn.close()
                try:
                    payload = json.loads(body_text)
                except ValueError:
                    payload = {"raw": body_text[:512]}
                results[rid] = {"status": upstream.status, "body": payload}
            except URL_ERRORS as exc:
                self.monitor.note_failure(rid, f"{type(exc).__name__}: {exc}")
                results[rid] = {"status": 0, "body": {"error": str(exc)}}

        _run_all(_send, targets, "router-broadcast")
        ok = all(r["status"] == 200 for r in results.values())
        if ok:
            first = results[sorted(results)[0]]
            body = dict(first["body"]) if isinstance(first["body"], dict) else {}
            body["replicas"] = {rid: r["status"] for rid, r in sorted(results.items())}
            return json_response(body, status=200)
        return json_response(
            {
                "message": "ingest fan-out failed on at least one replica",
                "replicas": dict(sorted(results.items())),
            },
            status=500,
        )


class _Handler(BaseHTTPRequestHandler):
    """One client connection of the router (the JAX app's middlewares:
    the request span, the route accounting, CORS)."""

    server_version = "genai-torch-router/1"
    protocol_version = "HTTP/1.1"
    router: RouterServer  # set on the subclass build_server makes
    trace_span = None  # the request's span (set per request)
    status = 500  # the status sent, for the request accounting
    url = None  # the request target, split
    _raw: Optional[bytes] = None  # the request body, once read
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
    def reply(self, resp: Response) -> None:
        status, headers, body = resp
        self.status = status
        self.count_request()
        self.send_response(status)
        for name, value in {**headers, **_CORS}.items():
            self.send_header(name, value)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.write(body)

    def start_stream(self, status: int, headers: Dict[str, str]) -> None:
        """Commit a streamed answer: its end is the connection's close."""
        self.send_response(status)
        for name, value in headers.items():
            self.send_header(name, value)
        self.send_header("Connection", "close")
        self.close_connection = True
        try:
            self.end_headers()
        except OSError as exc:
            raise _ClientGone() from exc

    def write(self, data: bytes) -> None:
        try:
            self.wfile.write(data)
            self.wfile.flush()
        except OSError as exc:
            raise _ClientGone() from exc

    # -- input ---------------------------------------------------------- #
    def body(self) -> bytes:
        if self._raw is None:
            n = int(self.headers.get("Content-Length", "0") or 0)
            if n > MAX_BODY:
                self.close_connection = True
                raise ValueError("request body too large")
            self._raw = self.rfile.read(n) if n > 0 else b""
        return self._raw

    # -- routing -------------------------------------------------------- #
    def _route(self, method: str) -> None:
        tracer = get_tracer()
        self.url = urllib.parse.urlsplit(self.path)
        self._raw = None
        span = tracer.start_span(
            f"{method} {self.url.path}", remote_ctx=tracer.extract(self.headers),
            attributes={"http.method": method, "http.target": self.url.path},
        )
        self.trace_span, self.status, self.route = span, 500, "unmatched"
        self._accounting = (method, observability.request_started())
        try:
            self._serve(method)
            if self._raw is None and method != "GET":
                self.body()  # a body nobody read must not be parsed as the next request
        except _ClientGone:
            logger.info("client disconnected from %s %s", method, self.url.path)
            self.close_connection = True
        except URL_ERRORS as exc:  # a committed byte stream's upstream failed
            span.record_exception(exc)
            self.close_connection = True
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            span.set_attribute("http.status_code", self.status)
            if self.status >= 500:
                span.status = "ERROR"
            tracer.finish_span(span, system_metrics=True)
            self.count_request()

    def _serve(self, method: str) -> None:
        """Serve the request, its route pattern in ``self.route`` before
        any reply goes out."""
        if method == "OPTIONS":
            self.reply((204, {}, b""))
            return
        path = self.url.path
        for m, pattern, rx, fn in _ROUTES:
            if m != method:
                continue
            hit = rx.fullmatch(path)
            if hit:
                self.route = pattern
                try:
                    result = getattr(self.router, fn)(self, hit)
                except ValueError as exc:  # an oversized body
                    result = json_response({"detail": str(exc)}, status=413)
                if result is not None:
                    self.reply(result)
                return
        hit = observability.dispatch(method, self.path, self.headers, self.body)
        if hit is not None:
            self.route, resp = hit
            self.reply(resp)
            return
        allowed = ([m for m, _, rx, _ in _ROUTES if rx.fullmatch(path)]
                   or observability.paths_served(path))
        if allowed:
            self.reply((405, {"Content-Type": "text/plain; charset=utf-8",
                              "Allow": ",".join(allowed)}, b"405: Method Not Allowed"))
        else:
            self.reply((404, {"Content-Type": "text/plain; charset=utf-8"}, b"404: Not Found"))

    def do_GET(self):  # noqa: N802 - http.server's naming
        self._route("GET")

    def do_POST(self):  # noqa: N802
        self._route("POST")

    def do_DELETE(self):  # noqa: N802
        self._route("DELETE")

    def do_OPTIONS(self):  # noqa: N802
        self._route("OPTIONS")


def create_router(config=None, replica_urls: Optional[List[str]] = None) -> RouterServer:
    """Build the router (config validated loudly at startup, the two
    servers' pattern: the router section, then the observability
    sections), with the observability sections configured as the servers
    configure them but for the SLO tracker, which holds the router's own
    objectives (JAX's ``create_router_app``)."""
    from generativeaiexamples_tpu_torch import config_validate

    if config is None:
        from generativeaiexamples_tpu_torch.config import get_config

        config = get_config()
    validate_config(config)
    config_validate.validate_observability(config)
    config_validate.configure_observability(config)
    slo_mod.configure_router(config)
    return RouterServer(config, replica_urls=replica_urls)
