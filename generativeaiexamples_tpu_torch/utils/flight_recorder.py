"""Per-request flight recorder: a bounded, lock-light ring buffer of
request lifecycle events.

Counterpart of generativeaiexamples_tpu/utils/flight_recorder.py: the
same ``EVENT_CATALOG`` key for key, rings, cursor and views, over the
port's own metrics registry.

Histograms answer "how slow are requests"; nothing in the stack could
answer "why was request X slow". The flight recorder closes that gap:
every layer that touches a request appends cheap timestamped events to
one per-request timeline — submit, admission/shed, prefix-cache match,
prefill-chunk dispatches, decode-wave join/leave, spec draft/accept
counts, batcher coalescing, retry/degrade, abort/finish — keyed by the
request's trace id and engine rid, and the server exposes them at
``GET /internal/requests`` (in-flight + recent summaries) and
``GET /internal/requests/{id}`` (full timeline).

Design constraints, in priority order:

- **near-zero cost disabled**: every public entry point starts with one
  module-global boolean read and returns;
- **lock-light enabled**: events append to a per-record Python list
  (GIL-atomic); the module lock guards only record registration,
  retirement, and the rid→record map — touched once per request phase,
  never per token;
- **whole-timeline eviction**: completed records rotate through a
  bounded ``deque(maxlen=...)``, so eviction drops an entire timeline —
  ``/internal/requests`` can never serve a partial one;
- **slow-request capture**: when a finished request's TTFT or total
  latency crosses the configured thresholds, its full timeline is
  written as one JSONL line (``capture_path``) and kept in a separate
  slow ring; the server additionally attaches the timeline as span
  events when tracing is active.

Ownership: a record created by the server (``start()`` bound to the
request thread) is retired by the server; a record the engine creates
for a bare ``submit()`` (bench, tests, facade) is retired when the
engine request finishes. One server record may span several engine
rids (e.g. query decomposition) — engine completion only unmaps the
rid and stamps an event on server-owned records.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

__all__ = [
    "EVENT_CATALOG",
    "RequestRecord",
    "enabled",
    "configure",
    "start",
    "bind",
    "unbind",
    "current",
    "event",
    "map_rid",
    "event_rid",
    "record_for_rid",
    "finish",
    "finish_rid",
    "inflight",
    "recent",
    "cursor",
    "completed_since",
    "get_timeline",
    "timelines_for_trace",
    "recent_timelines",
    "annotate_inflight",
    "emitted_kinds",
    "reset",
]

# --------------------------------------------------------------------------- #
# Flight-event catalog: THE module-level registry of every event kind
# any layer may append to a timeline. The vocabulary grew organically
# across PRs 6-11 with no drift guard; now the ``flight-events`` lint
# rule (tools/genai_lint/rules/flight_events.py) fails when a call site
# emits a kind missing from this dict, and when a catalog entry is
# missing from docs/observability.md's event table — so the catalog,
# the emitting code, and the operator docs can never silently diverge.
# Runtime emission also records every kind seen (``emitted_kinds()``)
# for introspection/tests.

EVENT_CATALOG: Dict[str, str] = {
    # server (chain-server /generate admission + streaming)
    "http_request": "server opened a /generate record",
    "admitted": "admission control accepted the request",
    "shed": "admission shed the request (429); attrs carry the reason",
    "deadline_exceeded": "deadline budget blown (stage=admission|stream)",
    # engine scheduling chain
    "submit": "request entered the engine admission queue",
    "admit": "slot claimed (attrs carry the measured queue_wait_s)",
    "engine_overloaded": "submit rejected by the queue-depth cap",
    "prefix_match": "radix prefix-cache hit at admission",
    "prefill_wave": "admission wave dispatched",
    "prefill_chunk": "one fixed-shape chunked-prefill dispatch",
    "decode_join": "request joined the decode batch",
    "decode_leave": "decode slot released",
    "first_token": "first generated token reached the reader",
    "spec_verify": "speculative verify dispatch (drafted/accepted/"
    "spec_proposer attrs)",
    "draft_prefill": "resident draft model prefilled a request's prompt "
    "into the draft KV cache at admission (spec_proposer attr)",
    "tier_assign": "scheduler policy assigned the request to an "
    "execution tier (disagg: tier=prefill at wave claim, tier=decode "
    "at handoff import)",
    "kv_handoff": "prefill tier handed the request's KV pages to the "
    "decode tier through the transfer queue (pages/bytes attrs)",
    "handoff_backpressure": "prefill tier stalled on a full "
    "prefill→decode transfer queue before claiming its next wave",
    "abort": "request aborted before completion",
    # preemption / drain lifecycle (engine/request_snapshot.py,
    # LLMEngine.drain/restore_snapshot — docs/resilience.md)
    "drain_begin": "engine drain started (pending/slotted counts)",
    "drain_complete": "engine drain finished (preempted/spooled counts)",
    "engine_draining": "submit refused: engine is draining",
    "preempt": "in-flight request checkpointed at drain (mode=restore|"
    "replay, snapshot/position/generated attrs)",
    "restore": "request re-admitted from a snapshot (mode=restore|"
    "replay, snapshot/position/emitted attrs)",
    "finish": "record retired (attrs carry the outcome)",
    "engine_finish": "engine rid completed on a server-owned record",
    # paged KV cache
    "page_alloc": "page reservation funded at admission",
    "page_free": "request's pages returned to the pool",
    "page_backpressure": "admission requeued by pool OOM backpressure",
    "prefix_pages_mapped": "prefix hit mapped shared pages zero-copy",
    "paged_kernel_fallback": "page kernel refused; XLA gather serves",
    # chains / retrieval / batcher / resilience
    "retrieve": "chain retrieval call (duration_s attr)",
    "retrieval_tier_wave": "retrieval tier served one batched "
    "embed→search→rerank wave (rows/dispatches/window_wait_s attrs)",
    "retrieval_tier_backpressure": "submitter stalled on a full "
    "retrieval transfer queue before enqueueing",
    "degraded": "chain answered LLM-only after a retrieval failure",
    "batcher_coalesced": "item served by a coalesced batch dispatch",
    "retry": "resilience layer retried a dependency call",
    "breaker_open": "circuit breaker rejected the call while open",
    # router hops (router/app.py)
    "tenant": "tenant admission resolved the account",
    "placement": "replica chosen (policy/outcome attrs)",
    "proxied": "upstream answered; response committed to the client",
    "first_byte": "first upstream body byte forwarded to the client",
    "failover": "re-placement onto a ring sibling (budgeted by "
    "router.retry_budget; from_replica/to_replica attrs)",
    "restore_fallback": "handover could not relay the advertised "
    "snapshot (spool unreachable) — replaying the original prompt",
    "upstream_failed": "every eligible upstream failed (502)",
    "proxy_aborted": "client disconnect / post-first-byte upstream death",
    # observability plane
    "hot_path_compile": "a compiled-program build landed AFTER warmup "
    "completion (stamped on every in-flight timeline it stalled)",
    "blackbox_capture": "anomaly black box captured a debug bundle",
}

_REG = metrics_mod.get_registry()
_M_EVENTS = _REG.counter(
    "genai_flight_recorder_events_total",
    "Lifecycle events appended to flight-recorder timelines.",
)
_M_DROPPED = _REG.counter(
    "genai_flight_recorder_dropped_events_total",
    "Events dropped because a timeline hit its per-record event cap.",
)
_M_SLOW = _REG.counter(
    "genai_flight_recorder_slow_captures_total",
    "Requests whose TTFT or total latency crossed the slow-capture "
    "thresholds and had their full timeline exported.",
)
_M_INFLIGHT = _REG.gauge(
    "genai_flight_recorder_inflight_requests",
    "Request timelines currently open in the flight recorder.",
)

# Hard cap on events per timeline: a pathological request (thousands of
# spec dispatches) must not grow without bound; the drop is counted and
# flagged on the record.
EVENT_CAP = 256

# --------------------------------------------------------------------------- #
# Module configuration (defaults keep the recorder ON with in-memory
# rings only — the bench and bare-engine paths need no config object).
# GENAI_FLIGHT_RECORDER=off is the process-level kill switch for
# entrypoints that never load an AppConfig (bench A/B runs, tools).

_ENABLED = os.environ.get("GENAI_FLIGHT_RECORDER", "on").lower() not in (
    "0", "off", "false", "no"
)
_DEFAULT_CAPACITY = 256
_DEFAULT_SLOW_CAPACITY = 64
_CAPACITY = _DEFAULT_CAPACITY          # completed-timeline ring
_SLOW_CAPACITY = _DEFAULT_SLOW_CAPACITY  # slow-capture ring
_SLOW_TTFT_S = 0.0       # 0 disables the TTFT trigger
_SLOW_TOTAL_S = 0.0      # 0 disables the total-latency trigger
_CAPTURE_PATH = ""       # JSONL export target; "" keeps captures in-memory

_LOCK = threading.Lock()
_LIVE: Dict[str, "RequestRecord"] = {}  # guarded by _LOCK
_BY_RID: Dict[int, "RequestRecord"] = {}  # guarded by _LOCK
_RECENT: Deque["RequestRecord"] = deque(maxlen=_CAPACITY)  # guarded by _LOCK
_SLOW: Deque["RequestRecord"] = deque(maxlen=_SLOW_CAPACITY)  # guarded by _LOCK
# Monotonic completion cursor: every retired record gets the next value,
# so pollers (the loadgen's telemetry tail) can fetch "everything that
# finished since my last scrape" instead of re-reading the whole ring.
# Process-lifetime monotonic; reset() (tests only) rewinds it.
_SEQ = 0  # guarded by _LOCK
_TLS = threading.local()
# Every event kind actually emitted this process (set.add is
# GIL-atomic; read via emitted_kinds()). Introspection next to the
# declared EVENT_CATALOG — tests assert emitted ⊆ declared.
_EMITTED_KINDS: set = set()


class RequestRecord:
    """One request's timeline. Event appends are list.append on the
    record (GIL-atomic); registration/retirement go through the module
    lock."""

    __slots__ = (
        "request_id", "trace_id", "owner", "rids", "seq",
        "t_wall", "t_start", "t_first_token", "t_finish",
        "events", "dropped", "done", "outcome", "slow", "captured",
    )

    def __init__(self, request_id: str, trace_id: Optional[str], owner: str):
        self.request_id = request_id
        self.trace_id = trace_id
        self.owner = owner  # "server" | "engine"
        self.seq = 0  # completion cursor position; assigned at finish()
        self.rids: List[int] = []
        self.t_wall = time.time()
        self.t_start = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.events: List[tuple] = []
        self.dropped = 0
        self.done = False
        self.outcome: Optional[str] = None
        self.slow = False
        self.captured = False

    # -- event API ------------------------------------------------------- #
    def event(self, name: str, **attrs: Any) -> None:
        _EMITTED_KINDS.add(name)
        if len(self.events) >= EVENT_CAP:
            self.dropped += 1
            _M_DROPPED.inc()
            return
        self.events.append(
            (time.monotonic() - self.t_start, name, attrs or None)
        )
        _M_EVENTS.inc()
        if name == "first_token" and self.t_first_token is None:
            self.t_first_token = time.monotonic()

    # -- derived timings -------------------------------------------------- #
    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_start

    @property
    def total_s(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return self.t_finish - self.t_start

    # -- views ------------------------------------------------------------ #
    def summary(self) -> Dict[str, Any]:
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "seq": self.seq,
            "rids": list(self.rids),
            "started_at": self.t_wall,
            "events": len(self.events),
            "dropped_events": self.dropped,
            "done": self.done,
            "outcome": self.outcome,
            "ttft_s": round(self.ttft_s, 6) if self.ttft_s is not None else None,
            "total_s": round(self.total_s, 6) if self.total_s is not None else None,
            "slow": self.slow,
        }

    def timeline(self) -> Dict[str, Any]:
        out = self.summary()
        out["timeline"] = [
            {"t_s": round(t, 6), "event": name, **(attrs or {})}
            for t, name, attrs in list(self.events)
        ]
        return out


# --------------------------------------------------------------------------- #
# Configuration


def enabled() -> bool:
    return _ENABLED


def configure(
    enable: Optional[bool] = None,
    capacity: Optional[int] = None,
    slow_capacity: Optional[int] = None,
    slow_ttft_ms: Optional[float] = None,
    slow_total_ms: Optional[float] = None,
    capture_path: Optional[str] = None,
) -> None:
    """Apply config-derived knobs (the server calls this at startup with
    the ``observability`` section; tests call it directly). Resizing the
    rings preserves the newest entries."""
    global _ENABLED, _CAPACITY, _SLOW_CAPACITY
    global _SLOW_TTFT_S, _SLOW_TOTAL_S, _CAPTURE_PATH, _RECENT, _SLOW
    with _LOCK:
        if enable is not None:
            _ENABLED = bool(enable)
        if capacity is not None and int(capacity) != _CAPACITY:
            _CAPACITY = max(1, int(capacity))
            _RECENT = deque(_RECENT, maxlen=_CAPACITY)
        if slow_capacity is not None and int(slow_capacity) != _SLOW_CAPACITY:
            _SLOW_CAPACITY = max(1, int(slow_capacity))
            _SLOW = deque(_SLOW, maxlen=_SLOW_CAPACITY)
        if slow_ttft_ms is not None:
            _SLOW_TTFT_S = max(0.0, float(slow_ttft_ms)) / 1000.0
        if slow_total_ms is not None:
            _SLOW_TOTAL_S = max(0.0, float(slow_total_ms)) / 1000.0
        if capture_path is not None:
            _CAPTURE_PATH = str(capture_path)


def validate_config(cfg) -> None:
    """Validate the observability config section (pure host; raises
    ValueError with the same phrasing as the other section checks)."""
    o = cfg.observability if hasattr(cfg, "observability") else cfg
    if o.flight_recorder_enable not in ("on", "off"):
        raise ValueError(
            f"observability.flight_recorder_enable must be on|off, got "
            f"{o.flight_recorder_enable!r}"
        )
    if o.flight_recorder_capacity < 1:
        raise ValueError(
            f"observability.flight_recorder_capacity must be >= 1, got "
            f"{o.flight_recorder_capacity}"
        )
    if o.slow_request_ttft_ms < 0:
        raise ValueError(
            f"observability.slow_request_ttft_ms must be >= 0 (0 "
            f"disables), got {o.slow_request_ttft_ms}"
        )
    if o.slow_request_total_ms < 0:
        raise ValueError(
            f"observability.slow_request_total_ms must be >= 0 (0 "
            f"disables), got {o.slow_request_total_ms}"
        )
    if o.slow_capture_path and os.path.isdir(o.slow_capture_path):
        raise ValueError(
            f"observability.slow_capture_path must be a JSONL file "
            f"path, not an existing directory: {o.slow_capture_path!r}"
        )


def configure_from_config(cfg) -> None:
    """Wire the ``observability`` config section into the module knobs
    (called by both servers at startup)."""
    o = cfg.observability if hasattr(cfg, "observability") else cfg
    configure(
        enable=o.flight_recorder_enable != "off",
        capacity=o.flight_recorder_capacity,
        slow_ttft_ms=o.slow_request_ttft_ms,
        slow_total_ms=o.slow_request_total_ms,
        capture_path=o.slow_capture_path,
    )


# --------------------------------------------------------------------------- #
# Record lifecycle


def start(
    trace_id: Optional[str] = None,
    request_id: Optional[str] = None,
    owner: str = "server",
) -> Optional[RequestRecord]:
    """Open a timeline. Returns None when the recorder is disabled so
    call sites can pass the handle around without re-checking."""
    if not _ENABLED:
        return None
    rec = RequestRecord(
        request_id=request_id or uuid.uuid4().hex[:16],
        trace_id=trace_id,
        owner=owner,
    )
    with _LOCK:
        _LIVE[rec.request_id] = rec
        _M_INFLIGHT.set(len(_LIVE))
    return rec


def bind(rec: Optional[RequestRecord]) -> None:
    """Attach ``rec`` to the calling thread (the deadline/tracing
    pattern): downstream layers find it via ``current()``."""
    _TLS.record = rec


def unbind() -> None:
    _TLS.record = None


def current() -> Optional[RequestRecord]:
    if not _ENABLED:
        return None
    return getattr(_TLS, "record", None)


def event(name: str, **attrs: Any) -> None:
    """Append an event to the calling thread's bound record (no-op when
    unbound or disabled)."""
    if not _ENABLED:
        return
    rec = getattr(_TLS, "record", None)
    if rec is not None:
        rec.event(name, **attrs)


def map_rid(rid: int, rec: Optional[RequestRecord]) -> None:
    """Associate an engine request id with a record (at submit)."""
    if not _ENABLED or rec is None:
        return
    with _LOCK:
        _BY_RID[rid] = rec
    rec.rids.append(rid)


def record_for_rid(rid: int) -> Optional[RequestRecord]:
    if not _ENABLED:
        return None
    with _LOCK:
        return _BY_RID.get(rid)


def event_rid(rid: int, name: str, **attrs: Any) -> None:
    """Append an event to the record mapped to an engine rid (engine
    dispatch/reader threads hold no thread-local binding)."""
    if not _ENABLED:
        return
    with _LOCK:
        rec = _BY_RID.get(rid)
    if rec is not None:
        rec.event(name, **attrs)


def finish(rec: Optional[RequestRecord], outcome: str = "finish") -> None:
    """Retire a record into the completed ring (idempotent). Runs the
    slow-request capture check."""
    global _SEQ
    if rec is None or rec.done:
        return
    rec.t_finish = time.monotonic()
    rec.outcome = outcome
    rec.event("finish", outcome=outcome)
    rec.done = True
    with _LOCK:
        _LIVE.pop(rec.request_id, None)
        for rid in rec.rids:
            if _BY_RID.get(rid) is rec:
                _BY_RID.pop(rid, None)
        _SEQ += 1
        rec.seq = _SEQ
        _RECENT.append(rec)
        _M_INFLIGHT.set(len(_LIVE))
    _maybe_capture_slow(rec)


def finish_rid(rid: int, outcome: str = "finish") -> None:
    """Engine-side completion for one rid. Engine-owned records retire
    here; server-owned records only unmap the rid (the server retires
    them after the SSE stream closes)."""
    if not _ENABLED:
        return
    with _LOCK:
        rec = _BY_RID.get(rid)
    if rec is None:
        return
    if rec.owner == "engine":
        finish(rec, outcome=outcome)
        return
    # Server-owned record: stamp the engine completion and unmap the
    # rid only — total latency (and retirement) stay server-owned.
    rec.event("engine_finish", rid=rid, outcome=outcome)
    with _LOCK:
        if _BY_RID.get(rid) is rec:
            _BY_RID.pop(rid, None)


# --------------------------------------------------------------------------- #
# Slow-request capture


def _maybe_capture_slow(rec: RequestRecord) -> None:
    if rec.captured:
        return
    ttft = rec.ttft_s
    total = rec.total_s
    slow = (
        (_SLOW_TTFT_S > 0 and ttft is not None and ttft >= _SLOW_TTFT_S)
        or (_SLOW_TOTAL_S > 0 and total is not None and total >= _SLOW_TOTAL_S)
    )
    if not slow:
        return
    rec.slow = True
    rec.captured = True
    _M_SLOW.inc()
    # JSONL export BEFORE the ring insert: pollers watching the slow
    # ring (tests, dashboards tailing the file on a trigger) must find
    # the exported line the moment the capture is visible.
    if _CAPTURE_PATH:
        try:
            line = json.dumps(rec.timeline(), default=str)
            with open(_CAPTURE_PATH, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")
        except (OSError, TypeError, ValueError):
            pass  # capture is best-effort; never fail the request path
    with _LOCK:
        _SLOW.append(rec)


def attach_span_events(rec: Optional[RequestRecord], span) -> None:
    """Mirror a slow record's timeline onto the request span (called by
    the server when tracing is active), so the Jaeger trace carries the
    same submit→finish chain the JSONL capture does."""
    if rec is None or span is None or not rec.slow:
        return
    for t, name, attrs in list(rec.events):
        payload = {"t_s": round(t, 6)}
        if attrs:
            payload.update({k: str(v) for k, v in attrs.items()})
        span.add_event(f"flight.{name}", payload)


# --------------------------------------------------------------------------- #
# Views (the /internal/requests handlers)


def inflight() -> List[Dict[str, Any]]:
    with _LOCK:
        recs = list(_LIVE.values())
    return [r.summary() for r in sorted(recs, key=lambda r: r.t_start)]


def recent(limit: int = 50) -> List[Dict[str, Any]]:
    if limit <= 0:
        return []  # [-0:] would slice the WHOLE deque, not none of it
    with _LOCK:
        recs = list(_RECENT)[-int(limit):]
    return [r.summary() for r in reversed(recs)]


def slow_captures(limit: int = 20) -> List[Dict[str, Any]]:
    if limit <= 0:
        return []
    with _LOCK:
        recs = list(_SLOW)[-int(limit):]
    return [r.summary() for r in reversed(recs)]


def cursor() -> int:
    """The current completion cursor: the seq of the newest retired
    record (0 before any finish). Pass it back as ``?since=`` to
    receive only records that finished after this call."""
    with _LOCK:
        return _SEQ


def completed_since(
    since: int, slow: bool = False, limit: int = 200
) -> Tuple[List[Dict[str, Any]], int]:
    """Incremental tail of completed timelines: FULL timelines (not
    summaries) for records with ``seq > since``, oldest first, capped
    at ``limit`` (the poller resumes from the returned cursor — the
    newest seq in the process, so a capped page is re-polled, and an
    idle poll returns an unchanged cursor). ``slow=True`` tails the
    slow-capture ring instead of the completed ring.

    Eviction semantics: a record evicted from the ring between polls is
    simply gone — the cursor never points at partial data because
    eviction drops whole timelines."""
    with _LOCK:
        src = _SLOW if slow else _RECENT
        recs = [r for r in src if r.seq > int(since)][: max(0, int(limit))]
        cur = _SEQ
    return [r.timeline() for r in recs], cur


def timelines_for_trace(trace_id: str) -> List[Dict[str, Any]]:
    """FULL timelines for every record carrying ``trace_id`` — live
    records first, then the completed and slow rings (deduplicated; a
    slow record also sits in the completed ring). One trace may map to
    several records on one process (e.g. a /generate record plus bare
    engine submits under the same span), and across processes the same
    trace id names the router hop and the replica serving — the
    ``?trace=`` endpoint filter + ``utils/trace_stitch.py`` merge is
    built on exactly this accessor."""
    with _LOCK:
        seen: List[RequestRecord] = []
        for rec in list(_LIVE.values()) + list(_RECENT) + list(_SLOW):
            if rec.trace_id == trace_id and all(r is not rec for r in seen):
                seen.append(rec)
    return [r.timeline() for r in sorted(seen, key=lambda r: r.t_start)]


def recent_timelines(limit: int = 32) -> List[Dict[str, Any]]:
    """The newest completed FULL timelines, newest first (black-box
    bundles embed these; ``recent()`` serves only summaries)."""
    if limit <= 0:
        return []
    with _LOCK:
        recs = list(_RECENT)[-int(limit):]
    return [r.timeline() for r in reversed(recs)]


def annotate_inflight(name: str, **attrs: Any) -> int:
    """Stamp one event onto EVERY in-flight timeline (returns how many
    were stamped). For process-wide incidents that stall all live
    requests at once — a hot-path XLA compile blocks the dispatch loop,
    a black-box capture marks the window it snapshotted — so each
    affected request's timeline explains its own stall."""
    if not _ENABLED:
        return 0
    with _LOCK:
        recs = list(_LIVE.values())
    for rec in recs:
        rec.event(name, **attrs)
    return len(recs)


def emitted_kinds() -> set:
    """Every event kind emitted so far this process (copy)."""
    return set(_EMITTED_KINDS)


def get_timeline(key: str) -> Optional[Dict[str, Any]]:
    """Full timeline by request id, or by engine rid (decimal string) —
    live records first, then the completed and slow rings."""
    with _LOCK:
        rec = _LIVE.get(key)
        if rec is None and key.isdigit():
            rec = _BY_RID.get(int(key))
        if rec is None:
            rid = int(key) if key.isdigit() else None
            for r in list(_RECENT) + list(_SLOW):
                if r.request_id == key or (rid is not None and rid in r.rids):
                    rec = r
                    break
    return rec.timeline() if rec is not None else None


# --------------------------------------------------------------------------- #
# Test hook


def reset() -> None:
    """Drop every record and restore module defaults (tests)."""
    global _ENABLED, _SLOW_TTFT_S, _SLOW_TOTAL_S, _CAPTURE_PATH, _SEQ
    global _CAPACITY, _SLOW_CAPACITY, _RECENT, _SLOW
    with _LOCK:
        _LIVE.clear()
        _BY_RID.clear()
        _EMITTED_KINDS.clear()
        # Restore default ring capacities too — a test that shrank the
        # ring must not leak its maxlen into the next test's evictions.
        _CAPACITY = _DEFAULT_CAPACITY
        _SLOW_CAPACITY = _DEFAULT_SLOW_CAPACITY
        _RECENT = deque(maxlen=_CAPACITY)
        _SLOW = deque(maxlen=_SLOW_CAPACITY)
        _SEQ = 0
        _ENABLED = True
        _SLOW_TTFT_S = 0.0
        _SLOW_TOTAL_S = 0.0
        _CAPTURE_PATH = ""
        _M_INFLIGHT.set(0)
    _TLS.record = None
