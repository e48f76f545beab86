"""Dispatch timeline profiler: per-launch spans + bubble attribution.

Counterpart of generativeaiexamples_tpu/engine/dispatch_timeline.py: the
same ring, cursor, bubble analyzer, Perfetto export and
``GENAI_DISPATCH_TIMELINE=off`` kill switch. One difference: a span's
host-side run time is a device-time estimate only where the engine runs
on the CPU (the ops run inside the call, as JAX's CPU backend does). On
the card the call returns once its kernels are launched, so there it is
the launch time: such spans carry ``launch_s`` in place of
``device_est_s``, the Perfetto export draws no device-estimate track for
them, and the bubble snapshot names its ``device`` share a launch share
(``bubble_run_kind``). Device time enters only from a ``torch.profiler``
trace (``perfetto_trace(device_events=...)``,
utils/device_trace.py), never from a synchronizing call. The engine sets
the run kind once at init (:func:`set_run_kind`). The port has no
dispatch lock: its spans' lock waits are 0.

compile_watch proves steady state never recompiles and the flight
recorder decomposes a *request's* latency into phases; this module
decomposes the *engine's* wall time. Every compiled-program launch the
engine issues (prefill wave, prefill chunk, decode block, spec verify,
spec-block fallback) already funnels through one choke point — the
``_dispatch_lock`` + ``telemetry.record_dispatch`` pairing — and this
module rides that choke point with a bounded, lock-light ring of
**dispatch spans**: program kind, tier thread, enqueue wall-clock,
dispatch-lock wait, host-side run time (the device-time estimate on
the CPU, the launch time on the card), batch
geometry, attention path, and the rids in the wave. Reader-thread
stalls and disagg handoff backpressure record as their own span
categories, and hot-path compiles overlay as markers.

On top of the ring:

- a **bubble analyzer** decomposing rolling-window engine-active wall
  time into device-busy / lock-contention / host-gap-with-work-queued /
  readback (the four components sum to 1.0 of the windowed active
  wall), exposed as the ``genai_engine_bubble_*`` gauges and the
  ``genai_engine_lock_wait_seconds`` / ``genai_engine_dispatch_gap_seconds``
  distributions, and folded into ``LLMEngine.utilization_snapshot()``;
- ``GET /internal/timeline`` (server/observability.py) serving the ring
  incrementally (``?since=<cursor>``, same contract as
  ``/internal/requests``) and as Chrome-trace JSON
  (``?format=perfetto``): one track per tier thread plus a device
  track, flight-recorder lifecycle events overlaid, joinable to
  stitched router traces by trace id;
- recent span windows embedded in black-box bundles
  (utils/blackbox.py) so an anomaly capture carries the dispatch
  cadence around the incident.

Ring semantics mirror utils/flight_recorder.py: a module-level
monotonic ``seq`` cursor, whole-window eviction (``WINDOW_SPANS`` spans
drop together — a reader never sees a window that lost spans
mid-window), a ``reset()`` test hook, the
``configure``/``validate_config``/``configure_from_config`` trio wired
to the ``observability`` config section, and the
``GENAI_DISPATCH_TIMELINE=off`` process kill switch — the engine
resolves it ONCE at init (the ``annotation_scope`` pattern), so 'off'
restores the exact prior dispatch path.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

__all__ = [
    "enabled",
    "configure",
    "validate_config",
    "configure_from_config",
    "record_span",
    "record_stall",
    "record_readback",
    "record_pipeline_flush",
    "record_rollback",
    "record_compile",
    "cursor",
    "spans_since",
    "recent_spans",
    "bubble_snapshot",
    "counters_snapshot",
    "perfetto_trace",
    "reset",
    "WINDOW_SPANS",
    "MODES",
]

# --------------------------------------------------------------------------- #
# Metrics (registered at import — tools/genai_lint REGISTRY_MODULES)

_REG = metrics_mod.get_registry()
_M_SPANS = _REG.counter(
    "genai_engine_timeline_spans_total",
    "Dispatch-timeline spans recorded, by span kind (dispatch program "
    "kinds plus stall/readback/compile categories).",
    ("kind",),
)
_M_EVICTED = _REG.counter(
    "genai_engine_timeline_evicted_total",
    "Dispatch-timeline spans evicted from the ring (always a whole "
    "span window at a time, oldest first).",
)
_M_LOCK_WAIT = _REG.histogram(
    "genai_engine_lock_wait_seconds",
    "Time a tier thread waited to acquire the engine dispatch lock "
    "before a compiled-program launch, by program kind — the "
    "cross-tier contention half of the bubble decomposition.",
    ("kind",),
    buckets=metrics_mod.FAST_SECONDS_BUCKETS,
)
_M_GAP = _REG.histogram(
    "genai_engine_dispatch_gap_seconds",
    "Host-side gap between a tier thread's consecutive dispatches "
    "while work was queued (scheduling, sampling bookkeeping, "
    "emission) — the host-bubble half of the decomposition.",
    buckets=metrics_mod.FAST_SECONDS_BUCKETS,
)
_M_BUBBLE = _REG.gauge(
    "genai_engine_bubble_ratio",
    "Fraction of rolling-window engine-active wall time NOT spent in "
    "device dispatches (lock contention + host gap + readback).",
)
_M_BUBBLE_COMPONENT = _REG.gauge(
    "genai_engine_bubble_component_ratio",
    "Rolling-window engine-active wall decomposition, by component "
    "(device, lock_contention, host_gap, readback); the four "
    "components sum to 1.0.",
    ("component",),
)
_M_BUBBLE_WINDOW = _REG.gauge(
    "genai_engine_bubble_window_seconds",
    "Engine-active wall time covered by the current bubble-analyzer "
    "rolling window (device + lock + gap + readback seconds).",
)

# --------------------------------------------------------------------------- #
# Module configuration (defaults keep the recorder ON — bare-engine and
# bench paths need no config object). GENAI_DISPATCH_TIMELINE=off is
# the process kill switch for entrypoints that never load an AppConfig;
# the engine reads enabled() ONCE at init, so 'off' leaves the dispatch
# sites byte-for-byte on the prior path.

_ENABLED = os.environ.get("GENAI_DISPATCH_TIMELINE", "on").lower() not in (
    "0", "off", "false", "no"
)

# Eviction granularity: the ring drops this many spans at once, so a
# cursor-tailing reader (or the bubble analyzer) never observes a span
# window missing interior spans — whole-window eviction, the same rule
# the flight recorder applies to whole timelines.
WINDOW_SPANS = 64
_DEFAULT_CAPACITY = 4096
_CAPACITY = _DEFAULT_CAPACITY

# Bubble analyzer rolling window (seconds of wall clock).
_BUBBLE_WINDOW_S = 60.0

# Per-span rid cap: a 96-row wave's ids matter less than its shape.
_RID_CAP = 16

# What a dispatch span's host-side run time measures: "device_est" (the
# engine runs on the CPU) or "launch" (on the card); set_run_kind().
RUN_KINDS = ("device_est", "launch")
_RUN_KIND = "device_est"

_LOCK = threading.Lock()
_SPANS: Deque["Span"] = deque()  # guarded by _LOCK
_SEQ = 0  # guarded by _LOCK; process-lifetime monotonic, reset() rewinds
# Per-thread wall clock of the last span's host return, for gap
# attribution (guarded by _LOCK).
_LAST_RETURN: Dict[str, float] = {}
# Cumulative component seconds (guarded by _LOCK) — the loadgen
# telemetry scraper reads these as run-window deltas via the engine's
# legacy flat `metrics` dict.
_CUM = {
    "spans": 0.0,
    "device": 0.0,
    "lock": 0.0,
    "gap": 0.0,
    "readback": 0.0,
}

# Per-MODE bubble split (guarded by _LOCK): the same four component
# seconds plus a dispatch count, attributed to the serving mode that
# produced the span — so "spec pays its sync on the dispatch thread"
# is a number, not a code comment. A span's mode is classified from
# its kind (spec verifies, their fallback blocks, and the async
# pipeline's flush/rollback spans are 'spec'; plain decode blocks are
# 'decode'; prefill waves/chunks and handoff stalls are 'prefill').
MODES = ("decode", "spec", "prefill", "other")
_CUM_MODE: Dict[str, Dict[str, float]] = {
    m: {"device": 0.0, "lock": 0.0, "gap": 0.0, "readback": 0.0,
        "dispatches": 0.0}
    for m in MODES
}


def _mode_of(kind: str) -> str:
    base = kind.split(":", 1)[1] if kind.startswith("readback:") else kind
    if base.startswith("spec") or base in ("pipeline_flush", "rollback"):
        return "spec"
    if base.startswith("decode"):
        return "decode"
    if base.startswith("prefill") or base.startswith("handoff"):
        return "prefill"
    return "other"


class Span:
    """One recorded launch/stall/readback. Appends are deque.append
    under the module lock; the record itself is immutable after that."""

    __slots__ = (
        "seq", "kind", "category", "thread", "t_wall", "lock_wait_s",
        "run_s", "gap_s", "rows", "tokens", "steps", "path", "rids",
        "run_kind",
    )

    def __init__(self, kind: str, category: str, thread: str,
                 t_wall: float, lock_wait_s: float, run_s: float,
                 gap_s: float, rows: int, tokens: int, steps: int,
                 path: Optional[str], rids: Tuple[int, ...]):
        self.seq = 0  # assigned under _LOCK at record time
        self.kind = kind
        self.category = category  # dispatch | stall | readback | compile
        self.thread = thread
        self.t_wall = t_wall
        self.lock_wait_s = lock_wait_s
        self.run_s = run_s
        self.gap_s = gap_s
        self.rows = rows
        self.tokens = tokens
        self.steps = steps
        self.path = path
        self.rids = rids
        self.run_kind = _RUN_KIND

    @property
    def t_end(self) -> float:
        return self.t_wall + self.lock_wait_s + self.run_s

    def view(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "seq": self.seq,
            "kind": self.kind,
            "category": self.category,
            "thread": self.thread,
            "t_wall": round(self.t_wall, 6),
            "lock_wait_s": round(self.lock_wait_s, 6),
            # the dispatch's host-side run time, named for what it is
            ("launch_s" if self.run_kind == "launch" else "device_est_s"):
                round(self.run_s, 6),
            "gap_s": round(self.gap_s, 6),
            "rows": self.rows,
            "tokens": self.tokens,
            "steps": self.steps,
        }
        if self.path is not None:
            out["path"] = self.path
        if self.rids:
            out["rids"] = list(self.rids)
        return out


# --------------------------------------------------------------------------- #
# Configuration


def enabled() -> bool:
    return _ENABLED


def set_run_kind(kind: str) -> None:
    """What spans recorded from now on measure with their run time:
    ``"device_est"`` (an engine on the CPU) or ``"launch"`` (on the
    card). The engine calls this once at init."""
    global _RUN_KIND
    if kind not in RUN_KINDS:
        raise ValueError(f"run kind must be one of {RUN_KINDS}, got {kind!r}")
    _RUN_KIND = kind


def configure(
    enable: Optional[bool] = None,
    capacity: Optional[int] = None,
) -> None:
    """Apply config-derived knobs (the servers call
    :func:`configure_from_config` at startup; tests call this
    directly). Capacity rounds up to a whole span window so eviction
    granularity never splits one; resizing preserves the newest spans
    in whole windows."""
    global _ENABLED, _CAPACITY
    with _LOCK:
        if enable is not None:
            _ENABLED = bool(enable)
        if capacity is not None:
            cap = max(WINDOW_SPANS, int(capacity))
            cap = ((cap + WINDOW_SPANS - 1) // WINDOW_SPANS) * WINDOW_SPANS
            _CAPACITY = cap
            while len(_SPANS) > _CAPACITY:
                _evict_window_locked()


def validate_config(cfg) -> None:
    """Validate the ``observability`` dispatch-timeline knobs (pure
    host; phrasing matches the other section checks)."""
    o = cfg.observability if hasattr(cfg, "observability") else cfg
    if o.dispatch_timeline_enable not in ("on", "off"):
        raise ValueError(
            f"observability.dispatch_timeline_enable must be on|off, got "
            f"{o.dispatch_timeline_enable!r}"
        )
    if o.dispatch_timeline_capacity < WINDOW_SPANS:
        raise ValueError(
            f"observability.dispatch_timeline_capacity must be >= "
            f"{WINDOW_SPANS} (one whole span window), got "
            f"{o.dispatch_timeline_capacity}"
        )


def configure_from_config(cfg) -> None:
    """Wire the ``observability`` config section into the module knobs
    (called by the servers at startup). The env kill switch wins: a
    process started with GENAI_DISPATCH_TIMELINE=off stays off even
    when the config says 'on' — same precedence as the blackbox."""
    o = cfg.observability if hasattr(cfg, "observability") else cfg
    env_off = os.environ.get("GENAI_DISPATCH_TIMELINE", "on").lower() in (
        "0", "off", "false", "no"
    )
    configure(
        enable=(o.dispatch_timeline_enable != "off") and not env_off,
        capacity=o.dispatch_timeline_capacity,
    )


# --------------------------------------------------------------------------- #
# Recording


def _evict_window_locked() -> None:
    """Drop one whole span window from the ring head. Caller holds
    _LOCK."""
    dropped = 0
    for _ in range(min(WINDOW_SPANS, len(_SPANS))):
        _SPANS.popleft()
        dropped += 1
    if dropped:
        _M_EVICTED.inc(dropped)


def _append(span: Span, observe_gap: bool) -> None:
    global _SEQ
    with _LOCK:
        _SEQ += 1
        span.seq = _SEQ
        if len(_SPANS) >= _CAPACITY:
            _evict_window_locked()
        _SPANS.append(span)
        _CUM["spans"] += 1
        mode = _CUM_MODE[_mode_of(span.kind)]
        if span.category == "dispatch":
            _CUM["device"] += span.run_s
            _CUM["lock"] += span.lock_wait_s
            _CUM["gap"] += span.gap_s
            mode["device"] += span.run_s
            mode["lock"] += span.lock_wait_s
            mode["gap"] += span.gap_s
            mode["dispatches"] += 1
            _LAST_RETURN[span.thread] = span.t_end
        elif span.category == "stall":
            _CUM["gap"] += span.run_s
            mode["gap"] += span.run_s
            _LAST_RETURN[span.thread] = span.t_end
        elif span.category == "readback":
            _CUM["readback"] += span.run_s
            mode["readback"] += span.run_s
    _M_SPANS.labels(kind=span.kind).inc()
    if span.category == "dispatch":
        _M_LOCK_WAIT.labels(kind=span.kind).observe(
            span.lock_wait_s, trace_id=None
        )
        if observe_gap:
            _M_GAP.observe(span.gap_s, trace_id=None)


def record_span(
    kind: str,
    *,
    t_wall: float,
    lock_wait_s: float,
    run_s: float,
    rows: int = 0,
    tokens: int = 0,
    steps: int = 1,
    path: Optional[str] = None,
    rids: Sequence[int] = (),
    queued: bool = True,
) -> None:
    """One compiled-program launch: ``t_wall`` is the enqueue wall
    clock (lock requested), ``lock_wait_s`` the dispatch-lock wait,
    ``run_s`` the host-side time inside the lock (a device-time estimate
    on the CPU; the launch time on the card, where only a profile's
    device track is truth).
    ``queued`` gates gap attribution: the host gap since this thread's
    previous dispatch counts as bubble only when work was available the
    whole time."""
    if not _ENABLED:
        return
    thread = threading.current_thread().name
    gap_s = 0.0
    if queued:
        last = _LAST_RETURN.get(thread)
        if last is not None:
            gap_s = max(0.0, t_wall - last)
    _append(
        Span(
            kind, "dispatch", thread, t_wall, max(0.0, lock_wait_s),
            max(0.0, run_s), gap_s, int(rows), int(tokens),
            max(1, int(steps)), path, tuple(rids)[:_RID_CAP],
        ),
        observe_gap=queued,
    )


def record_stall(
    kind: str, duration_s: float, rids: Sequence[int] = ()
) -> None:
    """A named host stall on a tier thread (disagg handoff
    backpressure, transfer-queue waits): visible as its own span on the
    thread's track and attributed to the host-gap bubble component."""
    if not _ENABLED or duration_s <= 0:
        return
    thread = threading.current_thread().name
    _append(
        Span(
            kind, "stall", thread, time.time() - duration_s, 0.0,
            float(duration_s), 0.0, 0, 0, 1, None,
            tuple(rids)[:_RID_CAP],
        ),
        observe_gap=False,
    )


def record_readback(kind: str, stall_s: float) -> None:
    """A device→host sync stall (reader thread, or the spec paths'
    on-thread syncs), attributed to the readback bubble component."""
    if not _ENABLED or stall_s < 0:
        return
    thread = threading.current_thread().name
    _append(
        Span(
            f"readback:{kind}", "readback", thread,
            time.time() - stall_s, 0.0, float(stall_s), 0.0, 0, 0, 1,
            None, (),
        ),
        observe_gap=False,
    )


def record_pipeline_flush(stall_s: float, rows: int = 0) -> None:
    """The spec pipeline's deferred packed readback landing: the wait
    the dispatch thread actually paid when it finally synced a verify
    dispatched one round earlier (engine/llm_engine.py
    ``_flush_spec_pipeline``). Readback category — it IS the spec
    readback, shrunk by whatever host work overlapped the in-flight
    verify — under its own ``pipeline_flush`` kind so the before/after
    of the async pipeline is visible in the ring, not just the sums."""
    if not _ENABLED or stall_s < 0:
        return
    thread = threading.current_thread().name
    _append(
        Span(
            "pipeline_flush", "readback", thread, time.time() - stall_s,
            0.0, float(stall_s), 0.0, int(rows), 0, 1, None, (),
        ),
        observe_gap=False,
    )


def record_rollback(
    duration_s: float, rows: int = 0, rids: Sequence[int] = ()
) -> None:
    """An optimistic-draft rollback: verify readback contradicted the
    acceptance assumption the runahead draft was proposed under, and
    the dispatch thread re-proposed from the true context. Stall
    category (host-gap bubble) with its own ``rollback`` kind;
    ``rows`` counts the rolled-back rows in the round."""
    if not _ENABLED or duration_s < 0:
        return
    thread = threading.current_thread().name
    _append(
        Span(
            "rollback", "stall", thread, time.time() - duration_s, 0.0,
            float(duration_s), 0.0, int(rows), 0, 1, None,
            tuple(rids)[:_RID_CAP],
        ),
        observe_gap=False,
    )


def record_compile(program: str, seconds: float, hot: bool = False) -> None:
    """A compiled-program build (engine/compile_watch.py) as a timeline
    marker. The build time already lands inside its dispatch span's
    run_s, so compile spans are overlay-only: excluded from the bubble
    sums and from gap bookkeeping."""
    if not _ENABLED:
        return
    thread = threading.current_thread().name
    _append(
        Span(
            ("hot_compile:" if hot else "compile:") + program,
            "compile", thread, time.time() - seconds, 0.0,
            float(seconds), 0.0, 0, 0, 1, None, (),
        ),
        observe_gap=False,
    )


# --------------------------------------------------------------------------- #
# Views


def cursor() -> int:
    """The process span cursor — spans_since(cursor()) returns only
    spans recorded after this call (the scraper-anchor contract shared
    with flight_recorder.cursor())."""
    with _LOCK:
        return _SEQ


def spans_since(since: int, limit: int = 500) -> Tuple[List[Dict], int]:
    """Incremental tail: span views with ``seq > since``, oldest first,
    ``limit``-capped, plus the current cursor. Cursor 0 starts from the
    oldest retained span."""
    with _LOCK:
        out = [s.view() for s in _SPANS if s.seq > since][: int(limit)]
        return out, _SEQ


def recent_spans(limit: int = 256) -> List[Dict]:
    """Newest ``limit`` span views, newest first (the blackbox embed)."""
    with _LOCK:
        spans = list(_SPANS)[-int(limit):]
    return [s.view() for s in reversed(spans)]


def counters_snapshot() -> Dict[str, float]:
    """Cumulative component seconds for the engine's legacy flat
    ``metrics`` dict — the loadgen scraper deltas these over the run
    window to build the gated ``bubble`` summary block."""
    with _LOCK:
        out = {
            "timeline_spans": _CUM["spans"],
            "timeline_device_est_seconds": round(_CUM["device"], 6),
            "timeline_lock_wait_seconds": round(_CUM["lock"], 6),
            "timeline_gap_seconds": round(_CUM["gap"], 6),
            "timeline_readback_stall_seconds": round(_CUM["readback"], 6),
        }
        # Per-mode split (always emitted, zeros included, so scraper
        # deltas never see a key appear mid-run): the mode sums equal
        # the totals above component by component.
        for mode, cum in _CUM_MODE.items():
            out[f"timeline_{mode}_device_est_seconds"] = round(
                cum["device"], 6
            )
            out[f"timeline_{mode}_lock_wait_seconds"] = round(cum["lock"], 6)
            out[f"timeline_{mode}_gap_seconds"] = round(cum["gap"], 6)
            out[f"timeline_{mode}_readback_stall_seconds"] = round(
                cum["readback"], 6
            )
            out[f"timeline_{mode}_dispatches"] = cum["dispatches"]
        return out


def bubble_snapshot(window_s: float = _BUBBLE_WINDOW_S) -> Dict[str, float]:
    """Rolling-window bubble decomposition. The denominator is
    engine-ACTIVE wall (device + lock + gap + readback seconds inside
    the window) — idle-with-no-work time is nobody's bubble — so the
    four component ratios sum to exactly 1.0. Updates the
    genai_engine_bubble_* gauges as a side effect (scrape-time
    freshness, the utilization_snapshot pattern)."""
    horizon = time.time() - window_s
    busy = lock = gap = readback = 0.0
    gaps: List[float] = []
    mode_active = {m: 0.0 for m in MODES}
    n = 0
    with _LOCK:
        for s in _SPANS:
            if s.t_end < horizon or s.category == "compile":
                continue
            n += 1
            if s.category == "dispatch":
                busy += s.run_s
                lock += s.lock_wait_s
                gap += s.gap_s
                gaps.append(s.gap_s)
                mode_active[_mode_of(s.kind)] += (
                    s.run_s + s.lock_wait_s + s.gap_s
                )
            elif s.category == "stall":
                gap += s.run_s
                mode_active[_mode_of(s.kind)] += s.run_s
            elif s.category == "readback":
                readback += s.run_s
                mode_active[_mode_of(s.kind)] += s.run_s
    active = busy + lock + gap + readback
    if active <= 0:
        return {"bubble_spans_in_window": 0}
    ratio = lambda x: round(x / active, 4)  # noqa: E731
    gap_p95 = 0.0
    if gaps:
        ordered = sorted(gaps)
        gap_p95 = ordered[
            min(len(ordered) - 1, max(0, int(round(0.95 * (len(ordered) - 1)))))
        ]
    out = {
        "bubble_ratio": ratio(active - busy),
        "bubble_device_ratio": ratio(busy),
        "bubble_lock_ratio": ratio(lock),
        "bubble_gap_ratio": ratio(gap),
        "bubble_readback_ratio": ratio(readback),
        "bubble_window_s": round(active, 4),
        "bubble_gap_p95_s": round(gap_p95, 6),
        "bubble_spans_in_window": n,
    }
    # Per-mode share of the active wall (all categories attributed to
    # the mode whose span produced them) — zero-activity modes are
    # omitted, the present ones sum to ~1.0 like the components do.
    for mode, secs in mode_active.items():
        if secs > 0:
            out[f"bubble_mode_{mode}_ratio"] = ratio(secs)
    if _RUN_KIND == "launch":
        # on the card the device share is the host's launch share
        out["bubble_run_kind"] = "launch"
    _M_BUBBLE.set(out["bubble_ratio"])
    _M_BUBBLE_COMPONENT.labels(component="device").set(out["bubble_device_ratio"])
    _M_BUBBLE_COMPONENT.labels(component="lock_contention").set(
        out["bubble_lock_ratio"]
    )
    _M_BUBBLE_COMPONENT.labels(component="host_gap").set(out["bubble_gap_ratio"])
    _M_BUBBLE_COMPONENT.labels(component="readback").set(
        out["bubble_readback_ratio"]
    )
    _M_BUBBLE_WINDOW.set(out["bubble_window_s"])
    return out


# --------------------------------------------------------------------------- #
# Perfetto (Chrome trace JSON) export

_PID_HOST = 1
_PID_DEVICE_EST = 2
_PID_DEVICE_TRACE = 3
_TID_REQUESTS = 1_000_000  # flight-recorder overlay track


def perfetto_trace(
    spans: Sequence[Dict],
    flight: Sequence[Dict] = (),
    device_events: Sequence[Dict] = (),
) -> Dict[str, Any]:
    """Chrome-trace JSON over span VIEWS (spans_since/recent_spans
    output): one track per tier thread on the host process, a device
    track (host-return estimates of CPU-engine spans; replaced by the
    measured kernel spans of a torch.profiler trace when
    ``device_events`` is given; launch spans of a card engine draw none),
    and flight-recorder request
    lifecycles overlaid as instants carrying their trace ids — the join
    key to stitched router traces. Timestamps are absolute wall-clock
    microseconds, so traces from co-scraped processes align."""
    events: List[Dict[str, Any]] = [
        {"ph": "M", "pid": _PID_HOST, "name": "process_name",
         "args": {"name": "genai-engine host"}},
        {"ph": "M", "pid": _PID_HOST, "tid": _TID_REQUESTS,
         "name": "thread_name", "args": {"name": "requests"}},
    ]
    tids: Dict[str, int] = {}

    def tid_for(thread: str) -> int:
        tid = tids.get(thread)
        if tid is None:
            tid = tids[thread] = len(tids) + 1
            events.append(
                {"ph": "M", "pid": _PID_HOST, "tid": tid,
                 "name": "thread_name", "args": {"name": thread}}
            )
        return tid

    emitted_device_est = False
    for view in sorted(spans, key=lambda v: v.get("t_wall", 0.0)):
        thread = view.get("thread", "?")
        tid = tid_for(thread)
        t0 = float(view.get("t_wall", 0.0))
        lock_wait = float(view.get("lock_wait_s", 0.0))
        estimate = "device_est_s" in view
        run = float(view.get("device_est_s", view.get("launch_s", 0.0)))
        args = {
            k: view[k]
            for k in ("seq", "rows", "tokens", "steps", "path", "rids",
                      "gap_s", "category")
            if k in view
        }
        if lock_wait > 0:
            events.append(
                {"ph": "X", "pid": _PID_HOST, "tid": tid,
                 "name": "dispatch_lock_wait", "cat": "lock",
                 "ts": t0 * 1e6, "dur": lock_wait * 1e6,
                 "args": {"seq": view.get("seq")}}
            )
        events.append(
            {"ph": "X", "pid": _PID_HOST, "tid": tid,
             "name": view.get("kind", "?"),
             "cat": view.get("category", "dispatch"),
             "ts": (t0 + lock_wait) * 1e6, "dur": run * 1e6,
             "args": args}
        )
        if view.get("category") == "dispatch" and estimate and not device_events:
            emitted_device_est = True
            events.append(
                {"ph": "X", "pid": _PID_DEVICE_EST, "tid": 1,
                 "name": view.get("kind", "?"), "cat": "device",
                 "ts": (t0 + lock_wait) * 1e6, "dur": run * 1e6,
                 "args": {"seq": view.get("seq")}}
            )
    if emitted_device_est:
        events.append(
            {"ph": "M", "pid": _PID_DEVICE_EST, "name": "process_name",
             "args": {"name": "device (host-return estimate)"}}
        )
    if device_events:
        events.append(
            {"ph": "M", "pid": _PID_DEVICE_TRACE, "name": "process_name",
             "args": {"name": "device (torch.profiler)"}}
        )
        for ev in device_events:
            events.append(
                {"ph": "X", "pid": _PID_DEVICE_TRACE,
                 "tid": int(ev.get("tid", 1)),
                 "name": ev.get("name", "?"), "cat": "device",
                 "ts": float(ev.get("ts_us", 0.0)),
                 "dur": float(ev.get("dur_us", 0.0)),
                 "args": {}}
            )
    for tl in flight or ():
        base = float(tl.get("started_at", 0.0))
        if not base:
            continue
        ident = {
            "request_id": tl.get("request_id"),
            "trace_id": tl.get("trace_id"),
            "rids": tl.get("rids"),
        }
        for ev in tl.get("timeline", ()):
            events.append(
                {"ph": "i", "s": "p", "pid": _PID_HOST,
                 "tid": _TID_REQUESTS, "name": ev.get("event", "?"),
                 "cat": "request",
                 "ts": (base + float(ev.get("t_s", 0.0))) * 1e6,
                 "args": ident}
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --------------------------------------------------------------------------- #
# Test hook


def reset() -> None:
    """Drop every span and rewind the cursor/counters and the run kind
    (tests only)."""
    global _SEQ, _RUN_KIND
    with _LOCK:
        _RUN_KIND = "device_est"
        _SPANS.clear()
        _LAST_RETURN.clear()
        _SEQ = 0
        for k in _CUM:
            _CUM[k] = 0.0
        for cum in _CUM_MODE.values():
            for k in cum:
                cum[k] = 0.0
