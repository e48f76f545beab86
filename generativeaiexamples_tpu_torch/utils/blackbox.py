"""Anomaly black box: capture a machine-readable debug bundle at the
moment an incident actually happens.

Counterpart of generativeaiexamples_tpu/utils/blackbox.py: the same
triggers, rate limit, bundle layout and views. Its provenance stamps come
from utils/provenance.py, and its log tail is utils/logging.py's ring, as
JAX's. Bundles embed the port's dispatch-timeline window and flight
records.

Histograms say *that* the fleet got slow; the flight recorder explains
one request after the fact; nothing captured the process's whole state
at the instant an SLO breach, a wedged dispatch loop, or a shed storm
fired. This module is the flight-data-recorder for those moments: a
config-gated trigger registry that, on firing, snapshots one bounded,
rate-limited on-disk bundle holding everything an investigation opens
first —

- the newest completed flight timelines + the slow-capture ring + the
  in-flight summaries (``utils/flight_recorder.py``),
- the full ``/metrics`` exposition text,
- the SLO evaluation and the live engine-utilization snapshot
  (compile stats included),
- run provenance (git SHA/dirty, config fingerprint — the bundle says
  WHAT was deployed, not just what it did),
- the recent log tail (``utils/logging.recent_lines``).

Triggers (``blackbox`` config section; a threshold of 0 disarms one):

- ``slo_breach``        — N consecutive SLO evaluations with
  ``all_met == False`` (``slo_breach_streak``);
- ``wedged``            — the engine watchdog marked the dispatch loop
  wedged;
- ``page_backpressure`` — N funding give-ups inside the window
  (``page_backpressure_storm`` / 60 s);
- ``shed_spike``        — N admission sheds inside the window
  (``shed_spike`` / 60 s);
- ``breaker_open``      — a dependency circuit breaker tripped open;
- ``replica_death``     — N passive replica failures observed by the
  router's proxy/health paths inside the window
  (``replica_death_storm`` / 60 s): a replica dying under load is
  exactly the moment the handover evidence should be captured.

Every ``notify_*`` entry point starts with one module-global boolean
read — the hot paths (shed responses, breaker transitions) pay nothing
while the box is disabled, and ``GENAI_BLACKBOX=off`` is the process
kill switch for entrypoints that never load an AppConfig. Captures are
globally rate-limited (``min_interval_s``), the bundle directory is
bounded (``max_bundles``, oldest evicted), each capture increments
``genai_blackbox_captures_total{trigger}`` and stamps a
``blackbox_capture`` flight event on every in-flight timeline, and
bundles are served at ``GET /internal/debug/bundles`` (+ fetch by id)
on both servers and the router.
"""
from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from generativeaiexamples_tpu_torch.utils import logging as logging_mod
from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

logger = logging.getLogger(__name__)

_REG = metrics_mod.get_registry()
_M_CAPTURES = _REG.counter(
    "genai_blackbox_captures_total",
    "Debug bundles captured by the anomaly black box, by trigger "
    "(slo_breach, wedged, page_backpressure, shed_spike, breaker_open, "
    "replica_death).",
    ("trigger",),
)

ENV_VAR = "GENAI_BLACKBOX"

TRIGGERS = (
    "slo_breach", "wedged", "page_backpressure", "shed_spike",
    "breaker_open", "replica_death",
)

_STORM_WINDOW_S = 60.0  # shed/backpressure spike counting window

# Process kill switch (bench runs, tools): the config knob can only
# narrow this, never re-enable it.
_ENV_ENABLED = os.environ.get(ENV_VAR, "on").lower() not in (
    "0", "off", "false", "no"
)

# _ARMED is THE fast-path gate: every notify reads it without the lock
# and returns immediately while the box is disabled.
_ARMED = False
_LOCK = threading.Lock()
_DIR: Optional[str] = None  # the bundle directory once configured (_dir())
_MAX_BUNDLES = 8
_MIN_INTERVAL_S = 60.0
_THRESHOLDS: Dict[str, float] = {}
_LAST_CAPTURE = 0.0  # guarded by _LOCK
_SLO_STREAK = 0  # guarded by _LOCK
_EVENTS: Dict[str, Deque[float]] = {}  # trigger -> timestamps, guarded by _LOCK
_BUNDLES: "deque[Dict[str, Any]]" = deque(maxlen=64)  # metadata, guarded by _LOCK
_CONFIG_FINGERPRINT: Optional[str] = None

_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def enabled() -> bool:
    return _ARMED


def _dir() -> str:
    """The configured directory, else ``genai_blackbox`` under the
    temporary directory (``TMPDIR``), where JAX's is ``/tmp/genai_blackbox``."""
    return _DIR or os.path.join(tempfile.gettempdir(), "genai_blackbox")


def validate_config(cfg) -> None:
    """Validate the ``blackbox`` config section (pure host; raises
    ValueError with the same phrasing as the other section checks)."""
    b = cfg.blackbox if hasattr(cfg, "blackbox") else cfg
    if b.enable not in ("on", "off"):
        raise ValueError(
            f"blackbox.enable must be on|off, got {b.enable!r}"
        )
    if not b.dir.strip():
        raise ValueError(
            "blackbox.dir must not be empty (bundle files need a home)"
        )
    if b.max_bundles < 1:
        raise ValueError(
            f"blackbox.max_bundles must be >= 1, got {b.max_bundles}"
        )
    if b.min_interval_s < 0:
        raise ValueError(
            f"blackbox.min_interval_s must be >= 0 (0 disables the rate "
            f"limit), got {b.min_interval_s}"
        )
    for field in ("slo_breach_streak", "shed_spike",
                  "page_backpressure_storm", "replica_death_storm"):
        if getattr(b, field) < 0:
            raise ValueError(
                f"blackbox.{field} must be >= 0 (0 disarms the trigger), "
                f"got {getattr(b, field)}"
            )


def configure(
    enable: Optional[bool] = None,
    directory: Optional[str] = None,
    max_bundles: Optional[int] = None,
    min_interval_s: Optional[float] = None,
    slo_breach_streak: Optional[int] = None,
    shed_spike: Optional[int] = None,
    page_backpressure_storm: Optional[int] = None,
    replica_death_storm: Optional[int] = None,
    config_fingerprint: Optional[str] = None,
) -> None:
    """Apply knobs (the servers call :func:`configure_from_config` at
    startup; tests call this directly). Arming resets the trigger
    windows so a fresh configuration never inherits stale streaks."""
    global _ARMED, _DIR, _MAX_BUNDLES, _MIN_INTERVAL_S
    global _SLO_STREAK, _LAST_CAPTURE, _CONFIG_FINGERPRINT
    with _LOCK:
        if directory is not None:
            _DIR = str(directory)
        if max_bundles is not None:
            _MAX_BUNDLES = max(1, int(max_bundles))
        if min_interval_s is not None:
            _MIN_INTERVAL_S = max(0.0, float(min_interval_s))
        for name, value in (
            ("slo_breach", slo_breach_streak),
            ("shed_spike", shed_spike),
            ("page_backpressure", page_backpressure_storm),
            ("replica_death", replica_death_storm),
        ):
            if value is not None:
                _THRESHOLDS[name] = max(0, int(value))
        if config_fingerprint is not None:
            _CONFIG_FINGERPRINT = config_fingerprint
        if enable is not None:
            _ARMED = bool(enable) and _ENV_ENABLED
            _SLO_STREAK = 0
            _LAST_CAPTURE = 0.0
            _EVENTS.clear()


def configure_from_config(cfg) -> None:
    """Wire the ``blackbox`` config section into the module knobs (all
    three processes call this at startup)."""
    from generativeaiexamples_tpu_torch.utils import provenance as provenance_mod

    b = cfg.blackbox if hasattr(cfg, "blackbox") else cfg
    configure(
        enable=b.enable != "off",
        directory=b.dir,
        max_bundles=b.max_bundles,
        min_interval_s=b.min_interval_s,
        slo_breach_streak=b.slo_breach_streak,
        shed_spike=b.shed_spike,
        page_backpressure_storm=b.page_backpressure_storm,
        replica_death_storm=b.replica_death_storm,
        config_fingerprint=provenance_mod.config_fingerprint(cfg),
    )


# --------------------------------------------------------------------------- #
# Trigger notifications (production call sites; near-zero disabled)


def notify_slo_evaluation(all_met: bool, samples: int = 0) -> None:
    """Fed by utils/slo.py after every window evaluation: N consecutive
    breached evaluations (with at least one sampled objective) fire the
    ``slo_breach`` trigger."""
    global _SLO_STREAK
    if not _ARMED:
        return
    threshold = _THRESHOLDS.get("slo_breach", 0)
    if threshold <= 0:
        return
    with _LOCK:
        if all_met or samples <= 0:
            _SLO_STREAK = 0
            return
        _SLO_STREAK += 1
        streak = _SLO_STREAK
        if streak < threshold:
            return
        _SLO_STREAK = 0  # re-arm only after a fresh streak
    _capture("slo_breach", {"streak": streak, "samples": samples})


def notify_wedged(reason: str) -> None:
    """Fed by the engine watchdog when the dispatch loop wedges."""
    if not _ARMED:
        return
    _capture("wedged", {"reason": reason})


def notify_breaker_open(dependency: str) -> None:
    """Fed by utils/resilience.py on a closed/half-open -> open
    transition."""
    if not _ARMED:
        return
    _capture("breaker_open", {"dependency": dependency})


def notify_shed(reason: str) -> None:
    """Fed by server/router admission sheds; fires ``shed_spike`` at N
    sheds inside the storm window."""
    if not _ARMED:
        return
    count = _count_windowed("shed_spike")
    if count is not None:
        _capture("shed_spike", {"sheds_in_window": count,
                                "last_reason": reason})


def notify_replica_death(replica_id: str, detail: str = "") -> None:
    """Fed by the router's passive failure path (router/health.py
    ``note_failure``): a storm of proxy/probe failures against the
    fleet fires ``replica_death`` — the bundle catches the router's
    view (placements, failovers, handovers) at the moment a replica
    went down under load."""
    if not _ARMED:
        return
    count = _count_windowed("replica_death")
    if count is not None:
        _capture("replica_death", {"failures_in_window": count,
                                   "last_replica": replica_id,
                                   "last_detail": detail})


def notify_page_backpressure() -> None:
    """Fed by engine/kv_pages.py funding give-ups; fires at N inside
    the storm window."""
    if not _ARMED:
        return
    count = _count_windowed("page_backpressure")
    if count is not None:
        _capture("page_backpressure", {"events_in_window": count})


def _count_windowed(trigger: str) -> Optional[int]:
    """Record one event for a windowed trigger; returns the in-window
    count when the threshold fired (and resets the window so one storm
    yields one capture), else None."""
    threshold = _THRESHOLDS.get(trigger, 0)
    if threshold <= 0:
        return None
    now = time.monotonic()
    with _LOCK:
        q = _EVENTS.setdefault(trigger, deque(maxlen=4096))
        q.append(now)
        while q and q[0] < now - _STORM_WINDOW_S:
            q.popleft()
        if len(q) < threshold:
            return None
        count = len(q)
        q.clear()
    return count


# --------------------------------------------------------------------------- #
# Capture


_CAPTURING = threading.local()
_WORKER: Optional[threading.Thread] = None  # guarded by _LOCK


def _capture(trigger: str, detail: Dict[str, Any]) -> None:
    """Rate-limited bundle capture, OFF the caller's thread. The notify
    hooks fire from hot contexts — the servers' event loops, the engine
    dispatch thread, a held circuit-breaker lock — so the caller only
    reserves the rate-limit slot (one lock round) and hands the
    snapshot + disk write to a short-lived daemon thread. Never raises:
    an incident snapshot failing must not add a second incident.
    Re-entrancy-guarded — the snapshot itself evaluates SLOs/renders
    metrics, which feed the very notify hooks that got us here."""
    global _LAST_CAPTURE, _WORKER
    if getattr(_CAPTURING, "active", False):
        return
    now = time.monotonic()
    with _LOCK:
        if _LAST_CAPTURE and now - _LAST_CAPTURE < _MIN_INTERVAL_S:
            return
        _LAST_CAPTURE = now
        previous = _WORKER

    def _run() -> None:
        if previous is not None:
            previous.join()  # captures never interleave
        _CAPTURING.active = True
        try:
            _write_bundle(trigger, detail)
        except Exception as exc:  # noqa: BLE001 - capture is best-effort
            logger.warning("black-box capture failed (%s): %s", trigger, exc)
        finally:
            _CAPTURING.active = False

    worker = threading.Thread(
        target=_run, name="blackbox-capture", daemon=True
    )
    with _LOCK:
        _WORKER = worker
    worker.start()


def drain(timeout_s: float = 10.0) -> None:
    """Wait for the in-flight capture (if any) to finish writing —
    tests and shutdown paths call this before reading bundles."""
    with _LOCK:
        worker = _WORKER
    if worker is not None:
        worker.join(timeout=timeout_s)


def _snapshot(trigger: str, detail: Dict[str, Any]) -> Dict[str, Any]:
    from generativeaiexamples_tpu_torch.utils import provenance as provenance_mod
    from generativeaiexamples_tpu_torch.utils import flight_recorder
    from generativeaiexamples_tpu_torch.utils import slo as slo_mod

    bundle_id = f"{int(time.time() * 1000)}-{os.getpid()}-{trigger}"
    bundle: Dict[str, Any] = {
        "id": bundle_id,
        "trigger": trigger,
        "detail": detail,
        "captured_at": time.time(),
        "provenance": {
            "git_sha": provenance_mod.git_sha(),
            "git_dirty": provenance_mod.git_dirty(),
            "config_fingerprint": _CONFIG_FINGERPRINT,
        },
        "flight": {
            "in_flight": flight_recorder.inflight(),
            "recent": flight_recorder.recent_timelines(32),
            "slow": flight_recorder.completed_since(0, slow=True)[0][-16:],
        },
        "slo": slo_mod.summary(),
        "log_tail": logging_mod.recent_lines(80),
    }
    # Recent dispatch-timeline window: the engine's launch cadence
    # around the incident (lock waits, gaps, readbacks). Lazy import —
    # the module is host-only, but router processes may run without the
    # engine package importable.
    try:
        from generativeaiexamples_tpu_torch.engine import dispatch_timeline

        bundle["dispatch_timeline"] = {
            "enabled": dispatch_timeline.enabled(),
            "spans": dispatch_timeline.recent_spans(64),
        }
    except Exception:  # noqa: BLE001 - engine-less processes
        bundle["dispatch_timeline"] = None
    # Live engine utilization (+ compile stats): peek only — a capture
    # must never BUILD an engine.
    try:
        from generativeaiexamples_tpu_torch.engine import llm_engine

        eng = llm_engine._ENGINE
        bundle["utilization"] = (
            eng.utilization_snapshot() if eng is not None else None
        )
    except Exception:  # noqa: BLE001 - an engine that cannot report
        bundle["utilization"] = None
    bundle["metrics"] = metrics_mod.get_registry().render()
    return bundle


def _write_bundle(trigger: str, detail: Dict[str, Any]) -> str:
    from generativeaiexamples_tpu_torch.utils import flight_recorder

    bundle = _snapshot(trigger, detail)
    bundle_id = bundle["id"]
    os.makedirs(_dir(), exist_ok=True)
    path = os.path.join(_dir(), f"bundle-{bundle_id}.json")
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(bundle, fh, default=str)
    meta = {
        "id": bundle_id,
        "trigger": trigger,
        "detail": detail,
        "captured_at": bundle["captured_at"],
        "path": path,
    }
    with _LOCK:
        _BUNDLES.append(meta)
    _evict_old()
    _M_CAPTURES.labels(trigger=trigger).inc()
    stamped = flight_recorder.annotate_inflight(
        "blackbox_capture", trigger=trigger, bundle=bundle_id
    )
    logger.error(
        "BLACK BOX capture: trigger=%s bundle=%s (%d in-flight timelines "
        "stamped) -> %s", trigger, bundle_id, stamped, path,
    )
    return bundle_id


def _evict_old() -> None:
    """Bound the on-disk bundle dir at max_bundles, oldest first."""
    try:
        names = sorted(
            n for n in os.listdir(_dir())
            if n.startswith("bundle-") and n.endswith(".json")
        )
    except OSError:
        return
    for name in names[: max(0, len(names) - _MAX_BUNDLES)]:
        try:
            os.remove(os.path.join(_dir(), name))
        except OSError:
            pass


# --------------------------------------------------------------------------- #
# Views (the /internal/debug/bundles handlers)


def list_bundles() -> List[Dict[str, Any]]:
    """Bundle metadata, newest first — the on-disk dir is the source of
    truth (a restarted process still serves its predecessor's
    captures); in-memory metadata fills in trigger/detail for bundles
    this process wrote."""
    by_id: Dict[str, Dict[str, Any]] = {}
    try:
        names = sorted(
            n for n in os.listdir(_dir())
            if n.startswith("bundle-") and n.endswith(".json")
        )
    except OSError:
        names = []
    for name in names:
        bundle_id = name[len("bundle-"):-len(".json")]
        by_id[bundle_id] = {
            "id": bundle_id,
            "path": os.path.join(_dir(), name),
        }
    with _LOCK:
        metas = list(_BUNDLES)
    for meta in metas:
        if meta["id"] in by_id:
            by_id[meta["id"]].update(meta)
    return sorted(by_id.values(), key=lambda m: m["id"], reverse=True)


def get_bundle(bundle_id: str) -> Optional[Dict[str, Any]]:
    """Full bundle content by id (path-traversal-safe), or None."""
    if not _ID_RE.match(bundle_id or ""):
        return None
    path = os.path.join(_dir(), f"bundle-{bundle_id}.json")
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def reset() -> None:
    """Test hook: disarm and drop in-memory state (on-disk bundles are
    the caller's tmpdir concern). Joins an in-flight capture first so
    it cannot write into the next test's window."""
    global _ARMED, _DIR, _SLO_STREAK, _LAST_CAPTURE, _CONFIG_FINGERPRINT, _WORKER
    drain()
    with _LOCK:
        _ARMED = False
        _DIR = None
        _SLO_STREAK = 0
        _LAST_CAPTURE = 0.0
        _EVENTS.clear()
        _BUNDLES.clear()
        _THRESHOLDS.clear()
        _CONFIG_FINGERPRINT = None
        _WORKER = None
