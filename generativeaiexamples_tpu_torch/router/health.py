"""Replica health, drain, and load accounting for the router.

Counterpart of generativeaiexamples_tpu/router/health.py: the same state
machine, drain flag and views, with the default probe over ``urllib``
(the JAX probe uses ``requests``).

One :class:`HealthMonitor` owns the fleet's replica table. Signals:

- an **active poller thread** (``router-health``, daemon) hitting each
  replica's ``/internal/ready`` — which carries both warmup readiness
  and the ``genai_engine_wedged`` flag — and optionally its
  ``/internal/slo`` attainment verdict;
- **passive proxy signals**: connect/stream failures reported by the
  proxy path count as failed polls immediately (a dead replica leaves
  placement on the first failed request, not a poll interval later),
  and ``X-GenAI-Queue-Depth`` response headers feed the bounded-load
  spill predicate between polls.

State machine per replica: ``healthy`` ⇄ ``unhealthy`` on
``fail_threshold`` consecutive bad signals / ``ok_threshold``
consecutive good polls (replicas start healthy — the router must route
before the first poll completes), plus an orthogonal ``draining`` flag
set by ``POST /internal/drain/{replica}``: a draining replica leaves
new-request placement immediately while its in-flight streams keep
running untouched (rolling restarts).
"""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from generativeaiexamples_tpu_torch.utils import blackbox
from generativeaiexamples_tpu_torch.utils.logging import get_logger
from generativeaiexamples_tpu_torch.utils.resilience import URL_ERRORS

logger = get_logger(__name__)

HEALTHY = "healthy"
UNHEALTHY = "unhealthy"

_PROBE_TIMEOUT_S = 5.0


def _get(url: str) -> Tuple[int, bytes]:
    """(status, body) of a GET; an HTTP error status is an answer, not
    an exception (``requests`` semantics)."""
    try:
        with urllib.request.urlopen(url, timeout=_PROBE_TIMEOUT_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.read()


def _json(body: bytes) -> dict:
    try:
        doc = json.loads(body)
    except ValueError:
        return {}
    return doc if isinstance(doc, dict) else {}


def _default_probe(url: str, slo_gate: bool) -> Tuple[bool, str]:
    """(healthy, detail) for one replica. Readiness carries wedged; the
    SLO verdict is consulted only when the gate is enabled."""
    try:
        status, body = _get(f"{url}/internal/ready")
        if status == 404:
            # Engine OpenAI-facade replicas serve /v1/health/ready
            # instead of /internal/ready (200 = ready, 503 = wedged) —
            # the router fronts both server kinds.
            status, body = _get(f"{url}/v1/health/ready")
    except URL_ERRORS as exc:
        return False, f"unreachable: {type(exc).__name__}"
    doc = _json(body)
    if doc.get("wedged"):
        return False, "engine wedged"
    if status != 200 or not doc.get("ready", status == 200):
        return False, f"not ready (http {status})"
    if slo_gate:
        try:
            status, body = _get(f"{url}/internal/slo")
            if status == 200 and _json(body).get("all_met") is False:
                return False, "slo unmet"
        except URL_ERRORS:
            pass  # SLO endpoint absent/flaky never fails an otherwise-ready replica
    return True, ""


class _Replica:
    """Mutable state for one replica. All fields guarded by the
    monitor's lock (single annotation point: instances never escape
    the monitor)."""

    __slots__ = (
        "replica_id", "url", "state", "draining", "fails", "oks",
        "inflight", "queue_depth", "last_error", "last_poll_at",
    )

    def __init__(self, replica_id: str, url: str):
        self.replica_id = replica_id
        self.url = url
        self.state = HEALTHY
        self.draining = False
        self.fails = 0
        self.oks = 0
        self.inflight = 0
        self.queue_depth = 0
        self.last_error = ""
        self.last_poll_at = 0.0


class HealthMonitor:
    """Fleet health table + poller. Thread-safe."""

    def __init__(
        self,
        replicas: Dict[str, str],
        interval_s: float = 2.0,
        fail_threshold: int = 2,
        ok_threshold: int = 2,
        slo_gate: bool = False,
        probe: Optional[Callable[[str, bool], Tuple[bool, str]]] = None,
        on_state_change: Optional[Callable[[str, str], None]] = None,
    ):
        """``replicas`` maps replica id (``r0``, ``r1``, …) → base URL.
        ``on_state_change(replica_id, new_state)`` fires outside the
        lock (metrics/gauge updates)."""
        self.interval_s = max(0.05, float(interval_s))
        self.fail_threshold = max(1, int(fail_threshold))
        self.ok_threshold = max(1, int(ok_threshold))
        self.slo_gate = bool(slo_gate)
        self._probe = probe or _default_probe
        self._on_state_change = on_state_change
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {  # guarded by self._lock
            rid: _Replica(rid, url) for rid, url in replicas.items()
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    # lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="router-health", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the poller must survive anything
                logger.exception("health poll failed")

    def poll_once(self) -> None:
        """One full probe pass (also called directly by tests)."""
        with self._lock:
            targets = [(r.replica_id, r.url) for r in self._replicas.values()]
        for rid, url in targets:
            healthy, detail = self._probe(url, self.slo_gate)
            if healthy:
                self._note_ok(rid)
            else:
                self.note_failure(rid, detail)

    # ------------------------------------------------------------------ #
    # signals

    def _note_ok(self, replica_id: str) -> None:
        changed: Optional[str] = None
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return
            rep.last_poll_at = time.monotonic()
            rep.fails = 0
            rep.oks += 1
            if rep.state == UNHEALTHY and rep.oks >= self.ok_threshold:
                rep.state = HEALTHY
                rep.last_error = ""
                changed = HEALTHY
        if changed and self._on_state_change:
            self._on_state_change(replica_id, changed)

    def note_failure(self, replica_id: str, detail: str = "") -> None:
        """A failed poll OR a proxy-observed failure (connect refused,
        mid-stream error) — both advance the same counter so a dead
        replica leaves placement on the first failed request."""
        changed: Optional[str] = None
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return
            rep.last_poll_at = time.monotonic()
            rep.oks = 0
            rep.fails += 1
            rep.last_error = detail or rep.last_error
            if rep.state == HEALTHY and rep.fails >= self.fail_threshold:
                rep.state = UNHEALTHY
                changed = UNHEALTHY
        # A storm of these is the replica_death black-box trigger: the
        # bundle captures the router's handover evidence at the moment
        # a replica went down under load (outside the lock; no-op while
        # the box is disarmed).
        blackbox.notify_replica_death(replica_id, detail)
        if changed:
            logger.warning(
                "replica %s marked unhealthy (%s)", replica_id, detail
            )
            if self._on_state_change:
                self._on_state_change(replica_id, changed)

    def note_queue_depth(self, replica_id: str, depth: int) -> None:
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is not None:
                rep.queue_depth = max(0, int(depth))

    def begin_request(self, replica_id: str) -> None:
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is not None:
                rep.inflight += 1

    def end_request(self, replica_id: str) -> None:
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is not None and rep.inflight > 0:
                rep.inflight -= 1

    # ------------------------------------------------------------------ #
    # drain

    def resolve(self, token: str) -> Optional[str]:
        """Replica id for an id, full URL, or host:port token."""
        with self._lock:
            for rid, rep in self._replicas.items():
                if token in (rid, rep.url, rep.url.rstrip("/")):
                    return rid
                if rep.url.split("//", 1)[-1].rstrip("/") == token:
                    return rid
        return None

    def drain(self, replica_id: str) -> bool:
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return False
            rep.draining = True
        logger.warning("replica %s draining (out of new-request placement)",
                       replica_id)
        return True

    def undrain(self, replica_id: str) -> bool:
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return False
            rep.draining = False
        return True

    # ------------------------------------------------------------------ #
    # views

    def url_of(self, replica_id: str) -> Optional[str]:
        with self._lock:
            rep = self._replicas.get(replica_id)
            return rep.url if rep is not None else None

    def placeable(self) -> List[str]:
        """Replica ids eligible for NEW request placement."""
        with self._lock:
            return [
                rid
                for rid, rep in self._replicas.items()
                if rep.state == HEALTHY and not rep.draining
            ]

    def inflight(self, replica_id: str) -> int:
        with self._lock:
            rep = self._replicas.get(replica_id)
            return rep.inflight if rep is not None else 0

    def total_inflight(self) -> int:
        with self._lock:
            return sum(rep.inflight for rep in self._replicas.values())

    def queue_depth(self, replica_id: str) -> int:
        with self._lock:
            rep = self._replicas.get(replica_id)
            return rep.queue_depth if rep is not None else 0

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                rid: {
                    "url": rep.url,
                    "state": rep.state,
                    "draining": rep.draining,
                    "inflight": rep.inflight,
                    "queue_depth": rep.queue_depth,
                    "consecutive_fails": rep.fails,
                    "last_error": rep.last_error,
                }
                for rid, rep in sorted(self._replicas.items())
            }
