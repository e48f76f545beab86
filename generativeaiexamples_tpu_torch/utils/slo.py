"""In-process SLO evaluation over sliding windows.

Counterpart of generativeaiexamples_tpu/utils/slo.py, copied onto the
port's registry and black box.

Config-declared latency/quality objectives (``slo`` section) are
evaluated continuously from the same signals the engine and server
already emit — TTFT, inter-token latency, admission sheds, degraded
answers — and exposed three ways:

- ``genai_slo_attainment_ratio{objective}`` — fraction of the sliding
  window meeting the objective's target (for latency objectives: the
  fraction of samples at or under the target; for rate objectives:
  ``1 - rate``);
- ``genai_slo_met{objective}`` — 1 while the objective holds (p95 ≤
  target / rate ≤ max), 0 otherwise;
- ``GET /internal/slo`` — the full JSON evaluation (targets, current
  percentiles/rates, sample counts, window).

Observation is O(1) (deque append); evaluation is lazy — at most once
per ``_EVAL_INTERVAL_S`` from the observe path, and eagerly from the
handler/bench readers — so the per-token hot path never sorts a window.

Objectives (0 target disables one):

- ``ttft_p95``          — engine submit → first token, p95 ≤ target ms
- ``inter_token_p95``   — per-token emission interval, p95 ≤ target ms
- ``shed_rate``         — shed / (shed + admitted) ≤ target fraction
- ``degraded_rate``     — degraded answers / requests ≤ target fraction
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

from generativeaiexamples_tpu_torch.utils import blackbox
from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

_REG = metrics_mod.get_registry()
_M_ATTAIN = _REG.gauge(
    "genai_slo_attainment_ratio",
    "Fraction of the sliding window meeting the objective's target "
    "(latency objectives: samples at/under target; rate objectives: "
    "1 - rate).",
    ("objective",),
)
_M_MET = _REG.gauge(
    "genai_slo_met",
    "1 while the objective currently holds over its sliding window "
    "(p95 at/under target, rate at/under max), 0 otherwise.",
    ("objective",),
)

# Latency objectives keep a bounded reservoir of the newest samples —
# at decode token rates a full window of inter-token samples would be
# hundreds of thousands of entries for no extra p95 fidelity.
_MAX_SAMPLES = 8192
_EVAL_INTERVAL_S = 5.0

LATENCY_OBJECTIVES = ("ttft_p95", "inter_token_p95")
RATE_OBJECTIVES = ("shed_rate", "degraded_rate")
# rate objective -> (bad event, base event) counted in the window
_RATE_EVENTS = {
    "shed_rate": ("shed", "admitted"),
    "degraded_rate": ("degraded", "answered"),
}

# The router process evaluates its OWN objective set (proxy overhead,
# failover rate) under names disjoint from the engine/server set above
# — one genai_slo_* exposition can aggregate a whole fleet without
# label collisions (docs/router.md).
ROUTER_LATENCY_OBJECTIVES = ("proxy_overhead_p95",)
ROUTER_RATE_EVENTS = {
    "failover_rate": ("failover", "proxied"),
}


class SLOTracker:
    """Sliding-window objective evaluation; one process-global instance
    (``get_tracker()``) fed by the engine/server/chains hot paths.

    The default objective set is the engine/chain-server one
    (TTFT/inter-token latency, shed/degraded rates); a process may
    instead install a custom set via ``latency_targets_ms`` (objective
    name → target ms) and ``rate_targets`` (objective name → (bad
    event, base event, max rate)) — the router's
    :func:`configure_router` does.
    """

    def __init__(
        self,
        window_s: float = 300.0,
        ttft_p95_ms: float = 30000.0,
        inter_token_p95_ms: float = 1000.0,
        shed_rate_max: float = 0.05,
        degraded_rate_max: float = 0.05,
        latency_targets_ms: Optional[Dict[str, float]] = None,
        rate_targets: Optional[Dict[str, Tuple[str, str, float]]] = None,
    ):
        self.window_s = float(window_s)
        if latency_targets_ms is None:
            latency_targets_ms = {
                "ttft_p95": ttft_p95_ms,
                "inter_token_p95": inter_token_p95_ms,
            }
        if rate_targets is None:
            rate_targets = {
                "shed_rate": ("shed", "admitted", shed_rate_max),
                "degraded_rate": ("degraded", "answered", degraded_rate_max),
            }
        self.latency_objectives: Tuple[str, ...] = tuple(latency_targets_ms)
        self.rate_events: Dict[str, Tuple[str, str]] = {
            name: (bad, base) for name, (bad, base, _) in rate_targets.items()
        }
        self.targets: Dict[str, float] = {
            **{
                name: max(0.0, float(ms)) / 1000.0
                for name, ms in latency_targets_ms.items()
            },
            **{
                name: max(0.0, float(mx))
                for name, (_, _, mx) in rate_targets.items()
            },
        }
        self._lock = threading.Lock()
        self._samples: Dict[str, Deque[Tuple[float, float]]] = {
            name: deque(maxlen=_MAX_SAMPLES) for name in self.latency_objectives
        }
        # Rate events are 1-second (bucket_start, count) buckets, NOT
        # per-event timestamps: a per-event deque capped for memory
        # would evict the plentiful base events ('admitted') before the
        # window expires while rare bad events ('shed') survive —
        # inflating the rate exactly when traffic is high. Bucket count
        # is bounded by the window, independent of traffic.
        bucket_cap = max(64, int(self.window_s) + 8)
        self._events: Dict[str, Deque[Tuple[int, int]]] = {
            kind: deque(maxlen=bucket_cap)
            for pair in self.rate_events.values()
            for kind in pair
        }
        self._last_eval = 0.0

    # ------------------------------------------------------------------ #
    # observation (hot paths)

    def observe_latency(self, objective: str, seconds: float) -> None:
        q = self._samples.get(objective)
        if q is None or self.targets.get(objective, 0.0) <= 0:
            return
        with self._lock:  # deque append is cheap; evaluate() iterates
            q.append((time.monotonic(), float(seconds)))
        self._maybe_evaluate()

    def observe_event(self, kind: str) -> None:
        q = self._events.get(kind)
        if q is None:
            return
        bucket = int(time.monotonic())
        with self._lock:
            if q and q[-1][0] == bucket:
                q[-1] = (bucket, q[-1][1] + 1)
            else:
                q.append((bucket, 1))
        self._maybe_evaluate()

    def _maybe_evaluate(self) -> None:
        now = time.monotonic()
        if now - self._last_eval >= _EVAL_INTERVAL_S:
            self.evaluate()

    # ------------------------------------------------------------------ #
    # evaluation

    @staticmethod
    def _percentile(values, p: float) -> Optional[float]:
        if not values:
            return None
        ordered = sorted(values)
        idx = min(len(ordered) - 1, max(0, int(round(p * (len(ordered) - 1)))))
        return ordered[idx]

    def evaluate(self) -> Dict[str, Any]:
        """Evaluate every enabled objective over the sliding window,
        update the gauges, and return the structured summary."""
        now = time.monotonic()
        cutoff = now - self.window_s
        out: Dict[str, Any] = {"window_s": self.window_s, "objectives": {}}
        with self._lock:
            self._last_eval = now
            for name in self.latency_objectives:
                target = self.targets[name]
                if target <= 0:
                    continue
                window = [v for (t, v) in self._samples[name] if t >= cutoff]
                p95 = self._percentile(window, 0.95)
                attain = (
                    sum(1 for v in window if v <= target) / len(window)
                    if window else 1.0
                )
                met = p95 is None or p95 <= target
                _M_ATTAIN.labels(objective=name).set(attain)
                _M_MET.labels(objective=name).set(1.0 if met else 0.0)
                out["objectives"][name] = {
                    "target_ms": round(target * 1000.0, 3),
                    "p95_ms": round(p95 * 1000.0, 3) if p95 is not None else None,
                    "samples": len(window),
                    "attainment": round(attain, 4),
                    "met": met,
                }
            for name, (bad_kind, base_kind) in self.rate_events.items():
                target = self.targets[name]
                if target <= 0:
                    continue
                bad = sum(
                    n for (t, n) in self._events[bad_kind] if t >= cutoff
                )
                base = sum(
                    n for (t, n) in self._events[base_kind] if t >= cutoff
                )
                total = bad + base
                rate = bad / total if total else 0.0
                met = rate <= target
                _M_ATTAIN.labels(objective=name).set(1.0 - rate)
                _M_MET.labels(objective=name).set(1.0 if met else 0.0)
                out["objectives"][name] = {
                    "target_rate": round(target, 4),
                    "rate": round(rate, 4),
                    "bad": bad,
                    "total": total,
                    # Window sample count under the same key latency
                    # objectives use, so a gate can uniformly refuse
                    # under-sampled verdicts ("met with 3 samples" is
                    # not the same evidence as "met with 3000").
                    "samples": total,
                    "met": met,
                }
        out["all_met"] = all(
            o["met"] for o in out["objectives"].values()
        ) if out["objectives"] else True
        # Feed the anomaly black box's breach-streak trigger (one
        # boolean read when the box is disabled; utils/blackbox.py).
        blackbox.notify_slo_evaluation(
            out["all_met"],
            samples=sum(
                int(o.get("samples") or 0) for o in out["objectives"].values()
            ),
        )
        return out


# --------------------------------------------------------------------------- #
# Process-global tracker + config plumbing

_TRACKER: Optional[SLOTracker] = None
_TRACKER_LOCK = threading.Lock()


def get_tracker() -> SLOTracker:
    global _TRACKER
    with _TRACKER_LOCK:
        if _TRACKER is None:
            _TRACKER = SLOTracker()
        return _TRACKER


def observe_latency(objective: str, seconds: float) -> None:
    """Module-level hot-path hook (engine _emit): one global read plus a
    deque append."""
    tracker = _TRACKER
    if tracker is not None:
        tracker.observe_latency(objective, seconds)
    else:
        get_tracker().observe_latency(objective, seconds)


def observe_event(kind: str) -> None:
    tracker = _TRACKER
    if tracker is not None:
        tracker.observe_event(kind)
    else:
        get_tracker().observe_event(kind)


def summary() -> Dict[str, Any]:
    """Eager evaluation (the /internal/slo handler and bench read this)."""
    return get_tracker().evaluate()


def validate_config(cfg) -> None:
    """Validate the ``slo`` section (pure host, server startup)."""
    s = cfg.slo if hasattr(cfg, "slo") else cfg
    if s.enable not in ("on", "off"):
        raise ValueError(f"slo.enable must be on|off, got {s.enable!r}")
    if s.window_s <= 0:
        raise ValueError(f"slo.window_s must be > 0, got {s.window_s}")
    for field in ("ttft_p95_ms", "inter_token_p95_ms"):
        if getattr(s, field) < 0:
            raise ValueError(
                f"slo.{field} must be >= 0 (0 disables), got {getattr(s, field)}"
            )
    for field in ("shed_rate_max", "degraded_rate_max"):
        v = getattr(s, field)
        if not (0.0 <= v <= 1.0):
            raise ValueError(
                f"slo.{field} must be in [0, 1] (0 disables), got {v}"
            )
    # Router-process objectives (absent from older bare-namespace test
    # configs; SLOConfig always carries them).
    v = getattr(s, "router_proxy_overhead_p95_ms", 0.0)
    if v < 0:
        raise ValueError(
            f"slo.router_proxy_overhead_p95_ms must be >= 0 (0 disables), got {v}"
        )
    v = getattr(s, "router_failover_rate_max", 0.0)
    if not (0.0 <= v <= 1.0):
        raise ValueError(
            f"slo.router_failover_rate_max must be in [0, 1] (0 disables), got {v}"
        )


def configure_from_config(cfg) -> None:
    """Build the process tracker from the ``slo`` config section (both
    servers call this at startup); slo.enable=off installs a tracker
    with every objective disabled so hot-path observes stay no-ops."""
    global _TRACKER
    s = cfg.slo if hasattr(cfg, "slo") else cfg
    if s.enable == "off":
        tracker = SLOTracker(
            window_s=s.window_s, ttft_p95_ms=0.0, inter_token_p95_ms=0.0,
            shed_rate_max=0.0, degraded_rate_max=0.0,
        )
    else:
        tracker = SLOTracker(
            window_s=s.window_s,
            ttft_p95_ms=s.ttft_p95_ms,
            inter_token_p95_ms=s.inter_token_p95_ms,
            shed_rate_max=s.shed_rate_max,
            degraded_rate_max=s.degraded_rate_max,
        )
    with _TRACKER_LOCK:
        _TRACKER = tracker


def configure_router(cfg) -> None:
    """Install the ROUTER process's objective set (proxy-overhead p95,
    failover rate) from the same ``slo`` config section both servers
    read — names disjoint from the engine objectives, so a fleet-wide
    scrape never collides. slo.enable=off installs an all-disabled
    tracker, same as :func:`configure_from_config`."""
    global _TRACKER
    s = cfg.slo if hasattr(cfg, "slo") else cfg
    off = s.enable == "off"
    latency = {
        name: 0.0 if off else getattr(s, f"router_{name}_ms")
        for name in ROUTER_LATENCY_OBJECTIVES
    }
    rates = {
        name: (bad, base, 0.0 if off else getattr(s, f"router_{name}_max"))
        for name, (bad, base) in ROUTER_RATE_EVENTS.items()
    }
    tracker = SLOTracker(
        window_s=s.window_s,
        latency_targets_ms=latency,
        rate_targets=rates,
    )
    with _TRACKER_LOCK:
        _TRACKER = tracker


def reset() -> None:
    """Test hook: drop the tracker (next access builds defaults)."""
    global _TRACKER
    with _TRACKER_LOCK:
        _TRACKER = None
