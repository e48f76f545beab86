"""Serving-system resilience primitives: deadlines, retries, breakers.

The port's copy of the JAX package's generativeaiexamples_tpu/utils/resilience.py,
with its rules and messages:

- ``Deadline``: an absolute-time request budget, bound to the request's
  threads through a thread-local (``set_current_deadline``);
- ``RetryPolicy`` / ``backoff_schedule``: jittered exponential backoff,
  deterministic under a seed;
- ``CircuitBreaker``: a closed/open/half-open breaker per dependency
  (``get_breaker``), so a dead service fails fast;
- ``call_with_resilience``: retry, breaker and deadline around one
  dependency call, raising the typed errors the chains degrade on;
- the typed errors: ``DeadlineExceeded``, ``DependencyUnavailable``,
  ``CircuitOpenError``, ``EngineOverloaded`` (429) and
  ``RequestPreempted`` (a drained request, with its snapshot id).

The port's remote clients speak ``urllib``, not ``requests``:
``http_error_is_transient`` sorts ``urllib.error.HTTPError`` by its
``code`` exactly as JAX sorts a ``requests`` error by its response status
(no response, 5xx and 429 are transient; another 4xx is not retried and
does not count against the breaker), and ``URL_ERRORS`` is the
``retry_on`` of those clients. Retries and breaker transitions count in
JAX's families (``genai_resilience_*``) and in plain integer counters
(``retries``, ``transitions``); a breaker that opens notifies the black
box, and a retry or an open-breaker refusal is a flight event of the
calling thread's request.

``resilience.enable = "off"`` restores the prior request path: guarded
calls run their function once, with no retry, breaker or deadline.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import http.client
import logging
import random
import threading
import time
import urllib.error
from typing import Callable, Dict, List, Optional, Tuple, Type

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

logger = logging.getLogger(__name__)

_REG = metrics_mod.get_registry()
_M_RETRIES = _REG.counter(
    "genai_resilience_retries_total",
    "Dependency-call retries after a transient failure, by dependency.",
    ("dependency",),
)
_M_TRANSITIONS = _REG.counter(
    "genai_resilience_breaker_transitions_total",
    "Circuit-breaker state transitions, by dependency and target state.",
    ("dependency", "to_state"),
)
_M_BREAKER_STATE = _REG.gauge(
    "genai_resilience_breaker_state",
    "Circuit-breaker state per dependency: 0=closed, 1=half_open, 2=open.",
    ("dependency",),
)

_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}

# dependency -> retries; (dependency, state) -> transitions into it
retries: "collections.Counter[str]" = collections.Counter()
transitions: "collections.Counter[tuple]" = collections.Counter()

# what a failed urllib call raises: URLError (HTTPError included) and
# socket timeouts and resets are OSErrors; a truncated answer is an
# http.client error
URL_ERRORS: Tuple[Type[BaseException], ...] = (OSError, http.client.HTTPException)


class ResilienceError(Exception):
    """Base class for the resilience layer's typed errors."""


class DeadlineExceeded(ResilienceError):
    """The request's deadline budget ran out."""


class DependencyUnavailable(ResilienceError):
    """A dependency failed past the retry budget (or its breaker is open)."""

    def __init__(self, dependency: str, message: str = ""):
        self.dependency = dependency
        super().__init__(message or f"dependency {dependency!r} unavailable")


class CircuitOpenError(DependencyUnavailable):
    """Fail-fast: the dependency's circuit breaker is open."""

    def __init__(self, dependency: str):
        super().__init__(dependency, f"circuit breaker open for {dependency!r}")


class EngineOverloaded(ResilienceError):
    """Typed load-shedding signal; carries the suggested Retry-After."""

    def __init__(self, message: str = "engine overloaded", retry_after: float = 1.0):
        self.retry_after = retry_after
        super().__init__(message)


class RequestPreempted(ResilienceError):
    """A live request was checkpointed off a draining engine. Carries the
    snapshot id when its state reached the spool, so the stream layer can
    name a restore target; None for a request that must replay from the
    prompt (engine/request_snapshot.py)."""

    def __init__(self, message: str = "request preempted", snapshot_id: Optional[str] = None):
        self.snapshot_id = snapshot_id
        super().__init__(message)


class Deadline:
    """An absolute-time request budget (monotonic clock). The
    constructor's clock is used for every expiry check."""

    __slots__ = ("_t0", "_deadline", "_clock", "budget")

    def __init__(self, budget_s: float, clock: Callable[[], float] = time.monotonic):
        self.budget = float(budget_s)
        self._clock = clock
        self._t0 = clock()
        self._deadline = self._t0 + self.budget

    def remaining(self, clock: Optional[Callable[[], float]] = None) -> float:
        """Seconds left; never negative."""
        return max(0.0, self._deadline - (clock or self._clock)())

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0


_TLS = threading.local()


def set_current_deadline(deadline: Optional[Deadline]) -> None:
    """Bind the request deadline to this thread (None clears it)."""
    _TLS.deadline = deadline


def get_current_deadline() -> Optional[Deadline]:
    return getattr(_TLS, "deadline", None)


def raise_if_deadline_expired(stage: str = "") -> None:
    """Raise DeadlineExceeded when the thread's bound deadline ran out.
    A no-op for threads without a deadline (non-server callers)."""
    deadline = get_current_deadline()
    if deadline is not None and deadline.expired:
        raise DeadlineExceeded(
            "request deadline exhausted"
            + (f" before {stage}" if stage else "")
            + f" (budget {deadline.budget:.3f}s)"
        )


# --------------------------------------------------------------------------- #
# Retry policy


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5  # +/- fraction of the computed delay


def backoff_schedule(policy: RetryPolicy, seed: Optional[int] = None) -> List[float]:
    """The delays slept between attempts (``max_attempts - 1`` of them):
    ``base * multiplier**i`` capped at ``max_delay``, with symmetric
    multiplicative jitter; deterministic for a seed, never negative."""
    rng = random.Random(seed)
    out: List[float] = []
    for i in range(max(0, policy.max_attempts - 1)):
        delay = min(policy.max_delay, policy.base_delay * policy.multiplier**i)
        if policy.jitter:
            delay *= 1.0 + policy.jitter * (2.0 * rng.random() - 1.0)
        out.append(max(0.0, delay))
    return out


# --------------------------------------------------------------------------- #
# Circuit breaker


class CircuitBreaker:
    """Per-dependency closed -> open -> half-open breaker.

    - ``closed``: calls pass; ``failure_threshold`` consecutive failures
      trip it open.
    - ``open``: calls fail fast until ``recovery_s`` elapses.
    - ``half_open``: one probe call goes through; success closes the
      breaker, failure opens it again (a fresh recovery window).
    """

    def __init__(self, name: str, failure_threshold: int = 5, recovery_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.recovery_s = float(recovery_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"  # guarded by self._lock
        self._failures = 0  # guarded by self._lock
        self._opened_at = 0.0  # guarded by self._lock
        self._probe_in_flight = False  # guarded by self._lock
        _M_BREAKER_STATE.labels(dependency=name).set(0)

    @property
    def state(self) -> str:
        with self._lock:
            # an open breaker past its recovery window reads as half_open
            if self._state == "open" and self._clock() - self._opened_at >= self.recovery_s:
                return "half_open"
            return self._state

    def _transition(self, to_state: str) -> None:
        """Caller holds self._lock."""
        if self._state == to_state:
            return
        self._state = to_state
        transitions[(self.name, to_state)] += 1
        _M_TRANSITIONS.labels(dependency=self.name, to_state=to_state).inc()
        _M_BREAKER_STATE.labels(dependency=self.name).set(_STATE_VALUES[to_state])
        log = logger.warning if to_state == "open" else logger.info
        log("circuit breaker %r -> %s", self.name, to_state)
        if to_state == "open":
            # an incident for the black box (one boolean read when it is
            # off; it never calls back into this module)
            from generativeaiexamples_tpu_torch.utils import blackbox

            blackbox.notify_breaker_open(self.name)

    def allow(self) -> bool:
        """Whether a call may proceed now; in half-open only the first
        caller gets the probe slot until its outcome is recorded."""
        return self.acquire()[0]

    def acquire(self) -> Tuple[bool, bool]:
        """``(allowed, holds_probe)``. A probe holder must settle the slot:
        ``record_success``/``record_failure``, or ``release_probe`` when
        the call ends without an outcome."""
        with self._lock:
            if self._state == "closed":
                return True, False
            if self._state == "open":
                if self._clock() - self._opened_at < self.recovery_s:
                    return False, False
                self._transition("half_open")
                self._probe_in_flight = False
            if self._probe_in_flight:
                return False, False
            self._probe_in_flight = True
            return True, True

    def release_probe(self) -> None:
        """Free the half-open probe slot without recording an outcome."""
        with self._lock:
            self._probe_in_flight = False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_in_flight = False
            if self._state != "closed":
                self._transition("closed")

    def record_failure(self) -> None:
        with self._lock:
            self._probe_in_flight = False
            if self._state == "half_open":
                self._opened_at = self._clock()
                self._transition("open")
                return
            self._failures += 1
            if self._state == "closed" and self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition("open")


_BREAKERS: Dict[str, CircuitBreaker] = {}  # guarded by _BREAKERS_LOCK
_BREAKERS_LOCK = threading.Lock()


def get_breaker(name: str) -> CircuitBreaker:
    """The process's breaker of a dependency, built with the resilience
    config's thresholds on first use."""
    with _BREAKERS_LOCK:
        breaker = _BREAKERS.get(name)
        if breaker is None:
            cfg = _resilience_config()
            breaker = CircuitBreaker(
                name,
                failure_threshold=getattr(cfg, "breaker_failure_threshold", 5),
                recovery_s=getattr(cfg, "breaker_recovery_s", 30.0),
            )
            _BREAKERS[name] = breaker
        return breaker


def reset_breakers() -> None:
    """Drop all breaker state (``runtime.reset_runtime`` calls this)."""
    with _BREAKERS_LOCK:
        _BREAKERS.clear()


# --------------------------------------------------------------------------- #
# Config


def _resilience_config():
    """The resilience section of the process config, or None when the
    environment does not parse."""
    try:
        from generativeaiexamples_tpu_torch.config import get_config

        return get_config().resilience
    except Exception:  # noqa: BLE001 - a config error must never fail a call
        return None


def resilience_enabled(config=None) -> bool:
    """Whether the resilience layer is active (``resilience.enable``);
    ``config=None`` reads the process config."""
    section = config.resilience if config is not None else _resilience_config()
    return getattr(section, "enable", "on") != "off"


def policy_from_config(config=None) -> RetryPolicy:
    section = config.resilience if config is not None else _resilience_config()
    if section is None:
        return RetryPolicy()
    return RetryPolicy(
        max_attempts=section.retry_max_attempts,
        base_delay=section.retry_base_delay_ms / 1000.0,
        max_delay=section.retry_max_delay_ms / 1000.0,
        jitter=section.retry_jitter,
    )


def validate_config(cfg) -> None:
    """The resilience section's checks, with the JAX package's messages."""
    r = cfg.resilience if hasattr(cfg, "resilience") else cfg
    if r.enable not in ("on", "off"):
        raise ValueError(f"resilience.enable must be on|off, got {r.enable!r}")
    for name in ("request_deadline_ms", "max_active_streams", "engine_queue_cap"):
        if getattr(r, name) < 0:
            raise ValueError(
                f"resilience.{name} must be >= 0 (0 disables), got {getattr(r, name)}")
    if r.shed_retry_after_s <= 0:
        raise ValueError(f"resilience.shed_retry_after_s must be > 0, got {r.shed_retry_after_s}")
    if r.retry_max_attempts < 1:
        raise ValueError(f"resilience.retry_max_attempts must be >= 1, got {r.retry_max_attempts}")
    if r.retry_base_delay_ms < 0 or r.retry_max_delay_ms < 0:
        raise ValueError("resilience retry delays must be >= 0")
    if not 0.0 <= r.retry_jitter <= 1.0:
        raise ValueError(f"resilience.retry_jitter must be in [0, 1], got {r.retry_jitter}")
    if r.breaker_failure_threshold < 1:
        raise ValueError(
            f"resilience.breaker_failure_threshold must be >= 1, got "
            f"{r.breaker_failure_threshold}")
    if r.breaker_recovery_s <= 0:
        raise ValueError(f"resilience.breaker_recovery_s must be > 0, got {r.breaker_recovery_s}")
    # the fault spec's shape (site:mode); utils/faults parses the rest
    for entry in (r.faults or "").replace(",", ";").split(";"):
        entry = entry.strip()
        if entry and (":" not in entry or not entry.split(":", 1)[0]):
            raise ValueError(
                f"resilience.faults entry {entry!r} is malformed (want "
                f"site:mode[=v]@at[xN] — docs/resilience.md)"
            )


# --------------------------------------------------------------------------- #
# Guarded calls


def http_error_is_transient(exc: BaseException) -> bool:
    """Retry filter of the urllib clients: no response at all (a failed
    connect, a timeout, a reset) and 5xx/429 answers are transient; any
    other HTTP status means the dependency is healthy and the request is
    at fault. ``urllib.error.HTTPError.code`` is the status."""
    status = exc.code if isinstance(exc, urllib.error.HTTPError) else None
    if status is None:
        return True
    return status >= 500 or status == 429


def call_with_resilience(
    dependency: str,
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    attempts: Optional[int] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    retry_filter: Optional[Callable[[BaseException], bool]] = None,
    breaker: Optional[CircuitBreaker] = None,
    sleep: Callable[[float], None] = time.sleep,
    seed: Optional[int] = None,
    **kwargs,
):
    """Run ``fn`` under the dependency's breaker with retry and backoff.

    - Breaker open: ``CircuitOpenError`` without calling ``fn``.
    - Retries on ``retry_on`` with the policy's jittered backoff, capped by
      the thread's deadline; ``attempts`` overrides ``max_attempts``.
    - ``retry_filter(exc)`` False: the error is raised at once and counts
      as a success of the dependency (it answered; the request is bad).
    - Budget spent: ``DependencyUnavailable`` chained to the last failure.
    - ``resilience.enable = off``: ``fn`` once, directly.
    """
    if not resilience_enabled():
        return fn(*args, **kwargs)
    br = breaker if breaker is not None else get_breaker(dependency)
    allowed, holds_probe = br.acquire()
    if not allowed:
        from generativeaiexamples_tpu_torch.utils import flight_recorder

        flight_recorder.event("breaker_open", dependency=dependency)
        raise CircuitOpenError(dependency)
    pol = policy or policy_from_config()
    max_attempts = max(1, attempts if attempts is not None else pol.max_attempts)
    delays = backoff_schedule(dataclasses.replace(pol, max_attempts=max_attempts), seed=seed)
    last: Optional[BaseException] = None
    try:
        for attempt in range(max_attempts):
            raise_if_deadline_expired(f"{dependency} call")
            try:
                result = fn(*args, **kwargs)
            except (DeadlineExceeded, EngineOverloaded):
                # budget and overload signals are not dependency failures
                raise
            except retry_on as exc:  # noqa: PERF203 - retry loop
                if retry_filter is not None and not retry_filter(exc):
                    br.record_success()
                    holds_probe = False
                    raise
                br.record_failure()
                holds_probe = False
                last = exc
                if attempt >= max_attempts - 1:
                    break
                allowed, holds_probe = br.acquire()
                if not allowed:
                    break
                retries[dependency] += 1
                _M_RETRIES.labels(dependency=dependency).inc()
                from generativeaiexamples_tpu_torch.utils import flight_recorder

                flight_recorder.event(
                    "retry", dependency=dependency, attempt=attempt + 1,
                    error=type(exc).__name__,
                )
                delay = delays[attempt]
                deadline = get_current_deadline()
                if deadline is not None:
                    if deadline.remaining() <= 0:
                        break
                    delay = min(delay, deadline.remaining())
                logger.warning(
                    "dependency %r failed (%s); retry %d/%d in %.3fs",
                    dependency, exc, attempt + 1, max_attempts - 1, delay,
                )
                if delay > 0:
                    sleep(delay)
            else:
                br.record_success()
                holds_probe = False
                return result
        raise DependencyUnavailable(
            dependency, f"dependency {dependency!r} failed after {max_attempts} attempt(s): {last}"
        ) from last
    finally:
        if holds_probe:
            # an exit that bypassed the breaker's accounting frees the probe
            br.release_probe()


def resilient(dependency: str, attempts: Optional[int] = None,
              retry_on: Tuple[Type[BaseException], ...] = (Exception,)):
    """Decorator form of ``call_with_resilience``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return call_with_resilience(dependency, fn, *args, attempts=attempts,
                                        retry_on=retry_on, **kwargs)

        return wrapper

    return deco
