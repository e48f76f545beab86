"""Deterministic fault injection for resilience testing.

The port's copy of the JAX package's generativeaiexamples_tpu/utils/faults.py,
with its grammar, modes and messages; an injected fault counts in JAX's
``genai_faults_injected_total`` family and in a plain integer per (site,
mode) (``injected``).

Production code calls ``fault_point("<site>")`` at named seams:
``retrieval.search``, ``engine.dispatch``, ``engine.spec_pipeline``,
``backend.stream``, ``server.admission`` and ``replica.kill``. The registry decides whether
that call raises, delays or hangs. Disabled (the default), ``fault_point``
is a single module-global boolean check.

Rules trigger by call ordinal ("raise on the Nth call to this site"), so
failure scenarios replay exactly:

- programmatically: ``faults.configure("retrieval.search", "error", at=2)``
- by spec string (env ``GENAI_FAULTS`` or the ``resilience.faults``
  config): ``site:mode[=value]@at[xcount]`` entries joined with ``;``,
  e.g. ``retrieval.search:error@1x0;engine.dispatch:hang=5@2``.

Modes: ``error`` (raise ``FaultInjected``), ``delay=<s>`` (sleep),
``hang[=<s>]`` (block, default 3600 s, released early by ``reset()``),
``kill`` (SIGKILL the whole process). ``at`` is the first triggering call
(1-based, default 1); ``xcount`` is how many consecutive calls trigger
(default 1; ``x0`` = every call from ``at`` on). Call counters start when
a site gains its first rule.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Dict, List

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

logger = logging.getLogger(__name__)

_REG = metrics_mod.get_registry()
_M_INJECTED = _REG.counter(
    "genai_faults_injected_total",
    "Faults injected by the deterministic fault-injection registry, "
    "by site and mode.",
    ("site", "mode"),
)

ENV_VAR = "GENAI_FAULTS"

_MODES = ("error", "delay", "hang", "kill")
_DEFAULT_HANG_S = 3600.0

# (site, mode) -> faults injected in this process
injected: "collections.Counter[tuple]" = collections.Counter()


class FaultInjected(RuntimeError):
    """The error the ``error`` mode raises at a fault site."""

    def __init__(self, site: str):
        self.site = site
        super().__init__(f"injected fault at {site!r}")


@dataclasses.dataclass
class _Rule:
    site: str
    mode: str
    at: int = 1        # first triggering call, 1-based
    count: int = 1     # consecutive triggering calls; 0 = forever
    value: float = 0.0  # delay/hang seconds

    def matches(self, n: int) -> bool:
        return n >= self.at and (self.count == 0 or n < self.at + self.count)


_LOCK = threading.Lock()
_RULES: Dict[str, List[_Rule]] = {}
_COUNTS: Dict[str, int] = {}
# A hanger captures the generation in the critical section that decides
# its rule fired, so a reset() at any later instant releases it.
_HANG_COND = threading.Condition(_LOCK)
_HANG_GEN = 0
_ACTIVE = False  # fast-path gate: read without the lock


def fault_point(site: str) -> None:
    """The production-side hook: one global read when no rules are
    installed."""
    if not _ACTIVE:
        return
    _trigger(site)


def _trigger(site: str) -> None:
    with _LOCK:
        rules = _RULES.get(site)
        if not rules:
            return
        n = _COUNTS.get(site, 0) + 1
        _COUNTS[site] = n
        fired = next((r for r in rules if r.matches(n)), None)
        gen = _HANG_GEN
        if fired is not None:
            injected[(site, fired.mode)] += 1
    if fired is None:
        return
    _M_INJECTED.labels(site=site, mode=fired.mode).inc()
    logger.warning(
        "fault injected at %s (call %d): %s%s",
        site, n, fired.mode,
        f"={fired.value}" if fired.mode in ("delay", "hang") else "",
    )
    if fired.mode == "delay":
        time.sleep(fired.value)
    elif fired.mode == "kill":
        # no atexit, no flushes: the process vanishes as a reclaimed VM
        # does; tests monkeypatch os.kill
        os.kill(os.getpid(), signal.SIGKILL)
    elif fired.mode == "hang":
        hang_deadline = time.time() + (fired.value or _DEFAULT_HANG_S)
        with _HANG_COND:
            while _HANG_GEN == gen:
                remaining = hang_deadline - time.time()
                if remaining <= 0:
                    break
                _HANG_COND.wait(timeout=remaining)
    else:
        raise FaultInjected(site)


def configure(site: str, mode: str, at: int = 1, count: int = 1, value: float = 0.0) -> None:
    """Install one rule. ``at`` is the first triggering call (1-based),
    ``count`` how many consecutive calls trigger (0 = forever)."""
    global _ACTIVE
    if mode not in _MODES:
        raise ValueError(f"fault mode must be one of {_MODES}, got {mode!r}")
    if at < 1:
        raise ValueError(f"fault 'at' must be >= 1, got {at}")
    if count < 0:
        raise ValueError(f"fault 'count' must be >= 0, got {count}")
    with _LOCK:
        _RULES.setdefault(site, []).append(
            _Rule(site=site, mode=mode, at=at, count=count, value=value)
        )
        _COUNTS.setdefault(site, 0)
        _ACTIVE = True
    logger.warning(
        "fault rule installed: %s:%s at=%d count=%d value=%s", site, mode, at, count, value,
    )


def install(spec: str) -> int:
    """Parse and install a spec string (module docstring); returns the
    number of rules installed. A malformed entry raises ValueError."""
    installed = 0
    for entry in (spec or "").replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, rest = entry.partition(":")
        if not sep or not site or not rest:
            raise ValueError(f"malformed fault entry {entry!r} (want site:mode[=v]@at[xN])")
        mode_part, _, pos_part = rest.partition("@")
        mode, _, value_s = mode_part.partition("=")
        at, count = 1, 1
        if pos_part:
            at_s, _, count_s = pos_part.partition("x")
            at = int(at_s)
            if count_s:
                count = int(count_s)
        configure(site.strip(), mode.strip(), at=at, count=count,
                  value=float(value_s) if value_s else 0.0)
        installed += 1
    return installed


def install_from_env() -> int:
    """Install rules from the ``GENAI_FAULTS`` environment variable."""
    spec = os.environ.get(ENV_VAR, "")
    return install(spec) if spec else 0


def active() -> bool:
    return _ACTIVE


def call_count(site: str) -> int:
    with _LOCK:
        return _COUNTS.get(site, 0)


def reset() -> None:
    """Drop every rule and counter and release in-flight hangs."""
    global _ACTIVE, _HANG_GEN
    with _HANG_COND:
        _RULES.clear()
        _COUNTS.clear()
        _ACTIVE = False
        _HANG_GEN += 1
        _HANG_COND.notify_all()


# env-spec rules arm as soon as an instrumented module imports this one
if os.environ.get(ENV_VAR):
    try:
        install_from_env()
    except ValueError as exc:  # an operator's typo
        logger.error("invalid %s spec ignored: %s", ENV_VAR, exc)
