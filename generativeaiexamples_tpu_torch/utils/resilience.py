"""Request deadlines, carried across threads.

A trimmed copy of the JAX package's generativeaiexamples_tpu/utils/resilience.py:
the ``Deadline`` budget, its thread-local binding and ``DeadlineExceeded``,
which the retrieval micro-batcher reads. Retries, circuit breakers and
fault injection are not ported.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class ResilienceError(Exception):
    """Base class for the resilience layer's typed errors."""


class DeadlineExceeded(ResilienceError):
    """The request's deadline budget ran out."""


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
