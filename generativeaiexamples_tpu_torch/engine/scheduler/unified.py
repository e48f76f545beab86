"""The default single-tier scheduler policy, as far as the port serves it.

Counterpart of generativeaiexamples_tpu/engine/scheduler/unified.py. The
port's dispatch loop still admits, prefills and decodes by itself
(``LLMEngine._loop``); what this slice takes from the policy is the
co-scheduling seam the retrieval micro-batcher calls: ``ingest_window``,
the decode-idle condition bulk embedding waits for (the JAX engine's
``wait_decode_idle`` became this). The rest of the scheduler seam
(admission, wave formation, disaggregation) is ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import time


class UnifiedPolicy:
    kind = "unified"

    def __init__(self, engine):
        self.engine = engine

    def has_work(self) -> bool:
        """Pending admissions wake the dispatch loop (caller holds the
        engine lock); ``hold_admissions`` masks them."""
        eng = self.engine
        return bool(eng._pending) and not eng._paused

    def ingest_window(self, timeout: float) -> bool:
        """Block until no request occupies a decode slot, or ``timeout``
        elapses; True when idle. The dispatch thread notifies the engine
        condition when it frees a slot, so a waiter wakes when decode
        drains."""
        eng = self.engine
        deadline = time.monotonic() + max(0.0, timeout)
        with eng._lock:
            while eng._slot_req:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                eng._lock.wait(remaining)
            return True
