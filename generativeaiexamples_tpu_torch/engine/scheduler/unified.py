"""The default single-tier scheduler policy.

Counterpart of generativeaiexamples_tpu/engine/scheduler/unified.py: the
dispatch thread claims one wave a pass (``claim_wave``), registers its
slots into the decode batch at once, and prefills it inline, so admission
alternates with decode blocks on one thread.

The ingest window is the decode-idle condition the retrieval
micro-batcher waits for before bulk embedding; the retrieval window waits
out pending admissions only (the dispatch thread is about to prefill).
"""
from __future__ import annotations

import time
from typing import Any, Dict

from generativeaiexamples_tpu_torch.engine.scheduler.base import SchedulerPolicy


class UnifiedPolicy(SchedulerPolicy):
    kind = "unified"

    def has_work(self) -> bool:
        """Pending admissions wake the dispatch loop (caller holds the
        engine lock); ``hold_admissions`` masks them."""
        eng = self.engine
        return bool(eng._pending) and not eng._paused

    def _on_claimed(self, admitted) -> None:
        for req in admitted:
            self.engine._register(req, req.slot)

    def admit(self) -> None:
        """One wave a pass, claimed, registered and prefilled on the
        dispatch thread."""
        wave = self.claim_wave()
        if wave is not None:
            self.engine._prefill_claimed(wave, register=True)

    def ingest_window(self, timeout: float) -> bool:
        """Block until no request occupies a decode slot, or ``timeout``
        elapses; True when idle. The dispatch thread notifies the engine
        condition when it frees a slot."""
        eng = self.engine
        deadline = time.monotonic() + max(0.0, timeout)
        with eng._lock:
            while eng._slot_req:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                eng._lock.wait(remaining)
            return True

    def retrieval_window(self, timeout: float) -> bool:
        """Wait out pending admissions only: a backlog means a prefill is
        about to run, while decode occupancy is the steady state a search
        wave has to run beside."""
        eng = self.engine
        deadline = time.monotonic() + max(0.0, timeout)
        with eng._lock:
            while eng._pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                eng._lock.wait(remaining)
            return True

    def describe(self) -> Dict[str, Any]:
        return {"policy": self.kind, "tiers": 1}
