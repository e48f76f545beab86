"""The scheduler seam of the port's engine.

Counterpart of generativeaiexamples_tpu/engine/scheduler/base.py: admission
and wave formation sit behind one :class:`SchedulerPolicy` object that the
engine's dispatch loop consults, so ``unified`` (the default:
:mod:`.unified`) and ``disagg`` (:mod:`.disagg`) share one wave-formation
rule (``claim_wave``) and differ only in which thread forms the wave and
where its requests join the decode batch. The policy also owns the
co-scheduling windows: the retrieval micro-batcher's ``ingest_window``
and the retrieval tier's ``retrieval_window``.

The draft-aware gating of JAX's policy (``AcceptanceTracker``,
``should_draft``) belongs to speculative decoding and is not part of the
port's seam yet. JAX's ``WavePlan`` is not copied: the port's prefill
picks the bucket of each part of a wave itself, so a plan would carry
only the claimed requests. The handoff counters are plain integers
(``handoff.metrics_snapshot``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

POLICY_KINDS = ("unified", "disagg")


def build_policy(cfg, engine) -> "SchedulerPolicy":
    """The configured policy over a built engine (its slot state exists,
    its threads do not yet; ``start()`` runs after they do). The fields
    were checked by ``EngineConfig.validate``."""
    if cfg.scheduler_policy == "disagg":
        from generativeaiexamples_tpu_torch.engine.scheduler.disagg import DisaggPolicy

        return DisaggPolicy(engine)
    from generativeaiexamples_tpu_torch.engine.scheduler.unified import UnifiedPolicy

    return UnifiedPolicy(engine)


class SchedulerPolicy:
    """Admission, wave formation and the co-scheduling windows."""

    kind = "base"

    def __init__(self, engine) -> None:
        self.engine = engine

    # -- lifecycle ----------------------------------------------------- #
    def start(self) -> None:
        """Start tier workers (after the engine's own threads)."""

    def stop(self) -> bool:
        """Join tier workers; True when all of them exited."""
        return True

    # -- dispatch-loop hooks ------------------------------------------- #
    def has_work(self) -> bool:
        """Whether the decode loop has admission work (caller holds the
        engine lock)."""
        raise NotImplementedError

    def admit(self) -> None:
        """The decode loop's admission step."""
        raise NotImplementedError

    # -- drain seam ---------------------------------------------------- #
    def wave_inflight(self) -> int:
        """Prefill waves mid-dispatch on a tier thread; a drain waits for
        0 before it reads live request state (caller holds the lock)."""
        return 0

    def drain_handoffs(self) -> list:
        """Pop every queued tier-crossing record at drain time; the caller
        checkpoints or completes each (caller holds the lock)."""
        return []

    # -- co-scheduling seams ------------------------------------------- #
    def ingest_window(self, timeout: float) -> bool:
        """Block until bulk ingest work may run, or ``timeout`` elapses;
        True when granted."""
        raise NotImplementedError

    def retrieval_window(self, timeout: float) -> bool:
        """Block until a retrieval-tier wave may dispatch, or ``timeout``
        elapses (the tier dispatches then anyway); True when granted."""
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        return {"policy": self.kind}

    # -- shared wave formation ----------------------------------------- #
    def _on_claimed(self, admitted: List[Any]) -> None:
        """A wave was claimed (engine lock held): the policy records where
        its requests' slots are held."""

    def claim_wave(self) -> Optional[List[Any]]:
        """Claim one admission wave from the backlog, in arrival order: up
        to the free slots and ``prefill_wave_tokens`` rows of one prefill
        bucket (``prefill_chunk``, or ``max_seq_len`` when shorter), each
        request holding its slot. Slot placement is the free list's pop.
        None when paused or nothing waits."""
        eng = self.engine
        with eng._lock:
            if eng._paused:
                return None
            bucket = eng._prefill_bucket(1)
            limit = min(len(eng._free_slots), eng._max_wave_rows(bucket))
            admitted: List[Any] = []
            while eng._pending and len(admitted) < limit:
                req = eng._pending.popleft()
                req.slot = eng._free_slots.pop()
                admitted.append(req)
            if admitted:
                self._on_claimed(admitted)
        return admitted or None
