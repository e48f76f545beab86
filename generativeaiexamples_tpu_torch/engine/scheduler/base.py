"""The scheduler seam of the port's engine.

Counterpart of generativeaiexamples_tpu/engine/scheduler/base.py: admission
and wave formation sit behind one :class:`SchedulerPolicy` object that the
engine's dispatch loop consults, so ``unified`` (the default:
:mod:`.unified`) and ``disagg`` (:mod:`.disagg`) share one wave-formation
rule (``claim_wave``) and differ only in which thread forms the wave and
where its requests join the decode batch. The policy also owns the
co-scheduling windows: the retrieval micro-batcher's ``ingest_window``
and the retrieval tier's ``retrieval_window``.

It also gates speculative decoding's draft model as JAX's does:
:class:`AcceptanceTracker` keeps a rolling window of verify rounds'
acceptance, and ``should_draft`` skips the resident-draft dispatch while
the ratio sits below ``spec_draft_min_acceptance`` (with probe rounds;
``draft_skips`` counts the skips); ``AdaptiveK`` reads the same ratio.
JAX's ``WavePlan`` is not copied: the port's prefill picks the bucket of
each part of a wave itself, so a plan would carry only the claimed
requests. The draft skips count in JAX's
``genai_engine_spec_draft_skips_total``; ``claim_wave`` observes each
request's queue wait and stamps its ``admit`` flight event at its first
claim, as JAX's does.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

from generativeaiexamples_tpu_torch.utils import flight_recorder
from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

_REG = metrics_mod.get_registry()
_M_SPEC_DRAFT_SKIPS = _REG.counter(
    "genai_engine_spec_draft_skips_total",
    "Spec rounds where the scheduler policy skipped the resident-draft "
    "dispatch because the rolling acceptance ratio fell below "
    "spec_draft_min_acceptance (the wave ran the synced block-decode "
    "fallback instead; draft-aware scheduling, docs/scheduler.md).",
)

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


class AcceptanceTracker:
    """Rolling draft-acceptance window for draft-aware scheduling (a copy
    of JAX's). Host arithmetic, single writer (the dispatch thread). A
    round counts only when it drafted; when the ratio over the last
    ``window`` drafting rounds drops below ``min_acceptance`` (with at
    least ``min_rounds`` rounds of evidence) drafting is skipped, except
    every ``probe_interval``-th skipped round, which drafts so the window
    sees fresh acceptance. ``min_acceptance <= 0`` disables it."""

    def __init__(
        self,
        min_acceptance: float = 0.0,
        window: int = 32,
        probe_interval: int = 16,
        min_rounds: int = 4,
    ) -> None:
        self.min_acceptance = float(min_acceptance)
        self.probe_interval = max(1, int(probe_interval))
        self.min_rounds = max(1, int(min_rounds))
        self._rounds: "collections.deque" = collections.deque(maxlen=max(1, window))
        self._skips_since_probe = 0

    def record(self, drafted: int, accepted: int) -> None:
        """One verify round's (drafted, accepted) token counts; zero-draft
        rounds carry no evidence."""
        if drafted > 0:
            self._rounds.append((int(drafted), int(accepted)))

    def ratio(self) -> Optional[float]:
        """Rolling acceptance ratio, or None without enough evidence."""
        if len(self._rounds) < self.min_rounds:
            return None
        drafted = sum(d for d, _ in self._rounds)
        if drafted <= 0:
            return None
        return sum(a for _, a in self._rounds) / drafted

    def should_draft(self) -> bool:
        """Whether the next spec round should run the draft dispatch."""
        if self.min_acceptance <= 0.0:
            return True
        r = self.ratio()
        if r is None or r >= self.min_acceptance:
            self._skips_since_probe = 0
            return True
        self._skips_since_probe += 1
        if self._skips_since_probe >= self.probe_interval:
            # probe round: draft once so the window re-measures
            self._skips_since_probe = 0
            return True
        return False


class SchedulerPolicy:
    """Admission, wave formation, the co-scheduling windows and
    draft-aware gating."""

    kind = "base"

    def __init__(self, engine) -> None:
        self.engine = engine
        self.tracker = AcceptanceTracker(
            getattr(engine.engine_config, "spec_draft_min_acceptance", 0.0)
        )
        # spec rounds whose draft dispatch was skipped (dispatch thread)
        self.draft_skips = 0

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

    def should_draft(self) -> bool:
        """Draft-aware gating (dispatch thread): False skips the
        resident-draft dispatch for this spec round (the engine runs the
        zero-draft block and counts the skip)."""
        ok = self.tracker.should_draft()
        if not ok:
            self.draft_skips += 1
            _M_SPEC_DRAFT_SKIPS.inc()
        return ok

    def record_spec_round(self, drafted: int, accepted: int) -> None:
        """One landed verify round's acceptance, into the tracker."""
        self.tracker.record(drafted, accepted)

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
        from generativeaiexamples_tpu_torch.engine import llm_engine as eng_mod

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
                # a backpressure requeue claims again: the queue wait and
                # the admit event belong to the first claim only
                if not req.t_admit:
                    req.t_admit = time.time()
                    eng_mod._M_QUEUE_WAIT.observe(req.t_admit - req.t_submit,
                                                  trace_id=req.trace_hex)
                    flight_recorder.event_rid(
                        req.rid, "admit", slot=req.slot,
                        queue_wait_s=round(req.t_admit - req.t_submit, 6),
                    )
                admitted.append(req)
            eng_mod._M_QUEUE_DEPTH.set(len(eng._pending))
            if admitted:
                self._on_claimed(admitted)
        return admitted or None
