"""Prefill/decode disaggregation: two tiers over one KV page pool.

Counterpart of generativeaiexamples_tpu/engine/scheduler/disagg.py: a
prefill-tier thread (``torch-llm-prefill-tier``) claims admission waves
and runs their prefill, and the engine's dispatch thread becomes the
decode tier, which never prefills: it imports finished prefills between
decode blocks. The tiers meet at a bounded
:class:`~.handoff.TransferQueue` of :class:`~.handoff.KVHandoff` records;
both share the pool, so a handoff moves page ownership, never a copy.

Streams and ordering. Both tiers launch on the device's current stream
(the default stream of one card), so the device runs their work in the
order the host launched it. The prefill tier launches a wave's table
writes, prefill and first-token sampling, queues the first tokens for the
reader, and only then puts the records in the transfer queue; the decode
tier imports a record (one indexed write of the slot state) before the
next block it dispatches, so every page the prefill wrote is ordered
before any decode read of it, and the first token reaches the reader
ahead of the request's decode tokens. Until the import, a claimed slot is
dead to decode (it writes the scratch page); a slot is released with its
device resets launched before it returns to the free list, so a wave that
claims it next writes its table after the reset. Neither tier waits for
the device.

Imports land between blocks: the decode tier imports at the top of a
loop pass, before it dispatches its next block, so a record never joins
a block already dispatched (whatever ``decode_runahead``). Prefix-cache
hits are retained in ``_fund`` on the prefill tier and their refcounts
travel with the record like any other funded page.

Requires the paged KV layout (pages are the handoff unit) and refuses
the fixed one with the JAX package's message.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict

import torch

from generativeaiexamples_tpu_torch.engine.scheduler import handoff as handoff_mod
from generativeaiexamples_tpu_torch.engine.scheduler.base import SchedulerPolicy

logger = logging.getLogger(__name__)


class DisaggPolicy(SchedulerPolicy):
    kind = "disagg"

    def __init__(self, engine) -> None:
        super().__init__(engine)
        cfg = engine.engine_config
        if not getattr(engine, "_paged", False):
            raise ValueError(
                "scheduler_policy='disagg' requires the paged KV layout "
                "(pages are the handoff unit); this config resolved "
                "kv_layout='fixed' — set kv_layout='paged' or fix the "
                "page geometry (see kv_pages.auto_layout_blockers)"
            )
        depth = cfg.handoff_queue_depth or 2 * engine.num_slots
        self._cond = engine._lock
        self.transfer = handoff_mod.TransferQueue(depth, self._cond)
        self._prefill_inflight = 0  # guarded by self._cond
        self._thread = threading.Thread(
            target=self._prefill_loop, daemon=True, name="torch-llm-prefill-tier"
        )
        logger.info("disagg scheduler: one card, shared pool, transfer queue depth %d", depth)

    # -- lifecycle ----------------------------------------------------- #
    def start(self) -> None:
        self._thread.start()

    def stop(self) -> bool:
        """Join the prefill tier (the engine already stopped running)."""
        if not self._thread.is_alive():
            return True
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            logger.error("disagg prefill tier did not join within 10 s")
            return False
        return True

    # -- dispatch-loop hooks ------------------------------------------- #
    def has_work(self) -> bool:
        """Queued handoffs wake the decode loop; pending requests belong
        to the prefill tier (caller holds the engine lock)."""
        return len(self.transfer) > 0

    def admit(self) -> None:
        """Decode-tier admission: import every queued handoff."""
        eng = self.engine
        with self._cond:
            recs = self.transfer.pop_all()
        for rec in recs:
            handoff_mod.record_wait(max(0.0, time.time() - rec.t_enqueue))
            eng._import_handoff(rec)

    # -- drain seam ---------------------------------------------------- #
    def wave_inflight(self) -> int:
        """Caller holds self._cond (the engine lock)."""
        return self._prefill_inflight

    def drain_handoffs(self) -> list:
        return self.transfer.pop_all()

    # -- co-scheduling seams ------------------------------------------- #
    def _prefill_idle(self, timeout: float) -> bool:
        eng = self.engine
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cond:
            while eng._pending or self._prefill_inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def ingest_window(self, timeout: float) -> bool:
        """Bulk ingest yields to the prefill tier: the window opens when
        nothing is pending and no wave is in flight."""
        return self._prefill_idle(timeout)

    def retrieval_window(self, timeout: float) -> bool:
        """The same predicate: prefill compute is the contended resource."""
        return self._prefill_idle(timeout)

    def describe(self) -> Dict[str, Any]:
        with self._cond:
            queued = len(self.transfer)
            inflight = self._prefill_inflight
        return {"policy": self.kind, "tiers": 2,
                "transfer_queue_capacity": self.transfer.capacity,
                "transfer_queued": queued, "prefill_inflight": inflight,
                "shared_pool": True}

    # -- wave formation hooks ------------------------------------------ #
    def _on_claimed(self, admitted) -> None:
        """The claimed slots stay the prefill tier's until import."""
        for req in admitted:
            self.engine._tier_slots[req.slot] = req

    # -- the prefill tier ---------------------------------------------- #
    def _prefill_loop(self) -> None:
        """Claim a wave, prefill it, hand its records to the decode tier.
        A full transfer queue stalls this loop before the next claim."""
        eng = self.engine
        while True:
            with self._cond:
                # a release notifies the engine lock: with no free slot the
                # tier waits for one instead of claiming empty waves
                while eng._running and (not eng._pending or eng._paused or not eng._free_slots):
                    self._cond.wait(timeout=1.0)
                if not eng._running:
                    return
                stall = self.transfer.wait_room(
                    stop=lambda: not eng._running or eng._paused or not eng._pending)
                if not eng._running:
                    return
                if eng._paused or not eng._pending or not self.transfer.has_room():
                    continue
                self._prefill_inflight += 1
            if stall > 1e-3:
                handoff_mod.record_stall(stall)
            wave = None
            try:
                wave = self.claim_wave()
                if wave is not None:
                    with torch.inference_mode():
                        records = eng._prefill_claimed(wave, register=False)
                    with self._cond:
                        for rec in records:
                            rec.t_enqueue = time.time()
                            handoff_mod.record_handoff(len(rec.pages), rec.nbytes)
                            self.transfer.put(rec)
                        eng._last_progress = time.time()
            except Exception as exc:  # noqa: BLE001 - the tier must survive
                logger.exception("prefill-tier error: %s", exc)
                if wave is not None:
                    eng._fail_claims(wave, exc)
            finally:
                with self._cond:
                    self._prefill_inflight -= 1
                    self._cond.notify_all()
