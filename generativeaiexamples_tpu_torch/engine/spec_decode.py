"""Speculative decoding: the host-side half and the proposer seam.

A copy of generativeaiexamples_tpu/engine/spec_decode.py whose metric
families are plain integer counters under one lock here
(:func:`metrics_snapshot`); the port registers no metric families.

Two draft sources share one verify and acceptance contract:

- **prompt lookup** (no draft model): match the tail of a request's
  prompt + output against earlier occurrences in it and propose what
  followed the most recent one (RAG and multi-turn outputs copy spans of
  their context);
- **resident draft model** (``spec_proposer='draft_model'``): a second,
  small Llama next to the target (engine/spec_draft.py) drafts K greedy
  tokens for the whole decode wave in one batched dispatch.

Either way the engine scores all K draft positions of every slot in one
verify dispatch (models/llama.py ``verify_layers`` /
``verify_layers_paged``) and accepts the longest prefix of each row's
draft that equals the target's own (greedy or seeded-sampled) outputs:
a proposal never changes a stream, only how many tokens a dispatch
emits.

This module holds the :class:`SpecProposer` seam (lookup, draft model,
combined), the draft-length capping rule every proposer shares, the
draft-frontier bookkeeping (:class:`DraftTracker`), the adaptive draft
width (:class:`AdaptiveK`), a host mirror of the device acceptance rule,
the knob checks and the counters. The verify programs and the scheduler
integration live in engine/llm_engine.py, the draft model in
engine/spec_draft.py.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Counters (process-wide, as the JAX families are): draft tokens proposed
# and accepted, acceptance-ratio sum and count over (row, dispatch) pairs
# that drafted, tokens emitted per live row per verify dispatch (sum and
# count), resident-draft dispatches by program, adaptive-K rounds and the
# sum of their widths.
_LOCK = threading.Lock()
counters: "collections.Counter[str]" = collections.Counter(dict.fromkeys((
    "drafted", "accepted", "acceptance_sum", "acceptance_n", "dispatch_tokens_sum",
    "dispatch_tokens_n", "draft_dispatches_propose", "draft_dispatches_prefill",
    "adaptive_rounds", "adaptive_k_sum",
), 0))

# The kind of the synchronizing call a thread is making, where the spec
# path allows one: speculative decoding trades the pipelined readback for
# host reads the next proposal needs (the verify's packed result, a
# wave's first tokens, the zero-draft block, the draft proposals). A
# measurement (``chip_smoke.py``'s sync counter) reads it to tell them
# from any other sync on the dispatch thread.
_SYNC = threading.local()


def sync_kind() -> Optional[str]:
    """The allowed kind of the synchronizing call this thread is in, or
    None."""
    return getattr(_SYNC, "kind", None)


@contextlib.contextmanager
def allowed_sync(kind: str):
    """Mark the synchronizing calls made inside as ``kind``."""
    prev = getattr(_SYNC, "kind", None)
    _SYNC.kind = kind
    try:
        yield
    finally:
        _SYNC.kind = prev


# The proposer registry: values the ``spec_proposer`` knob accepts.
# 'lookup' is the prompt-lookup path; 'draft_model' drafts with the
# resident small model; 'combined' tries lookup first and falls back to
# the draft model's proposal where the n-gram scan finds nothing.
PROPOSER_KINDS = ("lookup", "draft_model", "combined")


def effective_draft_len(cfg) -> int:
    """The draft width K every layer agrees on: the verify chunk's width,
    the ``cap_draft_len`` callers, the paged admission funding slack
    (``decode_block + K + 1``) and the draft-model program's step count
    all read this one rule, so the draft path can never propose past the
    funded page reservation.

    ``spec_draft_model_len`` (> 0, draft-model/combined proposers only)
    overrides ``spec_draft_len``; 0 inherits it."""
    k = max(1, cfg.spec_draft_len)
    if getattr(cfg, "spec_proposer", "lookup") in ("draft_model", "combined"):
        override = getattr(cfg, "spec_draft_model_len", 0)
        if override > 0:
            k = override
    return k


def adaptive_k_ladder(k_max: int, k_min: int) -> Tuple[int, ...]:
    """The closed set of verify widths adaptive K may pick, descending:
    halvings from ``k_max`` down to ``k_min`` inclusive (8 -> [8, 4, 2,
    1])."""
    k_max = max(1, int(k_max))
    k_min = max(1, min(int(k_min), k_max))
    rungs: List[int] = []
    k = k_max
    while k > k_min:
        rungs.append(k)
        k = max(k_min, k // 2)
    rungs.append(k_min)
    return tuple(rungs)


class AdaptiveK:
    """Acceptance-adaptive verify width (``spec_adaptive_k=on``): each
    round's draft width from the rolling acceptance ratio of the
    scheduler's ``AcceptanceTracker``:

    - no evidence yet (``ratio() is None``) -> ``k_max``;
    - ratio >= ``threshold`` -> ``k_max``: a load whose acceptance never
      dips below the threshold runs every round at k_max, as fixed K does;
    - otherwise the smallest ladder rung covering the expected acceptance
      depth ``ceil(ratio * k_max)`` (floored at ``k_min``);
    - every ``probe_interval``-th consecutive shrunk round runs ``k_max``
      anyway, so a recovered workload re-measures at full width.

    Funding is not adaptive: :func:`effective_draft_len` still bounds the
    paged admission slack at the configured max. Single writer (the
    dispatch thread), host arithmetic only."""

    def __init__(
        self,
        k_max: int,
        k_min: int = 1,
        threshold: float = 0.5,
        probe_interval: int = 16,
    ) -> None:
        self.k_max = max(1, int(k_max))
        self.k_min = max(1, min(int(k_min), self.k_max))
        self.threshold = float(threshold)
        self.probe_interval = max(1, int(probe_interval))
        self.ladder = adaptive_k_ladder(self.k_max, self.k_min)
        self._shrunk_rounds = 0

    def pick(self, ratio: Optional[float]) -> int:
        """Draft width for the next spec round given the tracker's rolling
        acceptance ratio (None = insufficient evidence)."""
        if ratio is None or ratio >= self.threshold:
            self._shrunk_rounds = 0
            return self.k_max
        self._shrunk_rounds += 1
        if self._shrunk_rounds >= self.probe_interval:
            # probe round: full width once, so the window can recover
            self._shrunk_rounds = 0
            return self.k_max
        want = max(self.k_min, min(self.k_max, int(np.ceil(ratio * self.k_max))))
        for k in reversed(self.ladder):  # ascending rungs
            if k >= want:
                return k
        return self.k_max


_CKPT = "checkpoints load with training and checkpoints (ROADMAP queue 1 item 10)"


def refuse_draft_checkpoint(cfg) -> None:
    """A draft checkpoint path is refused until checkpoints load."""
    if getattr(cfg, "spec_draft_checkpoint_path", ""):
        raise ValueError(f"spec_draft_checkpoint_path={cfg.spec_draft_checkpoint_path}: {_CKPT}")


def validate_config(cfg, startup: bool = False) -> None:
    """The spec-decode knobs' checks, each field's rule once, with the JAX
    package's text for the layer that refuses: its engine's
    (``EngineConfig.validate`` calls this) or, with ``startup``, its chain
    server's startup check (config/validate.py, called by
    ``config_validate``) for the fields that check covers."""

    def refuse(engine: str, at_startup: Optional[str] = None) -> None:
        raise ValueError(at_startup if startup and at_startup else engine)

    if cfg.spec_decode_enable not in ("on", "off"):
        refuse(f"spec_decode_enable must be on|off, got {cfg.spec_decode_enable!r}")
    # the JAX engine reads anything but 'off' as on; the port refuses it
    if cfg.spec_pipeline_enable not in ("on", "off"):
        refuse(f"engine.spec_pipeline_enable must be on|off, got {cfg.spec_pipeline_enable!r}")
    if cfg.spec_draft_len < 1:
        refuse(f"spec_draft_len must be >= 1, got {cfg.spec_draft_len}")
    if cfg.spec_ngram_max < 1:
        refuse(f"spec_ngram_max must be >= 1, got {cfg.spec_ngram_max}")
    proposer = cfg.spec_proposer
    if proposer not in PROPOSER_KINDS:
        refuse(f"spec_proposer must be one of {'|'.join(PROPOSER_KINDS)}, got {proposer!r}",
               f"engine.spec_proposer must be one of {PROPOSER_KINDS}, got {proposer!r}")
    if proposer != "lookup" and not (cfg.spec_draft_model or cfg.spec_draft_checkpoint_path):
        refuse(f"spec_proposer={proposer!r} needs a resident draft "
               f"model: set spec_draft_model (a models/llama.py preset "
               f"name) or spec_draft_checkpoint_path",
               f"engine.spec_proposer={proposer!r} requires "
               f"engine.spec_draft_model or engine.spec_draft_checkpoint_path"
               if cfg.spec_decode_enable == "on" else None)
    refuse_draft_checkpoint(cfg)
    if cfg.spec_draft_model_len < 0:
        refuse(f"spec_draft_model_len must be >= 0 (0 = inherit "
               f"spec_draft_len), got {cfg.spec_draft_model_len}")
    if cfg.spec_draft_kv_dtype not in ("bfloat16", "int8"):
        refuse(f"spec_draft_kv_dtype must be 'bfloat16' or 'int8', got "
               f"{cfg.spec_draft_kv_dtype!r}")
    if not 0.0 <= cfg.spec_draft_min_acceptance < 1.0:
        refuse(f"engine.spec_draft_min_acceptance must be in [0, 1) "
               f"(0 disables draft-aware skipping), got {cfg.spec_draft_min_acceptance}",
               f"engine.spec_draft_min_acceptance must be in [0, 1) "
               f"(0 disables), got {cfg.spec_draft_min_acceptance}")
    if cfg.spec_adaptive_k not in ("on", "off"):
        refuse(f"spec_adaptive_k must be on|off, got {cfg.spec_adaptive_k!r}",
               f"engine.spec_adaptive_k must be on|off, got {cfg.spec_adaptive_k!r}")
    k_min, k_max = cfg.spec_adaptive_k_min, effective_draft_len(cfg)
    if not 1 <= k_min <= k_max:
        # the startup check covers only the lower bound
        refuse(f"spec_adaptive_k_min must be in [1, {k_max}] "
               f"(the effective draft width), got {k_min}",
               f"engine.spec_adaptive_k_min must be >= 1, got {k_min}" if k_min < 1 else None)
    thr = cfg.spec_adaptive_k_threshold
    if not 0.0 < thr <= 1.0:
        refuse(f"spec_adaptive_k_threshold must be in (0, 1], got {thr}",
               f"engine.spec_adaptive_k_threshold must be in (0, 1], got {thr}")


def propose(ctx: Sequence[int], max_ngram: int, draft_len: int) -> List[int]:
    """Prompt-lookup draft for one row: match the longest tail n-gram
    (n = max_ngram down to 1) against an earlier occurrence in ``ctx``
    (the request's prompt + generated tokens) and return up to
    ``draft_len`` tokens following the most recent match.

    Longest n first, and within an n the newest match with a full
    ``draft_len`` continuation (the continuation may overlap the tail
    itself, which lets a period-p loop draft whole K-token blocks); the
    newest short continuation is the fallback when no full one exists.
    Returns [] when nothing matches (the row then runs as a plain
    single-token step inside the same verify dispatch). A numpy
    sliding-window compare."""
    n_ctx = len(ctx)
    if draft_len <= 0 or n_ctx < 2:
        return []
    arr = np.asarray(ctx, dtype=np.int64)
    for n in range(min(max_ngram, n_ctx - 1), 0, -1):
        tail = arr[n_ctx - n:]
        # match starts 0 .. n_ctx-1-n: the match must end before the tail
        # starts so at least one continuation token exists
        windows = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
        hits = np.nonzero((windows == tail).all(axis=1))[0]
        if hits.size == 0:
            continue
        short_cont: List[int] = []
        for start in hits[::-1]:  # newest first
            cont = arr[start + n:start + n + draft_len]
            if cont.size == draft_len:
                return [int(t) for t in cont]
            if cont.size and not short_cont:
                short_cont = [int(t) for t in cont]
        if short_cont:
            return short_cont
    return []


def draft_eligible(params) -> bool:
    """Whether a request's sampling params allow prompt-lookup drafting:
    greedy (temperature <= 0) and not opted out (``spec_decode`` is not
    False). Admission's context seeding, the engine's draftable-batch
    gate and each proposal all ask :meth:`SpecProposer.eligible`."""
    return params.temperature <= 0 and params.spec_decode is not False


# --------------------------------------------------------------------------- #
# The proposer seam. The engine owns clamping (every proposer gets caps
# from the same cap_draft_len rule) and the acceptance contract; a
# proposer only decides what to propose.


class SpecProposer:
    """One draft source. Every hook runs on the engine's dispatch thread:

    - ``eligible(params)``: whether this proposer drafts for a request
      (lookup: greedy rows; the draft-model proposers: sampled rows too,
      since the verify samples every position with plain decode's keys);
    - ``on_admit(slot, prompt_len)``: a draft-capable request took
      ``slot`` and its context was seeded (the draft-model proposer
      records the slot's draft-KV frontier);
    - ``on_release(slot)``: the slot left the decode batch;
    - ``propose_wave(rows)``: one round; ``rows`` is ``[(slot, ctx,
      cap)]`` for every live eligible row, and the result maps a slot to
      its draft, each within its row's cap."""

    kind = "none"
    # whether this proposer drafts with the resident draft model (the
    # engine prefills admitted prompts into the draft cache only then)
    uses_draft_model = False
    # whether the pipelined spec dispatch may call propose_wave on an
    # optimistic context while the verify is in flight: only a proposer
    # that is a pure function of the context it is given
    supports_runahead = False

    def eligible(self, params) -> bool:
        return draft_eligible(params)

    def on_admit(self, slot: int, prompt_len: int) -> None:  # noqa: ARG002
        return None

    def on_release(self, slot: int) -> None:  # noqa: ARG002
        return None

    def reset(self) -> None:
        return None

    def propose_wave(
        self, rows: Sequence[Tuple[int, Sequence[int], int]]
    ) -> Dict[int, List[int]]:
        raise NotImplementedError


class LookupProposer(SpecProposer):
    """Prompt-lookup drafting: a host n-gram scan per row, no device
    work, greedy rows only."""

    kind = "lookup"
    supports_runahead = True

    def __init__(self, ngram_max: int) -> None:
        self.ngram_max = max(1, ngram_max)

    def propose_wave(self, rows):
        out: Dict[int, List[int]] = {}
        for slot, ctx, cap in rows:
            if cap <= 0:
                continue
            d = propose(ctx, self.ngram_max, cap)
            if d:
                out[slot] = d
        return out


class DraftModelProposer(SpecProposer):
    """Resident-draft-model drafting through the engine's runtime
    (engine/spec_draft.py), which owns the batched draft dispatch and the
    per-slot draft-KV frontiers. Drafts sampled rows too."""

    kind = "draft_model"
    uses_draft_model = True

    def __init__(self, runtime) -> None:
        self._runtime = runtime

    def eligible(self, params) -> bool:
        return params.spec_decode is not False

    def on_admit(self, slot: int, prompt_len: int) -> None:
        self._runtime.on_admit(slot, prompt_len)

    def on_release(self, slot: int) -> None:
        self._runtime.on_release(slot)

    def reset(self) -> None:
        self._runtime.reset()

    def propose_wave(self, rows):
        return self._runtime.propose(rows)


class CombinedProposer(DraftModelProposer):
    """Lookup, then the draft model: rows whose n-gram scan matches draft
    for free; every other row takes the draft model's proposal. The draft
    dispatch still runs every round, so each row's catch-up span stays
    within the fixed catch-up width."""

    kind = "combined"

    def __init__(self, ngram_max: int, runtime) -> None:
        super().__init__(runtime)
        self.ngram_max = max(1, ngram_max)

    def propose_wave(self, rows):
        model = self._runtime.propose(rows)
        out: Dict[int, List[int]] = {}
        for slot, ctx, cap in rows:
            if cap <= 0:
                continue
            d = propose(ctx, self.ngram_max, cap)
            if not d:
                d = model.get(slot, [])
            if d:
                out[slot] = d
        return out


class DraftTracker:
    """Each slot's draft-model KV frontier, host only.

    ``fed[slot]`` counts the tokens of the slot's context already written
    into the draft cache. A verify that accepted ``n`` draft tokens
    extends the context by ``n + 1`` while ``fed`` stays at the pre-draft
    length, so the next round's catch-up span is exactly those ``n + 1 <=
    K + 1`` tokens, and writing them overwrites the rejected speculative
    rows in place (the acceptance rewind).

    A row leaves the invariant only by not drafting while others do (its
    cap hit 0 at the budget or capacity edge, and it never drafts again):
    ``begin_round`` then drops its state instead of feeding an oversized
    span."""

    def __init__(self, draft_k: int) -> None:
        self.draft_k = max(1, draft_k)
        self._fed: Dict[int, int] = {}

    @property
    def catchup_width(self) -> int:
        """Width of the catch-up chunk: a round emits at most ``accepted +
        bonus <= K + 1`` tokens per drafting row."""
        return self.draft_k + 1

    def on_admit(self, slot: int, prompt_len: int) -> None:
        self._fed[slot] = max(0, prompt_len)

    def on_release(self, slot: int) -> None:
        self._fed.pop(slot, None)

    def reset(self) -> None:
        self._fed.clear()

    def tracked(self, slot: int) -> bool:
        return slot in self._fed

    def begin_round(self, slot: int, ctx_len: int) -> Optional[Tuple[int, int]]:
        """(frontier, pending) for this round's catch-up, or None when the
        slot has no draft state. A pending span outside ``[1,
        catchup_width]`` retires the slot's state."""
        fed = self._fed.get(slot)
        if fed is None:
            return None
        pending = ctx_len - fed
        if pending < 1 or pending > self.catchup_width:
            self._fed.pop(slot, None)
            return None
        return fed, pending

    def mark_fed(self, slot: int, ctx_len: int) -> None:
        """This round's catch-up chunk was dispatched: the whole context is
        in the draft cache."""
        self._fed[slot] = ctx_len


def cap_draft_len(draft_len: int, position: int, budget: int,
                  max_seq_len: int) -> int:
    """Clamp a row's draft length so the verify chunk stays inside both
    budgets: ``budget - 1`` (the dispatch emits accepted + 1 tokens) and
    ``max_seq_len - 2 - position`` (the chunk writes KV rows at
    [position, position + draft_len] and the bonus token's next write
    position must stay < max_seq_len - 1)."""
    return max(0, min(draft_len, budget - 1, max_seq_len - 2 - position))


def accepted_length(draft: Sequence[int], verified: Sequence[int]) -> int:
    """Host mirror of the device acceptance rule: the number of leading
    draft tokens equal to the verify outputs at the same index."""
    n = 0
    for d, v in zip(draft, verified):
        if d != v:
            break
        n += 1
    return n


def _add(**values) -> None:
    with _LOCK:
        counters.update(values)


def record_draft_dispatch(program: str = "propose", n: int = 1) -> None:
    """Count resident-draft launches: ``propose`` (one catch-up + K-step
    dispatch a round) or ``prefill`` (admission's chunk dispatches)."""
    _add(**{f"draft_dispatches_{program}": n})


def record_dispatch(drafted: int, accepted: int) -> None:
    """Account one (row, dispatch): ``drafted`` proposed tokens of which
    ``accepted`` were kept; tokens emitted is accepted + 1."""
    values = {"dispatch_tokens_sum": accepted + 1, "dispatch_tokens_n": 1}
    if drafted > 0:
        values.update(drafted=drafted, accepted=accepted,
                      acceptance_sum=accepted / drafted, acceptance_n=1)
    _add(**values)


def record_adaptive_round(k: int) -> None:
    """Account one adaptive-K spec round dispatched at width ``k``."""
    _add(adaptive_rounds=1, adaptive_k_sum=int(k))


def metrics_snapshot() -> dict:
    """The JAX engine's flat keys for these counters."""
    with _LOCK:
        c = dict(counters)
    drafted, accepted = c["drafted"], c["accepted"]
    return {
        "spec_drafted_tokens": drafted,
        "spec_accepted_tokens": accepted,
        "spec_acceptance_rate": (accepted / drafted) if drafted else 0.0,
        "spec_tokens_per_step": (
            c["dispatch_tokens_sum"] / c["dispatch_tokens_n"] if c["dispatch_tokens_n"] else 0.0
        ),
        "spec_draft_dispatches": c["draft_dispatches_propose"] + c["draft_dispatches_prefill"],
        "spec_adaptive_rounds": c["adaptive_rounds"],
        "spec_adaptive_k_sum": c["adaptive_k_sum"],
    }
