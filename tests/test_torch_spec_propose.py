"""The port's speculative-decoding host half against the JAX package's
(engine/spec_decode.py in both): the prompt-lookup proposer, the
draft-length clamp, the acceptance rule's host mirror, the draft-frontier
tracker, the adaptive-K ladder and policy, the knob checks and their
messages, and the proposer seam, on the same numpy-seeded inputs. Every
result must be equal. Host only: no engine is built."""
import dataclasses
import re

import numpy as np
import pytest

from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine import spec_decode as jspec
from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import spec_decode as tspec
from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams


def _contexts(seed):
    """Buffers with repeats: a copied span, a loop, a random walk over a
    small alphabet and one over a large one."""
    rng = np.random.default_rng(seed)
    span = rng.integers(0, 500, 12).tolist()
    return [
        rng.integers(0, 500, 20).tolist() + span + rng.integers(0, 500, 5).tolist() + span[:4],
        [3, 1, 4] + [7] * int(rng.integers(2, 14)),
        rng.integers(0, 4, int(rng.integers(2, 60))).tolist(),
        rng.integers(0, 128256, 300).tolist(),
        [int(rng.integers(0, 9))],
        [],
    ]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("max_ngram", [1, 3, 5])
def test_propose_equals_jax(seed, max_ngram):
    for ctx in _contexts(seed):
        for draft_len in (-1, 0, 1, 4, 8):
            assert tspec.propose(ctx, max_ngram, draft_len) == jspec.propose(ctx, max_ngram, draft_len)


@pytest.mark.parametrize("seed", range(4))
def test_cap_draft_len_and_accepted_length_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        k, pos, budget, S = (int(x) for x in (rng.integers(1, 17), rng.integers(0, 140),
                                              rng.integers(-2, 40), rng.integers(16, 140)))
        assert tspec.cap_draft_len(k, pos, budget, S) == jspec.cap_draft_len(k, pos, budget, S)
        n = int(rng.integers(0, 9))
        draft = rng.integers(0, 3, n).tolist()
        verified = rng.integers(0, 3, n + 1).tolist()
        assert tspec.accepted_length(draft, verified) == jspec.accepted_length(draft, verified)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_draft_tracker_equals_jax(k):
    """The same admissions, rounds, acceptances, overflows and releases
    through both trackers give the same spans and states."""
    rng = np.random.default_rng(k)
    mine, ref = tspec.DraftTracker(k), jspec.DraftTracker(k)
    assert mine.catchup_width == ref.catchup_width == k + 1
    ctx = {}
    for step in range(300):
        slot = int(rng.integers(0, 4))
        op = rng.integers(0, 10)
        if op == 0 or slot not in ctx:
            n = int(rng.integers(1, 50))
            mine.on_admit(slot, n)
            ref.on_admit(slot, n)
            ctx[slot] = n + 1
        elif op == 1:
            mine.on_release(slot)
            ref.on_release(slot)
            ctx.pop(slot)
        else:
            a, b = mine.begin_round(slot, ctx[slot]), ref.begin_round(slot, ctx[slot])
            assert a == b, step
            if a is not None:
                mine.mark_fed(slot, ctx[slot])
                ref.mark_fed(slot, ctx[slot])
            # acceptance, now and then an overflow past K + 1
            ctx[slot] += int(rng.integers(1, k + 2)) if op < 9 else k + 3
        assert mine.tracked(slot) == ref.tracked(slot)
    mine.reset()
    ref.reset()
    assert not any(mine.tracked(s) for s in range(4))


@pytest.mark.parametrize("k_max,k_min", [(8, 1), (8, 3), (16, 2), (5, 5), (1, 1), (7, 9)])
def test_adaptive_k_ladder_and_picks_equal_jax(k_max, k_min):
    assert tspec.adaptive_k_ladder(k_max, k_min) == jspec.adaptive_k_ladder(k_max, k_min)
    rng = np.random.default_rng(k_max * 31 + k_min)
    for threshold, probe in ((0.5, 16), (0.9, 3), (1.0, 1)):
        mine = tspec.AdaptiveK(k_max, k_min, threshold, probe)
        ref = jspec.AdaptiveK(k_max, k_min, threshold, probe)
        assert mine.ladder == ref.ladder
        for _ in range(100):
            ratio = None if rng.random() < 0.1 else float(rng.random())
            assert mine.pick(ratio) == ref.pick(ratio)


def test_effective_draft_len_equals_jax():
    for proposer in tspec.PROPOSER_KINDS:
        for k, override in ((8, 0), (8, 12), (3, 1)):
            kw = dict(spec_draft_len=k, spec_proposer=proposer, spec_draft_model_len=override)
            assert tspec.effective_draft_len(EngineConfig(**kw)) == jspec.effective_draft_len(
                JaxEngineConfig(**kw))


BAD_KNOBS = [
    ("spec_decode_enable", "auto"),
    ("spec_draft_len", 0),
    ("spec_ngram_max", 0),
    ("spec_proposer", "oracle"),
    ("spec_proposer", "draft_model"),  # no draft model named
    ("spec_proposer", "combined"),
    ("spec_draft_model_len", -1),
    ("spec_draft_kv_dtype", "fp8"),
    ("spec_adaptive_k", "maybe"),
    ("spec_adaptive_k_min", 0),
    ("spec_adaptive_k_min", 9),
    ("spec_adaptive_k_threshold", 0.0),
    ("spec_adaptive_k_threshold", 1.5),
]


@pytest.mark.parametrize("field,value", BAD_KNOBS)
def test_validate_config_refuses_what_jax_refuses_with_its_message(field, value):
    with pytest.raises(ValueError) as ref:
        jspec.validate_config(JaxEngineConfig(**{field: value}))
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        tspec.validate_config(EngineConfig(**{field: value}))
    # the engine's config check runs it too
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        EngineConfig(**{field: value}).validate()


def test_validate_config_accepts_the_defaults_and_a_named_draft():
    for kw in ({}, {"spec_decode_enable": "on"},
               {"spec_proposer": "draft_model", "spec_draft_model": "debug-draft"},
               {"spec_adaptive_k": "on", "spec_adaptive_k_min": 8}):
        jspec.validate_config(JaxEngineConfig(**kw))
        tspec.validate_config(EngineConfig(**kw))
        EngineConfig(**kw).validate()


def test_spec_fields_have_the_jax_defaults():
    ref = JaxEngineConfig()
    mine = EngineConfig()
    names = [f.name for f in dataclasses.fields(EngineConfig) if f.name.startswith("spec_")]
    assert len(names) == 13
    for name in names:
        assert getattr(mine, name) == getattr(ref, name) and \
            type(getattr(mine, name)) is type(getattr(ref, name)), name


@pytest.mark.parametrize("temperature,spec", [(0.0, None), (0.0, False), (0.0, True),
                                              (0.7, None), (0.7, False)])
def test_eligibility_rules_equal_jax(temperature, spec):
    mine = SamplingParams(temperature=temperature, spec_decode=spec)
    ref = JaxParams(temperature=temperature, spec_decode=spec)
    assert tspec.draft_eligible(mine) == jspec.draft_eligible(ref)
    assert tspec.LookupProposer(3).eligible(mine) == jspec.LookupProposer(3).eligible(ref)
    assert tspec.DraftModelProposer(None).eligible(mine) == \
        jspec.DraftModelProposer(None).eligible(ref)


def test_sampling_params_spec_decode_defaults_to_none():
    assert SamplingParams().spec_decode is None is JaxParams().spec_decode


class _Runtime:
    """A draft runtime stand-in over a module's DraftTracker: a fixed
    token per slot, lifecycle calls recorded."""

    def __init__(self, mod, token=7, k=4):
        self.token, self.k = token, k
        self.tracker = mod.DraftTracker(k)
        self.calls = []

    def on_admit(self, slot, prompt_len):
        self.calls.append(("admit", slot, prompt_len))
        self.tracker.on_admit(slot, prompt_len)

    def on_release(self, slot):
        self.calls.append(("release", slot))
        self.tracker.on_release(slot)

    def reset(self):
        self.calls.append(("reset",))
        self.tracker.reset()

    def propose(self, rows):
        self.calls.append(("propose", [s for s, _, _ in rows]))
        out = {}
        for slot, ctx, cap in rows:
            if self.tracker.begin_round(slot, len(ctx)) is None:
                continue
            self.tracker.mark_fed(slot, len(ctx))
            if min(cap, self.k) > 0:
                out[slot] = [self.token] * min(cap, self.k)
        return out


@pytest.mark.parametrize("kind", tspec.PROPOSER_KINDS)
def test_proposers_equal_jax_through_a_session(kind):
    """Each proposer kind over the same rows, admissions and releases:
    the same drafts, flags and runtime calls as JAX's."""
    sides = []
    for mod in (tspec, jspec):
        rt = _Runtime(mod)
        prop = {"lookup": lambda: mod.LookupProposer(3),
                "draft_model": lambda: mod.DraftModelProposer(rt),
                "combined": lambda: mod.CombinedProposer(3, rt)}[kind]()
        sides.append((prop, rt))
    rng = np.random.default_rng(len(kind))
    ctxs = {s: c for s, c in enumerate(_contexts(3)[:4])}
    for (prop, _) in sides:
        assert prop.kind == kind
        for slot, ctx in ctxs.items():
            prop.on_admit(slot, len(ctx) - 1)
    outs = []
    for prop, rt in sides:
        rounds = []
        local = {s: list(c) for s, c in ctxs.items()}
        for r in range(6):
            rows = [(s, c, int(cap)) for (s, c), cap in zip(local.items(), [4, 2, 0, 8])]
            got = prop.propose_wave(rows)
            rounds.append(got)
            for s in local:
                local[s].extend(got.get(s, [])[:1] + [r])
            if r == 3:
                prop.on_release(1)
        prop.reset()
        outs.append((rounds, rt.calls, prop.uses_draft_model, prop.supports_runahead))
    assert outs[0] == outs[1]
    del rng


def test_counters_and_snapshot_keys_equal_jax():
    before = tspec.metrics_snapshot()
    jbefore = jspec.metrics_snapshot()
    assert set(before) == set(jbefore)
    for mod in (tspec, jspec):
        mod.record_dispatch(drafted=6, accepted=4)
        mod.record_dispatch(drafted=0, accepted=0)
        mod.record_draft_dispatch()
        mod.record_draft_dispatch(program="prefill", n=3)
        mod.record_adaptive_round(4)
    after, jafter = tspec.metrics_snapshot(), jspec.metrics_snapshot()
    for key in ("spec_drafted_tokens", "spec_accepted_tokens", "spec_draft_dispatches",
                "spec_adaptive_rounds", "spec_adaptive_k_sum"):
        assert after[key] - before[key] == jafter[key] - jbefore[key], key
    assert after["spec_tokens_per_step"] >= 1.0 and 0.0 < after["spec_acceptance_rate"] <= 1.0
